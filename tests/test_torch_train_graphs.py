"""The train step as a step graph (duodiff_tpu_torch.training.train_state's
step body, diffusion/graphs.py, the trainer's route) on the CPU.

A CUDA graph replays the kernels its capture recorded, on the same memory,
with every host value as it was at the capture. Here the capture is
emulated (tests/torch_graph_emulator.py): every aten op the body runs is
recorded, and a replay runs the recorded ops again on the same persistent
tensors, with the capture's scalars, below autograd and without bumping a
version counter, as a graph's replay does. So a body that read a host value
which the host moves between steps, wrote a tensor it had rebound or made
its state anew, would drift from the eager steps here as it would on the
card, and one that reads a value on the host during capture fails.

Held: (1) every tensor the body writes (parameters, gradients, AdamW's
moments and count, the accumulation window and mean, the non-finite
counters, the EMA, the metrics, the staged inputs) keeps its address, and
the body writes nothing else that outlives it; (2) the body reads only
device state: another host step number with the same draws changes
nothing, and the emulated replays equal the eager steps to the bit; (3) the
graphed steps match JAX's make_train_step and optax (accumulation,
skipping, label dropout; DeeDiff) at the bounds of
tests/test_torch_train_options.py and tests/test_torch_ee_train.py (atol
2e-5 on parameters and EMA, rtol 1e-5 on the loss and the norm); (4) after
a replay the packed operands count as stale and the next packed forward
packs again; (5) the training CLI graphed equals it eager, and the route
line.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

from duodiff_tpu.config import UViTConfig as JaxConfig
from duodiff_tpu.diffusion.schedule import NoiseSchedule as JaxSchedule
from duodiff_tpu.models.early_exit import EarlyExitUViT as JaxEarlyExitUViT
from duodiff_tpu.models.uvit import init_uvit as jax_init_uvit
from duodiff_tpu.training.train_state import create_train_state
from duodiff_tpu.training.train_state import make_optimizer as jax_make_optimizer
from duodiff_tpu.training.train_state import make_train_step as jax_make_train_step
from duodiff_tpu_torch import train
from duodiff_tpu_torch.config import UViTConfig
from duodiff_tpu_torch.data.synthetic import write_palette_cifar
from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
from duodiff_tpu_torch.models.early_exit import EarlyExitUViT
from duodiff_tpu_torch.models.uvit import UViT
from duodiff_tpu_torch.parallel.mesh import Grid
from duodiff_tpu_torch.training import trainer as trainer_module
from duodiff_tpu_torch.training.train_state import TrainState, make_optimizer, make_train_step
from duodiff_tpu_torch.utils.convert import (
    early_exit_state_dict_from_jax,
    uvit_state_dict_from_jax,
)
from torch_graph_emulator import emulated  # noqa: F401 (a fixture)

torch.set_num_threads(1)

NULL = 4
SMALL = dict(img_size=8, patch_size=2, in_chans=3, embed_dim=64, num_heads=4, mlp_ratio=4,
             depth=3, num_classes=NULL + 1)
EE = dict(img_size=16, patch_size=4, in_chans=3, embed_dim=32, depth=3, num_heads=4,
          mlp_ratio=4, num_classes=-1, normalize_timesteps=True,
          classifier_type="mlp_probe_per_layer")
OPT = dict(lr=1e-3, weight_decay=0.03, beta1=0.9, beta2=0.999, max_grad_norm=0.05,
           num_warmup_steps=0, num_training_steps=2)
OPTIONS = dict(grad_accum=2, skip_nonfinite=1)
DROP = 0.5
STEPS = 4


# --- the emulated graph (tests/torch_graph_emulator.py) ---------------------------


def _stray_writes(ops, kept_storages: set) -> list:
    """The shapes of the tensors the recorded ops wrote whose memory is
    neither one of ``kept_storages`` nor made by the ops themselves."""
    seen, made, stray = set(), set(), []
    for func, args, kwargs, result in ops:
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        for i, arg in enumerate(func._schema.arguments):
            if arg.alias_info is None or not arg.alias_info.is_write:
                continue
            value = args[i] if i < len(args) else kwargs.get(arg.name)
            for t in tree_leaves(value):
                if isinstance(t, torch.Tensor):
                    where = t.untyped_storage().data_ptr()
                    if where not in kept_storages and where not in made:
                        stray.append(tuple(t.shape))
        seen.update(t.untyped_storage().data_ptr() for t in ins)
        for t in tree_leaves(result):
            if isinstance(t, torch.Tensor) and t.untyped_storage().data_ptr() not in seen:
                made.add(t.untyped_storage().data_ptr())
                seen.add(t.untyped_storage().data_ptr())
    return stray


# --- set-ups -------------------------------------------------------------------


def _jax_uvit(seed=1):
    model, params = jax_init_uvit(JaxConfig(**SMALL), jax.random.PRNGKey(seed),
                                  dtype=jnp.float32, attn_impl="fused")
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rng.randn(*a.shape).astype(np.float32), params)
    return model, params


def _port_uvit(params, *, graphs_run=None, seed=0, label_dropout=DROP, ema=0.9, opt=OPT,
               dtype=torch.float32, **options):
    model = UViT(UViTConfig(**SMALL), dtype=dtype, attn_impl="plain")
    model.load_state_dict(uvit_state_dict_from_jax(params), strict=True)
    state = TrainState.create(model, make_optimizer(dict(model.named_parameters()), **opt,
                                                    **options), ema_decay=ema)
    step = make_train_step(model, NoiseSchedule.create(steps=1000),
                           parametrization="predict_noise", seed=seed, has_labels=True,
                           label_dropout=label_dropout, null_label=NULL, graphs=graphs_run)
    return model, state, step


def _batch(seed=0, n=4, side=8):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (n, side, side, 3)).astype(np.float32)
    return {"image": torch.from_numpy(x), "label": torch.arange(n) % NULL}


def _state_tensors(model, state, step) -> dict:
    """Every tensor the train step keeps: the parameters and gradients, the
    optimizer's tensors, the EMA, the run's static buffers."""
    opt = state.optimizer
    out = {}
    for n, p in model.named_parameters():
        out[f"param {n}"] = p
        out[f"grad {n}"] = p.grad
    for key in ("mu", "nu", "acc_grads"):
        for n, t in zip(opt.names, getattr(opt, key) or ()):
            out[f"{key} {n}"] = t
    for key in ("_count", "_mini", "notfinite_count", "total_notfinite", "last_finite"):
        if hasattr(opt, key):
            out[key] = getattr(opt, key)
    for n, t in (state.ema or {}).items():
        out[f"ema {n}"] = t
    for key, t in step.run["graphs"]._buffers.items():
        out[f"buffer {key[0]}"] = t
    return out


# --- (1) addresses -------------------------------------------------------------


def test_every_tensor_the_body_writes_keeps_its_address(emulated):
    """Over six steps (both kinds eager, captured, replayed): each kept
    tensor is the same object at the same address after every step, the
    values move, and every tensor a captured body writes that it did not
    make is one of them (a view of one counts as it)."""
    _, params = _jax_uvit()
    run = emulated()
    model, state, step = _port_uvit(params, graphs_run=run, **OPTIONS)
    batch = _batch()
    step(state, batch, 1)
    kept = _state_tensors(model, state, step)
    addresses = {k: (id(t), t.data_ptr()) for k, t in kept.items()}
    start = {k: t.detach().clone() for k, t in kept.items()}
    for s in range(2, 7):
        step(state, batch, s)
        now = _state_tensors(model, state, step)
        assert {k: (id(t), t.data_ptr()) for k, t in now.items()} == addresses, s
    assert {k for k in kept if not torch.equal(kept[k].detach(), start[k])} >= {
        "_count", "buffer metrics",
        *(f"param {n}" for n, _ in model.named_parameters()),
        *(f"mu {n}" for n in state.optimizer.names), *(f"ema {n}" for n in state.ema)}
    storages = {t.untyped_storage().data_ptr() for t in kept.values()}
    assert set(run.graphs) == {("train", "fold"), ("train", "update")}
    for key, g in run.graphs.items():
        assert g.graph.ops, key
        assert not _stray_writes(g.graph.ops, storages), key


# --- (2) only device state -------------------------------------------------------


def _draws_of(step, batch, s):
    return (*step.draws(batch, s), step.drop_mask(batch, s))


def test_the_body_reads_only_device_state(emulated):
    """Three runs from equal state over six steps: eager; graphed; graphed
    with host step numbers 100 apart and the first run's draws injected.
    All three equal to the bit after every step, the recorded bodies read
    nothing on the host, and a replay moves no version counter."""
    _, params = _jax_uvit()
    batch = _batch()
    eager = _port_uvit(params, **OPTIONS)
    graphed = _port_uvit(params, graphs_run=emulated(), **OPTIONS)
    shifted = _port_uvit(params, graphs_run=emulated(), **OPTIONS)
    for s in range(1, 7):
        versions = [p._version for p in graphed[0].parameters()]
        metrics = [eager[2](eager[1], batch, s), graphed[2](graphed[1], batch, s),
                   shifted[2](shifted[1], batch, s + 100, *_draws_of(shifted[2], batch, s))]
        for m in metrics[1:]:
            assert m.keys() == metrics[0].keys()
            assert all(torch.equal(m[k], metrics[0][k]) for k in m), s
        tensors = [_state_tensors(*run) for run in (eager, graphed, shifted)]
        for k, t in tensors[0].items():
            if not k.startswith("buffer"):
                assert torch.equal(tensors[1][k], t) and torch.equal(tensors[2][k], t), (s, k)
        if s >= 5:  # both kinds replay from step 5 on
            assert versions == [p._version for p in graphed[0].parameters()]
    assert graphed[1].optimizer.count == eager[1].optimizer.count == 3
    for run in (graphed, shifted):
        for g in run[2].run["graphs"].graphs.values():
            names = {str(func) for func, *_ in g.graph.ops}
            assert not any("_local_scalar_dense" in n for n in names), names


def test_a_graphed_step_keeps_its_first_state_and_shapes(emulated):
    _, params = _jax_uvit()
    model, state, step = _port_uvit(params, graphs_run=emulated())
    step(state, _batch(), 1)
    other = TrainState.create(model, make_optimizer(dict(model.named_parameters()), **OPT))
    with pytest.raises(ValueError, match="first call"):
        step(other, _batch(), 2)
    with pytest.raises(ValueError, match="first call"):
        step(state, _batch(n=2), 2)


# --- (3) against JAX ---------------------------------------------------------------


def _jax_drop_mask(key, n):
    return np.asarray(jax.random.bernoulli(jax.random.fold_in(key, 0x1ABE1), DROP, (n,)))


def _jax_draws(key, shape):
    t_key, n_key = jax.random.split(key)
    t = np.asarray(jax.random.randint(t_key, (shape[0],), 0, 1000))
    noise = np.asarray(jax.random.normal(n_key, shape, jnp.float32))
    return torch.from_numpy(t.copy()).long(), torch.from_numpy(noise.copy())


def _assert_close(got: torch.Tensor, want, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5,
                               equal_nan=True, err_msg=what)


def test_graphed_uvit_steps_match_jax(emulated):
    """Four data steps, two windows of --grad_accum 2 under --skip_nonfinite
    1 with label dropout 0.5: the second window's first batch holds a NaN, so
    its update is skipped on both sides. Parameters and EMA after every
    step, the loss and the norm of every finite step."""
    jmodel, params = _jax_uvit()
    jstep = jax.jit(jax_make_train_step(
        lambda p, x, t, y: jmodel.apply({"params": p}, x, t, y), JaxSchedule.create(steps=1000),
        model_kind="uvit", parametrization="predict_noise", has_labels=True,
        label_dropout=DROP, null_label=NULL))
    jstate = create_train_state(params, jax_make_optimizer(**OPT, **OPTIONS), ema_decay=0.9)
    model, state, step = _port_uvit(params, graphs_run=emulated(), **OPTIONS)
    base = jax.random.PRNGKey(3)
    for s in range(1, STEPS + 1):
        batch = _batch(seed=s)
        if s == 3:
            batch["image"][0, 0, 0, 0] = float("nan")
        key = jax.random.fold_in(base, s)
        jstate, jm = jstep(jstate, {"image": jnp.asarray(batch["image"].numpy()),
                                    "label": jnp.asarray(batch["label"].numpy())}, key)
        drop = torch.from_numpy(_jax_drop_mask(key, 4))
        m = step(state, batch, s, *_jax_draws(key, tuple(batch["image"].shape)), drop)
        if s != 3:
            np.testing.assert_allclose(m["train_loss"].item(), float(jm["train_loss"]),
                                       rtol=1e-5)
            np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-5)
        want = uvit_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params))
        want_ema = uvit_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.ema_params))
        for name, p in model.named_parameters():
            _assert_close(p, want[name], f"step {s} {name}")
            _assert_close(state.ema[name], want_ema[name], f"step {s} ema {name}")
    opt = state.optimizer
    assert opt.count == 1 and int(opt.total_notfinite) == 1 and not bool(opt.last_finite)


def test_graphed_deediff_steps_match_jax(emulated):
    """DeeDiff's loss through the graphed step, --grad_accum 2
    --skip_nonfinite 1, four data steps: parameters, EMA, every loss part."""
    config = UViTConfig(**EE)
    jmodel = JaxEarlyExitUViT(config=JaxConfig(**EE))
    x0 = jnp.zeros((1, 16, 16, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), x0, jnp.zeros((1,))))
    rng = np.random.RandomState(5)

    def draw(path, leaf):
        value = 0.05 * rng.randn(*leaf.shape).astype(np.float32)
        return value + 1.0 if path[-1].key == "scale" else value

    params = jax.tree_util.tree_map_with_path(draw, shapes["params"])
    jstep = jax.jit(jax_make_train_step(
        lambda p, x, t, y: jmodel.apply({"params": p}, x, t, y), JaxSchedule.create(steps=1000),
        model_kind="deediff_uvit", parametrization="predict_noise"))
    jstate = create_train_state(params, jax_make_optimizer(**OPT, **OPTIONS), ema_decay=0.9)
    model = EarlyExitUViT(config, dtype=torch.float32, attn_impl="plain")
    model.load_state_dict(early_exit_state_dict_from_jax(params, config), strict=True)
    state = TrainState.create(model, make_optimizer(dict(model.named_parameters()), **OPT,
                                                    **OPTIONS), ema_decay=0.9)
    step = make_train_step(model, NoiseSchedule.create(steps=1000),
                           parametrization="predict_noise", seed=0, model_kind="deediff_uvit",
                           graphs=emulated())
    base = jax.random.PRNGKey(8)
    tree = jax.tree_util.tree_map
    for s in range(1, STEPS + 1):
        x = np.random.RandomState(s).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
        key = jax.random.fold_in(base, s)
        jstate, jm = jstep(jstate, {"image": jnp.asarray(x)}, key)
        m = step(state, {"image": torch.from_numpy(x)}, s, *_jax_draws(key, x.shape))
        assert sorted(m) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-5, err_msg=k)
        want = early_exit_state_dict_from_jax(tree(np.asarray, jstate.params), config)
        want_ema = early_exit_state_dict_from_jax(tree(np.asarray, jstate.ema_params), config)
        for name, p in model.named_parameters():
            _assert_close(p, want[name], f"step {s} {name}")
            _assert_close(state.ema[name], want_ema[name], f"step {s} ema {name}")
    assert state.optimizer.count == STEPS // 2


# --- (4) the packs after a replay -----------------------------------------------------


@pytest.mark.parametrize("hook", [True, False], ids=["marked", "unmarked"])
def test_a_replay_marks_the_packed_operands_stale(emulated, monkeypatch, hook):
    """A replay writes the weights without moving their version counters.
    After the train step's hook (mark_weights_moved) the next packed
    forward packs again and equals a fresh packing; without it the stale
    operands would serve, which the unmarked case shows. (bf16 compute: the
    packs are copies of the fp32 weights, as on the card.)"""
    _, params = _jax_uvit()
    model, state, step = _port_uvit(params, graphs_run=emulated(), label_dropout=0.0, ema=0.0,
                                    opt=dict(OPT, num_training_steps=10), dtype=torch.bfloat16)
    if not hook:
        monkeypatch.setattr(model, "mark_weights_moved", lambda: None)
    batch = _batch()
    x, t, y = batch["image"], torch.tensor([10.0, 200.0, 500.0, 900.0]), batch["label"]
    for s in (1, 2):  # the eager warm-up, then the capture
        step(state, batch, s)
    model.eval().pack_for_kernels()
    with torch.no_grad():
        before = model(x, t, y)
    versions = [p._version for p in model.parameters()]
    step(state, batch, 3)  # a replay
    assert versions == [p._version for p in model.parameters()]
    model.eval()
    with torch.no_grad():
        got = model(x, t, y)
        model.pack_for_kernels()
        fresh = model(x, t, y)
    assert not torch.equal(before, fresh)
    assert torch.equal(got, fresh) == hook  # unmarked: the stale bf16 weights served


# --- (5) the CLI and the route ----------------------------------------------------------


TINY_CLI = dict(img_size=32, patch_size=4, in_chans=3, embed_dim=32, num_heads=4, mlp_ratio=4,
                qkv_bias=False, mlp_time_embed=False, num_classes=-1, normalize_timesteps=True,
                depth=3)


def test_the_cli_graphed_equals_the_cli_eager(emulated, monkeypatch, tmp_path):
    """``train.main`` with the trainer's graphs emulated against
    ``main(graphs=False)``: --grad_accum 2 --skip_nonfinite 1 --ema_decay
    0.9, samples at the last step (the sampler's own steps eager on the
    CPU), a resume in the middle of the run: parameters, optimizer state,
    EMA, logs and the in-training samples equal to the bit."""
    write_palette_cifar(tmp_path / "data", seed=0, per_batch=64)
    config = tmp_path / "tiny.yaml"
    config.write_text("model_params:\n" + "".join(f"  {k}: {v}\n" for k, v in TINY_CLI.items()))
    real = trainer_module.StepGraphs

    def run_graphs(device, graphed):
        run = real(device, graphed)
        run.graphed = graphed
        return run

    monkeypatch.setattr(trainer_module, "StepGraphs", run_graphs)
    monkeypatch.setattr(trainer_module, "train_graph_route",
                        lambda device, grid=None, graphs=True: (graphs, "emulated"))

    def argv(exp, n, *extra):
        return ["--config_path", str(config), "--device", "cpu", "--data_path",
                str(tmp_path / "data"), "--log_path", str(tmp_path / "logs"), "--exp_name", exp,
                "--n_steps", str(n), "--batch_size", "8", "--num_warmup_steps", "2", "--lr",
                "1e-3", "--seed", "0", "--grad_accum", "2", "--skip_nonfinite", "1",
                "--ema_decay", "0.9", "--log_every_n_steps", "6", "--n_samples", "2",
                "--num_timesteps", "20", "--save_every_n_steps", "2", *extra]

    eager = train.main(argv("eager", 6), graphs=False)
    graphed = train.main(argv("graphed", 6))
    train.main(argv("resumed", 4))
    resumed = train.main(argv("resumed", 6, "--resume"))
    assert set(graphed.graphs.graphs) == {("train", "fold"), ("train", "update")}
    assert not eager.graphs.graphs
    for other in (graphed, resumed):
        for a, b in zip(eager.model.state_dict().values(), other.model.state_dict().values()):
            assert torch.equal(a, b)
        for name, t in eager.state.ema.items():
            assert torch.equal(t, other.state.ema[name])
        want, got = eager.state.optimizer.state_dict(), other.state.optimizer.state_dict()
        assert (got["count"], got["mini_step"], got["total_notfinite"]) == (
            want["count"], want["mini_step"], want["total_notfinite"]) == (3, 0, 0)
        for key in ("mu", "nu", "acc_grads"):
            assert all(torch.equal(want[key][n], got[key][n]) for n in want[key])
        for name in ("samples_step6.png", "sample_stats_step6.npy"):
            assert (eager.log_path / name).read_bytes() == (other.log_path / name).read_bytes()
    strip = [{k: v for k, v in log.items() if k != "steps_per_sec"} for log in eager.logs]
    assert strip == [{k: v for k, v in log.items() if k != "steps_per_sec"}
                     for log in graphed.logs]


@pytest.mark.parametrize("device, grid, graphs_on, words", [
    ("cpu", None, True, "the CPU runs each step body eagerly"),
    ("cuda", None, False, "the caller asked for the eager steps"),
    ("cuda", Grid(rank=0, world=2, data=2, model=1), True, "a process grid of 2 ranks"),
    ("cuda:0", Grid(), True, "captured once as a CUDA graph"),
], ids=["cpu", "graphs_false", "grid", "on"])
def test_the_route_line(device, grid, graphs_on, words):
    graphed, line = trainer_module.train_graph_route(device, grid, graphs_on)
    assert graphed == (words == "captured once as a CUDA graph")
    assert line.startswith("train step graphs: ") and words in line
    if grid is not None and grid.distributed:
        assert "gloo" in line and "eager" in line
