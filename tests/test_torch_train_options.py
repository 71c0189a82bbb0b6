"""The port's --grad_accum, --skip_nonfinite and --use_checkpoint
(duodiff_tpu_torch.training, models.uvit) against the JAX package's optax
wrappers (duodiff_tpu.training.train_state.make_optimizer: optax.MultiSteps
around optax.apply_if_finite) on identical seeded gradient sequences, and
against its make_train_step on a small UViT; then the training CLI on the
CPU with the three flags, a resume in the middle of an accumulation window,
and a train step through the hidden-split MLP backward.

Tolerances: the optimizer alone on identical gradients rtol 1e-6 / atol 1e-7
after every data step (tests/test_torch_train_step.py's bound for it);
through a model atol 2e-5 after four clipped steps at lr 1e-3 (the same
file's); bf16 gradients through the split backward 5e-2 relative Frobenius
(the same file's); checkpointing and resume equal to the bit."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from duodiff_tpu.config import UViTConfig as JaxConfig
from duodiff_tpu.diffusion.schedule import NoiseSchedule as JaxSchedule
from duodiff_tpu.models.uvit import init_uvit as jax_init_uvit
from duodiff_tpu.training.train_state import create_train_state
from duodiff_tpu.training.train_state import make_optimizer as jax_make_optimizer
from duodiff_tpu.training.train_state import make_train_step as jax_make_train_step
from duodiff_tpu_torch import train
from duodiff_tpu_torch.config import UViTConfig
from duodiff_tpu_torch.data.synthetic import write_palette_cifar
from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
from duodiff_tpu_torch.models.uvit import UViT
from duodiff_tpu_torch.ops import block
from duodiff_tpu_torch.training.checkpointer import Checkpointer
from duodiff_tpu_torch.training.train_state import TrainState, make_optimizer, make_train_step
from duodiff_tpu_torch.utils.convert import uvit_state_dict_from_jax

torch.set_num_threads(1)

SMALL = dict(img_size=8, patch_size=2, in_chans=3, embed_dim=64, num_heads=4, mlp_ratio=4,
             depth=3)
OPT = dict(lr=1e-3, weight_decay=0.03, beta1=0.9, beta2=0.999, max_grad_norm=0.5,
           num_warmup_steps=2, num_training_steps=6)
SHAPES = {"a": (5, 7), "b": (7,), "c": (3, 2, 2)}


def _both_optimizers(**options):
    """The same initial parameters under optax and under the port, with an
    EMA of decay 0.5 on each side."""
    rng = np.random.RandomState(0)
    init = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    tx = jax_make_optimizer(**OPT, **options)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    model = torch.nn.Module()
    for k, v in tparams.items():
        model.register_parameter(k, v)
    state = TrainState.create(model, make_optimizer(tparams, **OPT, **options), ema_decay=0.5)
    return rng, init, tx, tparams, state


def _drive(options, bad_steps, n_steps=12):
    """Feed both sides the same gradients, non-finite at ``bad_steps``, and
    compare parameters and EMA after every data step."""
    rng, init, tx, tparams, state = _both_optimizers(**options)
    jparams, jopt, jema = dict(init), tx.init(init), dict(init)
    for i in range(n_steps):
        grads = {k: rng.randn(*s).astype(np.float32) * 0.3 for k, s in SHAPES.items()}
        if i in bad_steps:
            grads["b"][2] = np.nan if i % 2 else np.inf
        updates, jopt = tx.update(grads, jopt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        jema = {k: jema[k] * 0.5 + np.asarray(jparams[k]) * 0.5 for k in SHAPES}
        norm = state.optimizer.step([torch.from_numpy(grads[k].copy())
                                     for k in state.optimizer.names])
        state.update_ema()
        if i not in bad_steps:
            np.testing.assert_allclose(norm.item(), float(optax.global_norm(grads)), rtol=1e-6)
        for k in SHAPES:
            np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(jparams[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=f"step {i} {k}")
            np.testing.assert_allclose(state.ema[k].numpy(), jema[k], rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {i} ema {k}")
    return state, jopt


@pytest.mark.parametrize("grad_accum", [2, 3])
def test_grad_accum_matches_optax_multisteps(grad_accum):
    """The running mean, the clip of the mean, one AdamW update and one
    learning-rate position per window; between updates nothing moves but
    the EMA, which the JAX train state advances on every data step."""
    state, jopt = _drive({"grad_accum": grad_accum}, bad_steps=())
    assert state.optimizer.count == 12 // grad_accum == int(jopt.gradient_step)
    assert state.optimizer.mini_step == int(jopt.mini_step) == 0


@pytest.mark.parametrize("bad_steps", [(3,), (3, 4), (3, 4, 5), (2, 3, 4, 5, 8)],
                         ids=["one", "two_in_a_row", "three_in_a_row", "two_runs"])
def test_skip_nonfinite_matches_optax_apply_if_finite(bad_steps):
    """A bad step leaves parameters, moments and the count alone; with
    max_consecutive_errors 2 the third bad step in a row is applied as it
    is, NaN and all, on both sides."""
    state, jopt = _drive({"skip_nonfinite": 2}, bad_steps)
    opt = state.optimizer
    assert int(opt.total_notfinite) == int(jopt.total_notfinite) == len(bad_steps)
    assert int(opt.notfinite_count) == int(jopt.notfinite_count)
    assert bool(opt.last_finite) == bool(jopt.last_finite)
    applied = run = 0
    for i in range(12):  # a bad step counts once the run of bad steps exceeds 2
        run = run + 1 if i in bad_steps else 0
        applied += run == 0 or run > 2
    assert opt.count == applied


def test_both_options_match_optax_on_finite_gradients():
    state, jopt = _drive({"grad_accum": 2, "skip_nonfinite": 3}, bad_steps=())
    assert state.optimizer.count == 6 and int(state.optimizer.total_notfinite) == 0
    assert int(jopt.inner_opt_state.total_notfinite) == 0


def test_a_bad_step_inside_a_window_skips_that_window_only():
    """With both options a non-finite data step makes its window's mean
    non-finite, that one update is skipped, and the next window starts from
    zero again. (optax 0.2.6 multiplies the non-finite mean by 0 to reset it
    and so never recovers; the port does not copy that.)"""
    _, _, _, tparams, state = _both_optimizers(grad_accum=2, skip_nonfinite=3)
    opt = state.optimizer
    good = [torch.full(p.shape, 0.1) for p in opt.params]
    bad = [g.clone() for g in good]
    bad[1][0] = float("nan")
    opt.step([g.clone() for g in good])
    before = [p.detach().clone() for p in opt.params]
    opt.step([g.clone() for g in bad])                   # window 1: skipped
    assert opt.count == 0 and int(opt.total_notfinite) == 1 and not bool(opt.last_finite)
    assert all(torch.equal(a, b) for a, b in zip(before, opt.params))
    assert all(bool((a == 0).all()) for a in opt.acc_grads)
    for _ in range(4):
        opt.step([g.clone() for g in good])              # windows 2 and 3: applied
    # (the first update sits at learning-rate position 0 of the warm-up, the second moves)
    assert opt.count == 2 and int(opt.notfinite_count) == 0 and bool(opt.last_finite)
    assert all(bool(torch.isfinite(p).all()) and not torch.equal(a, p)
               for a, p in zip(before, opt.params))


def test_option_state_round_trips_in_the_middle_of_a_window():
    """state_dict carries the running mean, the mini-step and the non-finite
    counters: an optimizer restored after an odd step continues to the bit."""
    options = dict(grad_accum=2, skip_nonfinite=2)
    _, _, _, _, whole = _both_optimizers(**options)
    _, _, _, _, first = _both_optimizers(**options)
    _, _, _, _, second = _both_optimizers(**options)
    rng = np.random.RandomState(5)
    seq = [[torch.from_numpy(rng.randn(*p.shape).astype(np.float32)) for p in whole.optimizer.params]
           for _ in range(6)]
    seq[1][0][0, 0] = float("inf")
    for g in seq:
        whole.optimizer.step([t.clone() for t in g])
    for g in seq[:3]:
        first.optimizer.step([t.clone() for t in g])
    saved = first.optimizer.state_dict()
    assert saved["mini_step"] == 1 and saved["total_notfinite"] == 1 and saved["count"] == 0
    with torch.no_grad():
        for dst, src in zip(second.optimizer.params, first.optimizer.params):
            dst.copy_(src)
    second.optimizer.load_state_dict(saved)
    for g in seq[3:]:
        second.optimizer.step([t.clone() for t in g])
    assert second.optimizer.count == whole.optimizer.count == 2
    for a, b in zip(whole.optimizer.params, second.optimizer.params):
        assert torch.equal(a, b)
    for a, b in zip(whole.optimizer.mu + whole.optimizer.nu,
                    second.optimizer.mu + second.optimizer.nu):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="mini-step"):
        make_optimizer({k: torch.nn.Parameter(torch.zeros(s)) for k, s in SHAPES.items()},
                       **OPT, grad_accum=3).load_state_dict(dict(saved, mini_step=3))


def test_invalid_options_are_refused():
    p = {"w": torch.nn.Parameter(torch.ones(3))}
    with pytest.raises(ValueError, match="grad_accum"):
        make_optimizer(p, **OPT, grad_accum=0)
    with pytest.raises(ValueError, match="skip_nonfinite"):
        make_optimizer(p, **OPT, skip_nonfinite=-1)


# ---- through a small model ----

def _jax_setup(dtype, seed=0):
    model, params = jax_init_uvit(JaxConfig(**SMALL), jax.random.PRNGKey(seed), dtype=dtype,
                                  attn_impl="fused")
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rng.randn(*a.shape).astype(np.float32), params)
    step = jax_make_train_step(lambda p, x, t, y: model.apply({"params": p}, x, t, y),
                               JaxSchedule.create(steps=1000), model_kind="uvit",
                               parametrization="predict_noise")
    x = rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    return params, step, x


def _draws(key, shape):
    t_key, n_key = jax.random.split(key)
    t = np.asarray(jax.random.randint(t_key, (shape[0],), 0, 1000))
    noise = np.asarray(jax.random.normal(n_key, shape, jnp.float32))
    return torch.from_numpy(t.copy()).long(), torch.from_numpy(noise.copy())


def _port(params, dtype, impl, **model_kw):
    model = UViT(UViTConfig(**SMALL), dtype=dtype, attn_impl=impl, **model_kw)
    model.load_state_dict(uvit_state_dict_from_jax(params), strict=True)
    step = make_train_step(model, NoiseSchedule.create(steps=1000),
                           parametrization="predict_noise", seed=0)
    return model, step


def test_train_step_with_grad_accum_matches_jax():
    """Four data steps, two optimizer updates: parameters and EMA after
    every data step, the logged gradient norm that of the data step."""
    opt = dict(OPT, max_grad_norm=0.05, num_warmup_steps=0, num_training_steps=2)
    params, jstep, x = _jax_setup(jnp.float32, seed=1)
    model, step = _port(params, torch.float32, "plain")
    state = TrainState.create(model, make_optimizer(dict(model.named_parameters()), **opt,
                                                    grad_accum=2), ema_decay=0.9)
    jstate = create_train_state(params, jax_make_optimizer(**opt, grad_accum=2), ema_decay=0.9)
    jfn = jax.jit(jstep)
    batch = {"image": jnp.asarray(x), "label": jnp.zeros(2, jnp.int32)}
    base = jax.random.PRNGKey(3)
    for s in range(1, 5):
        key = jax.random.fold_in(base, s)
        jstate, jm = jfn(jstate, batch, key)
        m = step(state, {"image": torch.from_numpy(x)}, s, *_draws(key, x.shape))
        np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(m["train_loss"].item(), float(jm["train_loss"]), rtol=1e-5)
        want = uvit_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params))
        want_ema = uvit_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.ema_params))
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=2e-5,
                                       err_msg=f"step {s} {name}")
            np.testing.assert_allclose(state.ema[name].numpy(), want_ema[name].numpy(),
                                       atol=2e-5, err_msg=f"step {s} ema {name}")
        assert state.optimizer.count == s // 2


@pytest.mark.parametrize("dtype, impl", [(torch.float32, "plain"), (torch.bfloat16, "fused"),
                                         (torch.float32, "xla")])
def test_use_checkpoint_changes_no_bit(dtype, impl):
    """Recomputing each block in the backward repeats its forward exactly:
    the loss and every gradient equal those without checkpointing."""
    params, _, x = _jax_setup(jnp.float32, seed=2)
    results = []
    for use_checkpoint in (False, True):
        model, step = _port(params, dtype, impl, use_checkpoint=use_checkpoint)
        key = jax.random.PRNGKey(9)
        metrics, grads = step.backward({"image": torch.from_numpy(x)}, *_draws(key, x.shape))
        results.append((metrics["train_loss"].detach(), [g.clone() for g in grads]))
    (loss_a, grads_a), (loss_b, grads_b) = results
    assert torch.equal(loss_a, loss_b)
    assert len(grads_a) == len(grads_b)
    for a, b in zip(grads_a, grads_b):
        assert torch.equal(a, b)


def test_use_checkpoint_is_off_outside_training():
    """In eval, or under no_grad, the blocks run once and directly."""
    model = UViT(UViTConfig(**SMALL), dtype=torch.float32, use_checkpoint=True)
    model.pack_for_kernels()
    x, t = torch.zeros(1, 8, 8, 3), torch.zeros(1)
    with torch.no_grad():
        want = model.eval()(x, t)
        assert torch.equal(model.train()(x, t), want)


def test_train_step_through_the_split_backward_matches_jax(monkeypatch):
    """bf16, attn_impl fused, DUODIFF_MLP_BWD_SPLIT=1: every MLP sublayer's
    gradients come from the split backward, and agree with the JAX fused
    train step's as the monolithic ones do."""
    monkeypatch.setenv("DUODIFF_MLP_BWD_SPLIT", "1")
    calls = []
    fn = block.fused_mlp_sublayer_bwd_split
    monkeypatch.setattr(block, "fused_mlp_sublayer_bwd_split",
                        lambda *a, **kw: calls.append(kw["splits"]) or fn(*a, **kw))
    params, jstep, x = _jax_setup(jnp.bfloat16)
    key = jax.random.PRNGKey(5)
    batch = {"image": jnp.asarray(x), "label": jnp.zeros(2, jnp.int32)}
    (loss, _), grads = jax.value_and_grad(jstep.loss_fn, has_aux=True)(params, batch, key)
    want = uvit_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    model, step = _port(params, torch.bfloat16, "fused")
    metrics, got = step.backward({"image": torch.from_numpy(x)}, *_draws(key, x.shape))
    assert calls == [4] * SMALL["depth"]
    assert abs(metrics["train_loss"].item() / float(loss) - 1) <= 1e-5
    for (name, _), g in zip(model.named_parameters(), got):
        w = want[name].numpy()
        assert np.linalg.norm(g.numpy() - w) / np.linalg.norm(w) <= 5e-2, name


# ---- the training CLI ----

TINY = dict(img_size=32, patch_size=4, in_chans=3, embed_dim=32, num_heads=4, mlp_ratio=4,
            qkv_bias=False, mlp_time_embed=False, num_classes=-1, normalize_timesteps=True,
            depth=3)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("options")
    write_palette_cifar(d / "data", seed=0, per_batch=64)
    config = d / "tiny.yaml"
    config.write_text("model_params:\n" + "".join(f"  {k}: {v}\n" for k, v in TINY.items()))
    return {"data": str(d / "data"), "logs": str(d / "logs"), "config": str(config)}


def _argv(files, exp, n_steps, *extra):
    return ["--config_path", files["config"], "--device", "cpu", "--data_path", files["data"],
            "--log_path", files["logs"], "--exp_name", exp, "--n_steps", str(n_steps),
            "--batch_size", "8", "--num_warmup_steps", "1", "--lr", "1e-3", "--seed", "0",
            *extra]


def test_cli_runs_with_the_three_options(files):
    trainer = train.main(_argv(files, "three", 6, "--grad_accum", "2", "--skip_nonfinite", "3",
                               "--use_checkpoint", "--ema_decay", "0.9"))
    opt = trainer.state.optimizer
    assert trainer.model.use_checkpoint and opt.grad_accum == 2 and opt.skip_nonfinite == 3
    assert [log["step"] for log in trainer.logs] == [1, 6]
    assert all(np.isfinite(log["train_loss"]) and np.isfinite(log["grad_norm"])
               for log in trainer.logs)
    assert opt.count == 3 and opt.mini_step == 0 and int(opt.total_notfinite) == 0
    # the schedule counts updates: 3 in all, the last at position 2 of 3
    assert opt.lr_schedule(0) == 0.0 and 0.0 < opt.lr_schedule(2) < 1e-3
    saved = Checkpointer.restore(trainer.log_path / "cifar10_uvit_last")["optimizer"]
    assert saved["count"] == 3 and saved["mini_step"] == 0 and "acc_grads" in saved


def test_cli_refuses_steps_that_do_not_fill_the_windows(files):
    with pytest.raises(ValueError, match="must be a multiple of --grad_accum 4"):
        train.main(_argv(files, "ragged", 6, "--grad_accum", "4"))


def test_cli_resume_inside_an_accumulation_window_equals_an_unbroken_run(files):
    extra = ("--grad_accum", "2", "--skip_nonfinite", "2", "--ema_decay", "0.9")
    whole = train.main(_argv(files, "whole", 6, *extra))
    odd = _run_to(files, "cut", 3, extra)
    assert odd["optimizer"]["mini_step"] == 1 and odd["optimizer"]["count"] == 1
    resumed = train.main(_argv(files, "cut", 6, "--resume", *extra))
    assert resumed.start_step == 3 and resumed.logs[-1]["step"] == 6
    for (name, a), b in zip(whole.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    wo, ro = whole.state.optimizer, resumed.state.optimizer
    assert wo.count == ro.count == 3 and ro.mini_step == 0
    for a, b in zip(wo.mu + wo.nu, ro.mu + ro.nu):
        assert torch.equal(a, b)
    for name in whole.state.ema:
        assert torch.equal(whole.state.ema[name], resumed.state.ema[name])


def _run_to(files, exp, stop, extra):
    """The six-step run of ``extra`` stopped after step ``stop`` by a
    preemption signal, as a cluster would; returns its checkpoint."""
    import signal

    from duodiff_tpu_torch.training.trainer import Trainer

    args = train.get_args(_argv(files, exp, 6, *extra))
    train.merge_args_with_config(args, args.config_path)
    trainer = Trainer(args)
    step_fn = trainer._train_step

    def preempted(state, batch, step):
        if step == stop:
            signal.raise_signal(signal.SIGTERM)
        return step_fn(state, batch, step)

    trainer._train_step = preempted
    trainer.train()
    saved = Checkpointer.restore(trainer.log_path / "cifar10_uvit_last")
    assert saved["step"] == stop
    return saved
