"""FSDP of the port (duodiff_tpu_torch.parallel.fsdp) against the JAX
package's ``fsdp_shard_params`` and FSDP train step, and against the port's
own data-parallel step:

- the rule: for a U-ViT and an early-exit U-ViT (attention probes, the time
  embedding's MLP, labels), on JAX's meshes (8, 1), (4, 2) and (2, 1) with
  ``min_size`` 1024 and 16384, every leaf is sharded over the data group
  exactly when JAX shards it, with the elements a rank JAX's
  ``shard_shape`` gives, and the bytes a rank are JAX's;
- one train step in gloo worlds of 2 ranks (data 2) and 4 ranks (data 2 x
  model 2; the unfused ``xla`` block under tensor parallelism) of a depth-3
  U-ViT, on JAX's own timesteps and noise (its key split, injected into
  the port), against JAX's FSDP train step on the (2, 1) and (2, 2) host
  meshes, fp32, no clipping: the loss within rtol 1e-6, the gradient norm
  within 1e-5, every gathered gradient (the chunks' reduce-scatter, the
  rest's all-reduce) within rtol 1e-4 / atol 1e-6 and the gathered
  parameters after the step within atol 2e-5 with lr 1e-3
  (tests/test_torch_train_step.py's bounds and their reason: AdamW's first
  step moves a parameter by lr g / (|g| + 1e-8), which for the many small
  gradients follows their last bits; measured up to 4.6e-6);
- the same world's data-parallel step: equal parameters, to the bit in the
  2-rank world (a sum of two terms has one rounding either way);
- each rank's parameters, AdamW moments and EMA hold its chunks only, and
  the FSDP step shows all-gathers and reduce-scatters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_dist_worker import run_world

from duodiff_tpu.config import UViTConfig as JaxConfig
from duodiff_tpu.diffusion.schedule import NoiseSchedule as JaxSchedule
from duodiff_tpu.models.early_exit import EarlyExitUViT as JaxEarlyExitUViT
from duodiff_tpu.models.uvit import init_uvit
from duodiff_tpu.parallel import batch_sharding, create_mesh, fsdp_shard_params
from duodiff_tpu.training.train_state import create_train_state
from duodiff_tpu.training.train_state import make_optimizer as jax_make_optimizer
from duodiff_tpu.training.train_state import make_train_step as jax_make_train_step
from duodiff_tpu.utils.param_layout import qkv_heads_to_packed, qkv_packed_to_heads
from duodiff_tpu_torch.config import UViTConfig
from duodiff_tpu_torch.parallel import fsdp
from duodiff_tpu_torch.utils import convert

H = 4
RULE_CFG = dict(img_size=32, patch_size=4, in_chans=3, embed_dim=128, depth=3, num_heads=H,
                mlp_ratio=4, qkv_bias=True, mlp_time_embed=True, num_classes=10,
                normalize_timesteps=True)
# no qkv bias: the k bias's gradient is zero up to rounding (the softmax does
# not see it), so AdamW's first step on it is the sign of rounding noise
STEP_CFG = dict(img_size=16, patch_size=2, in_chans=3, embed_dim=64, depth=3, num_heads=H,
                mlp_ratio=4, qkv_bias=False, mlp_time_embed=False, num_classes=-1,
                normalize_timesteps=True)
OPT = dict(lr=1e-3, weight_decay=0.03, beta1=0.9, beta2=0.999, max_grad_norm=1e6,
           num_warmup_steps=0, num_training_steps=10)
STEP_MIN_SIZE = 1024
B = 8


def _numbered(tree):
    """The tree with every leaf filled with its index (fp32), and the leaves."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    filled = [np.full(leaf.shape, i, np.float32) for i, leaf in enumerate(leaves)]
    return jax.tree_util.tree_unflatten(treedef, filled), leaves


def _rule_trees(kind: str, heads_layout: bool):
    """(JAX params shapes, the port's state dict of leaf indices, port config)."""
    cfg = dict(RULE_CFG, classifier_type="attention_probe")
    layout = "heads" if heads_layout else "packed"
    x, t = jnp.zeros((1, 32, 32, 3)), jnp.zeros((1,))
    y = jnp.zeros((1,), jnp.int32)
    if kind == "uvit":
        model, _ = init_uvit(JaxConfig(**cfg), jax.random.PRNGKey(0), qkv_layout=layout)
    else:
        model = JaxEarlyExitUViT(config=JaxConfig(**cfg), qkv_layout=layout)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, t, y))["params"]
    numbered, leaves = _numbered(shapes)
    packed = qkv_heads_to_packed(numbered, H) if heads_layout else numbered
    if kind == "uvit":
        sd = convert.uvit_state_dict_from_jax(packed)
    else:
        sd = convert.early_exit_state_dict_from_jax(packed, UViTConfig(**cfg))
    return shapes, leaves, sd


@pytest.mark.parametrize("min_size", [1024, 16384])
@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2), (2, 1)])
@pytest.mark.parametrize("kind", ["uvit", "early_exit"])
def test_rule_matches_fsdp_shard_params(kind, mesh_shape, min_size):
    data, model = mesh_shape
    mesh = create_mesh(shape=mesh_shape, devices=jax.devices()[:data * model])
    shapes, leaves, sd = _rule_trees(kind, heads_layout=model > 1)
    shardings = jax.tree_util.tree_leaves(fsdp_shard_params(shapes, mesh, min_size=min_size))
    plan = fsdp.plan({k: v.shape for k, v in sd.items()}, H, data, model, min_size)
    jax_bytes = port_bytes = 0
    seen = set()
    for name, t in sd.items():
        i = int(t.reshape(-1)[0])
        assert torch.all(t == i), name
        seen.add(i)
        leaf, sh = leaves[i], shardings[i]
        want = int(np.prod(sh.shard_shape(leaf.shape)))
        cut = model if model > 1 and convert.shard_kind(name) is not None else 1
        got = t.numel() // cut // (data if plan[name] else 1)
        assert plan[name] == ("data" in tuple(sh.spec)), (name, sh.spec)
        assert got == want, (name, leaf.shape, sh.spec)
        jax_bytes += 4 * want
        port_bytes += 4 * got
    assert seen == set(range(len(leaves)))
    assert port_bytes == jax_bytes
    if data > 1 and min_size == 1024:
        assert any(plan.values())


def _random_params(jmodel, seed):
    x = jnp.zeros((1, 16, 16, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), x, jnp.zeros((1,))))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        value = 0.05 * rng.randn(*leaf.shape).astype(np.float32)
        return value + 1.0 if path[-1].key == "scale" else value

    return jax.tree_util.tree_map_with_path(draw, shapes["params"])


def _jax_fsdp_step(params, mesh_shape, img, key):
    """JAX's FSDP train step (tests/test_fsdp.py's pattern) on the host mesh:
    (loss, params after the step under the port's names)."""
    data, model = mesh_shape
    mesh = create_mesh(shape=mesh_shape, devices=jax.devices()[:data * model])
    heads = model > 1
    jmodel, _ = init_uvit(JaxConfig(**STEP_CFG), jax.random.PRNGKey(0), attn_impl="xla",
                          qkv_layout="heads" if heads else "packed")
    p = qkv_packed_to_heads(params, H) if heads else params
    shardings = fsdp_shard_params(p, mesh, min_size=STEP_MIN_SIZE)
    placed = jax.device_put(jax.tree_util.tree_map(lambda a: jnp.array(a), p), shardings)
    state = create_train_state(placed, jax_make_optimizer(**OPT), ema_decay=0.9)
    step_fn = jax_make_train_step(lambda q, x, t, y: jmodel.apply({"params": q}, x, t, y),
                                  JaxSchedule.create(steps=1000), model_kind="uvit",
                                  parametrization="predict_noise")
    step = jax.jit(step_fn)
    batch = {"image": jax.device_put(img, batch_sharding(mesh)),
             "label": jax.device_put(np.zeros((B,), np.int32), batch_sharding(mesh, ndim=1))}
    new, metrics = step(state, batch, key)
    out = jax.tree_util.tree_map(np.asarray, new.params)
    if heads:
        out = qkv_heads_to_packed(out, H)
    grads = jax.grad(lambda q: step_fn.loss_fn(q, batch, key)[0])(placed)
    grads = jax.tree_util.tree_map(np.asarray, grads)
    if heads:
        grads = qkv_heads_to_packed(grads, H)
    return (float(metrics["train_loss"]), float(metrics["grad_norm"]),
            convert.uvit_state_dict_from_jax(out), convert.uvit_state_dict_from_jax(grads))


WORLDS = {"2 ranks, data 2": (2, 1), "4 ranks, data 2 x model 2": (4, 2)}


@pytest.fixture(scope="module")
def step_inputs(tmp_path_factory):
    work = tmp_path_factory.mktemp("fsdp")
    jmodel, _ = init_uvit(JaxConfig(**STEP_CFG), jax.random.PRNGKey(0), attn_impl="xla")
    params = _random_params(jmodel, seed=3)
    rng = np.random.RandomState(0)
    img = rng.uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    t_key, n_key = jax.random.split(key)
    t = np.asarray(jax.random.randint(t_key, (B,), 0, 1000))
    noise = np.asarray(jax.random.normal(n_key, img.shape, jnp.float32))
    inputs = {"config": STEP_CFG, "sd": convert.uvit_state_dict_from_jax(params),
              "img": torch.from_numpy(img), "t": torch.from_numpy(t.copy()).long(),
              "noise": torch.from_numpy(noise.copy()), "opt": OPT,
              "min_size": STEP_MIN_SIZE, "attn_impl": "xla"}
    return work, inputs, params, img, key


@pytest.fixture(scope="module", params=list(WORLDS))
def world(request, step_inputs):
    """One world's records (every rank's) and gathered results, and JAX's
    FSDP step on the matching mesh."""
    work, inputs, params, img, key = step_inputs
    n, mp = WORLDS[request.param]
    out = work / f"out_{n}"
    out.mkdir()
    path = work / f"inputs_{n}.pth"
    torch.save(dict(inputs, model_parallel=mp), path)
    rcs, outs = run_world(n, ["tests/torch_dist_worker.py", "fsdp", str(path), str(out)], work,
                          timeout=120)
    assert rcs == [0] * n, "\n".join(o[-3000:] for o in outs)
    records = [torch.load(out / f"rank{r}.pth", weights_only=False) for r in range(n)]
    gathered = torch.load(out / "gathered.pth", weights_only=False)
    return records, gathered, _jax_fsdp_step(params, (2, mp), img, key), inputs


def test_fsdp_step_matches_jax_fsdp_step(world):
    _, got, (jax_loss, jax_norm, jax_params, jax_grads), _ = world
    np.testing.assert_allclose(got["fsdp"]["loss"], jax_loss, rtol=1e-6)
    np.testing.assert_allclose(got["fsdp"]["grad_norm"], jax_norm, rtol=1e-5)
    assert set(got["fsdp"]["params"]) == set(jax_params) == set(got["fsdp"]["grads"])
    for name, want in jax_grads.items():
        np.testing.assert_allclose(got["fsdp"]["grads"][name].numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    for name, want in jax_params.items():
        np.testing.assert_allclose(got["fsdp"]["params"][name].numpy(), want.numpy(), atol=2e-5,
                                   err_msg=name)


def test_fsdp_step_equals_the_data_parallel_step(world):
    records, got, _, inputs = world
    fsdp_run, dp_run = got["fsdp"], got["dp"]
    for what in ("params", "ema", "mu"):
        for name, want in dp_run[what].items():
            have = fsdp_run[what][name]
            if records[0]["model"] == 1:  # data 2 alone: to the bit
                assert torch.equal(have, want), (what, name)
            else:
                np.testing.assert_allclose(have.numpy(), want.numpy(), rtol=1e-6, atol=1e-9,
                                           err_msg=f"{what} {name}")
    assert fsdp_run["loss"] == pytest.approx(dp_run["loss"], rel=1e-6)
    # the checkpointed (gathered) state is the full model's
    assert {k: v.shape for k, v in fsdp_run["params"].items()} == {
        k: v.shape for k, v in inputs["sd"].items()}


def test_each_rank_holds_its_chunks_only(world):
    records, _, _, _ = world
    for rec in records:
        shapes = rec["fsdp_shapes"]
        assert shapes, "nothing was sharded"
        for name, (p, mu, nu, ema) in rec["fsdp_numels"].items():
            whole = rec["dp_numels"][name][0]  # the tensor-parallel shard's elements
            want = whole // rec["data"] if name in shapes else whole
            assert (p, mu, nu, ema) == (want,) * 4, name
        sharded = sum(rec["fsdp_numels"][n][0] for n in shapes)
        assert sharded * rec["data"] == sum(rec["dp_numels"][n][0] for n in shapes)


def test_fsdp_step_gathers_and_reduce_scatters(world):
    records, _, _, _ = world
    units = 1 + STEP_CFG["depth"]  # the root and three blocks
    for rec in records:
        fs, dp = rec["fsdp_collectives"], rec["dp_collectives"]
        # one gather a unit forward, one again in its backward; one scatter a unit
        assert fs["all_gather"]["calls"] == 2 * units - 1  # the root is kept for the backward
        assert fs["reduce_scatter"]["calls"] == units
        assert "all_gather" not in dp and "reduce_scatter" not in dp
        # the data-parallel step all-reduces every gradient; FSDP only the small ones
        assert fs["all_reduce"]["bytes"] < dp["all_reduce"]["bytes"]
