"""Tensor and data parallelism of the port (duodiff_tpu_torch.parallel) in
worlds of 2 and 4 gloo processes on the CPU (tests/torch_dist_worker.py,
which imports no JAX), against the JAX package's tp_fused sublayers and
tensor-parallel models on the 8-device host mesh (tests/conftest.py; its
(data 4, model 2) mesh, whose function every world's grid computes), on the
same numpy inputs and crossed-over weights:

- the attention and MLP sublayers (duodiff_tpu/parallel/tp_fused.py):
  output, dx and every parameter gradient, the shards' gradients summed
  over the data ranks and gathered;
- a depth-3 U-ViT and a depth-3 early-exit U-ViT, their blocks sharded:
  the forwards against JAX's tensor-parallel fused models, the U-ViT's
  gradients against JAX's;
- the unfused blocks (``pallas``, the attention kernels K9 / K10 on a
  rank's H / mp heads, and ``xla``) under tensor parallelism: the forward
  and the gradients of the same U-ViT against JAX's;
- a U-ViT with the time embedding's MLP, sharded by JAX's rules (fc1
  column-, fc2 row-parallel): forward and gradients against JAX's;
- the early-exit model with its heads' decoder and attention probes
  sharded (_TP_RULES_STACKED): the forward above, and the gradients of its
  three outputs' mean squares against ``jax.grad``'s;
- ``shard_state_dict`` and ``gather_state_dict``: the shards are the
  model's after ``shard_``, and gathered back they equal the full state
  dict to the bit, for the U-ViTs and the early-exit model's new names.

Worlds: 2 ranks (model 2), 4 ranks (data 2 x model 2) and 4 ranks (model
4). Tolerances (fp32): forwards 2e-5 for the sublayers
(tests/test_tp_fused.py:81) and 5e-5 for the models (:175), gradients 3e-4
(:141-146, :201)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_dist_worker import run_world

from duodiff_tpu.config import UViTConfig as JaxConfig
from duodiff_tpu.models.early_exit import EarlyExitUViT as JaxEarlyExitUViT
from duodiff_tpu.models.uvit import init_uvit
from duodiff_tpu.parallel import create_mesh
from duodiff_tpu.parallel.tp_fused import tp_fused_attn_sublayer, tp_fused_mlp_sublayer
from duodiff_tpu.utils.param_layout import qkv_packed_to_heads
from duodiff_tpu_torch.utils import convert

B, L, D, H = 8, 17, 32, 4
DH, HIDDEN = D // H, 4 * D
WORLDS = {"2 ranks, model 2": (2, 2), "4 ranks, data 2 x model 2": (4, 2),
          "4 ranks, model 4": (4, 4)}
CFG = dict(img_size=16, patch_size=2, in_chans=3, embed_dim=D, depth=3, num_heads=H, mlp_ratio=4,
           qkv_bias=True, num_classes=-1, normalize_timesteps=True)


def _numpy_inputs():
    rng = np.random.RandomState(0)
    r = lambda *s, scale=0.2: (scale * rng.randn(*s)).astype(np.float32)  # noqa: E731
    return {
        "x": rng.randn(B, L, D).astype(np.float32), "dy": rng.randn(B, L, D).astype(np.float32),
        "attn": (1.0 + r(D, scale=0.1), r(D, scale=0.1), r(D, 3 * D), r(3 * D, scale=0.1),
                 r(D, D), r(D, scale=0.1)),
        "mlp": (1.0 + r(D, scale=0.1), r(D, scale=0.1), r(D, HIDDEN), r(HIDDEN, scale=0.1),
                r(HIDDEN, D), r(D, scale=0.1)),
        "img": rng.randn(B, 16, 16, 3).astype(np.float32),
        "t": np.linspace(3.0, 990.0, B).astype(np.float32),
    }


def _random_params(jmodel, seed):
    """JAX's tree of the model (shapes traced) drawn from numpy: 0.05 N(0, 1),
    LayerNorm scales about 1, so that no parameter is zero."""
    x = jnp.zeros((1, 16, 16, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), x, jnp.zeros((1,))))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        value = 0.05 * rng.randn(*leaf.shape).astype(np.float32)
        return value + 1.0 if path[-1].key == "scale" else value

    return jax.tree_util.tree_map_with_path(draw, shapes["params"])


def _jax_sublayers(inp, mesh):
    """tp_fused_* on the mesh: outputs and the VJPs of dy (heads-layout
    gradients back in the packed (in, out) layout)."""
    x, dy = jnp.asarray(inp["x"]), jnp.asarray(inp["dy"])
    g, b, wq, bq, wp, bp = (jnp.asarray(a) for a in inp["attn"])

    def attn(x, g, b, wq, bq, wp, bp):
        return tp_fused_attn_sublayer(x, g, b, wq.reshape(D, 3, H, DH), bq.reshape(3, H, DH),
                                      wp.reshape(H, DH, D), bp, mesh=mesh, interpret=True)

    y, vjp = jax.vjp(attn, x, g, b, wq, bq, wp, bp)
    out = {"attn": (y, vjp(dy))}
    g, b, w1, b1, w2, b2 = (jnp.asarray(a) for a in inp["mlp"])

    def mlp(x, g, b, w1, b1, w2, b2):
        return tp_fused_mlp_sublayer(x, g, b, w1, b1, w2, b2, mesh=mesh, interpret=True)

    y, vjp = jax.vjp(mlp, x, g, b, w1, b1, w2, b2)
    out["mlp"] = (y, vjp(dy))
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The inputs, the crossed-over weights and JAX's references."""
    work = tmp_path_factory.mktemp("tp")
    inp = _numpy_inputs()
    cfg = JaxConfig(**CFG)
    model_p, _ = init_uvit(cfg, jax.random.PRNGKey(0), attn_impl="xla")
    params = _random_params(model_p, seed=1)
    ee_cfg = dict(CFG, classifier_type="attention_probe")
    ee_p = JaxEarlyExitUViT(config=JaxConfig(**ee_cfg))
    ee_params = _random_params(ee_p, seed=2)
    img, t = jnp.asarray(inp["img"]), jnp.asarray(inp["t"])
    grads = jax.grad(lambda p: jnp.mean(model_p.apply({"params": p}, img, t) ** 2))(params)
    te_cfg = dict(CFG, mlp_time_embed=True)
    model_te, _ = init_uvit(JaxConfig(**te_cfg), jax.random.PRNGKey(0), attn_impl="xla")
    te_params = _random_params(model_te, seed=3)
    te_y, te_vjp = jax.vjp(lambda p: model_te.apply({"params": p}, img, t), te_params)
    te_grads = te_vjp(2.0 * te_y / te_y.size)[0]

    def ee_loss(p):
        backbone, u, g = ee_p.apply({"params": p}, img, t)
        return jnp.mean(backbone ** 2) + jnp.mean(u ** 2) + jnp.mean(g ** 2)

    ee_grads = jax.grad(ee_loss)(ee_params)
    # JAX's (data 4, model 2) mesh; every world of the port, model 2 or 4,
    # computes the same function
    mesh = create_mesh(shape=(4, 2))
    model_tp, _ = init_uvit(cfg, jax.random.PRNGKey(0), attn_impl="fused", mlp_impl="fused",
                            qkv_layout="heads", tp_mesh=mesh)
    ee_tp = JaxEarlyExitUViT(config=JaxConfig(**ee_cfg), attn_impl="fused", qkv_layout="heads",
                             tp_mesh=mesh)
    refs = {
        "uvit_grads": convert.uvit_state_dict_from_jax(grads), **_jax_sublayers(inp, mesh),
        "uvit_y": model_tp.apply({"params": qkv_packed_to_heads(params, H)}, img, t),
        "ee": ee_tp.apply({"params": qkv_packed_to_heads(ee_params, H)}, img, t),
        "te_y": te_y, "te_grads": convert.uvit_state_dict_from_jax(te_grads),
        "ee_grads": convert.early_exit_state_dict_from_jax(ee_grads, _port_config(ee_cfg)),
    }
    to_t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    data = {
        "x": to_t(inp["x"]), "dy": to_t(inp["dy"]), "heads": H, "img": to_t(inp["img"]),
        "t": to_t(inp["t"]), "uvit_config": CFG, "ee_config": ee_cfg,
        "uvit_sd": convert.uvit_state_dict_from_jax(params),
        "ee_sd": convert.early_exit_state_dict_from_jax(ee_params, _port_config(ee_cfg)),
        "te_config": te_cfg, "te_sd": convert.uvit_state_dict_from_jax(te_params),
    }
    # the sublayers' parameters in torch layout: kernels (in, out) -> (out, in)
    for which in ("attn", "mlp"):
        data[which] = tuple(to_t(a.T if a.ndim == 2 else a).contiguous() for a in inp[which])
    torch.save(data, work / "inputs.pth")
    return work, refs


def _port_config(cfg):
    from duodiff_tpu_torch.config import UViTConfig

    return UViTConfig(**cfg)


@pytest.fixture(scope="module", params=list(WORLDS))
def world(request, setup):
    """One world's results (rank 0's), and JAX's references for its model size."""
    work, refs = setup
    n, mp = WORLDS[request.param]
    out = work / f"out_{n}_{mp}.pth"
    rcs, outs = run_world(n, ["tests/torch_dist_worker.py", str(work / "inputs.pth"), str(mp),
                              str(out)], work, timeout=120)
    assert rcs == [0] * n, "\n".join(o[-3000:] for o in outs)
    assert "backend gloo" in outs[0]
    return torch.load(out, weights_only=False), refs, n // mp


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("which", ["attn", "mlp"])
def test_sublayer_forward_and_gradients_match_jax_tp(world, which):
    got, refs, data = world
    assert got["data"] == data
    y, grads = refs[which]
    np.testing.assert_allclose(_np(got[which]["y"]), np.asarray(y), atol=2e-5)
    np.testing.assert_allclose(_np(got[which]["dx"]), np.asarray(grads[0]), atol=3e-4)
    names = {"attn": ("norm1.weight", "norm1.bias", "attn.qkv.weight", "attn.qkv.bias",
                      "attn.proj.weight", "attn.proj.bias"),
             "mlp": ("norm2.weight", "norm2.bias", "mlp.fc1.weight", "mlp.fc1.bias",
                     "mlp.fc2.weight", "mlp.fc2.bias")}[which]
    for name, want in zip(names, grads[1:]):
        want = np.asarray(want)
        g = _np(got[which]["grads"][name])
        np.testing.assert_allclose(g.T if g.ndim == 2 else g, want, atol=3e-4, err_msg=name)


def _check_grads(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(_np(got[name]), _np(w), atol=3e-4, err_msg=name)


def test_uvit_forward_matches_jax_tp(world):
    got, refs, _ = world
    np.testing.assert_allclose(_np(got["uvit_y"]), np.asarray(refs["uvit_y"]), atol=5e-5)


def test_uvit_gradients_match_jax(world):
    got, refs, _ = world
    _check_grads(got["uvit_grads"], refs["uvit_grads"])


# the unfused block under tensor parallelism: around K9 / K10 on the rank's
# heads (pallas), and around plain attention (xla); both compute JAX's function
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_unfused_forward_matches_jax_tp(world, impl):
    got, refs, _ = world
    np.testing.assert_allclose(_np(got[f"{impl}_y"]), np.asarray(refs["uvit_y"]), atol=5e-5)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_unfused_gradients_match_jax(world, impl):
    got, refs, _ = world
    _check_grads(got[f"{impl}_grads"], refs["uvit_grads"])


def test_time_embedding_shard_matches_jax(world):
    got, refs, _ = world
    np.testing.assert_allclose(_np(got["te_y"]), np.asarray(refs["te_y"]), atol=5e-5)
    _check_grads(got["te_grads"], refs["te_grads"])


def test_early_exit_gradients_match_jax(world):
    got, refs, _ = world
    _check_grads(got["ee_grads"], refs["ee_grads"])


def test_early_exit_forward_matches_jax_tp(world):
    got, refs, _ = world
    for name, g, w in zip(("backbone", "u", "g"), got["ee"], refs["ee"]):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=5e-5, err_msg=name)


def test_state_dict_shards_and_gathers_back_to_the_bit(world):
    got, _, _ = world
    assert got["shard_equal"] and got["roundtrip_equal"]


@pytest.mark.parametrize("prefix", ["pallas_", "xla_", "te_", "ee_"])
def test_other_state_dicts_shard_and_gather_back_to_the_bit(world, prefix):
    got, _, _ = world
    assert got[f"{prefix}shard_equal"] and got[f"{prefix}roundtrip_equal"]
