"""The port's W8A8 sublayers (duodiff_tpu_torch.ops.block_int8), its int8
UViT and its int8-scales reader against the JAX package, on the same numpy
inputs and JAX-initialised weights carried across.

Tolerances:
- int8 weight codes: equal; column scales within 1e-7 relative (the same
  fp32 operations in the same order);
- sublayers, plain PyTorch against the Pallas int8 kernels run with
  interpret=True: atol = rtol = 2e-2, the bound tests/test_ops.py allows
  between those kernels and their XLA reference (the same math up to the
  order of fp32 sums, which can move an activation across an int8
  rounding boundary);
- the whole int8 UViT forward in fp32 against the JAX model with
  attn_impl="fused_int8" (its Pallas kernels in interpret mode): atol =
  rtol = 2e-2 and a relative Frobenius error under 2e-2. Where fp32
  summation order moves an activation across an int8 rounding boundary,
  one code of one row changes and the blocks after it carry the step on.
  The JAX package's own two int8 paths differ that way: its Pallas kernel
  and its XLA reference (``attn_sublayer_int8_xla``) give 8e-5 apart at
  one block input here, 5e-3 at the output; the exact erf here against
  the kernels' ``_erf_poly`` (|err| < 1.5e-7) flips codes as well;
- the whole forward against that XLA int8 math (the JAX calibration
  forward, dynamic scales, tanh GELU): 1e-5, no flips in that case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from duodiff_tpu.config import UViTConfig as JaxConfig
from duodiff_tpu.models.uvit import init_uvit as jax_init_uvit
from duodiff_tpu.ops import pallas_block_int8 as pbi
from duodiff_tpu.utils.int8_calib import load_int8_scales as jax_load_int8_scales
from duodiff_tpu.utils.int8_calib import scales_dict_to_tuple as jax_scales_dict_to_tuple
from duodiff_tpu_torch.config import UViTConfig
from duodiff_tpu_torch.models.uvit import UViT
from duodiff_tpu_torch.ops import block_int8 as q
from duodiff_tpu_torch.utils.convert import uvit_state_dict_from_jax
from duodiff_tpu_torch.utils.int8_scales import load_int8_scales, scales_dict_to_tuple
from duodiff_tpu_torch.utils.model_loading import load_model

torch.set_num_threads(1)

D, HEADS = 64, 4
TOL = 2e-2
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
STATIC = (3.5, 1.25)  # (sx, sh): post-LN and post-GELU amax of a calibration
SCALES_ASSET = "assets/int8_scales_celeba_flagship.json"


def _params(rng, qkv_bias):
    """numpy params in the JAX layout: kernels (in, out)."""
    r = lambda *s: (0.05 * rng.randn(*s)).astype(np.float32)  # noqa: E731
    return {
        "ln_s": (1.0 + r(D)), "ln_b": r(D),
        "wqkv": r(D, 3 * D), "bqkv": r(3 * D) if qkv_bias else None,
        "wp": r(D, D), "bp": r(D),
        "w1": r(D, 4 * D), "b1": r(4 * D), "w2": r(4 * D, D), "b2": r(D),
    }


def _linear(kernel, bias):
    lin = nn.Linear(*kernel.shape, bias=bias is not None)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(kernel.T.copy()))
        if bias is not None:
            lin.bias.copy_(torch.from_numpy(bias))
    return lin


def _norm(p):
    norm = nn.LayerNorm(D)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(p["ln_s"]))
        norm.bias.copy_(torch.from_numpy(p["ln_b"]))
    return norm


def _attn_ops(p):
    return q.pack_attn_int8(_norm(p), _linear(p["wqkv"], p["bqkv"]),
                            _linear(p["wp"], p["bp"]), num_heads=HEADS)


def _mlp_ops(p, static_scales=None):
    return q.pack_mlp_int8(_norm(p), _linear(p["w1"], p["b1"]), _linear(p["w2"], p["b2"]),
                           static_scales=static_scales)


def _inputs(seq_len, dtype_name, qkv_bias=False, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, seq_len, D).astype(np.float32)
    jdt, tdt = DTYPES[dtype_name]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt), _params(rng, qkv_bias)


def _assert_close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("which", ["qkv", "qkv_bias", "proj", "fc1", "fc2"])
def test_weight_codes_and_scales_match_jax(which):
    p = _params(np.random.RandomState(4), qkv_bias=which == "qkv_bias")
    _, _, wqkv8, sqkv, bqkv, wp8, sp, _ = _attn_ops(p)
    _, _, w1_8, s1, _, w2_8, s2, _, inv = _mlp_ops(p)
    assert inv is None
    j_wqkv8, j_sqkv, j_bqkv, j_wp8, j_sp = pbi._prep_attn_int8(
        jnp.asarray(p["wqkv"]), None if p["bqkv"] is None else jnp.asarray(p["bqkv"]),
        jnp.asarray(p["wp"]), num_heads=HEADS)
    pairs = {
        "qkv": ((wqkv8, sqkv), (j_wqkv8, j_sqkv)),
        "qkv_bias": ((wqkv8, sqkv), (j_wqkv8, j_sqkv)),
        "proj": ((wp8, sp), (j_wp8, j_sp)),
        "fc1": ((w1_8, s1), pbi.quantize_weight_int8(jnp.asarray(p["w1"]))),
        "fc2": ((w2_8, s2), pbi.quantize_weight_int8(jnp.asarray(p["w2"]))),
    }
    (codes, scale), (j_codes, j_scale) = pairs[which]
    assert codes.dtype == torch.int8
    # packed (out, in) against JAX's (in, out)
    np.testing.assert_array_equal(codes.numpy().T, np.asarray(j_codes))
    np.testing.assert_allclose(scale.numpy(), np.asarray(j_scale)[0], rtol=1e-7, atol=0)
    if which == "qkv_bias":
        np.testing.assert_allclose(bqkv.numpy(), np.asarray(j_bqkv)[0], rtol=1e-7, atol=0)


@pytest.mark.parametrize("width,heads", [(512, 8), (1024, 16)], ids=["d512", "d1024"])
def test_prescaled_q_bias_equals_jax_to_the_bit(width, heads):
    """K11's qkv bias with the softmax scale folded into its q part, fp32,
    equal to the bit to JAX's _prep_attn_int8 at the CelebA and the latent
    ImageNet-256 widths (the latter where K11's open check ran)."""
    rng = np.random.RandomState(width)
    wqkv = (0.05 * rng.randn(width, 3 * width)).astype(np.float32)
    bqkv = (0.05 * rng.randn(3 * width)).astype(np.float32)
    wp = (0.05 * rng.randn(width, width)).astype(np.float32)
    norm = nn.LayerNorm(width)
    proj = nn.Linear(width, width)
    got = q.pack_attn_int8(norm, _linear(wqkv, bqkv), proj, num_heads=heads)[4]
    want = pbi._prep_attn_int8(jnp.asarray(wqkv), jnp.asarray(bqkv), jnp.asarray(wp),
                               num_heads=heads)[2]
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[0])


def test_static_scales_fold_as_jax():
    """s1 * sx/127, s2 * sh/127 and inv = [127/sx, 127/sh] in fp32, as the
    JAX wrapper folds them; the codes are those of the dynamic pack."""
    p = _params(np.random.RandomState(5), qkv_bias=False)
    dyn, stat = _mlp_ops(p), _mlp_ops(p, STATIC)
    assert torch.equal(dyn[2], stat[2]) and torch.equal(dyn[5], stat[5])
    sx, sh = (jnp.asarray(v, jnp.float32) for v in STATIC)
    _, j_s1 = pbi.quantize_weight_int8(jnp.asarray(p["w1"]))
    _, j_s2 = pbi.quantize_weight_int8(jnp.asarray(p["w2"]))
    np.testing.assert_allclose(stat[3].numpy(), np.asarray(j_s1 * (sx / 127.0))[0], rtol=1e-7)
    np.testing.assert_allclose(stat[6].numpy(), np.asarray(j_s2 * (sh / 127.0))[0], rtol=1e-7)
    np.testing.assert_array_equal(stat[8].numpy(),
                                  np.asarray([127.0 / sx, 127.0 / sh], np.float32))
    with pytest.raises(ValueError, match="> 0"):
        _mlp_ops(p, (0.0, 1.0))


def test_row_quantizers_match_jax():
    rng = np.random.RandomState(6)
    x = (rng.randn(5, 96) * np.array([[0.0], [1e-3], [1.0], [7.0], [40.0]])).astype(np.float32)
    x8, rs = q._quant_rows(torch.from_numpy(x))
    j_x8, j_rs = pbi._quant_rows(jnp.asarray(x))
    np.testing.assert_array_equal(x8.numpy(), np.asarray(j_x8))
    np.testing.assert_array_equal(rs.numpy(), np.asarray(j_rs))
    assert x8.min() >= -127 and x8[0].abs().max() == 0  # an all-zero row: codes 0, inv 1
    inv = torch.tensor(127.0 / 3.0)
    np.testing.assert_array_equal(
        q._quant_rows_static(torch.from_numpy(x), inv).numpy(),
        np.asarray(pbi._quant_rows_static(jnp.asarray(x), jnp.float32(127.0 / 3.0))))


def test_int8_products_are_exact():
    """The plain versions' int8 product equals an int64 one, also at K = 2048
    where an fp32 sum of partial products would round."""
    a = torch.full((3, 2048), 127, dtype=torch.int8)
    a[1] = -127
    w = torch.randint(-127, 128, (4, 2048), dtype=torch.int8, generator=torch.Generator().manual_seed(0))
    exact = (a.long() @ w.long().t()).float()
    assert torch.equal(q._int8_matmul(a, w), exact)


@pytest.mark.parametrize("seq_len", [17, 33])
@pytest.mark.parametrize("qkv_bias", [False, True])
@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
def test_attn_sublayer_int8_matches_pallas(seq_len, qkv_bias, dtype_name):
    xj, xt, p = _inputs(seq_len, dtype_name, qkv_bias)
    want = pbi.fused_attn_sublayer_int8(
        xj, p["ln_s"], p["ln_b"], p["wqkv"], p["bqkv"], p["wp"], p["bp"],
        num_heads=HEADS, interpret=True)
    got = q.attn_sublayer_int8_plain(xt, *_attn_ops(p), num_heads=HEADS)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    _assert_close(got, want, TOL)


@pytest.mark.parametrize("seq_len", [17, 33])
@pytest.mark.parametrize("gelu_approx", [False, True])
@pytest.mark.parametrize("scales", ["dynamic", "static"])
@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
def test_mlp_sublayer_int8_matches_pallas(seq_len, gelu_approx, scales, dtype_name):
    xj, xt, p = _inputs(seq_len, dtype_name)
    static = STATIC if scales == "static" else None
    want = pbi.fused_mlp_sublayer_int8(
        xj, p["ln_s"], p["ln_b"], p["w1"], p["b1"], p["w2"], p["b2"],
        gelu_approx=gelu_approx, interpret=True, static_scales=static)
    got = q.mlp_sublayer_int8_plain(xt, *_mlp_ops(p, static), gelu_approx=gelu_approx)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    _assert_close(got, want, TOL)


def test_cpu_tensors_take_the_plain_path_without_counting():
    _, xt, p = _inputs(17, "bf16", qkv_bias=True)
    attn_ops, mlp_ops = _attn_ops(p), _mlp_ops(p, STATIC)
    k11, k12 = q.fused_attn_sublayer_int8, q.fused_mlp_sublayer_int8
    before = (k11.launches, k12.launches, k12.launches_dynamic, k12.launches_static)
    y = k11(xt, *attn_ops, num_heads=HEADS)
    assert torch.equal(y, q.attn_sublayer_int8_plain(xt, *attn_ops, num_heads=HEADS))
    y = k12(xt, *mlp_ops, gelu_approx=True)
    assert torch.equal(y, q.mlp_sublayer_int8_plain(xt, *mlp_ops, gelu_approx=True))
    assert (k11.launches, k12.launches, k12.launches_dynamic, k12.launches_static) == before


def test_int8_launchers_refuse_cpu_tensors():
    """The CUDA launchers never fall back: a CPU operand is an error."""
    _, xt, p = _inputs(17, "bf16")
    with pytest.raises(ValueError, match="CUDA"):
        q._attn_sublayer_int8_cuda(xt, *_attn_ops(p), num_heads=1, eps=1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        q._mlp_sublayer_int8_cuda(xt, *_mlp_ops(p), gelu_approx=False, eps=1e-5)


SMALL = dict(img_size=16, patch_size=4, in_chans=3, embed_dim=D, num_heads=HEADS, mlp_ratio=4)
UVIT_CASES = {
    "depth3_dynamic": (dict(SMALL, depth=3), False),
    "depth5_static_qkvbias": (dict(SMALL, depth=5, qkv_bias=True), True),
}


def _block_scales(depth):
    """Distinct (sx, sh) per block, so a wrong block order shows."""
    return tuple((3.0 + 0.1 * i, 1.0 + 0.05 * i) for i in range(2 * (depth // 2) + 1))


@pytest.mark.parametrize("name", sorted(UVIT_CASES))
@pytest.mark.parametrize("gelu_approx", [False, True])
def test_int8_uvit_forward_matches_jax(name, gelu_approx):
    kw, static = UVIT_CASES[name]
    scales = _block_scales(kw["depth"]) if static else None
    jmodel, params = jax_init_uvit(JaxConfig(**kw), jax.random.PRNGKey(0), dtype=jnp.float32,
                                   attn_impl="fused_int8", gelu_approx=gelu_approx,
                                   int8_mlp_scales=scales)
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rng.randn(*a.shape).astype(np.float32), params)
    x = rng.randn(2, 16, 16, 3).astype(np.float32)
    t = np.array([3.0, 700.0], np.float32)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    model = UViT(UViTConfig(**kw), dtype=torch.float32, attn_impl="fused_int8",
                 gelu_approx=gelu_approx, int8_mlp_scales=scales)
    model.load_state_dict(uvit_state_dict_from_jax(params), strict=True)
    model.pack_for_kernels()
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert got.shape == want.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < TOL


def test_int8_uvit_forward_matches_jax_reference_math():
    """The JAX calibration forward runs the int8 sublayers' XLA reference
    math (no Pallas) with dynamic scales: the port's int8 forward is that
    math, to fp32 rounding."""
    kw = dict(SMALL, depth=5, qkv_bias=True)
    jmodel, params = jax_init_uvit(JaxConfig(**kw), jax.random.PRNGKey(1), dtype=jnp.float32,
                                   attn_impl="fused_int8", gelu_approx=True,
                                   int8_calibrate=True)
    rng = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rng.randn(*a.shape).astype(np.float32), params)
    x = rng.randn(2, 16, 16, 3).astype(np.float32)
    t = np.array([10.0, 900.0], np.float32)
    want, _ = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                           mutable=["int8_calib"])
    model = UViT(UViTConfig(**kw), dtype=torch.float32, attn_impl="plain_int8",
                 gelu_approx=True)
    model.load_state_dict(uvit_state_dict_from_jax(params), strict=True)
    model.pack_for_kernels()
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_uvit_routes_each_block_its_own_scales():
    cfg = UViTConfig(**dict(SMALL, depth=5))
    scales = _block_scales(5)
    model = UViT(cfg, dtype=torch.float32, attn_impl="plain_int8", int8_mlp_scales=scales)
    assert [blk.int8_mlp_scales for blk in model.blocks()] == list(scales)
    with pytest.raises(ValueError, match="need 5"):
        UViT(cfg, attn_impl="fused_int8", int8_mlp_scales=scales[:3])
    with pytest.raises(ValueError, match="int8 attn_impl"):
        UViT(cfg, attn_impl="fused", int8_mlp_scales=scales)


def test_int8_scales_loader_matches_jax():
    got = load_int8_scales(SCALES_ASSET)
    want = jax_load_int8_scales(SCALES_ASSET)
    assert got == want and len(got) == 13
    assert scales_dict_to_tuple(got, 13) == jax_scales_dict_to_tuple(want, 13)
    assert scales_dict_to_tuple(got, 3) == jax_scales_dict_to_tuple(want, 3)
    with pytest.raises(ValueError, match="missing blocks"):
        scales_dict_to_tuple(got, 15)


def test_load_model_int8_scales(tmp_path):
    """The scales reach the blocks through load_model, and only with an int8
    attn_impl, as duodiff_tpu.utils.model_loading requires."""
    config = tmp_path / "model.yaml"
    config.write_text("model_params:\n" + "".join(
        f"  {k}: {v}\n" for k, v in dict(SMALL, depth=13).items()))
    model, _ = load_model(config, device="cpu", attn_impl="fused_int8", int8_scales=SCALES_ASSET)
    want = scales_dict_to_tuple(load_int8_scales(SCALES_ASSET), 13)
    assert tuple(blk.int8_mlp_scales for blk in model.blocks()) == want
    with pytest.raises(ValueError, match="fused_int8"):
        load_model(config, device="cpu", attn_impl="fused", int8_scales=SCALES_ASSET)
