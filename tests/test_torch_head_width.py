"""The port at U-ViT-H's head width, 72 (D = 1152 with 16 heads; DiT-XL's
too), against the JAX package on the CPU, on the same inputs made from a
seed with numpy and weights crossed over by the port's converter:

- the plain versions of K1, K6, K7, K9, K10, K11 and K12 at head width 72 (D =
  144, 2 heads, L = 18 and a ragged 33) against the Pallas kernels in
  interpret mode, K11's int8 weight codes equal to JAX's; K6's plain version
  also against the flash route JAX takes for its attention backward at
  D >= 768, K9 and K10 inside an XLA chain;
- the plain LayerNorm + quant and LayerNorm backward at D = 1152, whose card
  kernels hold a row in a warp's registers, against JAX's ``_ln_fwd`` /
  ``_quant_rows`` and the LayerNorm's VJP;
- a tiny latent class-conditional U-ViT at head width 72 (D = 144, 2 heads,
  depth 3 and 5, 8 x 8 x 4 latents in patches of 2, 11 classes): the fp32
  forward, a guided DuoDiff trajectory on one injected noise table and one
  train step;
- the U-ViT-H/2 dict (``config.UVIT_H2_IMAGENET256``) through the port's
  config writer and reader, and ``flops_per_uvit_forward``, against JAX's;
- what the CUDA wrappers refuse, through stand-in libraries: a head width
  outside 64 and 72, a length past the width's limit, rows wider than the
  LayerNorm passes hold.

Tolerances, the JAX tests' own between the package's paths
(tests/test_ops.py), each with its reason: kernels fp32 1e-5 (summation
order), bf16 5e-2 (bf16 rounding at the same points, flipped now and then by
summation order); backward kernels fp32 rtol 2e-4 / atol 2e-5, bf16 2e-2
relative Frobenius per gradient and dx 5e-2 elementwise; int8 sublayers 2e-2
(an int8 code flips by one where an fp32 sum in another order crosses a
half); the LayerNorm passes fp32 1e-5 (summation order over 1152 values);
the model forward and the trajectory 1e-4 (``ROADMAP.md`` section 3: ~1e-6 a
forward, then the ancestral updates); the train step's loss 1e-6 and its
gradients rtol 1e-4 / atol 1e-6, as ``test_torch_imagenet.py`` holds them.
"""

import functools
import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duodiff_tpu.config import UViTConfig as JaxConfig
from duodiff_tpu.config import load_model_config as jax_load_model_config
from duodiff_tpu.diffusion.sampling import duodiff_sample as jax_duodiff_sample
from duodiff_tpu.diffusion.sampling import make_guided_apply as jax_make_guided_apply
from duodiff_tpu.diffusion.schedule import NoiseSchedule as JaxSchedule
from duodiff_tpu.models.uvit import init_uvit as jax_init_uvit
from duodiff_tpu.ops import pallas_attention as jax_fa
from duodiff_tpu.ops import pallas_block as pb
from duodiff_tpu.ops import pallas_block_int8 as pbi
from duodiff_tpu.training.train_state import make_train_step as jax_make_train_step
from duodiff_tpu.utils.profiling import flops_per_uvit_forward as jax_flops
from duodiff_tpu_torch.config import (
    UVIT_H2_IMAGENET256,
    UViTConfig,
    load_autoencoder_config,
    load_model_config,
    write_config,
)
from duodiff_tpu_torch.diffusion.sampling import duodiff_sample, make_guided_apply
from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
from duodiff_tpu_torch.models.uvit import UViT
from duodiff_tpu_torch.ops import _build, block, gemm
from duodiff_tpu_torch.ops import block_int8 as q
from duodiff_tpu_torch.ops import flash_attention as fa
from duodiff_tpu_torch.ops import sdpa_int8
from duodiff_tpu_torch.training.train_state import make_train_step
from duodiff_tpu_torch.utils import convert
from duodiff_tpu_torch.utils.profiling import flops_per_uvit_forward

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
DH, HEADS = 72, 2
D = DH * HEADS
LENGTHS = [18, 33]
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
FWD_TOL = {"fp32": 1e-5, "bf16": 5e-2}
BF16_REL_FRO = 2e-2
INT8_TOL = 2e-2
ATTN_NAMES = ("dx", "dg", "db", "dwqkv", "dbqkv", "dwp", "dbp")
MLP_NAMES = ("dx", "dg", "db", "dw1", "db1", "dw2", "db2")


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _np(t):
    return np.asarray(t.astype(jnp.float32)) if isinstance(t, jnp.ndarray) else t.float().numpy()


def _block_inputs(l, seed=0, b=2):
    """numpy x, dy and one block's parameters in the JAX layout (kernels
    (in, out), the qkv kernel unscaled), at D = 144."""
    rng = np.random.RandomState(seed + l)
    r = lambda *s: (0.05 * rng.randn(*s)).astype(np.float32)  # noqa: E731
    x = rng.randn(b, l, D).astype(np.float32)
    dy = rng.randn(b, l, D).astype(np.float32)
    p = {"ln_s": 1.0 + r(D), "ln_b": r(D), "wqkv": r(D, 3 * D), "bqkv": r(3 * D), "wp": r(D, D),
         "bp": r(D), "w1": r(D, 4 * D), "b1": r(4 * D), "w2": r(4 * D, D), "b2": r(D)}
    return x, dy, p


def _close(got, want, dtype_name):
    tol = FWD_TOL[dtype_name]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _compare_grads(names, got, want, dtype_name):
    for name, g, w in zip(names, got, want):
        if w is None:
            assert g is None, name
            continue
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        assert g.shape == w.shape, name
        if dtype_name == "fp32":
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-5, err_msg=name)
            continue
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= BF16_REL_FRO, (name, rel)
        if name == "dx":
            np.testing.assert_allclose(g, w, rtol=5e-2, atol=5e-2, err_msg=name)


def _linear(kernel, bias):
    lin = torch.nn.Linear(*kernel.shape, bias=bias is not None)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(kernel.T.copy()))
        if bias is not None:
            lin.bias.copy_(torch.from_numpy(bias))
    return lin


def _norm(p):
    norm = torch.nn.LayerNorm(D)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(p["ln_s"]))
        norm.bias.copy_(torch.from_numpy(p["ln_b"]))
    return norm


# --- the kernels' plain versions at head width 72 ------------------------------


def _heads(l, n, seed):
    rng = np.random.default_rng(seed + l)
    return [rng.standard_normal((2, HEADS, l, DH)).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("l", LENGTHS)
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_k9_plain_matches_pallas_at_head_width_72(dtype_name, l):
    jdt, tdt = DTYPES[dtype_name]
    arrays = _heads(l, 3, seed=0)
    got = fa.flash_attention_plain(*[_t(a, tdt) for a in arrays])
    want = jax_fa.flash_attention(*[jnp.asarray(a).astype(jdt) for a in arrays], interpret=True)
    assert got.dtype == tdt and got.shape == (2, HEADS, l, DH)
    _close(got, want, dtype_name)


@pytest.mark.parametrize("l", LENGTHS)
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_k10_plain_matches_pallas_at_head_width_72(dtype_name, l):
    jdt, tdt = DTYPES[dtype_name]
    arrays = _heads(l, 4, seed=1)
    got = fa.flash_attention_bwd_plain(*[_t(a, tdt) for a in arrays])
    want = jax_fa._flash_attention_bwd_impl(*[jnp.asarray(a).astype(jdt) for a in arrays],
                                            interpret=True)
    tol = {"fp32": 1e-5, "bf16": 2e-2}[dtype_name]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == tdt and g.shape == (2, HEADS, l, DH)
        np.testing.assert_allclose(_np(g), _np(w), rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("l", LENGTHS)
@pytest.mark.parametrize("qkv_bias", [False, True])
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_k1_plain_matches_pallas_at_head_width_72(dtype_name, qkv_bias, l):
    """K1 with the softmax scale 72**-0.5, which is not a power of two: the
    fold into the q columns and the q bias in fp32 before the cast is where
    the two packages round, so any other point shows here."""
    x, _, p = _block_inputs(l)
    bqkv = p["bqkv"] if qkv_bias else None
    jdt, tdt = DTYPES[dtype_name]
    want = pb.fused_attn_sublayer(jnp.asarray(x, jdt), p["ln_s"], p["ln_b"], p["wqkv"], bqkv,
                                  p["wp"], p["bp"], num_heads=HEADS, interpret=True)
    ops = block.pack_attn(_norm(p), _linear(p["wqkv"], bqkv), _linear(p["wp"], p["bp"]),
                          num_heads=HEADS, dtype=tdt)
    before = block.fused_attn_sublayer.launches
    got = block.fused_attn_sublayer(_t(x, tdt), *ops, num_heads=HEADS)
    assert got.dtype == tdt and block.fused_attn_sublayer.launches == before
    _close(got, want, dtype_name)


@pytest.mark.parametrize("l", LENGTHS)
@pytest.mark.parametrize("qkv_bias", [False, True])
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_k6_plain_matches_pallas_at_head_width_72(dtype_name, qkv_bias, l):
    x, dy, p = _block_inputs(l, seed=1)
    bqkv = p["bqkv"] if qkv_bias else None
    jdt, tdt = DTYPES[dtype_name]
    want = pb._attn_sublayer_bwd_impl(jnp.asarray(x, jdt), jnp.asarray(dy, jdt), p["ln_s"],
                                      p["ln_b"], p["wqkv"], bqkv, p["wp"], num_heads=HEADS,
                                      eps=1e-5, interpret=True)
    got = block.fused_attn_sublayer_bwd(_t(x, tdt), _t(dy, tdt), _t(p["ln_s"]), _t(p["ln_b"]),
                                        _t(p["wqkv"], tdt), _t(bqkv), _t(p["wp"], tdt),
                                        num_heads=HEADS)
    _compare_grads(ATTN_NAMES, got, want, dtype_name)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_k6_plain_matches_the_flash_route_jax_takes_for_u_vit_h(dtype_name):
    """At D >= 768 (U-ViT-H's 1152) JAX's fused training runs the attention
    backward as jax.vjp of _attn_sublayer_reference(sdpa="flash"), K9 and K10
    at head width 72 inside an XLA chain; the port keeps K6. K6's plain
    version against that route's gradients, held as
    test_torch_imagenet.py holds it at head width 64."""
    jdt, tdt = DTYPES[dtype_name]
    tol = {"fp32": 2e-4, "bf16": 3e-2}[dtype_name]
    x, dy, p = _block_inputs(33, seed=2, b=3)
    jargs = (jnp.asarray(x).astype(jdt),
             *map(jnp.asarray, (p["ln_s"], p["ln_b"], p["wqkv"], p["bqkv"], p["wp"], p["bp"])))
    _, vjp = jax.vjp(functools.partial(pb._attn_sublayer_reference, num_heads=HEADS, eps=1e-5,
                                       sdpa="flash", interpret=True), *jargs)
    want = vjp(jnp.asarray(dy).astype(jdt))
    got = block.attn_sublayer_bwd_plain(_t(x, tdt), _t(dy, tdt), _t(p["ln_s"]), _t(p["ln_b"]),
                                        _t(p["wqkv"], tdt), _t(p["bqkv"]), _t(p["wp"], tdt),
                                        num_heads=HEADS)
    for name, g, w in zip(("dx", "dln_s", "dln_b", "dwqkv", "dbqkv", "dwp", "dbp"), got, want):
        w = np.asarray(w.astype(jnp.float32))
        err = np.linalg.norm(g.float().numpy() - w) / np.linalg.norm(w)
        assert err <= tol, (name, err)


@pytest.mark.parametrize("l", LENGTHS)
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_k7_plain_matches_pallas_at_u_vit_h_ratio(dtype_name, l):
    """K7 at D = 144 with U-ViT-H's mlp_ratio 4 (its LayerNorm backward is
    the row kernel that now takes 1152; the 1152-wide rows themselves are
    held below)."""
    x, dy, p = _block_inputs(l, seed=3)
    jdt, tdt = DTYPES[dtype_name]
    want = pb._mlp_sublayer_bwd_impl(jnp.asarray(x, jdt), jnp.asarray(dy, jdt), p["ln_s"],
                                     p["ln_b"], p["w1"], p["b1"], p["w2"], eps=1e-5,
                                     gelu_approx=False, interpret=True)
    got = block.fused_mlp_sublayer_bwd(_t(x, tdt), _t(dy, tdt), _t(p["ln_s"]), _t(p["ln_b"]),
                                       _t(p["w1"], tdt), _t(p["b1"]), _t(p["w2"], tdt))
    _compare_grads(MLP_NAMES, got, want, dtype_name)


@pytest.mark.parametrize("l", LENGTHS)
@pytest.mark.parametrize("variant", ["K11", "K11_qkv_bias", "K12_dynamic_erf", "K12_dynamic_tanh",
                                     "K12_static_erf", "K12_static_tanh"])
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_int8_sublayers_match_pallas_at_head_width_72(dtype_name, variant, l):
    x, _, p = _block_inputs(l, seed=4)
    jdt, tdt = DTYPES[dtype_name]
    xj, xt = jnp.asarray(x, jdt), _t(x, tdt)
    if variant.startswith("K11"):
        bqkv = p["bqkv"] if variant.endswith("bias") else None
        want = pbi.fused_attn_sublayer_int8(xj, p["ln_s"], p["ln_b"], p["wqkv"], bqkv, p["wp"],
                                            p["bp"], num_heads=HEADS, interpret=True)
        ops = q.pack_attn_int8(_norm(p), _linear(p["wqkv"], bqkv), _linear(p["wp"], p["bp"]),
                               num_heads=HEADS)
        got = q.fused_attn_sublayer_int8(xt, *ops, num_heads=HEADS)
    else:
        static = (3.5, 1.25) if "static" in variant else None
        tanh = variant.endswith("tanh")
        want = pbi.fused_mlp_sublayer_int8(xj, p["ln_s"], p["ln_b"], p["w1"], p["b1"], p["w2"],
                                           p["b2"], gelu_approx=tanh, interpret=True,
                                           static_scales=static)
        ops = q.pack_mlp_int8(_norm(p), _linear(p["w1"], p["b1"]), _linear(p["w2"], p["b2"]),
                              static_scales=static)
        got = q.fused_mlp_sublayer_int8(xt, *ops, gelu_approx=tanh)
    assert got.dtype == tdt and got.shape == xt.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=INT8_TOL, atol=INT8_TOL)


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_k11_weight_codes_equal_jax_at_head_width_72(qkv_bias):
    """The int8 fold of 72**-0.5 goes into the q column scales and the q
    bias in fp32, never into the codes: codes equal, scales and bias to
    fp32's rounding."""
    _, _, p = _block_inputs(18, seed=5)
    bqkv = p["bqkv"] if qkv_bias else None
    jw8, jsq, jb, jp8, jsp = pbi._prep_attn_int8(jnp.asarray(p["wqkv"]),
                                                 None if bqkv is None else jnp.asarray(bqkv),
                                                 jnp.asarray(p["wp"]), num_heads=HEADS)
    _, _, w8, sq, b, p8, sp, _ = q.pack_attn_int8(_norm(p), _linear(p["wqkv"], bqkv),
                                                  _linear(p["wp"], p["bp"]), num_heads=HEADS)
    np.testing.assert_array_equal(w8.t().numpy(), np.asarray(jw8))
    np.testing.assert_array_equal(p8.t().numpy(), np.asarray(jp8))
    np.testing.assert_allclose(sq.numpy(), np.asarray(jsq)[0], rtol=1e-7, atol=0)
    np.testing.assert_allclose(sp.numpy(), np.asarray(jsp)[0], rtol=1e-7, atol=0)
    if qkv_bias:
        np.testing.assert_allclose(b.numpy(), np.asarray(jb)[0], rtol=1e-7, atol=0)
    else:
        assert b is None and jb is None


# --- the row kernels at D = 1152 ----------------------------------------------


def _rows(seed, d=1152, m=37):
    rng = np.random.RandomState(seed)
    x = (rng.randn(m, d) * 2.0 + 0.5).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.randn(d)).astype(np.float32)
    beta = (0.1 * rng.randn(d)).astype(np.float32)
    return x, gamma, beta


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_ln_quant_plain_matches_jax_at_1152(mode):
    """A code differs by one at most, where the two fp32 means sum 1152
    values in other orders and a value lies at a half."""
    x, gamma, beta = _rows(7)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    xj = jnp.asarray(xt.float().numpy())
    xn = pb._ln_fwd(xj, jnp.asarray(gamma), jnp.asarray(beta), 1e-5)[2]
    inv = None if mode == "dynamic" else torch.tensor([127.0 / 3.5])
    x8, rs = gemm.ln_quant_rows(xt, torch.from_numpy(gamma), torch.from_numpy(beta), inv)
    if mode == "dynamic":
        j8, jrs = pbi._quant_rows(xn)
        np.testing.assert_allclose(rs.numpy(), np.asarray(jrs)[:, 0], rtol=1e-6)
    else:
        j8 = pbi._quant_rows_static(xn, jnp.float32(127.0 / 3.5))
        assert rs is None
    diff = np.abs(x8.numpy().astype(np.int64) - np.asarray(j8).astype(np.int64))
    assert x8.shape == (37, 1152) and diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def test_ln_backward_plain_matches_jax_at_1152():
    """The LayerNorm backward of K6, K7 and K8 (dx and the dgamma / dbeta
    sums) at D = 1152 against the VJP of JAX's _ln_fwd and its _ln_bwd_dx."""
    x, gamma, beta = _rows(8)
    dxn = np.random.RandomState(9).randn(*x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, g, b: pb._ln_fwd(a, g, b, 1e-5)[2], jnp.asarray(x),
                     jnp.asarray(gamma), jnp.asarray(beta))
    want = vjp(jnp.asarray(dxn))
    x_hat, rstd, _ = block._ln_fwd(_t(x), _t(gamma), _t(beta), 1e-5)
    dx = block._ln_bwd_dx(_t(dxn), x_hat, rstd, _t(gamma))
    got = (dx, (_t(dxn) * x_hat).sum(0), _t(dxn).sum(0))
    for name, g, w in zip(("dx", "dgamma", "dbeta"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5, err_msg=name)
    jx_hat, jrstd, _ = pb._ln_fwd(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), 1e-5)
    np.testing.assert_allclose(
        dx.numpy(), np.asarray(pb._ln_bwd_dx(jnp.asarray(dxn), jx_hat, jrstd, jnp.asarray(gamma))),
        rtol=1e-5, atol=1e-5)


# --- a tiny latent U-ViT at head width 72 --------------------------------------

TINY = dict(img_size=8, patch_size=2, in_chans=4, embed_dim=D, num_heads=HEADS, mlp_ratio=4,
            qkv_bias=False, mlp_time_embed=False, num_classes=11, normalize_timesteps=False)
NULL = 10
LATENT = (2, 8, 8, 4)


def _perturbed(params, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rng.randn(*a.shape).astype(np.float32), params)


def _jax_model(depth, seed, dtype=jnp.float32, **kw):
    model, params = jax_init_uvit(JaxConfig(**dict(TINY, depth=depth)), jax.random.PRNGKey(seed),
                                  dtype=dtype, **kw)
    return model, _perturbed(params, seed)


def _port_model(depth, params, dtype=torch.float32, **kw):
    model = UViT(UViTConfig(**dict(TINY, depth=depth)), dtype=dtype, **kw)
    model.load_state_dict(convert.uvit_state_dict_from_jax(params), strict=True)
    model.pack_for_kernels()
    return model


def _latents(seed, b=2):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, 8, 8, 4).astype(np.float32)
    t = rng.randint(0, 1000, b).astype(np.float32)
    y = rng.randint(0, NULL, b).astype(np.int32)
    return x, t, y


@pytest.mark.parametrize("impl", ["fused", "pallas"])
def test_latent_forward_matches_jax_at_head_width_72(impl):
    jmodel, params = _jax_model(3, 1, attn_impl=impl)
    x, t, y = _latents(2)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                                   jnp.asarray(y)))
    model = _port_model(3, params, attn_impl=impl)
    assert model.blocks()[0].num_heads == HEADS
    with torch.no_grad():
        got = model.eval()(_t(x), _t(t), torch.from_numpy(y).long())
    assert got.shape == want.shape == LATENT
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_guided_duodiff_trajectory_matches_jax_at_head_width_72():
    steps, t_switch, w = 20, 6, 1.5
    pairs = []
    for depth, seed in ((3, 11), (5, 12)):
        jmodel, params = _jax_model(depth, seed, attn_impl="fused")
        japply = (lambda m, p: lambda x, t, y: m.apply({"params": p}, x, t, y))(jmodel, params)
        pairs.append((jax_make_guided_apply(japply, w, NULL),
                      make_guided_apply(_port_model(depth, params, attn_impl="fused").eval(),
                                        w, NULL)))
    rng = np.random.RandomState(13)
    table = rng.randn(steps, *LATENT).astype(np.float32)
    table[0] = 0.0
    x0 = rng.randn(*LATENT).astype(np.float32)
    y = np.array([2, 7], np.int32)
    want = jax_duodiff_sample(
        pairs[0][0], pairs[1][0], jax.random.PRNGKey(0), schedule=JaxSchedule.create(steps=steps),
        shape=LATENT, t_switch=t_switch, y=jnp.asarray(y), x_init=jnp.asarray(x0),
        noise_table=jnp.asarray(table))
    with torch.no_grad():
        got = duodiff_sample(
            pairs[0][1], pairs[1][1], None, schedule=NoiseSchedule.create(steps=steps),
            shape=LATENT, t_switch=t_switch, y=torch.from_numpy(y).long(), x_init=_t(x0),
            noise_table=_t(table))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_train_step_matches_jax_at_head_width_72():
    """Loss and every gradient of a train step with attn_impl="pallas" (K9
    forward, K10 backward at head width 72) against JAX's make_train_step,
    with label dropout; JAX's own draws are injected into the port."""
    jmodel, params = _jax_model(3, 7, attn_impl="pallas")
    jstep = jax_make_train_step(
        lambda p, x, t, y: jmodel.apply({"params": p}, x, t, y), JaxSchedule.create(steps=1000),
        model_kind="uvit", parametrization="predict_noise", has_labels=True, label_dropout=0.5,
        null_label=NULL)
    x, _, y = _latents(8, b=4)
    key = jax.random.PRNGKey(9)
    batch = {"image": jnp.asarray(x), "label": jnp.asarray(y)}
    (loss, _), grads = jax.value_and_grad(jstep.loss_fn, has_aux=True)(params, batch, key)
    want = convert.uvit_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    t_key, n_key = jax.random.split(key)
    timesteps = torch.from_numpy(np.asarray(jax.random.randint(t_key, (4,), 0, 1000))).long()
    noise = _t(np.asarray(jax.random.normal(n_key, x.shape, jnp.float32)))
    drop = torch.from_numpy(np.asarray(
        jax.random.bernoulli(jax.random.fold_in(key, 0x1ABE1), 0.5, (4,))))
    model = _port_model(3, params, attn_impl="pallas")
    step = make_train_step(model, NoiseSchedule.create(steps=1000),
                           parametrization="predict_noise", seed=0, has_labels=True,
                           label_dropout=0.5, null_label=NULL)
    metrics, got = step.backward({"image": _t(x), "label": torch.from_numpy(y).long()},
                                 timesteps, noise, drop)
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(want)
    assert abs(metrics["train_loss"].item() - float(loss)) <= 1e-6 * abs(float(loss))
    for name, g in zip(names, got):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


# --- U-ViT-H/2 -----------------------------------------------------------------


@pytest.mark.parametrize("depth", [3, 29], ids=["shallow", "full"])
def test_u_vit_h2_config_reads_as_jax_reads_it(depth, tmp_path):
    """The dict of published widths, written by the port's writer, read by
    the port's reader and by JAX's (PyYAML): the same model, the same
    autoencoder block, the same FLOPs a forward."""
    path = write_config(tmp_path / "uvit_h2.yaml", dict(UVIT_H2_IMAGENET256, depth=depth),
                        tmp_path / "autoencoder_kl.pth")
    cfg = load_model_config(path)
    jax_cfg, jax_ae = jax_load_model_config(path)
    assert {f: getattr(cfg, f) for f in vars(jax_cfg)} == vars(jax_cfg)
    assert cfg.embed_dim // cfg.num_heads == 72 and cfg.depth == depth
    assert cfg.num_patches + cfg.extras == 258
    assert load_autoencoder_config(path).autoencoder_checkpoint_path == jax_ae.autoencoder_checkpoint_path
    for batch in (1, 32):
        assert flops_per_uvit_forward(cfg, batch) == jax_flops(jax_cfg, batch)


def test_u_vit_h2_model_builds_at_head_width_72():
    """The port's U-ViT-H/2 at depth 3 on the meta device: 16 heads of 72, no
    weights made."""
    with torch.device("meta"):
        model = UViT(UViTConfig(**dict(UVIT_H2_IMAGENET256, depth=3)))
    blk = model.blocks()[0]
    assert blk.num_heads == 16 and blk.attn["qkv"].weight.shape == (3 * 1152, 1152)


# --- the refusals, through stand-in libraries ------------------------------------


class _Library:
    """Stands in for the loaded kernel library: the cores take head widths 64
    (up to L = 272) and 72 (up to L = 258 here, to show the limit is the
    width's), and there is no kernel entry, so a call that got past the
    checks fails with AttributeError."""

    LIMITS = {64: 272, 72: 258}

    def duodiff_attn_head_width(self, i):
        return list(self.LIMITS)[i] if i < len(self.LIMITS) else 0

    def duodiff_attn_core_max_len(self, dh):
        return self.LIMITS.get(dh, 0)

    duodiff_attn_bwd_core_max_len = duodiff_attn_core_max_len

    def duodiff_sdpa_int8_max_len(self):
        return 272


@pytest.fixture
def stand_in(monkeypatch):
    lib = _Library()
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    for mod in (block, fa):
        monkeypatch.setattr(mod, "_check", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return lib


def _sublayer(d, heads, l):
    bf = torch.bfloat16
    x = torch.zeros(1, l, d, dtype=bf)
    vec, wqkv, wp = torch.zeros(d), torch.zeros(d, 3 * d, dtype=bf), torch.zeros(d, d, dtype=bf)
    return {
        "K1": lambda: block._attn_sublayer_cuda(x, vec, vec, wqkv, None, wp, vec,
                                                num_heads=heads, eps=1e-5),
        "K6": lambda: block._attn_sublayer_bwd_cuda(x, x, vec, vec, wqkv, None, wp,
                                                    num_heads=heads, eps=1e-5),
    }


@pytest.mark.parametrize("kernel", ["K1", "K6", "K9", "K10", "K15"])
def test_a_head_width_the_cores_do_not_take_is_refused(kernel, stand_in):
    """Head width 80 (D = 160, 2 heads): refused before the library is asked
    anything, with a message naming 64 and 72."""
    qh = torch.zeros(1, 2, 18, 80, dtype=torch.bfloat16)
    call = {**_sublayer(160, 2, 18),
            "K9": lambda: fa._flash_attention_cuda(qh, qh, qh),
            "K10": lambda: fa._flash_attention_bwd_cuda(qh, qh, qh, qh),
            "K15": lambda: sdpa_int8._launch("duodiff_sdpa_chain_bf16", None, "core",
                                             qh, qh, qh)}[kernel]
    with pytest.raises(ValueError, match="head width 64 or 72"):
        call()


def test_the_library_names_the_widths_it_takes(stand_in):
    with pytest.raises(ValueError, match=r"takes head width 64 or 72, got 80"):
        block._check_seq_len(stand_in, 18, 80)
    with pytest.raises(ValueError, match=r"backward core takes head width 64 or 72, got 80"):
        block._check_seq_len(stand_in, 18, 80, backward=True)
    assert block.library_head_widths(stand_in) == block.HEAD_WIDTHS


@pytest.mark.parametrize("kernel", ["K1", "K6", "K9", "K10"])
def test_a_length_past_the_widths_limit_is_refused(kernel, stand_in):
    """The stand-in's limit at 72 is 258: L = 259 is refused there with the
    limit named, and passes the same check at 64 (limit 272), reaching the
    absent kernel entry."""
    for dh, l in ((72, 259), (64, 259)):
        heads = 2
        qh = torch.zeros(1, heads, l, dh, dtype=torch.bfloat16)
        call = {**_sublayer(dh * heads, heads, l),
                "K9": lambda: fa._flash_attention_cuda(qh, qh, qh),
                "K10": lambda: fa._flash_attention_bwd_cuda(qh, qh, qh, qh)}[kernel]
        if dh == 72:
            with pytest.raises(ValueError, match=r"sequence length 259 does not fit the "
                                                 r"attention (backward )?core \(at most 258\) "
                                                 r"at head width 72"):
                call()
        else:
            with pytest.raises(AttributeError):
                call()


@pytest.mark.parametrize("kernel", ["K6", "K7", "K8", "K11", "K12", "LN+quant"])
def test_rows_wider_than_the_ln_passes_are_refused(kernel, stand_in):
    """2088 = 29 heads of 72, past the 2048 the LayerNorm passes hold in a
    warp's registers; 2048 itself passes the row check."""
    bf, i8 = torch.bfloat16, torch.int8
    for d in (2088, 2048):
        x, vec = torch.zeros(1, 4, d, dtype=bf), torch.zeros(d)
        w1, w2 = torch.zeros(d, 4 * d, dtype=bf), torch.zeros(4 * d, d, dtype=bf)
        call = {
            "K6": lambda: block._attn_sublayer_bwd_cuda(
                x, x, vec, vec, torch.zeros(d, 3 * d, dtype=bf), None,
                torch.zeros(d, d, dtype=bf), num_heads=d // 72 if d % 72 == 0 else d // 64,
                eps=1e-5),
            "K7": lambda: block._mlp_sublayer_bwd_cuda(x, x, vec, vec, w1, torch.zeros(4 * d), w2,
                                                       gelu_approx=False, eps=1e-5),
            "K8": lambda: block._mlp_sublayer_bwd_split_cuda(
                x, x, vec, vec, w1, torch.zeros(4 * d), w2, splits=4, gelu_approx=False,
                eps=1e-5),
            "K11": lambda: q._attn_sublayer_int8_cuda(
                x, vec, vec, torch.zeros(3 * d, d, dtype=i8), torch.ones(3 * d), None,
                torch.zeros(d, d, dtype=i8), torch.ones(d), vec,
                num_heads=d // 72 if d % 72 == 0 else d // 64, eps=1e-5),
            "K12": lambda: q._mlp_sublayer_int8_cuda(
                x, vec, vec, torch.zeros(4 * d, d, dtype=i8), torch.ones(4 * d),
                torch.zeros(4 * d), torch.zeros(d, 4 * d, dtype=i8), torch.ones(d), vec, None,
                gelu_approx=False, eps=1e-5),
            "LN+quant": lambda: gemm._ln_quant_rows_cuda(x[0], vec, vec, None, eps=1e-5,
                                                         first=False),
        }[kernel]
        if d > block.ROW_MAX_WIDTH:
            with pytest.raises(ValueError, match="at most 2048"):
                call()
        else:
            try:
                call()
            except ValueError as err:  # any later check, but not the row width's
                assert "at most 2048" not in str(err)
            except (AttributeError, TypeError, RuntimeError):
                pass


# --- the sources say what the wrappers hold --------------------------------------


def _source(name):
    return (_build.CSRC_DIR / name).read_text()


def test_the_wrappers_widths_are_the_cores():
    """HEAD_WIDTHS is kHeadWidths, the widths with_head_dim instantiates, and
    ROW_MAX_WIDTH the limit of both LayerNorm passes; the LayerNorm + quant
    keeps two rows a warp up to 1024 columns (its codes there unchanged) and
    one above; the cores' m16n8k8 step and 144-byte rows at 72."""
    tiles = _source("attn_tiles.cuh")
    widths = re.search(r"kHeadWidths\[\] = \{([^}]*)\}", tiles).group(1)
    assert tuple(int(w) for w in widths.split(",")) == block.HEAD_WIDTHS
    for w in block.HEAD_WIDTHS:
        assert f"if (Dh == {w}) return f(HeadDim<{w}>{{}});" in tiles
    assert "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32" in tiles
    kvec = 8
    for name, const in (("quant.cuh", "kLnQuantMaxWidth"), ("layernorm_bwd.cuh", "kLnbMaxWidth")):
        expr = re.search(rf"constexpr int {const} = ([^;]*);", _source(name)).group(1)
        assert eval(expr, {"kVec": kvec}) == block.ROW_MAX_WIDTH, name  # noqa: S307
    rule = re.search(r"int ln_quant_rows_per_warp\(int chunks\) \{\s*return chunks <= (\d+) \? "
                     r"(\d+) : (\d+);\s*\}", _source("quant.cuh"))
    assert tuple(int(v) for v in rule.groups()) == (4, 2, 1)
    for entry, nargs in (("duodiff_attn_sublayer", 19), ("duodiff_attn_sublayer_bwd", 23),
                         ("duodiff_flash_attention", 9), ("duodiff_attn_core_max_len", 1)):
        assert len(_build._SIGNATURES[entry][0]) == nargs, entry
