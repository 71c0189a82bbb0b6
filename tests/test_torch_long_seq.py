"""The port past 272 tokens, where the card's attention core takes its blocked
form (``csrc/attn_core.cuh``), against the JAX package on the CPU, on the same
inputs made from a seed with numpy and weights crossed over by the port's
converter:

- the plain versions of every kernel on the long path at L = 290 and 1025 (a
  17 x 17 and a 32 x 32 image at patch 1; D = 128, 2 heads of 64) against the
  Pallas kernels in interpret mode, fp32 and bf16: K1 with and without a qkv
  bias, K1-v1, K5, K9, K11 (its int8 weight codes equal to JAX's), K15's bf16
  form against the probe tool's body, and the measuring entry's plain core
  against the kernels' own;
- a U-ViT at L = 1025 (32 x 32 x 3 at patch 1, D = 128, depth 3): the fp32
  forward, and a 4-step DuoDiff trajectory on one injected noise table;
- ``train.py --dataset celeba --img_size 64``: patch 2, L = 1025, as
  ``main.py``'s own defaults give it;
- what the CUDA wrappers take and refuse past 272, through a stand-in library
  that reports the limits the sources set: every forward wrapper takes the
  forward core's limit and refuses one more, naming it; the backward
  wrappers do the same at the backward core's limit, which is the forward
  core's (the backward past 272 is ``tests/test_torch_long_seq_bwd.py``).

Tolerances, the JAX tests' own between the package's paths
(tests/test_ops.py), as ``tests/test_torch_head_width.py`` holds them: kernels
fp32 1e-5 (summation order), bf16 5e-2 (bf16 rounding at the same points,
flipped now and then by summation order); int8 sublayers 2e-2 (an int8 code
flips by one where an fp32 sum in another order crosses a half); the model
forward and the trajectory 1e-4 (~1e-6 a forward, then the ancestral
updates).
"""

import importlib.util
import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import main as jax_main
from duodiff_tpu.config import UViTConfig as JaxConfig
from duodiff_tpu.diffusion.sampling import duodiff_sample as jax_duodiff_sample
from duodiff_tpu.diffusion.schedule import NoiseSchedule as JaxSchedule
from duodiff_tpu.models.uvit import init_uvit as jax_init_uvit
from duodiff_tpu.ops import pallas_attention as jax_fa
from duodiff_tpu.ops import pallas_block as pb
from duodiff_tpu.ops import pallas_block_int8 as pbi
from duodiff_tpu_torch import train
from duodiff_tpu_torch.config import UViTConfig
from duodiff_tpu_torch.diffusion.sampling import duodiff_sample
from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
from duodiff_tpu_torch.models.uvit import UViT
from duodiff_tpu_torch.ops import _build, block
from duodiff_tpu_torch.ops import block_int8 as q
from duodiff_tpu_torch.ops import flash_attention as fa
from duodiff_tpu_torch.ops import sdpa_int8
from duodiff_tpu_torch.utils import convert

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
DH, HEADS = 64, 2
D, HID = DH * HEADS, 4 * DH * HEADS
LENGTHS = [290, 1025]
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
FWD_TOL = {"fp32": 1e-5, "bf16": 5e-2}
INT8_TOL = 2e-2
JAX_ORDER = ("ln1_s", "ln1_b", "wqkv", "bqkv", "wp", "bp", "ln2_s", "ln2_b", "w1", "b1", "w2",
             "b2")


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _np(t):
    return np.asarray(t.astype(jnp.float32)) if isinstance(t, jnp.ndarray) else t.float().numpy()


def _close(got, want, dtype_name, tol=None):
    tol = FWD_TOL[dtype_name] if tol is None else tol
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _block_inputs(l, qkv_bias=True, seed=0):
    """numpy x (1, l, D) and one block's parameters in the JAX layout
    (kernels (in, out), the qkv kernel unscaled)."""
    rng = np.random.RandomState(seed + l)
    r = lambda *s: (0.05 * rng.randn(*s)).astype(np.float32)  # noqa: E731
    x = rng.randn(1, l, D).astype(np.float32)
    p = {"ln1_s": 1.0 + r(D), "ln1_b": r(D), "wqkv": r(D, 3 * D), "bqkv": r(3 * D),
         "wp": r(D, D), "bp": r(D), "ln2_s": 1.0 + r(D), "ln2_b": r(D), "w1": r(D, HID),
         "b1": r(HID), "w2": r(HID, D), "b2": r(D)}
    if not qkv_bias:
        p["bqkv"] = None
    return x, p


def _packed(p, tdt):
    """(v2 attention operands, v1 attention operands, MLP operands)."""
    params = convert.block_params_from_jax(p)
    return (block.attn_operands(*params[:6], num_heads=HEADS, dtype=tdt),
            block.attn_operands_v1(*params[:6], dtype=tdt),
            block.mlp_operands(*params[6:], dtype=tdt))


def _jax_attn(p):
    return [p[k] for k in JAX_ORDER[:6]]


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
        norm.weight.copy_(torch.from_numpy(p["ln1_s"]))
        norm.bias.copy_(torch.from_numpy(p["ln1_b"]))
    return norm


def _heads(l, seed, b=2):
    rng = np.random.default_rng(seed + l)
    return [rng.standard_normal((b, HEADS, l, DH)).astype(np.float32) for _ in range(3)]


# --- the kernels' plain versions past 272 tokens --------------------------------


@pytest.mark.parametrize("l", LENGTHS)
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_k9_plain_matches_pallas_past_272(dtype_name, l):
    jdt, tdt = DTYPES[dtype_name]
    arrays = _heads(l, seed=0)
    got = fa.flash_attention_plain(*[_t(a, tdt) for a in arrays])
    want = jax_fa.flash_attention(*[jnp.asarray(a).astype(jdt) for a in arrays], interpret=True)
    assert got.dtype == tdt and got.shape == (2, HEADS, l, DH)
    _close(got, want, dtype_name)


@pytest.mark.parametrize("l", LENGTHS)
@pytest.mark.parametrize("qkv_bias", [False, True])
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_k1_plain_matches_pallas_past_272(dtype_name, qkv_bias, l):
    x, p = _block_inputs(l, qkv_bias)
    jdt, tdt = DTYPES[dtype_name]
    want = pb.fused_attn_sublayer(jnp.asarray(x, jdt), *_jax_attn(p), num_heads=HEADS,
                                  interpret=True)
    v2, _, _ = _packed(p, tdt)
    before = block.fused_attn_sublayer.launches
    got = block.fused_attn_sublayer(_t(x, tdt), *v2, num_heads=HEADS)
    assert got.dtype == tdt and block.fused_attn_sublayer.launches == before
    _close(got, want, dtype_name)


@pytest.mark.parametrize("l", LENGTHS)
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_k1_v1_plain_matches_pallas_past_272(dtype_name, l):
    """The normalise-first form, which the card runs in three passes over the
    key blocks: p = e / sum rounded before the value product."""
    x, p = _block_inputs(l, seed=1)
    jdt, tdt = DTYPES[dtype_name]
    want = pb.fused_attn_sublayer(jnp.asarray(x, jdt), *_jax_attn(p), num_heads=HEADS,
                                  interpret=True, variant="v1")
    _, v1, _ = _packed(p, tdt)
    got = block.fused_attn_sublayer(_t(x, tdt), *v1, num_heads=HEADS, variant="v1")
    assert got.dtype == tdt
    _close(got, want, dtype_name)


@pytest.mark.parametrize("l", LENGTHS)
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_k5_plain_matches_pallas_past_272(dtype_name, l):
    x, p = _block_inputs(l, seed=2)
    jdt, tdt = DTYPES[dtype_name]
    want = pb.fused_block(jnp.asarray(x, jdt), *[p[k] for k in JAX_ORDER], num_heads=HEADS,
                          interpret=True)
    v2, _, mlp = _packed(p, tdt)
    got = block.fused_block(_t(x, tdt), *v2, *mlp, num_heads=HEADS)
    assert got.dtype == tdt and got.shape == (1, l, D)
    _close(got, want, dtype_name)


@pytest.mark.parametrize("l", LENGTHS)
@pytest.mark.parametrize("qkv_bias", [False, True])
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_k11_plain_matches_pallas_past_272(dtype_name, qkv_bias, l):
    x, p = _block_inputs(l, qkv_bias, seed=3)
    jdt, tdt = DTYPES[dtype_name]
    want = pbi.fused_attn_sublayer_int8(jnp.asarray(x, jdt), *_jax_attn(p), num_heads=HEADS,
                                        interpret=True)
    ops = q.pack_attn_int8(_norm(p), _linear(p["wqkv"], p["bqkv"]), _linear(p["wp"], p["bp"]),
                           num_heads=HEADS)
    got = q.fused_attn_sublayer_int8(_t(x, tdt), *ops, num_heads=HEADS)
    assert got.dtype == tdt and got.shape == (1, l, D)
    _close(got, want, dtype_name, tol=INT8_TOL)


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_k11_weight_codes_equal_jax(qkv_bias):
    """The codes K11 runs at L = 1025 are the weights' alone: equal to JAX's,
    the scales and the q bias to fp32's rounding."""
    _, p = _block_inputs(1025, qkv_bias, seed=4)
    jw8, jsq, jb, jp8, jsp = pbi._prep_attn_int8(
        jnp.asarray(p["wqkv"]), None if p["bqkv"] is None else jnp.asarray(p["bqkv"]),
        jnp.asarray(p["wp"]), num_heads=HEADS)
    _, _, w8, sq, b, p8, sp, _ = q.pack_attn_int8(_norm(p), _linear(p["wqkv"], p["bqkv"]),
                                                  _linear(p["wp"], p["bp"]), num_heads=HEADS)
    np.testing.assert_array_equal(w8.t().numpy(), np.asarray(jw8))
    np.testing.assert_array_equal(p8.t().numpy(), np.asarray(jp8))
    np.testing.assert_allclose(sq.numpy(), np.asarray(jsq)[0], rtol=1e-7, atol=0)
    np.testing.assert_allclose(sp.numpy(), np.asarray(jsp)[0], rtol=1e-7, atol=0)
    if qkv_bias:
        np.testing.assert_allclose(b.numpy(), np.asarray(jb)[0], rtol=1e-7, atol=0)
    else:
        assert b is None and jb is None


@pytest.fixture(scope="module")
def probe_sdpa():
    """The JAX probe tool's module, its kernel bodies reading H and G."""
    spec = importlib.util.spec_from_file_location("jax_probe_int8_sdpa",
                                                  REPO / "tools" / "probe_int8_sdpa.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.H, mod.G = HEADS, 1
    return mod


@pytest.mark.parametrize("l", LENGTHS)
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_k15_bf16_plain_matches_the_probe_body_past_272(probe_sdpa, dtype_name, l):
    """K15's bf16 form (the core with no scale) against the probe's
    _sdpa_bf16_kernel in its own pallas_call, one sample a grid step; the
    body rounds e and its output to bf16 at either input type, so both are
    held to the bf16 bound."""
    jdt, tdt = DTYPES[dtype_name]
    arrays = _heads(l, seed=5)
    qj, kj, vj = (jnp.asarray(a).astype(jdt) for a in arrays)
    spec = pl.BlockSpec((1, HEADS, l, DH), lambda i: (i, 0, 0, 0))
    want = pl.pallas_call(probe_sdpa._sdpa_bf16_kernel, grid=(qj.shape[0],),
                          in_specs=[spec, spec, spec], out_specs=spec,
                          out_shape=jax.ShapeDtypeStruct(qj.shape, jnp.bfloat16),
                          interpret=True)(qj, kj, vj)
    got = sdpa_int8.sdpa_chain_bf16(*[_t(a, tdt) for a in arrays])  # CPU: the plain version
    assert got.dtype == tdt and got.shape == qj.shape
    _close(got, want, "bf16")


@pytest.mark.parametrize("l", LENGTHS)
def test_the_measuring_entrys_plain_core_is_the_kernels(l):
    """attn_core_form's plain version, which the card holds both forms of
    the core to: K9's at the default scale, K15's bf16 form at scale 1, and
    in the normalise-first form the per-head core of K1-v1 (fp32, where the
    two orders of the sums agree to 1e-6)."""
    q_, k_, v_ = (_t(a, torch.bfloat16) for a in _heads(l, seed=6))
    assert torch.equal(fa.attn_core_form(q_, k_, v_), fa.flash_attention_plain(q_, k_, v_))
    assert torch.equal(fa.attn_core_form(q_, k_, v_, scale=1.0),
                       sdpa_int8.sdpa_chain_bf16_plain(q_, k_, v_))
    x, p = _block_inputs(l, seed=7)
    _, v1, _ = _packed(p, torch.float32)
    ln_w, ln_b, wqkv, bqkv = v1[:4]
    xn = block._layer_norm(_t(x), ln_w, ln_b, 1e-5)
    qkv = torch.matmul(xn[None], wqkv[:, None]) + bqkv[:, None, None, :]
    qh, kh, vh = (t.reshape(1, l, HEADS, DH).transpose(1, 2).contiguous() for t in qkv)
    got = fa.attn_core_form(qh, kh, vh, norm_first=True)
    s = torch.einsum("bhle,bhme->bhlm", qh, kh) * DH**-0.5
    want = torch.einsum("bhlm,bhme->bhle", torch.softmax(s, -1), vh)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


# --- a U-ViT at L = 1025 ----------------------------------------------------------

LONG = dict(img_size=32, patch_size=1, in_chans=3, embed_dim=D, num_heads=HEADS, mlp_ratio=4,
            qkv_bias=False, mlp_time_embed=False, num_classes=-1, normalize_timesteps=True)
IMAGES = (2, 32, 32, 3)


def _models(depth, seed, impl="fused"):
    """(JAX apply_fn, the port's model) at LONG's widths, the same weights."""
    kw = dict(LONG, depth=depth)
    jmodel, params = jax_init_uvit(JaxConfig(**kw), jax.random.PRNGKey(seed),
                                   dtype=jnp.float32, attn_impl=impl)
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rng.randn(*a.shape).astype(np.float32), params)
    model = UViT(UViTConfig(**kw), dtype=torch.float32, attn_impl=impl)
    model.load_state_dict(convert.uvit_state_dict_from_jax(params), strict=True)
    model.pack_for_kernels()
    return (lambda x, t, y=None: jmodel.apply({"params": params}, x, t, y)), model


@pytest.mark.parametrize("impl", ["fused", "pallas"])
def test_uvit_forward_at_1025_tokens_matches_jax(impl):
    japply, model = _models(3, 1, impl)
    cfg = model.config
    assert cfg.num_patches + cfg.extras == 1025
    rng = np.random.RandomState(2)
    x = rng.randn(*IMAGES).astype(np.float32)
    t = np.array([999.0, 17.0], np.float32)
    want = np.asarray(japply(jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = model.eval()(_t(x), _t(t))
    assert got.shape == want.shape == IMAGES
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_duodiff_trajectory_at_1025_tokens_matches_jax():
    steps, t_switch = 4, 2
    (j_early, t_early), (j_late, t_late) = _models(3, 3), _models(3, 4)
    rng = np.random.RandomState(5)
    table = rng.randn(steps, *IMAGES).astype(np.float32)
    table[0] = 0.0
    x0 = rng.randn(*IMAGES).astype(np.float32)
    want = jax_duodiff_sample(
        j_early, j_late, jax.random.PRNGKey(0), schedule=JaxSchedule.create(steps=steps),
        shape=IMAGES, t_switch=t_switch, x_init=jnp.asarray(x0), noise_table=jnp.asarray(table))
    with torch.no_grad():
        got = duodiff_sample(
            t_early.eval(), t_late.eval(), None, schedule=NoiseSchedule.create(steps=steps),
            shape=IMAGES, t_switch=t_switch, x_init=_t(x0), noise_table=_t(table))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_celeba_64_from_the_training_flags_is_1025_tokens():
    """``--dataset celeba --img_size 64`` with nothing else: the parsers'
    default patch 2 (main.py's and train.py's alike) gives 1,024 patches and
    the time token."""
    argv = ["--dataset", "celeba", "--img_size", "64", "--data_path", "data", "--n_steps", "1"]
    args, jax_args = train.get_args(argv), jax_main.get_args(argv)
    cfg = UViTConfig.from_dict(vars(args))
    assert (args.patch_size, jax_args.patch_size, jax_args.img_size) == (2, 2, 64)
    assert (cfg.img_size, cfg.patch_size, cfg.num_patches + cfg.extras) == (64, 2, 1025)
    assert (cfg.embed_dim, cfg.num_heads, cfg.depth) == (512, 8, 13)


# --- what the wrappers take and refuse past 272, through a stand-in library --------


def _source_limit(name):
    expr = re.search(rf"constexpr int {name} = (\d+);",
                     (_build.CSRC_DIR / "attn_tiles.cuh").read_text())
    return int(expr.group(1))


def test_the_sources_limits():
    """The forward and the backward core take L past 1,025 at both widths
    (their blocked forms), to the same limit; K15's int8 core 272."""
    forward, registers = _source_limit("kMaxSeqBlocked"), _source_limit("kMaxSeq")
    assert forward >= 1025 and registers == 272
    entries = (_build.CSRC_DIR / "attn_sublayer.cu").read_text()
    assert "return duodiff::kMaxSeqBlocked;" in entries.split("duodiff_attn_core_max_len")[1]
    bwd = (_build.CSRC_DIR / "attn_sublayer_bwd.cu").read_text()
    assert "return duodiff::kMaxSeqBlocked; });" in bwd.split("duodiff_attn_bwd_core_max_len")[1]
    assert "duodiff_sdpa_int8_max_len() { return duodiff::kMaxSeq; }" in (
        _build.CSRC_DIR / "sdpa_int8.cu").read_text()


class _Library:
    """Stands in for the loaded kernel library with the limits the sources
    set; it has no kernel entry, so a call that got past the checks fails
    with AttributeError."""

    def __init__(self):
        # the backward core's limit is the forward core's (test_the_sources_limits)
        self.forward = self.backward = _source_limit("kMaxSeqBlocked")
        self.int8 = _source_limit("kMaxSeq")

    def duodiff_attn_head_width(self, i):
        return block.HEAD_WIDTHS[i] if i < len(block.HEAD_WIDTHS) else 0

    def duodiff_attn_core_max_len(self, dh):
        return self.forward if dh in block.HEAD_WIDTHS else 0

    def duodiff_attn_bwd_core_max_len(self, dh):
        return self.backward if dh in block.HEAD_WIDTHS else 0

    def duodiff_sdpa_int8_max_len(self):
        return self.int8


@pytest.fixture
def stand_in(monkeypatch):
    lib = _Library()
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    for mod in (block, q, fa):
        monkeypatch.setattr(mod, "_check", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return lib


def _wrapper(kernel, l, dh=DH):
    """The CUDA launch of ``kernel`` on zeros of length l, two heads of dh."""
    bf, i8, d = torch.bfloat16, torch.int8, 2 * dh
    x, vec = torch.zeros(1, l, d, dtype=bf), torch.zeros(d)
    wqkv, wp = torch.zeros(d, 3 * d, dtype=bf), torch.zeros(d, d, dtype=bf)
    qh = torch.zeros(1, 2, l, dh, dtype=bf)
    return {
        "K1": lambda: block._attn_sublayer_cuda(x, vec, vec, wqkv, None, wp, vec, num_heads=2,
                                                eps=1e-5),
        "K1-v1": lambda: block._attn_sublayer_cuda(x, vec, vec, torch.zeros(3, d, d, dtype=bf),
                                                   None, wp, vec, num_heads=2, eps=1e-5,
                                                   variant="v1"),
        "K5": lambda: block._fused_block_cuda(
            x, vec, vec, wqkv, None, wp, vec, vec, vec, torch.zeros(d, 4 * d, dtype=bf),
            torch.zeros(4 * d), torch.zeros(4 * d, d, dtype=bf), vec, num_heads=2,
            gelu_approx=False, eps=1e-5),
        "K9": lambda: fa._flash_attention_cuda(qh, qh, qh),
        "K11": lambda: q._attn_sublayer_int8_cuda(
            x, vec, vec, torch.zeros(3 * d, d, dtype=i8), torch.ones(3 * d), None,
            torch.zeros(d, d, dtype=i8), torch.ones(d), vec, num_heads=2, eps=1e-5),
        "K15": lambda: sdpa_int8._launch("duodiff_sdpa_chain_bf16", None, "attention core",
                                         qh, qh, qh),
        "core": lambda: fa.attn_core_form(qh.to("meta"), qh.to("meta"), qh.to("meta")),
        "K6": lambda: block._attn_sublayer_bwd_cuda(x, x, vec, vec, wqkv, None, wp,
                                                    num_heads=2, eps=1e-5),
        "K10": lambda: fa._flash_attention_bwd_cuda(qh, qh, qh, qh),
    }[kernel]


@pytest.mark.parametrize("kernel", ["K1", "K1-v1", "K5", "K9", "K11", "K15", "core"])
def test_a_forward_wrapper_takes_the_cores_limit_and_refuses_past_it(kernel, stand_in):
    """At the forward core's limit the wrapper gets past every check to the
    (absent) kernel entry; one past it, it refuses, naming the limit. The
    measuring entry runs on meta tensors here (not the CPU's plain path)."""
    limit = stand_in.forward
    with pytest.raises(AttributeError):
        _wrapper(kernel, limit)()
    with pytest.raises(ValueError, match=rf"sequence length {limit + 1} does not fit the "
                                         rf"attention core \(at most {limit}\) at head width 64"):
        _wrapper(kernel, limit + 1)()


@pytest.mark.parametrize("kernel", ["K6", "K10"])
@pytest.mark.parametrize("dh", block.HEAD_WIDTHS)
def test_a_backward_wrapper_still_refuses_273(kernel, dh, stand_in):
    """The backward wrapper takes the backward core's limit (its blocked
    form's, at least 1,025) and refuses one past it: at the limit it gets
    through to the (absent) kernel entry, one past it it stops in the
    backward core's check, which names the limit."""
    limit = stand_in.backward
    assert limit >= 1025
    with pytest.raises(AttributeError):
        _wrapper(kernel, limit, dh)()
    with pytest.raises(ValueError, match=rf"sequence length {limit + 1} does not fit the "
                                         rf"attention backward core \(at most {limit}\) at "
                                         rf"head width {dh}"):
        _wrapper(kernel, limit + 1, dh)()
