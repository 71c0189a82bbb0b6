"""The int8 GEMM of the W8A8 sublayers (duodiff_tpu_torch.ops.gemm.gemm_int8;
device code csrc/gemm_int8.cuh) and the LayerNorm + row quant pass in front
of them (ops.gemm.ln_quant_rows; csrc/quant.cuh) on CPU tensors, where they
run their plain PyTorch versions: against numpy (int64 products, the fp32
epilogue in the kernel's order) over every epilogue at ragged M, N, K; the
epilogue's order; the wrappers' refusals; K11 and K12 at a row count that is
no multiple of 128 against the Pallas int8 kernels of
duodiff_tpu/ops/pallas_block_int8.py run with interpret=True; and guards on
the kernel sources.

Tolerances: the products are exact on both sides and every epilogue step is
one fp32 rounding in the same order, so the bias and residual epilogues
(bf16 out) equal numpy's to the bit. GELU is torch's against scipy's in
float64: fp32 outputs within 1e-6 relative + 2e-6 absolute (1 + erf cancels
for negative arguments, so an ulp of erf near -1 is ~1e-7 of |v| in GELU);
int8 codes differ by at most 1, in at most 1e-3 of the entries (an ulp of
GELU moves v * inv across a half now and then). The sublayers against Pallas:
atol = rtol = 2e-2, as tests/test_torch_int8.py.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import erf

from duodiff_tpu.ops import pallas_block as pb
from duodiff_tpu.ops import pallas_block_int8 as pbi
from duodiff_tpu_torch.ops import block_int8 as q
from duodiff_tpu_torch.ops import gemm
from duodiff_tpu_torch.ops._build import _SIGNATURES, CSRC_DIR

torch.set_num_threads(1)

EPILOGUES = ("bias", "residual", "gelu_f32", "gelu_quant")
EPILOGUE_GELU = {"bias": "none", "residual": "none", "gelu_f32": "erf", "gelu_quant": "tanh"}
QUANT_INV = 127.0 / 4.0


def _operands(m, n, k, epilogue, rows, with_bias, seed):
    """int8 codes in [-127, 127], column scales that bring the sums to ~N(0,
    1), row scales in [0.5, 1.5), bias, and the residual and quant_inv where
    the epilogue takes them."""
    rng = np.random.RandomState(seed)
    a8 = torch.from_numpy(rng.randint(-127, 128, (m, k)).astype(np.int8))
    b8 = torch.from_numpy(rng.randint(-127, 128, (n, k)).astype(np.int8))
    col = (0.5 + rng.rand(n)) * 3.0 / (127.0**2 * np.sqrt(k))
    col = torch.from_numpy(col.astype(np.float32))
    row = torch.from_numpy((0.5 + rng.rand(m)).astype(np.float32)) if rows else None
    bias = torch.from_numpy((0.1 * rng.randn(n)).astype(np.float32)) if with_bias else None
    res = None
    if epilogue == "residual":
        res = torch.from_numpy(rng.randn(m, n).astype(np.float32)).to(torch.bfloat16)
    inv = torch.tensor([QUANT_INV]) if epilogue == "gelu_quant" else None
    return a8, b8, col, row, bias, res, inv


def _gelu64(v, mode):
    if mode == "erf":
        return 0.5 * v * (1.0 + erf(v / np.sqrt(2.0)))
    if mode == "tanh":
        return 0.5 * v * (1.0 + np.tanh(np.sqrt(2.0 / np.pi) * (v + 0.044715 * v**3)))
    return v


def _numpy_epilogue_input(a8, b8, col, row, bias, res):
    """float32(acc) * (row x col scale product), then + residual, then + bias,
    each a float32 rounding, from int64 products."""
    acc = a8.numpy().astype(np.int64) @ b8.numpy().astype(np.int64).T
    scale = col.numpy() if row is None else row.numpy()[:, None] * col.numpy()[None, :]
    v = acc.astype(np.float32) * scale.astype(np.float32)
    if res is not None:
        v = res.float().numpy() + v
    if bias is not None:
        v = v + bias.numpy()
    assert v.dtype == np.float32
    return v


def _check_against_numpy(ops, epilogue, gelu):
    a8, b8, col, row, bias, res, inv = ops
    got = gemm.gemm_int8(a8, b8, col, row, bias, res, inv, epilogue=epilogue, gelu=gelu)
    assert got.dtype == gemm.INT8_EPILOGUES[epilogue][1]
    assert got.shape == (a8.shape[0], b8.shape[0])
    v = _numpy_epilogue_input(a8, b8, col, row, bias, res)
    if epilogue in ("bias", "residual"):
        assert torch.equal(got, torch.from_numpy(v).to(torch.bfloat16))
        return
    want = _gelu64(v.astype(np.float64), gelu)
    if epilogue == "gelu_f32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=2e-6)
        return
    codes = np.clip(np.rint(want * np.float32(QUANT_INV)), -127, 127)
    diff = np.abs(got.numpy().astype(np.int64) - codes)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


@pytest.mark.parametrize("with_bias", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("rows", [False, True], ids=["col_scales", "row_scales"])
@pytest.mark.parametrize("epilogue", EPILOGUES)
def test_plain_epilogues_match_numpy(epilogue, rows, with_bias):
    ops = _operands(129, 144, 80, epilogue, rows, with_bias, seed=len(epilogue) + 2 * rows)
    _check_against_numpy(ops, epilogue, EPILOGUE_GELU[epilogue])


@pytest.mark.parametrize("k", [16, 80, 2048])
@pytest.mark.parametrize("n", [16, 144, 272])
@pytest.mark.parametrize("m", [1, 127, 129])
def test_plain_shapes_match_numpy(m, n, k):
    """The shapes where a 128-row, 128-column or 128-deep tile breaks, with
    K11's epilogues (row scales) and K12's static ones (column scales only;
    fc1's tanh GELU quantized to int8 codes)."""
    seed = m + n + k
    _check_against_numpy(_operands(m, n, k, "bias", True, True, seed), "bias", "none")
    _check_against_numpy(_operands(m, n, k, "residual", False, True, seed), "residual", "none")
    _check_against_numpy(_operands(m, n, k, "gelu_quant", False, True, seed), "gelu_quant",
                         "tanh")


def test_products_are_exact_at_the_largest_sums():
    """K = 2048 of +-127 * +-127: |acc| = 33,032,192 > 2**24, which fp32
    partial sums could not hold; the plain product is the int64 one."""
    a8 = torch.full((2, 2048), 127, dtype=torch.int8)
    a8[1] = -127
    b8 = torch.full((16, 2048), 127, dtype=torch.int8)
    got = gemm.gemm_int8(a8, b8, torch.ones(16), epilogue="gelu_f32")
    want = (a8.long() @ b8.long().t()).float()
    assert torch.equal(got, want) and got[0, 0].item() == float(np.float32(2048 * 127**2))


def _unit(acc, n=8):
    """a8 @ b8.T == acc in every entry of a (1, n) output."""
    a8 = torch.zeros(1, 16, dtype=torch.int8)
    a8[0, 0] = acc
    b8 = torch.zeros(n, 16, dtype=torch.int8)
    b8[:, 0] = 1
    return a8, b8


@pytest.mark.parametrize("case", ["scale_product_first", "residual_then_bias_one_rounding",
                                  "bias_then_gelu_then_codes"])
def test_plain_keeps_the_epilogue_order(case):
    """float(acc) * (row_scale * col_scale), then the residual, then the bias,
    each one fp32 rounding, GELU last, one rounding to the output type."""
    if case == "scale_product_first":
        # r = c = 1 + 2**-23: fl(r * c) = 1 + 2**-22, and 3 * that is exact;
        # fl(fl(3 * r) * c) would give 3 + 2**-20
        a8, b8 = _unit(3)
        one_up = float(np.float32(1.0) + np.float32(2.0**-23))
        got = gemm.gemm_int8(a8, b8, torch.full((8,), one_up), torch.tensor([one_up]),
                             epilogue="gelu_f32")
        assert (got == 3.0 * (1.0 + 2.0**-22)).all()
    elif case == "residual_then_bias_one_rounding":
        # 1 + 2**-8 + 2**-8 = 1 + 2**-7, a bf16 value; a rounding to bf16 after
        # the residual would give 1 (half to even), and 1 again after the bias
        a8, b8 = _unit(1)
        got = gemm.gemm_int8(a8, b8, torch.full((8,), 2.0**-8), bias=torch.full((8,), 2.0**-8),
                             residual=torch.ones(1, 8, dtype=torch.bfloat16),
                             epilogue="residual")
        assert got.dtype == torch.bfloat16 and (got.float() == 1.0 + 2.0**-7).all()
    else:
        # gelu(0.5 + 0.5) = gelu(1) * inv, rounded once to a code; GELU
        # before the bias would give gelu(0.5) + 0.5
        a8, b8 = _unit(1, n=16)
        inv = 100.0
        got = gemm.gemm_int8(a8, b8, torch.full((16,), 0.5), bias=torch.full((16,), 0.5),
                             quant_inv=torch.tensor([inv]), epilogue="gelu_quant", gelu="erf")
        assert got.dtype == torch.int8
        assert (got == int(np.rint(_gelu64(1.0, "erf") * inv))).all()


def test_wrappers_take_the_plain_version_on_the_cpu_without_counting():
    ops = _operands(33, 16, 32, "gelu_quant", False, True, seed=5)
    before = (gemm.gemm_int8.launches, gemm.ln_quant_rows.launches)
    got = gemm.gemm_int8(*ops, epilogue="gelu_quant", gelu="tanh")
    assert torch.equal(got, gemm.gemm_int8_plain(*ops, epilogue="gelu_quant", gelu="tanh"))
    x = torch.randn(5, 64).to(torch.bfloat16)
    x8, rs = gemm.ln_quant_rows(x, torch.ones(64), torch.zeros(64))
    assert x8.dtype == torch.int8 and rs.shape == (5,)
    assert (gemm.gemm_int8.launches, gemm.ln_quant_rows.launches) == before


def test_int8_launchers_refuse_what_the_kernels_do_not_take():
    a8, b8, col, row, bias, res, inv = _operands(16, 16, 32, "residual", True, True, seed=6)
    cuda = gemm._gemm_int8_cuda
    with pytest.raises(ValueError, match="CUDA"):
        cuda(a8, b8, col, row, bias, res, None, epilogue="residual", gelu="none")
    with pytest.raises(ValueError, match="multiple of 16"):
        cuda(a8[:, :24], b8[:, :24], col, row, bias, res, None, epilogue="residual", gelu="none")
    with pytest.raises(ValueError, match="of 16 for int8"):
        cuda(a8, b8[:8], col[:8], None, None, None, torch.ones(1), epilogue="gelu_quant",
             gelu="tanh")
    with pytest.raises(ValueError, match="residual"):
        cuda(a8, b8, col, row, bias, res, None, epilogue="bias", gelu="none")
    with pytest.raises(ValueError, match="quant_inv"):
        gemm.gemm_int8_plain(a8, b8, col, epilogue="gelu_quant", gelu="tanh")
    with pytest.raises(ValueError, match="epilogue"):
        gemm.gemm_int8_plain(a8, b8, col, epilogue="relu")
    with pytest.raises(ValueError, match="gelu"):
        gemm.gemm_int8_plain(a8, b8, col, epilogue="gelu_f32", gelu="sigmoid")
    x = torch.randn(4, 2056).to(torch.bfloat16)
    with pytest.raises(ValueError, match="at most 2048"):
        gemm._ln_quant_rows_cuda(x, torch.ones(2056), torch.zeros(2056), None, eps=1e-5,
                                 first=False)
    with pytest.raises(ValueError, match="CUDA"):
        gemm._ln_quant_rows_cuda(x[:, :64], torch.ones(64), torch.zeros(64), None, eps=1e-5,
                                 first=False)
    assert len(_SIGNATURES["duodiff_gemm_int8"][0]) == 14
    assert len(_SIGNATURES["duodiff_ln_quant_rows"][0]) == 11


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_ln_quant_rows_plain_matches_jax(mode):
    """The LayerNorm + row quant of the sublayers against JAX's _ln_fwd and
    row quantizers: a code differs by one at most, where the two fp32 means
    sum in other orders and a value lies at a half."""
    rng = np.random.RandomState(7)
    x = (rng.randn(129, 192) * 2.0 + 0.5).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.randn(192)).astype(np.float32)
    beta = (0.1 * rng.randn(192)).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    xj = jnp.asarray(xt.float().numpy())
    xn = pb._ln_fwd(xj, jnp.asarray(gamma), jnp.asarray(beta), 1e-5)[2]
    inv = None if mode == "dynamic" else torch.tensor([127.0 / 3.5])
    x8, rs = gemm.ln_quant_rows(xt, torch.from_numpy(gamma), torch.from_numpy(beta), inv)
    if mode == "dynamic":
        j8, jrs = pbi._quant_rows(xn)
        np.testing.assert_allclose(rs.numpy(), np.asarray(jrs)[:, 0], rtol=1e-6)
    else:
        j8, jrs = pbi._quant_rows_static(xn, jnp.float32(127.0 / 3.5)), None
        assert rs is None
    diff = np.abs(x8.numpy().astype(np.int64) - np.asarray(j8).astype(np.int64))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


# --- the sublayers that carry the kernels, at B * L = 129 rows ----------------

B, L, D, HEADS = 3, 43, 64, 4
TOL = 2e-2
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
STATIC = (3.5, 1.25)  # (sx, sh): post-LN and post-GELU amax of a calibration


def _block(seed=0):
    rng = np.random.RandomState(seed)
    r = lambda *s: (0.05 * rng.randn(*s)).astype(np.float32)  # noqa: E731
    x = rng.randn(B, L, D).astype(np.float32)
    p = {"ln_s": 1.0 + r(D), "ln_b": r(D), "wqkv": r(D, 3 * D), "bqkv": r(3 * D), "wp": r(D, D),
         "bp": r(D), "w1": r(D, 4 * D), "b1": r(4 * D), "w2": r(4 * D, D), "b2": r(D)}
    return x, p


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


@pytest.mark.parametrize("variant", ["K11", "K11_qkv_bias", "K12_dynamic_erf", "K12_dynamic_tanh",
                                     "K12_static_erf", "K12_static_tanh"])
@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
def test_int8_sublayers_match_pallas_at_ragged_rows(variant, dtype_name):
    assert (B * L) % 128 != 0
    x, p = _block()
    jdt, tdt = DTYPES[dtype_name]
    xj, xt = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    counters = (q.fused_attn_sublayer_int8.launches, q.fused_mlp_sublayer_int8.launches)
    if variant.startswith("K11"):
        bqkv = p["bqkv"] if variant.endswith("bias") else None
        want = pbi.fused_attn_sublayer_int8(xj, p["ln_s"], p["ln_b"], p["wqkv"], bqkv, p["wp"],
                                            p["bp"], num_heads=HEADS, interpret=True)
        ops = q.pack_attn_int8(_norm(p), _linear(p["wqkv"], bqkv), _linear(p["wp"], p["bp"]),
                               num_heads=HEADS)
        got = q.fused_attn_sublayer_int8(xt, *ops, num_heads=HEADS)
    else:
        static = STATIC if "static" in variant else None
        tanh = variant.endswith("tanh")
        want = pbi.fused_mlp_sublayer_int8(xj, p["ln_s"], p["ln_b"], p["w1"], p["b1"], p["w2"],
                                           p["b2"], gelu_approx=tanh, interpret=True,
                                           static_scales=static)
        ops = q.pack_mlp_int8(_norm(p), _linear(p["w1"], p["b1"]), _linear(p["w2"], p["b2"]),
                              static_scales=static)
        got = q.fused_mlp_sublayer_int8(xt, *ops, gelu_approx=tanh)
    assert got.dtype == tdt and got.shape == xt.shape
    assert counters == (q.fused_attn_sublayer_int8.launches, q.fused_mlp_sublayer_int8.launches)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=TOL, atol=TOL)


def test_int8_sublayer_launchers_refuse_rows_wider_than_the_ln_pass():
    xt = torch.zeros(1, 4, 2064, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="at most 2048"):
        q._mlp_sublayer_int8_cuda(xt, torch.ones(2064), torch.zeros(2064),
                                  torch.zeros(16, 2064, dtype=torch.int8), torch.ones(16),
                                  torch.zeros(16), torch.zeros(2064, 16, dtype=torch.int8),
                                  torch.ones(2064), torch.zeros(2064), None, gelu_approx=False,
                                  eps=1e-5)


# --- the kernel sources -------------------------------------------------------

INT8_GEMM_CALLERS = ("attn_sublayer_int8.cu", "mlp_sublayer_int8.cu", "gemm_int8_entry.cu")


def _source(name):
    return (CSRC_DIR / name).read_text()


def test_int8_gemm_source_is_the_hopper_design():
    """wgmma s8 x s8 -> s32 products from a TMA-fed mbarrier ring, persistent
    blocks, warp-specialised; no mma.sync and no WMMA left in it."""
    src = _source("gemm_int8.cuh")
    for needle in ("mma.sync", "wmma::", "<mma.h>", "cp.async.cg"):
        assert needle not in src, needle
    for needle in ("wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8", "tma_load_2d(",
                   "mbar_arrive_expect_tx(", "mbar_wait(&full[s]", "mbar_wait(&empty[s]",
                   "mbar_wait(staged", "mbar_wait(drained", "const __grid_constant__ CUtensorMap",
                   "tile += gridDim.x", "kI8Stages = 4", "CU_TENSOR_MAP_DATA_TYPE_UINT8",
                   "__shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0)"):
        assert needle in src, needle


def test_the_hopper_helpers_live_in_one_header():
    """gemm.cuh and gemm_int8.cuh take the mbarrier, TMA, descriptor and
    tensor-map helpers from hopper.cuh; no other source defines them."""
    helpers = _source("hopper.cuh")
    for needle in ("cp.async.bulk.tensor.2d", "mbarrier.try_wait.parity", "cuTensorMapEncodeTiled",
                   "wgmma.fence.sync.aligned", "__trap()"):
        assert needle in helpers, needle
    for name in ("gemm.cuh", "gemm_int8.cuh"):
        assert '#include "hopper.cuh"' in _source(name), name
    for path in sorted(Path(CSRC_DIR).iterdir()):
        if path.suffix in (".cu", ".cuh") and path.name != "hopper.cuh":
            src = path.read_text()
            for needle in ("mbarrier.try_wait", "cuTensorMapEncodeTiled",
                           "cp.async.bulk.tensor", "uint64_t smem_desc("):
                assert needle not in src, f"{path.name} defines {needle} again"


@pytest.mark.parametrize("unit", INT8_GEMM_CALLERS)
def test_every_int8_gemm_caller_goes_through_launch_gemm_int8(unit):
    src = _source(unit)
    assert '#include "gemm_int8.cuh"' in src and "launch_gemm_int8(" in src
    if unit != "gemm_int8_entry.cu":
        assert "launch_ln_quant_rows(" in src and '#include "quant.cuh"' in src


def test_ln_quant_pass_reads_its_row_once():
    """Each of a warp's rows in registers (kChunks x 8 values a lane), loaded
    once, gamma and beta as vectors; the first form of the pass only in the
    measurement entry."""
    src = _source("quant.cuh")
    start = src.index("ln_quant_rows_kernel(")
    body = src[start:src.index("\n}\n", start)]
    assert "float v[kLnRows][kChunks][kVec]" in body
    assert body.count("load8(") == 1
    assert "load_row8(gamma + c" in body and "load_row8(beta + c" in body
    assert "gamma[c + e]" not in body
    assert "ln_quant_rows_first_kernel" not in src
    assert "ln_quant_rows_first_kernel" in _source("gemm_int8_entry.cu")
