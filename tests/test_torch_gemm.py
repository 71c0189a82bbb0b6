"""The bf16 GEMM of the block kernels (duodiff_tpu_torch.ops.gemm; device
code csrc/gemm.cuh) on CPU tensors, where it runs its plain PyTorch
version: against numpy in float64 over every epilogue form and the shapes
where a tile breaks, its epilogue order, the sublayers that carry it (K1,
K2, K5) against the Pallas kernels of duodiff_tpu/ops/pallas_block.py run
with interpret=True at a row count that is no multiple of 128, and guards
on the kernel sources.

Tolerances: against float64, |got - want| <= 2**-7 |want| (one bf16
rounding of the output; 0 for fp32 outputs) + 1e-5 * S, where S = |a| @ |b|
+ |residual| + |bias| bounds the fp32 sums' error. The sublayers: fp32
1e-5, bf16 5e-2, as tests/test_torch_block_ops.py."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import erf

from duodiff_tpu.ops import pallas_block as pb
from duodiff_tpu_torch.ops import block, gemm
from duodiff_tpu_torch.ops._build import _SIGNATURES, CSRC_DIR
from duodiff_tpu_torch.utils.convert import block_params_from_jax

torch.set_num_threads(1)

RESIDUALS = {"none": None, "bf16": torch.bfloat16, "fp32": torch.float32}
OUTPUTS = {"bf16": torch.bfloat16, "fp32": torch.float32}


def _operands(m, n, k, residual, with_bias, seed):
    """bf16-valued a (M, K), b (K, N), fp32 bias, the residual in its type."""
    rng = np.random.RandomState(seed)
    a = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(torch.bfloat16)
    b = torch.from_numpy((rng.randn(k, n) / np.sqrt(k)).astype(np.float32)).to(torch.bfloat16)
    bias = torch.from_numpy((0.1 * rng.randn(n)).astype(np.float32)) if with_bias else None
    res = None
    if RESIDUALS[residual] is not None:
        res = torch.from_numpy(rng.randn(m, n).astype(np.float32)).to(RESIDUALS[residual])
    return a, b, bias, res


def _gelu64(v, mode):
    if mode == "erf":
        return 0.5 * v * (1.0 + erf(v / np.sqrt(2.0)))
    if mode == "tanh":
        return 0.5 * v * (1.0 + np.tanh(np.sqrt(2.0 / np.pi) * (v + 0.044715 * v ** 3)))
    return v


def _check_against_float64(a, b, bias, res, gelu, out_dtype):
    got = gemm.gemm_bf16(a, b, bias, res, gelu=gelu, out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == (a.shape[0], b.shape[1])
    a64, b64 = a.double().numpy(), b.double().numpy()
    v = a64 @ b64
    size = np.abs(a64) @ np.abs(b64)
    if res is not None:
        v = v + res.double().numpy()
        size = size + np.abs(res.double().numpy())
    if bias is not None:
        v = v + bias.double().numpy()
        size = size + np.abs(bias.double().numpy())
    want = _gelu64(v, gelu)
    rel = 2.0 ** -7 if out_dtype == torch.bfloat16 else 0.0
    limit = rel * np.abs(want) + 1e-5 * (size + 1.0)
    diff = np.abs(got.double().numpy() - want)
    assert (diff <= limit).all(), f"worst {np.max(diff / limit):.3g} of the bound"


@pytest.mark.parametrize("out", sorted(OUTPUTS))
@pytest.mark.parametrize("gelu", ["none", "erf", "tanh"])
@pytest.mark.parametrize("with_bias", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("residual", sorted(RESIDUALS))
def test_plain_epilogue_forms_match_float64(residual, with_bias, gelu, out):
    seed = len(residual) + 3 * len(gelu)
    a, b, bias, res = _operands(129, 136, 72, residual, with_bias, seed=seed)
    _check_against_float64(a, b, bias, res, gelu, OUTPUTS[out])


@pytest.mark.parametrize("k", [8, 72, 512])
@pytest.mark.parametrize("n", [8, 136, 512])
@pytest.mark.parametrize("m", [1, 127, 128, 129, 2056])
def test_plain_shapes_match_float64(m, n, k):
    """The shapes where a 128-row, 128- or 256-column or 64-deep tile breaks,
    with the fc2 epilogue (bf16 residual, bias) into bf16, and fc1's (bias,
    exact GELU) into fp32."""
    a, b, bias, res = _operands(m, n, k, "bf16", True, seed=m + n + k)
    _check_against_float64(a, b, bias, res, "none", torch.bfloat16)
    _check_against_float64(a, b, bias, None, "erf", torch.float32)


def _unit_operands(acc, res, res_dtype, bias):
    """a @ b == acc in every entry of a (1, 8) output (a = [acc, 0...], b = e0
    rows of ones), with the given residual and bias in every entry."""
    a = torch.zeros(1, 8, dtype=torch.bfloat16)
    a[0, 0] = acc
    b = torch.zeros(8, 8, dtype=torch.bfloat16)
    b[0] = 1.0
    return a, b, torch.full((8,), bias), torch.full((1, 8), res, dtype=res_dtype)


@pytest.mark.parametrize("case", ["residual_then_bias", "one_rounding", "gelu_last"])
def test_plain_keeps_the_epilogue_order(case):
    """Residual first, then bias, then GELU, all in fp32, one rounding."""
    if case == "residual_then_bias":
        # (1 + 2**-24) + 2**-24 rounds to 1 twice in fp32; 1 + (2**-24 + 2**-24)
        # would give 1 + 2**-23
        a, b, bias, res = _unit_operands(1.0, 2.0 ** -24, torch.float32, 2.0 ** -24)
        got = gemm.gemm_bf16(a, b, bias, res, out_dtype=torch.float32)
        assert (got == 1.0).all()
    elif case == "one_rounding":
        # 2**-8 + 1 + 2**-8 = 1 + 2**-7, a bf16 value; rounding after the
        # residual would give bf16(1 + 2**-8) = 1, and 1 again after the bias
        a, b, bias, res = _unit_operands(2.0 ** -8, 1.0, torch.bfloat16, 2.0 ** -8)
        got = gemm.gemm_bf16(a, b, bias, res)
        assert got.dtype == torch.bfloat16 and (got.float() == 1.0 + 2.0 ** -7).all()
    else:
        # gelu(0.5 + 0.25 + 0.25) = gelu(1); GELU before the residual or the
        # bias would give gelu(0.5) + 0.5 or gelu(0.75) + 0.25
        a, b, bias, res = _unit_operands(0.5, 0.25, torch.float32, 0.25)
        got = gemm.gemm_bf16(a, b, bias, res, gelu="erf", out_dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), _gelu64(np.ones((1, 8)), "erf"), rtol=1e-6)


def test_wrapper_takes_the_plain_version_on_the_cpu_without_counting():
    a, b, bias, res = _operands(33, 16, 24, "bf16", True, seed=5)
    before = gemm.gemm_bf16.launches
    got = gemm.gemm_bf16(a, b, bias, res, gelu="tanh")
    assert torch.equal(got, gemm.gemm_bf16_plain(a, b, bias, res, gelu="tanh"))
    assert gemm.gemm_bf16.launches == before


def test_kernel_launcher_refuses_what_it_does_not_take():
    a, b, bias, res = _operands(16, 16, 16, "bf16", True, seed=6)
    with pytest.raises(ValueError, match="CUDA"):
        gemm._gemm_bf16_cuda(a, b, bias, res, gelu="none", out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        gemm._gemm_bf16_cuda(a[:, :12], b[:12], bias, res, gelu="none", out_dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="out_dtype"):
        gemm._gemm_bf16_cuda(a, b, bias, res, gelu="none", out_dtype=torch.float16)
    with pytest.raises(ValueError, match="gelu"):
        gemm.gemm_bf16_plain(a, b, gelu="sigmoid")
    argtypes, _ = _SIGNATURES["duodiff_gemm_bf16"]
    assert len(argtypes) == 12


# --- the sublayers that carry the GEMM, at B * L = 129 rows -------------------

B, L, D, HEADS, HID = 3, 43, 64, 4, 256
DTYPES = {"fp32": (jnp.float32, torch.float32, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 5e-2)}
JAX_ORDER = ("ln1_s", "ln1_b", "wqkv", "bqkv", "wp", "bp", "ln2_s", "ln2_b", "w1", "b1", "w2",
             "b2")


def _block_inputs(seed=0):
    rng = np.random.RandomState(seed)
    r = lambda *s: (0.05 * rng.randn(*s)).astype(np.float32)  # noqa: E731
    x = rng.randn(B, L, D).astype(np.float32)
    p = {"ln1_s": 1.0 + r(D), "ln1_b": r(D), "wqkv": r(D, 3 * D), "bqkv": r(3 * D), "wp": r(D, D),
         "bp": r(D), "ln2_s": 1.0 + r(D), "ln2_b": r(D), "w1": r(D, HID), "b1": r(HID),
         "w2": r(HID, D), "b2": r(D)}
    return x, p


@pytest.mark.parametrize("kernel", ["K1", "K2", "K5"])
@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
def test_sublayers_match_pallas_at_ragged_rows(kernel, dtype_name):
    assert (B * L) % 128 != 0
    x, p = _block_inputs()
    jdt, tdt, tol = DTYPES[dtype_name]
    xj, xt = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    params = block_params_from_jax(p)
    attn = block.attn_operands(*params[:6], num_heads=HEADS, dtype=tdt)
    mlp = block.mlp_operands(*params[6:], dtype=tdt)
    args = [p[k] for k in JAX_ORDER]
    counters = (block.fused_attn_sublayer.launches, block.fused_mlp_sublayer.launches,
                block.fused_block.launches)
    if kernel == "K1":
        want = pb.fused_attn_sublayer(xj, *args[:6], num_heads=HEADS, interpret=True)
        got = block.fused_attn_sublayer(xt, *attn, num_heads=HEADS)
    elif kernel == "K2":
        want = pb.fused_mlp_sublayer(xj, *args[6:], gelu_approx=True, interpret=True)
        got = block.fused_mlp_sublayer(xt, *mlp, gelu_approx=True)
    else:
        want = pb.fused_block(xj, *args, num_heads=HEADS, interpret=True)
        got = block.fused_block(xt, *attn, *mlp, num_heads=HEADS)
    assert got.dtype == tdt and got.shape == xt.shape
    assert counters == (block.fused_attn_sublayer.launches, block.fused_mlp_sublayer.launches,
                        block.fused_block.launches)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


# --- the kernel sources -------------------------------------------------------

GEMM_CALLERS = ("attn_sublayer.cu", "attn_sublayer_v1.cu", "attn_sublayer_bwd.cu",
                "mlp_sublayer.cu", "fused_block.cu", "gemm_bf16.cu")


def test_gemm_source_is_the_hopper_design():
    """One design: wgmma products from a TMA-fed mbarrier ring, persistent
    blocks, warp-specialised (producer, MMA and epilogue warpgroups); no WMMA
    left in it. The mbarrier, TMA and descriptor helpers come from
    hopper.cuh, which it includes."""
    src = (CSRC_DIR / "gemm.cuh").read_text()
    assert "wmma::" not in src and "<mma.h>" not in src
    assert '#include "hopper.cuh"' in src
    src += (CSRC_DIR / "hopper.cuh").read_text()
    for needle in ("wgmma.mma_async", "cp.async.bulk.tensor", "mbarrier.try_wait.parity",
                   "const __grid_constant__ GemmProblems",
                   "CUtensorMap a[kProblems], b[kProblems];", "tile += gridDim.x",
                   "kGemmStages = 4", "mbar_wait(staged", "mbar_wait(drained"):
        assert needle in src, needle


@pytest.mark.parametrize("unit", GEMM_CALLERS)
def test_every_gemm_caller_goes_through_gemm_cuh(unit):
    src = (CSRC_DIR / unit).read_text()
    assert '#include "gemm.cuh"' in src and "launch_gemm" in src


@pytest.mark.parametrize("source", sorted(p.name for p in Path(CSRC_DIR).iterdir()
                                          if p.suffix in (".cu", ".cuh")))
def test_no_library_gemm_in_the_kernels(source):
    src = (CSRC_DIR / source).read_text().lower()
    for needle in ("cublas", "cudnn", "cutlass/gemm/device", "gemmuniversaladapter",
                   "collectivebuilder"):
        assert needle not in src, f"{source} mentions {needle}"
