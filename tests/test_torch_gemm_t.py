"""The backward GEMMs of the block kernels (duodiff_tpu_torch.ops.gemm.gemm_t
and mlp_bwd_hidden; device code csrc/gemm.cuh in the forms csrc/gemm_t.cuh
launches, and csrc/mlp_bwd_hidden.cuh) on CPU tensors, where they run their
plain PyTorch versions: against numpy in float64 in every form and at the
shapes where a tile breaks; the wrappers' refusals; the backward sublayers
that carry them (K6, K7, K8) against the Pallas kernels of
duodiff_tpu/ops/pallas_block.py run with interpret=True at a row count that
is no multiple of 128; and guards on the kernel sources.

Tolerances: against float64, |got - want| <= 2**-7 |want| (one bf16
rounding of the output; 0 for fp32 outputs) + 1e-5 * S, where S = |a| @ |b|
(plus |out| when added to) bounds the fp32 sums' error; the hidden stage's
GELU and its derivative add 1e-6 of |h| and |dh|. The sublayers: as
tests/test_torch_block_bwd.py and tests/test_torch_block_split.py (fp32 rtol
2e-4 / atol 2e-5, K8 1e-5; bf16 2e-2 relative Frobenius, K8 1e-2, and dx
elementwise within 5e-2 + 5e-2 * |want|)."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import erf

from duodiff_tpu.ops.pallas_block import (
    _attn_sublayer_bwd_impl,
    _mlp_sublayer_bwd_impl,
    _mlp_sublayer_bwd_split,
)
from duodiff_tpu_torch.ops import block, gemm
from duodiff_tpu_torch.ops._build import _SIGNATURES, CSRC_DIR

torch.set_num_threads(1)


def _bf16(rng, *shape, scale=1.0):
    return torch.from_numpy((scale * rng.randn(*shape)).astype(np.float32)).to(torch.bfloat16)


def _product64(a, b, trans_a):
    a64, b64 = a.double().numpy(), b.double().numpy()
    if trans_a:
        return a64.T @ b64, np.abs(a64.T) @ np.abs(b64)
    return a64 @ b64.T, np.abs(a64) @ np.abs(b64.T)


def _assert_within(got, want, size, rel):
    limit = rel * np.abs(want) + 1e-5 * (size + 1.0)
    diff = np.abs(got.double().numpy() - want)
    assert (diff <= limit).all(), f"worst {np.max(diff / limit):.3g} of the bound"


FORMS = ("wgrad", "nt_fp32", "nt_bf16", "nt_acc")


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("k", [8, 72, 520])
@pytest.mark.parametrize("n", [8, 136])
@pytest.mark.parametrize("rows", [1, 127, 129, 300])
def test_plain_forms_match_float64(rows, n, k, form):
    """Every form at the shapes where a 128-row tile, a 128-column tile or a
    64-deep slab breaks. A weight gradient contracts over `rows` into a (k,
    n) output (k a multiple of 8, as its stored (K, M) operand needs)."""
    rng = np.random.RandomState(rows + n + k)
    if form == "wgrad":
        a, b = _bf16(rng, rows, k), _bf16(rng, rows, n, scale=rows ** -0.5)
        got = gemm.gemm_t(a, b, trans_a=True)
        want, size = _product64(a, b, True)
        assert got.dtype == torch.float32 and got.shape == (k, n)
        _assert_within(got, want, size, 0.0)
        return
    a, b = _bf16(rng, rows, k), _bf16(rng, n, k, scale=k ** -0.5)
    want, size = _product64(a, b, False)
    if form == "nt_acc":
        out = torch.from_numpy(rng.randn(rows, n).astype(np.float32))
        start = out.double().numpy().copy()
        got = gemm.gemm_t(a, b, trans_a=False, out=out)
        assert got is out
        _assert_within(got, start + want, size + np.abs(start), 0.0)
        return
    out_dtype = torch.bfloat16 if form == "nt_bf16" else torch.float32
    got = gemm.gemm_t(a, b, trans_a=False, out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == (rows, n)
    _assert_within(got, want, size, 2.0 ** -7 if form == "nt_bf16" else 0.0)


def test_accumulate_adds_the_product_to_what_out_holds():
    """C + (A B^T) in one fp32 rounding: 1 + 2**-24 stays 1 in fp32, and the
    product is added to the value out holds, not to a copy."""
    a = torch.zeros(1, 8, dtype=torch.bfloat16)
    a[0, 0] = 2.0 ** -12
    b = torch.zeros(8, 8, dtype=torch.bfloat16)
    b[:, 0] = 2.0 ** -12
    out = torch.ones(1, 8)
    got = gemm.gemm_t(a, b, trans_a=False, out=out)
    assert got is out and (out == 1.0).all()


def _gelu64(h, mode):
    if mode == "erf":
        cdf = 0.5 * (1.0 + erf(h / np.sqrt(2.0)))
        return h * cdf, cdf + h * np.exp(-0.5 * h * h) / np.sqrt(2.0 * np.pi)
    c, a = np.sqrt(2.0 / np.pi), 0.044715
    t = np.tanh(c * (h + a * h ** 3))
    return 0.5 * h * (1.0 + t), 0.5 * (1.0 + t) + 0.5 * h * (1.0 - t * t) * c * (1 + 3 * a * h * h)


@pytest.mark.parametrize("gelu", ["erf", "tanh"])
@pytest.mark.parametrize("hid", [8, 136, 264])
@pytest.mark.parametrize("d", [8, 72])
@pytest.mark.parametrize("rows", [1, 127, 129])
def test_plain_hidden_stage_matches_float64(rows, d, hid, gelu):
    """hgb = bf16(gelu(h)), dhp = bf16(dh gelu'(h)) and db1 = the column
    sums of the unrounded dh gelu'(h), h = xn W1 + b1, dh = dy W2^T."""
    rng = np.random.RandomState(rows + d + hid)
    xn, dy = _bf16(rng, rows, d), _bf16(rng, rows, d)
    w1, w2 = _bf16(rng, d, hid, scale=d ** -0.5), _bf16(rng, hid, d, scale=d ** -0.5)
    b1 = torch.from_numpy((0.1 * rng.randn(hid)).astype(np.float32))
    hgb, dhp, db1 = gemm.mlp_bwd_hidden(xn, w1, b1, dy, w2, gelu=gelu)
    assert (hgb.dtype, dhp.dtype, db1.dtype) == (torch.bfloat16, torch.bfloat16, torch.float32)
    h = xn.double().numpy() @ w1.double().numpy() + b1.double().numpy()
    h_size = np.abs(xn.double().numpy()) @ np.abs(w1.double().numpy()) + np.abs(b1.numpy())
    dh = dy.double().numpy() @ w2.double().numpy().T
    dh_size = np.abs(dy.double().numpy()) @ np.abs(w2.double().numpy().T)
    g, dg = _gelu64(h, gelu)
    # GELU moves by at most ~1.1 |dh| per unit of h; its derivative by ~0.6
    _assert_within(hgb, g, 1.2 * h_size + 0.1 * np.abs(h), 2.0 ** -7)
    _assert_within(dhp, dh * dg, 1.2 * dh_size + np.abs(dh) * (h_size + 0.1), 2.0 ** -7)
    _assert_within(db1, (dh * dg).sum(0), (1.2 * dh_size + np.abs(dh) * (h_size + 0.1)).sum(0),
                   0.0)


def test_hidden_stage_plain_is_what_k7_plain_computes():
    """The hidden stage's plain version gives K7's plain dW2 and db1 inputs:
    hgb^T dy and the db1 of mlp_sublayer_bwd_plain, to the bit in fp32."""
    rng = np.random.RandomState(9)
    rows, d, hid = 65, 16, 64
    x, dy = (torch.from_numpy(rng.randn(1, rows, d).astype(np.float32)) for _ in range(2))
    ln_s, ln_b = torch.ones(d), torch.zeros(d)
    w1 = torch.from_numpy((0.2 * rng.randn(d, hid)).astype(np.float32))
    w2 = torch.from_numpy((0.2 * rng.randn(hid, d)).astype(np.float32))
    b1 = torch.from_numpy((0.1 * rng.randn(hid)).astype(np.float32))
    want = block.mlp_sublayer_bwd_plain(x, dy, ln_s, ln_b, w1, b1, w2)
    xn = block._layer_norm(x.float(), ln_s, ln_b, 1e-5)[0]
    hgb, _, db1 = gemm.mlp_bwd_hidden_plain(xn, w1, b1, dy[0], w2)
    assert torch.equal(db1, want[4])
    assert torch.allclose(hgb.float().t() @ dy[0], want[5], rtol=2e-2, atol=2e-2)


def test_wrappers_take_the_plain_version_on_the_cpu_without_counting():
    rng = np.random.RandomState(5)
    a, b = _bf16(rng, 40, 16), _bf16(rng, 40, 24)
    before = gemm.gemm_t.launches, gemm.mlp_bwd_hidden.launches
    assert torch.equal(gemm.gemm_t(a, b, trans_a=True), gemm.gemm_t_plain(a, b, trans_a=True))
    xn, dy = _bf16(rng, 9, 16), _bf16(rng, 9, 16)
    w1, w2 = _bf16(rng, 16, 32), _bf16(rng, 32, 16)
    b1 = torch.zeros(32)
    got = gemm.mlp_bwd_hidden(xn, w1, b1, dy, w2, gelu="tanh")
    want = gemm.mlp_bwd_hidden_plain(xn, w1, b1, dy, w2, gelu="tanh")
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (gemm.gemm_t.launches, gemm.mlp_bwd_hidden.launches) == before


def _misaligned(t):
    """A bf16 view of t's values that starts 2 bytes past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 8, dtype=t.dtype)
    view = flat[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16
    return view


@pytest.mark.parametrize("case", ["n_mod_8", "m_mod_8_transposed_a", "k_mod_8", "misaligned",
                                  "fp32_only_weight_grad", "cpu_tensor"])
def test_kernel_launcher_refuses_what_it_does_not_take(case):
    """What the kernel's launcher refuses, the wrapper refuses before it:
    N % 8, M % 8 with A stored (K, M), K % 8 where both operands are read
    along K, a misaligned operand (the TMA loads), a bf16 weight gradient,
    and (the launcher only) tensors that are not on the card."""
    rng = np.random.RandomState(6)
    kwargs = {"out_dtype": torch.float32, "out": None, "splits": 0}
    if case == "n_mod_8":
        args, msg = (_bf16(rng, 16, 16), _bf16(rng, 12, 16), False), "N must be"
    elif case == "m_mod_8_transposed_a":
        args, msg = (_bf16(rng, 16, 12), _bf16(rng, 16, 16), True), "M must be"
    elif case == "k_mod_8":
        args, msg = (_bf16(rng, 16, 12), _bf16(rng, 16, 12), False), "K must be"
    elif case == "misaligned":
        args, msg = (_misaligned(_bf16(rng, 16, 16)), _bf16(rng, 16, 16), False), "aligned"
    elif case == "fp32_only_weight_grad":
        args, msg = (_bf16(rng, 16, 16), _bf16(rng, 16, 16), True), "fp32"
        kwargs["out_dtype"] = torch.bfloat16
    else:
        args, msg = (_bf16(rng, 16, 16), _bf16(rng, 16, 16), False), "CUDA"
    a, b, trans_a = args
    with pytest.raises(ValueError, match=msg):
        gemm._gemm_t_cuda(a, b, trans_a=trans_a, **kwargs)
    if case in ("n_mod_8", "m_mod_8_transposed_a", "k_mod_8"):
        with pytest.raises(ValueError, match=msg):
            gemm.gemm_t(a, b, trans_a=trans_a)


@pytest.mark.parametrize("case", ["hidden_mod_8", "misaligned", "gelu", "cpu_tensor"])
def test_hidden_launcher_refuses_what_it_does_not_take(case):
    rng = np.random.RandomState(7)
    xn, dy = _bf16(rng, 9, 16), _bf16(rng, 9, 16)
    w1, w2, b1 = _bf16(rng, 16, 32), _bf16(rng, 32, 16), torch.zeros(32)
    gelu, msg = "erf", "CUDA"
    if case == "hidden_mod_8":
        w1, w2, b1, msg = w1[:, :28].contiguous(), w2[:28].contiguous(), b1[:28], "multiples of 8"
    elif case == "misaligned":
        xn, msg = _misaligned(xn), "aligned"
    elif case == "gelu":
        gelu, msg = "none", "gelu"
    with pytest.raises(ValueError, match=msg):
        gemm._mlp_bwd_hidden_cuda(xn, w1, b1, dy, w2, gelu=gelu)


def test_entries_are_declared():
    assert len(_SIGNATURES["duodiff_gemm_t"][0]) == 10
    assert len(_SIGNATURES["duodiff_mlp_bwd_hidden"][0]) == 14
    for name in ("duodiff_gemm_t_splits", "duodiff_gemm_t_flag_bytes", "duodiff_gemm_t_layout",
                 "duodiff_mlp_bwd_hidden_part_bytes"):
        assert name in _SIGNATURES


# --- K6, K7, K8 at B * L = 129 rows against the Pallas kernels -----------------

B, L, D, HEADS, HID = 3, 43, 64, 4, 256
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
NAMES = {"K6": ("dx", "dg", "db", "dwqkv", "dbqkv", "dwp", "dbp"),
         "K7": ("dx", "dg", "db", "dw1", "db1", "dw2", "db2")}


def _sublayer_inputs(seed=0):
    rng = np.random.RandomState(seed)
    r = lambda *s: (0.05 * rng.randn(*s)).astype(np.float32)  # noqa: E731
    x = rng.randn(B, L, D).astype(np.float32)
    dy = rng.randn(B, L, D).astype(np.float32)
    p = {"ln_s": 1.0 + r(D), "ln_b": r(D), "wqkv": r(D, 3 * D), "bqkv": r(3 * D),
         "wp": r(D, D), "w1": r(D, HID), "b1": r(HID), "w2": r(HID, D)}
    return x, dy, p


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _compare(names, got, want, dtype_name, fp32_tol, bf16_rel):
    for name, g, w in zip(names, got, want):
        if w is None:
            assert g is None, name
            continue
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        assert g.shape == w.shape, name
        if dtype_name == "fp32":
            np.testing.assert_allclose(g, w, rtol=fp32_tol[0], atol=fp32_tol[1], err_msg=name)
            continue
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= bf16_rel, (name, rel)
        if name == "dx":
            np.testing.assert_allclose(g, w, rtol=5e-2, atol=5e-2, err_msg=name)


@pytest.mark.parametrize("case", ["K6", "K6_qkv_bias", "K7_erf", "K7_tanh", "K8_2", "K8_4"])
@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
def test_backward_sublayers_match_pallas_at_ragged_rows(case, dtype_name):
    assert (B * L) % 128 != 0
    x, dy, p = _sublayer_inputs()
    jdt, tdt = DTYPES[dtype_name]
    xj, dyj = jnp.asarray(x, jdt), jnp.asarray(dy, jdt)
    counters = (block.fused_attn_sublayer_bwd.launches, block.fused_mlp_sublayer_bwd.launches,
                block.fused_mlp_sublayer_bwd_split.launches)
    mlp = (_t(x, tdt), _t(dy, tdt), _t(p["ln_s"]), _t(p["ln_b"]), _t(p["w1"], tdt), _t(p["b1"]),
           _t(p["w2"], tdt))
    if case.startswith("K6"):
        bqkv = p["bqkv"] if case == "K6_qkv_bias" else None
        want = _attn_sublayer_bwd_impl(xj, dyj, p["ln_s"], p["ln_b"], p["wqkv"], bqkv, p["wp"],
                                       num_heads=HEADS, eps=1e-5, interpret=True)
        got = block.fused_attn_sublayer_bwd(_t(x, tdt), _t(dy, tdt), _t(p["ln_s"]),
                                            _t(p["ln_b"]), _t(p["wqkv"], tdt), _t(bqkv),
                                            _t(p["wp"], tdt), num_heads=HEADS)
        _compare(NAMES["K6"], got, want, dtype_name, (2e-4, 2e-5), 2e-2)
    elif case.startswith("K7"):
        approx = case == "K7_tanh"
        want = _mlp_sublayer_bwd_impl(xj, dyj, p["ln_s"], p["ln_b"], p["w1"], p["b1"], p["w2"],
                                      eps=1e-5, gelu_approx=approx, interpret=True)
        got = block.fused_mlp_sublayer_bwd(*mlp, gelu_approx=approx)
        _compare(NAMES["K7"], got, want, dtype_name, (2e-4, 2e-5), 2e-2)
    else:
        splits = int(case[-1])
        want = _mlp_sublayer_bwd_split(xj, dyj, p["ln_s"], p["ln_b"], p["w1"], p["b1"], p["w2"],
                                       eps=1e-5, gelu_approx=False, interpret=True,
                                       config=(splits, 16, 64))
        got = block.fused_mlp_sublayer_bwd_split(*mlp, splits=splits)
        _compare(NAMES["K7"], got, want, dtype_name, (1e-5, 1e-5), 1e-2)
    assert got[0].dtype == tdt
    assert counters == (block.fused_attn_sublayer_bwd.launches,
                        block.fused_mlp_sublayer_bwd.launches,
                        block.fused_mlp_sublayer_bwd_split.launches)


# --- the kernel sources ---------------------------------------------------------

BWD_UNITS = ("attn_sublayer_bwd.cu", "mlp_sublayer_bwd.cu", "mlp_sublayer_bwd_split.cu",
             "gemm_t_entry.cu")


def _included(unit):
    """The unit's source and every csrc header it includes, transitively."""
    seen, todo, text = set(), [unit], ""
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        src = (CSRC_DIR / name).read_text()
        text += src
        todo += re.findall(r'#include "([^"]+)"', src)
    return text


@pytest.mark.parametrize("unit", BWD_UNITS)
def test_no_wmma_in_a_backward_unit(unit):
    src = _included(unit)
    assert "wmma::" not in src and "<mma.h>" not in src and "nvcuda" not in src


@pytest.mark.parametrize("header", ["gemm.cuh", "mlp_bwd_hidden.cuh"])
def test_backward_products_are_wgmma_from_a_tma_ring(header):
    """Persistent, warp-specialised blocks: wgmma products from shared memory
    that a TMA producer fills through a full / empty mbarrier ring, an
    epilogue handed each staged tile by mbarriers."""
    src = (CSRC_DIR / header).read_text()
    assert '#include "hopper.cuh"' in src
    for needle in ("wgmma.mma_async", "tma_load_2d(", "mbar_wait(&full[s]", "mbar_wait(&empty[s]",
                   "tile += gridDim.x", "mbar_wait(staged", "mbar_wait(drained",
                   "__launch_bounds__(k"):
        assert needle in src, (header, needle)
    # the TMA maps reach the kernel as grid constants, one by one or in the
    # GEMM's operand struct (one or two products a launch)
    assert ("const __grid_constant__ CUtensorMap" in src
            or ("const __grid_constant__ GemmProblems" in src
                and "CUtensorMap a[kProblems], b[kProblems];" in src)), header
    hopper = (CSRC_DIR / "hopper.cuh").read_text()
    for needle in ("cp.async.bulk.tensor", "mbarrier.try_wait.parity", "ld.acquire.gpu",
                   "st.release.gpu", "__trap()"):
        assert needle in hopper, needle


@pytest.mark.parametrize("unit", BWD_UNITS[:3])
def test_every_backward_caller_goes_through_the_one_design(unit):
    """No GEMM kernel of its own in a backward unit: the products go through
    gemm_t.cuh's launchers over gemm.cuh and the hidden stage."""
    src = (CSRC_DIR / unit).read_text()
    assert '#include "gemm_t.cuh"' in src
    assert "launch_weight_grad(" in src or "launch_weight_grad_pair(" in src
    assert "__global__" not in src
    assert "launch_gemm_nt" in src
    if unit.startswith("mlp"):
        assert "launch_mlp_bwd_hidden(" in src
    gemm_t = (CSRC_DIR / "gemm_t.cuh").read_text()
    assert '#include "gemm.cuh"' in gemm_t and "__global__" not in gemm_t
    assert gemm_t.count("launch_gemm_form<") >= 3


@pytest.mark.parametrize("source", sorted(p.name for p in Path(CSRC_DIR).iterdir()
                                          if p.suffix in (".cu", ".cuh")))
def test_no_floating_point_atomic(source):
    """Every reduction is summed in a fixed order: no atomicAdd (the split
    flags are plain acquire / release loads and stores of ints)."""
    src = (CSRC_DIR / source).read_text()
    assert "atomicAdd" not in src and "red.global.add.f" not in src and "atom.global.add.f" not in src


def test_weight_gradient_scratch_is_the_flags():
    """The 16 fp32 partials of a weight gradient are gone from every
    backward workspace: the row splits need one int a tile."""
    for unit in BWD_UNITS[:3]:
        src = (CSRC_DIR / unit).read_text()
        assert "kMaxSplits" not in src and "w.flags = take(" in src
