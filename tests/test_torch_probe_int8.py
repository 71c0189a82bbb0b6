"""The port's int8 probe tools and their kernels' plain versions (K13, K14:
``duodiff_tpu_torch.ops.block_int8``; K15: ``duodiff_tpu_torch.ops.sdpa_int8``)
against the kernel bodies of the repository's ``tools/probe_int8_static.py``
and ``tools/probe_int8_sdpa.py``, on the same numpy inputs.

The probes' own ``pallas_call``s take no ``interpret`` argument, so the tests
load the tool files, take the kernel bodies, and wrap them in a
``pl.pallas_call(..., interpret=True)`` of their own, one sample a grid step
(the bodies read the module globals ``H`` and ``G``, set here).

Tolerances:
- K13, K14 (bf16 outputs): atol = rtol = 2e-2, the bound
  tests/test_torch_int8.py holds K11 and K12 to: the same math up to the
  order of fp32 sums, which can move an activation across an int8 rounding
  boundary; weight codes equal;
- K15 bf16 form: atol = 5e-2, the JAX tests' bf16 bound (achieved: 0 at
  L = 37 and 9.8e-4 at L = 257, printed by the test);
- K15 int8 form: relative Frobenius error <= 1e-2 (achieved: 0 at L = 37 and
  5.4e-5 at L = 257: exp differs in the last place between XLA and torch,
  which flips a code of e now and then); the codes of q, k, v and e equal a
  numpy reproduction's;
- int8 against bf16 on the same inputs: relative L2 between 5e-3 and 5e-2.
"""

import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from duodiff_tpu.ops import pallas_block_int8 as pbi
from duodiff_tpu_torch.ops import block_int8 as q8
from duodiff_tpu_torch.ops import sdpa_int8
from duodiff_tpu_torch.tools import probe_int8_sdpa, probe_int8_static, probe_mlp_bwd_split

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
D, HEADS, HID = 128, 2, 512
TOL = 2e-2
MLP_SCALES, ATTN_SCALES = (8.0, 6.0), (8.0, 4.0)


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_static():
    mod = _load_tool("probe_int8_static")
    mod.H = HEADS
    return mod


@pytest.fixture(scope="module")
def jax_sdpa():
    mod = _load_tool("probe_int8_sdpa")
    mod.G = 1
    return mod


def _sublayer_call(body, x, args):
    """The probe's pallas_call around a sublayer body, one sample a grid step,
    in interpret mode; every operand but x is whole in every step."""
    b, l, d = x.shape
    row = pl.BlockSpec((1, l, d), lambda i: (i, 0, 0))
    whole = [pl.BlockSpec(a.shape, lambda i: (0, 0)) for a in args]
    return pl.pallas_call(body, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype), grid=(b,),
                          in_specs=[row, *whole], out_specs=row, interpret=True)(x, *args)


def _operands(seq_len, seed=0):
    """x and the four fp32 kernels of a block, drawn as the probe draws them."""
    rng = np.random.RandomState(seed)
    return {
        "x": rng.randn(2, seq_len, D).astype(np.float32),
        "gamma": (rng.randn(1, D) * 0.1 + 1.0).astype(np.float32),
        "beta": (rng.randn(1, D) * 0.1).astype(np.float32),
        "w1": (rng.randn(D, HID) * 0.02).astype(np.float32),
        "w2": (rng.randn(HID, D) * 0.02).astype(np.float32),
        "wqkv": (rng.randn(D, 3 * D) * 0.02).astype(np.float32),
        "wp": (rng.randn(D, D) * 0.02).astype(np.float32),
    }


def _torch_packed(w, extra=None):
    w8, s = q8.quantize_weight_int8(torch.from_numpy(w), extra_col_scale=extra)
    return w8.t().contiguous(), s


def _assert_close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# --- K13: the MLP twins ----------------------------------------------------------


@pytest.mark.parametrize("seq_len", [37, 257])
@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_k13_mlp_plain_matches_the_probe_bodies(jax_static, seq_len, mode):
    o = _operands(seq_len)
    xj = jnp.asarray(o["x"], jnp.bfloat16)
    w1_8, s1 = pbi.quantize_weight_int8(jnp.asarray(o["w1"]))
    w2_8, s2 = pbi.quantize_weight_int8(jnp.asarray(o["w2"]))
    b1, b2 = jnp.zeros((1, HID), jnp.float32), jnp.zeros((1, D), jnp.float32)
    t1_8, t_s1 = _torch_packed(o["w1"])
    t2_8, t_s2 = _torch_packed(o["w2"])
    np.testing.assert_array_equal(t1_8.numpy().T, np.asarray(w1_8))
    np.testing.assert_array_equal(t2_8.numpy().T, np.asarray(w2_8))
    sx, sh = MLP_SCALES
    inv = None
    if mode == "static":
        body = jax_static.functools.partial(jax_static._mlp_kernel_static,
                                            inv_x=127.0 / sx, inv_h=127.0 / sh)
        s1, s2 = s1 * (sx / 127.0), s2 * (sh / 127.0)
        t_s1, t_s2 = t_s1 * (sx / 127.0), t_s2 * (sh / 127.0)
        inv = q8.static_inv(MLP_SCALES)
    else:
        body = jax_static._mlp_kernel_dyn
    want = _sublayer_call(body, xj, (jnp.asarray(o["gamma"]), jnp.asarray(o["beta"]),
                                     w1_8, s1, b1, w2_8, s2, b2))
    xt = torch.from_numpy(o["x"]).to(torch.bfloat16)
    got = q8.mlp_sublayer_int8_plain(
        xt, torch.from_numpy(o["gamma"][0]), torch.from_numpy(o["beta"][0]), t1_8, t_s1,
        torch.zeros(HID), t2_8, t_s2, torch.zeros(D), inv, gelu_approx=True)
    assert got.dtype == torch.bfloat16 and got.shape == xt.shape
    _assert_close(got, want)
    # the probe's route equals the model's: the wrapper on packed modules' operands
    assert torch.equal(got, q8.fused_mlp_sublayer_int8(
        xt, torch.from_numpy(o["gamma"][0]), torch.from_numpy(o["beta"][0]), t1_8, t_s1,
        torch.zeros(HID), t2_8, t_s2, torch.zeros(D), inv, gelu_approx=True))


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_k13_mlp_plain_matches_the_package_kernel(mode):
    """The same operands through duodiff_tpu's own K12 in interpret mode."""
    o = _operands(37, seed=1)
    static = MLP_SCALES if mode == "static" else None
    want = pbi.fused_mlp_sublayer_int8(
        jnp.asarray(o["x"], jnp.bfloat16), o["gamma"][0], o["beta"][0], o["w1"],
        np.zeros(HID, np.float32), o["w2"], np.zeros(D, np.float32), gelu_approx=True,
        interpret=True, static_scales=static)
    t1_8, s1 = _torch_packed(o["w1"])
    t2_8, s2 = _torch_packed(o["w2"])
    inv = None
    if static:
        s1, s2 = s1 * (static[0] / 127.0), s2 * (static[1] / 127.0)
        inv = q8.static_inv(static)
    got = q8.mlp_sublayer_int8_plain(
        torch.from_numpy(o["x"]).to(torch.bfloat16), torch.from_numpy(o["gamma"][0]),
        torch.from_numpy(o["beta"][0]), t1_8, s1, torch.zeros(HID), t2_8, s2, torch.zeros(D),
        inv, gelu_approx=True)
    _assert_close(got, want)


# --- K14: the attention twins ----------------------------------------------------


def _attn_sides(o, scales):
    """(JAX args, torch args) of the attention sublayer; ``scales`` None: dynamic."""
    softmax_scale = (D // HEADS) ** -0.5
    col = np.concatenate([np.full((1, D), softmax_scale, np.float32),
                          np.ones((1, 2 * D), np.float32)], axis=1)
    wqkv8, sqkv = pbi.quantize_weight_int8(jnp.asarray(o["wqkv"]),
                                           extra_col_scale=jnp.asarray(col))
    wp8, sp = pbi.quantize_weight_int8(jnp.asarray(o["wp"]))
    tqkv8, t_sqkv = _torch_packed(o["wqkv"], torch.from_numpy(col[0]))
    tp8, t_sp = _torch_packed(o["wp"])
    np.testing.assert_array_equal(tqkv8.numpy().T, np.asarray(wqkv8))
    np.testing.assert_array_equal(tp8.numpy().T, np.asarray(wp8))
    inv = None
    if scales is not None:
        sx, sm = scales
        sqkv, sp = sqkv * (sx / 127.0), sp * (sm / 127.0)
        t_sqkv, t_sp = t_sqkv * (sx / 127.0), t_sp * (sm / 127.0)
        inv = q8.static_inv(scales)
    bp = jnp.zeros((1, D), jnp.float32)
    jax_args = (jnp.asarray(o["gamma"]), jnp.asarray(o["beta"]), wqkv8, sqkv, wp8, sp, bp)
    torch_args = (torch.from_numpy(o["gamma"][0]), torch.from_numpy(o["beta"][0]), tqkv8, t_sqkv,
                  None, tp8, t_sp, torch.zeros(D), inv)
    return jax_args, torch_args


@pytest.mark.parametrize("seq_len", [37, 257])
@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_k14_attn_plain_matches_the_probe_bodies(jax_static, seq_len, mode):
    o = _operands(seq_len, seed=2)
    scales = ATTN_SCALES if mode == "static" else None
    jax_args, torch_args = _attn_sides(o, scales)
    body = jax_static._attn_kernel_dyn
    if scales:
        body = jax_static.functools.partial(jax_static._attn_kernel_static,
                                            inv_x=127.0 / scales[0], inv_m=127.0 / scales[1])
    want = _sublayer_call(body, jnp.asarray(o["x"], jnp.bfloat16), jax_args)
    xt = torch.from_numpy(o["x"]).to(torch.bfloat16)
    got = q8.attn_sublayer_int8_plain(xt, *torch_args, num_heads=HEADS)
    assert got.dtype == torch.bfloat16 and got.shape == xt.shape
    _assert_close(got, want)
    assert torch.equal(got, q8.fused_attn_sublayer_int8(xt, *torch_args, num_heads=HEADS))


def test_k14_static_scales_change_the_result_and_count_nothing_on_the_cpu():
    o = _operands(37, seed=3)
    xt = torch.from_numpy(o["x"]).to(torch.bfloat16)
    dyn = q8.fused_attn_sublayer_int8(xt, *_attn_sides(o, None)[1], num_heads=HEADS)
    before = (q8.fused_attn_sublayer_int8.launches, q8.fused_attn_sublayer_int8.launches_static)
    sta = q8.fused_attn_sublayer_int8(xt, *_attn_sides(o, ATTN_SCALES)[1], num_heads=HEADS)
    assert not torch.equal(dyn, sta)
    assert (q8.fused_attn_sublayer_int8.launches,
            q8.fused_attn_sublayer_int8.launches_static) == before


def test_k14_a_small_static_scale_saturates(jax_static):
    """sx = sm = 0.5 clips most codes: they saturate at +-127 and never wrap,
    and the plain version still follows the Pallas body."""
    o = _operands(37, seed=4)
    scales = (0.5, 0.5)
    jax_args, torch_args = _attn_sides(o, scales)
    xt = torch.from_numpy(o["x"]).to(torch.bfloat16)
    xn = torch.nn.functional.layer_norm(xt.float(), (D,), torch_args[0], torch_args[1], 1e-5)
    codes = q8._quant_rows_static(xn, torch_args[-1][0])
    assert codes.dtype == torch.int8 and int(codes.min()) == -127 and int(codes.max()) == 127
    assert ((xn * torch_args[-1][0]).abs() > 127).float().mean() > 0.1  # many values clip
    assert torch.equal(codes.float().sign(), torch.sign(torch.round(xn * torch_args[-1][0])))
    body = jax_static.functools.partial(jax_static._attn_kernel_static,
                                        inv_x=127.0 / 0.5, inv_m=127.0 / 0.5)
    want = _sublayer_call(body, jnp.asarray(o["x"], jnp.bfloat16), jax_args)
    _assert_close(q8.attn_sublayer_int8_plain(xt, *torch_args, num_heads=HEADS), want)


def test_static_inv_refuses_bad_scales():
    np.testing.assert_array_equal(q8.static_inv((8.0, 4.0)).numpy(),
                                  np.asarray([127.0 / 8.0, 127.0 / 4.0], np.float32))
    for bad in ((0.0, 1.0), (1.0, -2.0), (1.0,)):
        with pytest.raises(ValueError, match="> 0"):
            q8.static_inv(bad)


# --- K15: the attention chain ----------------------------------------------------


def _sdpa_call(body, q, k, v):
    b, h, l, dh = q.shape
    spec = pl.BlockSpec((1, h, l, dh), lambda i: (i, 0, 0, 0))
    return pl.pallas_call(body, grid=(b,), in_specs=[spec, spec, spec], out_specs=spec,
                          out_shape=jax.ShapeDtypeStruct(q.shape, jnp.bfloat16),
                          interpret=True)(q, k, v)


def _qkv(batch, seq_len, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(batch, HEADS, seq_len, 64).astype(np.float32) for _ in range(3))


def _both(arrays):
    return (tuple(jnp.asarray(a, jnp.bfloat16) for a in arrays),
            tuple(torch.from_numpy(a).to(torch.bfloat16) for a in arrays))


@pytest.mark.parametrize("batch,seq_len", [(2, 37), (1, 257)])
def test_k15_bf16_plain_matches_the_probe_body(jax_sdpa, batch, seq_len):
    jax_sdpa.H = HEADS
    (qj, kj, vj), (qt, kt, vt) = _both(_qkv(batch, seq_len))
    want = np.asarray(_sdpa_call(jax_sdpa._sdpa_bf16_kernel, qj, kj, vj), np.float32)
    got = sdpa_int8.sdpa_chain_bf16_plain(qt, kt, vt)
    assert got.dtype == torch.bfloat16 and got.shape == qt.shape
    err = np.abs(got.float().numpy() - want).max()
    print(f"K15 bf16 plain vs Pallas body, L={seq_len}: max abs err {err:.3g}")
    assert err <= 5e-2
    assert torch.equal(got, sdpa_int8.sdpa_chain_bf16(qt, kt, vt))  # CPU: the plain version


@pytest.mark.parametrize("batch,seq_len", [(2, 37), (1, 257)])
def test_k15_int8_plain_matches_the_probe_body(jax_sdpa, batch, seq_len):
    jax_sdpa.H = HEADS
    (qj, kj, vj), (qt, kt, vt) = _both(_qkv(batch, seq_len, seed=1))
    want = np.asarray(_sdpa_call(jax_sdpa._sdpa_int8_kernel, qj, kj, vj), np.float32)
    got = sdpa_int8.sdpa_chain_int8_plain(qt, kt, vt).float().numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    print(f"K15 int8 plain vs Pallas body, L={seq_len}: rel fro err {rel:.3g}")
    assert rel <= 1e-2
    bf = sdpa_int8.sdpa_chain_bf16_plain(qt, kt, vt).float().numpy()
    from_bf16 = np.linalg.norm(got - bf) / np.linalg.norm(bf)
    assert 5e-3 <= from_bf16 <= 5e-2, from_bf16
    assert torch.equal(sdpa_int8.sdpa_chain_int8(qt, kt, vt).float(), torch.from_numpy(got))


def _np_quant_rows(x, axis):
    amax = np.abs(x).max(axis=axis, keepdims=True)
    inv = np.where(amax > 0, np.float32(127.0) / np.where(amax > 0, amax, 1), np.float32(1.0))
    return np.clip(np.rint(x * inv.astype(np.float32)), -127, 127).astype(np.int8), amax


def test_k15_codes_equal_a_numpy_reproduction():
    """q, k per row, v per column over the tokens, e as rint(e * 127): the
    codes of the plain version are those numpy computes from the same bf16
    inputs; the scores are rebuilt from the codes in int64."""
    _, (qt, kt, vt) = _both(_qkv(1, 37, seed=2))
    parts = sdpa_int8.sdpa_int8_parts(qt, kt, vt)
    qf, kf, vf = (t.float().numpy() for t in (qt, kt, vt))
    q8_, qmax = _np_quant_rows(qf, -1)
    k8_, kmax = _np_quant_rows(kf, -1)
    v8_, vmax = _np_quant_rows(vf, -2)
    np.testing.assert_array_equal(parts["q8"].numpy(), q8_)
    np.testing.assert_array_equal(parts["k8"].numpy(), k8_)
    np.testing.assert_array_equal(parts["v8"].numpy(), v8_)
    np.testing.assert_array_equal(parts["vmax"].numpy(), vmax)
    np.testing.assert_array_equal(parts["sq"].numpy(), qmax / np.float32(127.0))
    s32 = q8_.astype(np.int64) @ k8_.astype(np.int64).swapaxes(-1, -2)
    sq, sk = qmax / np.float32(127.0), kmax / np.float32(127.0)
    s = s32.astype(np.float32) * (sq * sk.swapaxes(-1, -2))
    e = torch.exp(torch.from_numpy(s - s.max(-1, keepdims=True))).numpy()
    e8 = np.rint(e * np.float32(127.0)).astype(np.int8)
    np.testing.assert_array_equal(parts["e8"].numpy(), e8)
    assert e8.min() >= 0 and e8.max() == 127  # the row maximum's e is 1: no clip needed


def test_k15_zero_rows_and_columns_stay_finite(jax_sdpa):
    """An all-zero q row and k row (inv = 1, scale 0) and an all-zero v column
    (vmax 0): finite outputs, the zero column stays zero, and the plain version
    still follows the Pallas body."""
    jax_sdpa.H = HEADS
    q, k, v = _qkv(1, 37, seed=3)
    q[0, 0, 5] = 0.0
    k[0, 1, 7] = 0.0
    v[0, :, :, 11] = 0.0
    (qj, kj, vj), (qt, kt, vt) = _both((q, k, v))
    got = sdpa_int8.sdpa_chain_int8_plain(qt, kt, vt).float()
    assert bool(torch.isfinite(got).all()) and float(got[..., 11].abs().max()) == 0.0
    want = np.asarray(_sdpa_call(jax_sdpa._sdpa_int8_kernel, qj, kj, vj), np.float32)
    assert np.linalg.norm(got.numpy() - want) / np.linalg.norm(want) <= 1e-2
    # a zero q row scores every key alike: its output is the mean of v's codes' values
    np.testing.assert_allclose(got[0, 0, 5].numpy(), vt[0, 0].float().mean(0).numpy(), atol=2e-2)


def test_k15_launchers_refuse_what_the_kernels_do_not_take():
    _, (qt, kt, vt) = _both(_qkv(1, 37))
    for fn in (sdpa_int8.sdpa_chain_bf16, sdpa_int8.sdpa_chain_int8):
        before = fn.launches
        fn(qt, kt, vt)
        assert fn.launches == before  # the CPU path launches nothing
    with pytest.raises(ValueError, match="head width 64"):
        sdpa_int8._launch("duodiff_sdpa_chain_int8", "duodiff_sdpa_int8_smem_bytes", "core",
                          qt[..., :32], kt[..., :32], vt[..., :32])
    with pytest.raises(TypeError, match="bfloat16"):
        sdpa_int8._launch("duodiff_sdpa_chain_int8", "duodiff_sdpa_int8_smem_bytes", "core",
                          qt.float(), kt.float(), vt.float())


class _CoreLimits:
    """Stands in for the loaded kernel library: it knows both cores' longest
    sequence and the int8 core's shared memory, and has no kernel entry, so
    a call that got past the checks fails with AttributeError."""

    @staticmethod
    def duodiff_attn_core_max_len():
        return 272

    @staticmethod
    def duodiff_sdpa_int8_max_len():
        return 272

    @staticmethod
    def duodiff_sdpa_int8_smem_bytes(length):
        return 43584


@pytest.mark.parametrize("entry, smem_entry", [
    ("duodiff_sdpa_chain_int8", "duodiff_sdpa_int8_smem_bytes"), ("duodiff_sdpa_chain_bf16", None),
], ids=["int8", "bf16"])
def test_k15_forms_refuse_a_sequence_past_the_cores_registers(entry, smem_entry, monkeypatch):
    """Both forms keep a warp's score tiles in registers, which bounds L at
    272 (the int8 form's first design, with its score rows in shared memory,
    took longer ones): each refuses L = 273 with the attention core's message
    before it allocates or launches anything, and lets L = 272 through. The
    device checks are taken out so that CPU tensors reach the length check."""
    from duodiff_tpu_torch.ops import _build, flash_attention

    monkeypatch.setattr(_build, "load_library", lambda: _CoreLimits)
    monkeypatch.setattr(flash_attention, "_check", lambda *a: None)
    q = torch.zeros(1, 1, 273, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"sequence length 273 does not fit the (int8 )?attention "
                                         r"core \(at most 272\)"):
        sdpa_int8._launch(entry, smem_entry, "core", q, q, q)
    q = q[:, :, :272].contiguous()
    with pytest.raises(AttributeError, match=entry):
        sdpa_int8._launch(entry, smem_entry, "core", q, q, q)


def _token_pos():
    """csrc/attn_core_int8.cuh's token_pos, its expression taken from the
    source: where token t of a 32-token block of v^T is staged."""
    src = (REPO / "duodiff_tpu_torch/csrc/attn_core_int8.cuh").read_text()
    expr = re.search(r"int token_pos\(int t\) \{\s*const int u = t & 15;\s*return (.*?);", src,
                     re.S).group(1)
    return lambda t: eval(expr, {"t": t, "u": t & 15})  # noqa: S307 - integer C expression


def test_k15_int8_core_stages_v_in_the_a_fragments_order():
    """The int8 core packs e codes straight from the int32 accumulator tiles
    of q k^T into the A fragments of the value product, so v^T's tokens are
    staged in that order: position 4tg+i takes token (2tg, 2tg+1, 8+2tg,
    9+2tg)[i] and 16+4tg+i token (16+2tg, 17+2tg, 24+2tg, 25+2tg)[i]. Checked
    twice: token_pos against that rule, and a numpy model of one k32 step of
    mma.sync m16n8k32 (thread (g, tg) holds keys 2tg, 2tg+1 of each 8-key
    accumulator tile; A fragment bytes k = 4tg..4tg+3 and 16+4tg..16+4tg+3;
    B column n, k rows from v^T's staged row n) against e8 v8 itself."""
    pos = _token_pos()
    assert sorted(pos(t) for t in range(32)) == list(range(32))
    for half in (0, 16):
        for tg in range(4):
            for i, tok in enumerate((2 * tg, 2 * tg + 1, 8 + 2 * tg, 9 + 2 * tg)):
                assert pos(half + tok) == half + 4 * tg + i
    rng = np.random.RandomState(0)
    e8 = rng.randint(0, 128, size=(16, 32)).astype(np.int64)   # 16 rows, 32 keys
    v8 = rng.randint(-127, 128, size=(32, 8)).astype(np.int64)  # 32 tokens, 8 columns
    vt = np.zeros((8, 32), np.int64)
    for tok in range(32):
        vt[:, pos(tok)] = v8[tok]
    a = np.zeros((16, 32), np.int64)  # the A operand as the fragments hold it
    for g in range(8):
        for tg in range(4):
            for r in (g, g + 8):
                held = [e8[r, 8 * t + 2 * tg + c] for t in range(4) for c in range(2)]
                a[r, 4 * tg:4 * tg + 4] = held[:4]          # tiles 0, 1
                a[r, 16 + 4 * tg:16 + 4 * tg + 4] = held[4:]  # tiles 2, 3
    b = vt.T  # B (k, n): k runs along v^T's staged row n
    np.testing.assert_array_equal(a @ b, e8 @ v8)


def test_k15_int8_core_keeps_codes_not_scores_in_shared_memory():
    """The redesigned int8 core: score tiles in registers (no fp32 score or
    e rows in shared memory), k and v quantized once a block, B fragments by
    ldmatrix, the int8 products m16n8k32 (and m16n8k16 for a class's last 16
    keys), and the length limit of the bf16 core, reported to the wrapper."""
    src = (REPO / "duodiff_tpu_torch/csrc/attn_core_int8.cuh").read_text()
    for gone in ("s_pitch", "e_pitch", "float* Ss", "E8s"):
        assert gone not in src, gone
    for needle in ("m16n8k32.row.col.s32.s8.s8.s32", "m16n8k16.row.col.s32.s8.s8.s32",
                   "ldmatrix_x4(", "token_pos(", "with_seq_class(", "head_splits(",
                   "__launch_bounds__(kI8AttnWarps * 32, kI8BlocksPerSm)"):
        assert needle in src, needle
    entry = (REPO / "duodiff_tpu_torch/csrc/sdpa_int8.cu").read_text()
    assert "duodiff_sdpa_int8_max_len() { return duodiff::kMaxSeq; }" in entry


# --- the tools ---------------------------------------------------------------------


def test_probe_int8_static_runs_on_the_cpu(capsys):
    out = probe_int8_static.main(["--device", "cpu", "--batch", "1", "--iters", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("cpu (no card")
    assert lines[1].startswith("MLP  int8 dynamic") and "saving" in lines[1]
    assert "static" in lines[1]
    assert lines[2].startswith("ATTN int8 dynamic") and "saving" in lines[2]
    assert lines[3].startswith("projected step saving at depth 13:") and len(lines) == 4
    assert "18.4" not in lines[3]
    assert set(out["ms"]) == {"mlp_dynamic", "mlp_static", "attn_dynamic", "attn_static"}
    assert all(v > 0 for v in out["ms"].values())
    saving = (out["ms"]["mlp_dynamic"] - out["ms"]["mlp_static"]
              + out["ms"]["attn_dynamic"] - out["ms"]["attn_static"]) * 13
    assert out["projected_step_saving_ms"] == pytest.approx(saving)
    # nothing is launched on the CPU
    assert out["launches"] == {"mlp": {"dynamic": 0, "static": 0},
                               "attn": {"dynamic": 0, "static": 0}}


def test_probe_int8_static_draws_the_jax_tools_operands(jax_static):
    """Same RandomState(0), same order of draws, same packing: the codes and
    folded scales of the port's tool equal those the JAX tool builds."""
    ops = probe_int8_static.operands(1, "cpu")
    rng = np.random.RandomState(0)
    x = rng.randn(1, probe_int8_static.L, probe_int8_static.D)
    np.testing.assert_array_equal(ops["x"].float().numpy(),
                                  np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32))
    gamma = rng.randn(1, 512).astype(np.float32) * 0.1 + 1.0
    rng.randn(1, 512)  # beta
    np.testing.assert_array_equal(ops["mlp"]["dynamic"][0].numpy(), gamma[0])
    w1 = rng.randn(512, 2048).astype(np.float32) * 0.02
    w1_8, s1 = pbi.quantize_weight_int8(jnp.asarray(w1))
    np.testing.assert_array_equal(ops["mlp"]["dynamic"][2].numpy().T, np.asarray(w1_8))
    np.testing.assert_allclose(ops["mlp"]["static"][3].numpy(), np.asarray(s1 * (8.0 / 127.0))[0],
                               rtol=1e-7)
    np.testing.assert_array_equal(ops["mlp"]["static"][8].numpy(),
                                  np.asarray([127.0 / 8.0, 127.0 / 6.0], np.float32))
    np.testing.assert_array_equal(ops["attn"]["static"][8].numpy(),
                                  np.asarray([127.0 / 8.0, 127.0 / 4.0], np.float32))
    assert ops["attn"]["dynamic"][4] is None and ops["attn"]["dynamic"][8] is None
    assert (jax_static.B, jax_static.L, jax_static.D, jax_static.HID) == (
        probe_int8_static.B, probe_int8_static.L, probe_int8_static.D, probe_int8_static.HID)


def test_probe_int8_sdpa_runs_on_the_cpu(capsys):
    out = probe_int8_sdpa.main(["--device", "cpu", "--batch", "1", "--iters", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("cpu (no card")
    assert lines[1].startswith("sdpa bf16:") and "ms/13-block step" in lines[1]
    assert lines[2].startswith("sdpa int8:")
    assert lines[3].startswith("speedup:") and lines[3].endswith("x")
    assert lines[4].startswith("rel l2 err int8 vs bf16:") and len(lines) == 5
    assert out["speedup"] == pytest.approx(out["ms"]["bf16"] / out["ms"]["int8"])
    assert 5e-3 <= out["rel_l2_err"] <= 5e-2
    assert out["launches"] == {"bf16": 0, "int8": 0}


def test_probe_mlp_bwd_split_prints_what_it_printed(capsys):
    out = probe_mlp_bwd_split.main(["imagenet64", "2", "--device", "cpu", "--batch", "1",
                                    "--reps", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("cpu (no card")
    assert lines[1] == "shape=imagenet64: B=1 L=258 D=768 hidden=3072 auto-splits=4"
    assert [line.split(":")[0] for line in lines[2:]] == [
        "autograd through mlp_sublayer_plain", "K7 monolithic", "  dx", "K8 splits=2", "  dx"]
    assert set(out["ms"]) == {"autograd through mlp_sublayer_plain", "K7 monolithic",
                              "K8 splits=2"}


@pytest.mark.parametrize("tool", [probe_int8_static, probe_int8_sdpa, probe_mlp_bwd_split])
def test_tools_refuse_the_card_where_there_is_none(tool):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        tool.main(["--device", "cuda"])
