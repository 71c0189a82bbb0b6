"""The tensor-parallel shard forms of K1, K2, K6 and K7 (``residual=False``:
a shard of the heads or of the hidden columns, the partial without ``x +``,
dx without ``+ dy``) on CPU tensors, where the wrappers run their plain
PyTorch versions, against the Pallas kernels of
duodiff_tpu/ops/pallas_block.py run with interpret=True in the same form
(``head_dim=64, residual=False``, the shard's weights, a zero output bias, as
duodiff_tpu/parallel/tp_fused.py calls them), at D = 128, 2 heads of 64,
2 shards; the shards' partials summed against the square kernel; and the
wrappers' checks and counters through a stand-in library.

Tolerances: fp32 forward 2e-5 (tests/test_tp_fused.py:81), gradients 3e-4
(:141-146); bf16 5e-2, elementwise for the forward and as a relative
Frobenius error for each gradient."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duodiff_tpu.ops import pallas_block as pb
from duodiff_tpu_torch.ops import _build, block
from duodiff_tpu_torch.utils.convert import block_params_from_jax

torch.set_num_threads(1)

B, L, D, HEADS, DH, MP = 2, 33, 128, 2, 64, 2
HID = 4 * D
A, HID_LOC, HEADS_LOC = D // MP, HID // MP, HEADS // MP
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(qkv_bias, seed=0):
    """numpy x, dy and a block's parameters in the JAX layout (kernels (in,
    out), the qkv kernel unscaled, its columns q, k, v, each head-major)."""
    rng = np.random.RandomState(seed)
    r = lambda *s: (0.05 * rng.randn(*s)).astype(np.float32)  # noqa: E731
    x = rng.randn(B, L, D).astype(np.float32)
    dy = rng.randn(B, L, D).astype(np.float32)
    p = {"ln1_s": 1.0 + r(D), "ln1_b": r(D), "wqkv": r(D, 3 * D), "bqkv": r(3 * D), "wp": r(D, D),
         "bp": r(D), "ln2_s": 1.0 + r(D), "ln2_b": r(D), "w1": r(D, HID), "b1": r(HID),
         "w2": r(HID, D), "b2": r(D)}
    if not qkv_bias:
        p["bqkv"] = None
    return x, dy, p


def _shard(p, rank):
    """Shard ``rank`` of the JAX-layout parameters: q, k and v columns of its
    heads, the matching proj rows, its hidden columns of fc1 and rows of
    fc2; zero output biases (what tp_fused.py passes the kernels)."""
    lo, hi, hlo, hhi = rank * A, (rank + 1) * A, rank * HID_LOC, (rank + 1) * HID_LOC
    q = {**p, "wqkv": p["wqkv"].reshape(D, 3, D)[:, :, lo:hi].reshape(D, 3 * A),
         "wp": p["wp"][lo:hi], "bp": np.zeros(D, np.float32), "w1": p["w1"][:, hlo:hhi],
         "b1": p["b1"][hlo:hhi], "w2": p["w2"][hlo:hhi], "b2": np.zeros(D, np.float32)}
    if p["bqkv"] is not None:
        q["bqkv"] = p["bqkv"].reshape(3, D)[:, lo:hi].reshape(3 * A)
    return q


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _j(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a, dtype)


def _jax_attn(p, xj, **kw):
    return pb.fused_attn_sublayer(xj, _j(p["ln1_s"]), _j(p["ln1_b"]), _j(p["wqkv"]),
                                  _j(p["bqkv"]), _j(p["wp"]), _j(p["bp"]), interpret=True, **kw)


def _jax_mlp(p, xj, **kw):
    return pb.fused_mlp_sublayer(xj, _j(p["ln2_s"]), _j(p["ln2_b"]), _j(p["w1"]), _j(p["b1"]),
                                 _j(p["w2"]), _j(p["b2"]), interpret=True, **kw)


def _close(got, want, dtype_name, tol32=2e-5):
    tol = tol32 if dtype_name == "fp32" else 5e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("qkv_bias", [False, True])
@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
def test_attention_shard_forward_matches_pallas(qkv_bias, dtype_name):
    x, _, p = _inputs(qkv_bias)
    jdt, tdt = DTYPES[dtype_name]
    s = _shard(p, 1)
    want = _jax_attn(s, jnp.asarray(x, jdt), num_heads=HEADS_LOC, head_dim=DH, residual=False)
    ops = block.attn_operands(*block_params_from_jax(s)[:6], num_heads=HEADS_LOC, dtype=tdt)
    got = block.fused_attn_sublayer(_t(x, tdt), *ops, num_heads=HEADS_LOC, residual=False)
    _close(got, want, dtype_name)


@pytest.mark.parametrize("gelu_approx", [False, True], ids=["erf", "tanh"])
@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
def test_mlp_shard_forward_matches_pallas(gelu_approx, dtype_name):
    x, _, p = _inputs(False)
    jdt, tdt = DTYPES[dtype_name]
    s = _shard(p, 0)
    want = _jax_mlp(s, jnp.asarray(x, jdt), gelu_approx=gelu_approx, residual=False)
    ops = block.mlp_operands(*block_params_from_jax(s)[6:], dtype=tdt)
    got = block.fused_mlp_sublayer(_t(x, tdt), *ops, gelu_approx=gelu_approx, residual=False)
    _close(got, want, dtype_name)


def test_shard_partials_sum_to_the_square_sublayers():
    """fp32: x + the shards' summed partials + the bias is the square form."""
    x, _, p = _inputs(True)
    full = block_params_from_jax(p)
    sq_attn = block.fused_attn_sublayer(
        _t(x), *block.attn_operands(*full[:6], num_heads=HEADS, dtype=torch.float32),
        num_heads=HEADS)
    sq_mlp = block.fused_mlp_sublayer(_t(x), *block.mlp_operands(*full[6:], dtype=torch.float32))
    attn = mlp = _t(x) + 0.0
    for r in range(MP):
        s = block_params_from_jax(_shard(p, r))
        attn = attn + block.fused_attn_sublayer(
            _t(x), *block.attn_operands(*s[:6], num_heads=HEADS_LOC, dtype=torch.float32),
            num_heads=HEADS_LOC, residual=False)
        mlp = mlp + block.fused_mlp_sublayer(
            _t(x), *block.mlp_operands(*s[6:], dtype=torch.float32), residual=False)
    torch.testing.assert_close(attn + full[5], sq_attn, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(mlp + full[11], sq_mlp, rtol=2e-5, atol=2e-5)


def _grads_close(got, want, dtype_name, names):
    for name, g, w in zip(names, got, want):
        if w is None:
            assert g is None, name
            continue
        w = np.asarray(jnp.asarray(w, jnp.float32))
        g = g.float().numpy()
        if dtype_name == "fp32":
            np.testing.assert_allclose(g, w, atol=3e-4, err_msg=name)
        else:
            rel = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert rel <= 5e-2, (name, rel)


@pytest.mark.parametrize("qkv_bias", [False, True])
@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
def test_attention_shard_gradients_match_pallas(qkv_bias, dtype_name):
    """K6's shard form through the autograd Function (FusedAttnSublayerFn,
    residual=False) against the VJP of fused_attn_sublayer_trainable in the
    same form (the Pallas backward in interpret mode): dx without + dy."""
    x, dy, p = _inputs(qkv_bias, seed=2)
    jdt, tdt = DTYPES[dtype_name]
    s = _shard(p, 1)
    args = (jnp.asarray(x, jdt), _j(s["ln1_s"]), _j(s["ln1_b"]), _j(s["wqkv"]), _j(s["bqkv"]),
            _j(s["wp"]))
    zero = jnp.zeros((D,), jnp.float32)

    def f(xx, g, b, wq, bq, wp):
        return pb.fused_attn_sublayer_trainable(xx, g, b, wq, bq, wp, zero, HEADS_LOC, 1e-5,
                                                True, "v2", DH, False)

    if qkv_bias:
        _, vjp = jax.vjp(f, *args)
        want = vjp(jnp.asarray(dy, jdt))
    else:
        _, vjp = jax.vjp(lambda xx, g, b, wq, wp: f(xx, g, b, wq, None, wp), *args[:4], args[5])
        dx, dg, db, dwq, dwp = vjp(jnp.asarray(dy, jdt))
        want = (dx, dg, db, dwq, None, dwp)
    ln_w, ln_b, qkv_w, qkv_b, proj_w, _ = (t if t is None else t.requires_grad_()
                                           for t in block_params_from_jax(s)[:6])
    xt = _t(x, tdt).requires_grad_()
    y = block.FusedAttnSublayerFn.apply(xt, ln_w, ln_b, qkv_w, qkv_b, proj_w, torch.zeros(D),
                                        HEADS_LOC, 1e-5, False)
    y.backward(_t(dy, tdt))
    got = (xt.grad, ln_w.grad, ln_b.grad, qkv_w.grad.t(),
           None if qkv_b is None else qkv_b.grad, proj_w.grad.t())
    _grads_close(got, want, dtype_name, ("dx", "dg", "db", "dwqkv", "dbqkv", "dwp"))


@pytest.mark.parametrize("gelu_approx", [False, True], ids=["erf", "tanh"])
@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
def test_mlp_shard_gradients_match_pallas(gelu_approx, dtype_name, monkeypatch):
    """K7's shard form through FusedMlpSublayerFn (residual=False) against
    the VJP of fused_mlp_sublayer_trainable in the same form; K8 is square
    only, so the shard form is K7's even with DUODIFF_MLP_BWD_SPLIT=1."""
    monkeypatch.setenv("DUODIFF_MLP_BWD_SPLIT", "1")
    x, dy, p = _inputs(False, seed=3)
    jdt, tdt = DTYPES[dtype_name]
    s = _shard(p, 0)
    args = (jnp.asarray(x, jdt), _j(s["ln2_s"]), _j(s["ln2_b"]), _j(s["w1"]), _j(s["b1"]),
            _j(s["w2"]))
    zero = jnp.zeros((D,), jnp.float32)
    _, vjp = jax.vjp(lambda xx, g, b, w1, b1, w2: pb.fused_mlp_sublayer_trainable(
        xx, g, b, w1, b1, w2, zero, 1e-5, gelu_approx, True, False), *args)
    want = vjp(jnp.asarray(dy, jdt))
    params = [t.requires_grad_() for t in block_params_from_jax(s)[6:11]]
    xt = _t(x, tdt).requires_grad_()
    y = block.FusedMlpSublayerFn.apply(xt, *params, torch.zeros(D), gelu_approx, 1e-5, False)
    y.backward(_t(dy, tdt))
    ln_w, ln_b, w1, b1, w2 = params
    got = (xt.grad, ln_w.grad, ln_b.grad, w1.grad.t(), b1.grad, w2.grad.t())
    _grads_close(got, want, dtype_name, ("dx", "dg", "db", "dw1", "db1", "dw2"))


def test_square_form_keeps_dy_in_dx():
    """The shard form's dx is the square form's less dy (fp32, one shard)."""
    x, dy, p = _inputs(False)
    prm = block_params_from_jax(p)
    ln, wq, wp = (prm[0], prm[1]), prm[2].t().contiguous(), prm[4].t().contiguous()
    sq = block.fused_attn_sublayer_bwd(_t(x), _t(dy), *ln, wq, None, wp, num_heads=HEADS)
    part = block.fused_attn_sublayer_bwd(_t(x), _t(dy), *ln, wq, None, wp, num_heads=HEADS,
                                         residual=False)
    torch.testing.assert_close(part[0] + _t(dy), sq[0], rtol=1e-5, atol=1e-5)
    for a, b in zip(part[1:], sq[1:]):
        torch.testing.assert_close(a, b)


# --- the wrappers through a stand-in library -----------------------------------


class _Lib:
    """Stands in for the loaded kernel library: records each entry's
    arguments and reports success, so that a wrapper's checks, the flag it
    passes and its counters can be held without a card."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name.endswith("_max_len"):
            return lambda *a: 272
        if name.endswith("_workspace"):
            return lambda *a: 16
        return lambda *a: self.calls.append((name, a)) or 0


@pytest.fixture
def lib(monkeypatch):
    fake = _Lib()
    monkeypatch.setattr(_build, "load_library", lambda: fake)
    monkeypatch.setattr(block, "_check", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return fake


def _meta(*shape, dtype=torch.bfloat16):
    """A tensor on no device: the wrappers take it for a card's, not the CPU's."""
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("residual", [True, False])
def test_wrappers_pass_the_form_and_count_it_apart(lib, residual):
    """Each of the four wrappers passes residual (1 or 0) to its C entry, just
    before eps, and counts the launch in .launches or .launches_shard."""
    d, a = 128, 128 if residual else 64
    heads, hid = a // 64, 256
    x, vec = _meta(2, 3, d), _meta(d, dtype=torch.float32)
    calls = {
        "duodiff_attn_sublayer": (block.fused_attn_sublayer, lambda: block.fused_attn_sublayer(
            x, vec, vec, _meta(d, 3 * a), None, _meta(a, d), vec, num_heads=heads,
            residual=residual)),
        "duodiff_mlp_sublayer": (block.fused_mlp_sublayer, lambda: block.fused_mlp_sublayer(
            x, vec, vec, _meta(d, hid), _meta(hid, dtype=torch.float32), _meta(hid, d), vec,
            residual=residual)),
        "duodiff_attn_sublayer_bwd": (block.fused_attn_sublayer_bwd,
                                      lambda: block.fused_attn_sublayer_bwd(
                                          x, x, vec, vec, _meta(d, 3 * a), None, _meta(a, d),
                                          num_heads=heads, residual=residual)),
        "duodiff_mlp_sublayer_bwd": (block.fused_mlp_sublayer_bwd,
                                     lambda: block.fused_mlp_sublayer_bwd(
                                         x, x, vec, vec, _meta(d, hid),
                                         _meta(hid, dtype=torch.float32), _meta(hid, d),
                                         residual=residual)),
    }
    for entry, (wrapper, call) in calls.items():
        before = (wrapper.launches, wrapper.launches_shard)
        call()
        name, args = lib.calls[-1]
        assert name == entry and args[-3] == int(residual)
        after = (wrapper.launches, wrapper.launches_shard)
        assert after == (before[0] + residual, before[1] + (not residual)), entry


def test_wrappers_refuse_the_wrong_form(lib):
    """The square form needs A == D; the shard form A == heads * 64 <= D; K1-v1
    and K5 have the square form only."""
    x, vec = _meta(2, 3, 128), _meta(128, dtype=torch.float32)
    half = (_meta(128, 192), None, _meta(64, 128))
    with pytest.raises(ValueError, match="square form"):
        block.fused_attn_sublayer(x, vec, vec, half[0], None, half[2], vec, num_heads=1)
    with pytest.raises(ValueError, match="shard form"):
        block.fused_attn_sublayer(x, vec, vec, half[0], None, half[2], vec, num_heads=2,
                                  residual=False)
    wide = (_meta(128, 768), _meta(256, 128))
    with pytest.raises(ValueError, match="shard form"):
        block.fused_attn_sublayer_bwd(x, x, vec, vec, wide[0], None, wide[1], num_heads=4,
                                      residual=False)
    with pytest.raises(ValueError, match="square residual form"):
        block.fused_attn_sublayer(x, vec, vec, _meta(3, 128, 128), None, _meta(128, 128), vec,
                                  num_heads=2, variant="v1", residual=False)
    assert lib.calls == []
