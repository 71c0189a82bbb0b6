"""The port's backward sublayers (duodiff_tpu_torch.ops.block K6 and K7) on
CPU tensors, where they run their plain PyTorch versions, against the Pallas
backward kernels of duodiff_tpu/ops/pallas_block.py run with
interpret=True, on the same numpy inputs; and the autograd Functions that
pair them with K1 and K2.

Tolerances: fp32 rtol 2e-4 / atol 2e-5 (tests/test_ops.py's bound for the
Pallas backward against autograd). bf16: each gradient within 2e-2 relative
Frobenius error and dx elementwise within 5e-2 + 5e-2 * |want|: the two
sides round at the same points to bf16 (2**-8 relative), but an fp32
difference in summation order flips a rounding now and then, and the
weight gradients sum such flips over every row."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from duodiff_tpu.ops.pallas_block import _attn_sublayer_bwd_impl, _mlp_sublayer_bwd_impl
from duodiff_tpu_torch.models.layers import Block
from duodiff_tpu_torch.ops import block

torch.set_num_threads(1)

D, HEADS = 64, 4
ATTN_NAMES = ("dx", "dg", "db", "dwqkv", "dbqkv", "dwp", "dbp")
MLP_NAMES = ("dx", "dg", "db", "dw1", "db1", "dw2", "db2")
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
BF16_REL_FRO = 2e-2


def _inputs(seq_len, seed=0):
    """numpy x, dy and params in the JAX layout (kernels (in, out), the qkv
    kernel unscaled)."""
    rng = np.random.RandomState(seed)
    r = lambda *s: (0.05 * rng.randn(*s)).astype(np.float32)  # noqa: E731
    x = rng.randn(2, seq_len, D).astype(np.float32)
    dy = rng.randn(2, seq_len, D).astype(np.float32)
    p = {"ln_s": 1.0 + r(D), "ln_b": r(D), "wqkv": r(D, 3 * D), "bqkv": r(3 * D),
         "wp": r(D, D), "w1": r(D, 4 * D), "b1": r(4 * D), "w2": r(4 * D, D)}
    return x, dy, p


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _compare(names, got, want, dtype_name):
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


@pytest.mark.parametrize("seq_len", [17, 33])
@pytest.mark.parametrize("qkv_bias", [False, True])
@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
def test_attn_sublayer_bwd_matches_pallas(seq_len, qkv_bias, dtype_name):
    x, dy, p = _inputs(seq_len)
    bqkv = p["bqkv"] if qkv_bias else None
    jdt, tdt = DTYPES[dtype_name]
    want = _attn_sublayer_bwd_impl(jnp.asarray(x, jdt), jnp.asarray(dy, jdt), p["ln_s"], p["ln_b"],
                                   p["wqkv"], bqkv, p["wp"], num_heads=HEADS, eps=1e-5,
                                   interpret=True)
    got = block.fused_attn_sublayer_bwd(_t(x, tdt), _t(dy, tdt), _t(p["ln_s"]), _t(p["ln_b"]),
                                        _t(p["wqkv"], tdt), _t(bqkv), _t(p["wp"], tdt),
                                        num_heads=HEADS)
    assert got[0].dtype == tdt and all(g.dtype == torch.float32 for g in got[1:] if g is not None)
    _compare(ATTN_NAMES, got, want, dtype_name)


@pytest.mark.parametrize("seq_len", [17, 33])
@pytest.mark.parametrize("gelu_approx", [False, True])
@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
def test_mlp_sublayer_bwd_matches_pallas(seq_len, gelu_approx, dtype_name):
    x, dy, p = _inputs(seq_len)
    jdt, tdt = DTYPES[dtype_name]
    want = _mlp_sublayer_bwd_impl(jnp.asarray(x, jdt), jnp.asarray(dy, jdt), p["ln_s"], p["ln_b"],
                                  p["w1"], p["b1"], p["w2"], eps=1e-5, gelu_approx=gelu_approx,
                                  interpret=True)
    got = block.fused_mlp_sublayer_bwd(_t(x, tdt), _t(dy, tdt), _t(p["ln_s"]), _t(p["ln_b"]),
                                       _t(p["w1"], tdt), _t(p["b1"]), _t(p["w2"], tdt),
                                       gelu_approx=gelu_approx)
    _compare(MLP_NAMES, got, want, dtype_name)


def _modules(p, qkv_bias):
    """torch-layout LayerNorm and Linear modules holding the JAX-layout params."""
    def linear(kernel, bias):
        lin = nn.Linear(*kernel.shape, bias=bias is not None)
        with torch.no_grad():
            lin.weight.copy_(_t(kernel.T))
            if bias is not None:
                lin.bias.copy_(_t(bias))
        return lin

    norm = nn.LayerNorm(D)
    with torch.no_grad():
        norm.weight.copy_(_t(p["ln_s"]))
        norm.bias.copy_(_t(p["ln_b"]))
    rng = np.random.RandomState(3)
    b = lambda n: (0.05 * rng.randn(n)).astype(np.float32)  # noqa: E731
    return (norm, linear(p["wqkv"], p["bqkv"] if qkv_bias else None), linear(p["wp"], b(D)),
            linear(p["w1"], p["b1"]), linear(p["w2"], b(D)))


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_attn_bwd_plain_matches_autograd_of_plain_forward(qkv_bias):
    """In fp32 the explicit backward is the plain forward's gradient, for the
    unscaled torch-layout weight (the scale folding is differentiated)."""
    x, dy, p = _inputs(17, seed=1)
    norm, qkv, proj, _, _ = _modules(p, qkv_bias)
    xt = _t(x).requires_grad_(True)
    params = (norm.weight, norm.bias, qkv.weight, qkv.bias, proj.weight, proj.bias)
    y = block.attn_sublayer_plain(xt, *block.attn_operands(*params, num_heads=HEADS,
                                                           dtype=torch.float32),
                                  num_heads=HEADS)
    y.backward(_t(dy))
    dx, dg, db, dwqkv, dbqkv, dwp, dbp = block.attn_sublayer_bwd_plain(
        _t(x), _t(dy), _t(p["ln_s"]), _t(p["ln_b"]), qkv.weight.detach().t(),
        None if qkv.bias is None else qkv.bias.detach(), proj.weight.detach().t(),
        num_heads=HEADS)
    pairs = [(dx, xt.grad), (dg, norm.weight.grad), (db, norm.bias.grad),
             (dwqkv, qkv.weight.grad.t()), (dwp, proj.weight.grad.t()), (dbp, proj.bias.grad)]
    if qkv_bias:
        pairs.append((dbqkv, qkv.bias.grad))
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("gelu_approx", [False, True])
def test_mlp_bwd_plain_matches_autograd_of_plain_forward(gelu_approx):
    x, dy, p = _inputs(17, seed=2)
    norm, _, _, fc1, fc2 = _modules(p, False)
    xt = _t(x).requires_grad_(True)
    params = (norm.weight, norm.bias, fc1.weight, fc1.bias, fc2.weight, fc2.bias)
    y = block.mlp_sublayer_plain(xt, *block.mlp_operands(*params, dtype=torch.float32),
                                 gelu_approx=gelu_approx)
    y.backward(_t(dy))
    got = block.mlp_sublayer_bwd_plain(_t(x), _t(dy), _t(p["ln_s"]), _t(p["ln_b"]),
                                       fc1.weight.detach().t(), fc1.bias.detach(),
                                       fc2.weight.detach().t(), gelu_approx=gelu_approx)
    wants = (xt.grad, norm.weight.grad, norm.bias.grad, fc1.weight.grad.t(), fc1.bias.grad,
             fc2.weight.grad.t(), fc2.bias.grad)
    for g, w in zip(got, wants):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_functions_pair_forward_and_backward(dtype):
    """The autograd Functions on CPU tensors: forward = K1 / K2 on packed
    operands, parameter gradients = the explicit backward in torch layout;
    no launch is counted."""
    x, dy, p = _inputs(17, seed=4)
    norm, qkv, proj, fc1, fc2 = _modules(p, True)
    before = (block.fused_attn_sublayer_bwd.launches, block.fused_mlp_sublayer_bwd.launches)
    xt = _t(x, dtype)
    attn = (norm.weight, norm.bias, qkv.weight, qkv.bias, proj.weight, proj.bias)
    y = block.FusedAttnSublayerFn.apply(xt, *attn, HEADS, 1e-5)
    assert torch.equal(y, block.fused_attn_sublayer(
        xt, *block.pack_attn(norm, qkv, proj, num_heads=HEADS, dtype=dtype), num_heads=HEADS))
    y.backward(_t(dy, dtype))
    want = block.attn_sublayer_bwd_plain(
        xt, _t(dy, dtype), norm.weight.detach(), norm.bias.detach(),
        qkv.weight.detach().t().to(dtype), qkv.bias.detach(), proj.weight.detach().t().to(dtype),
        num_heads=HEADS)
    for got, w in [(norm.weight.grad, want[1]), (qkv.weight.grad, want[3].t()),
                   (qkv.bias.grad, want[4]), (proj.weight.grad, want[5].t()),
                   (proj.bias.grad, want[6])]:
        assert got.dtype == torch.float32
        assert torch.equal(got, w)
    mlp = (norm.weight, norm.bias, fc1.weight, fc1.bias, fc2.weight, fc2.bias)
    xm = _t(x, dtype).requires_grad_(True)
    block.FusedMlpSublayerFn.apply(xm, *mlp, True, 1e-5).backward(_t(dy, dtype))
    want = block.mlp_sublayer_bwd_plain(
        xm.detach(), _t(dy, dtype), norm.weight.detach(), norm.bias.detach(),
        fc1.weight.detach().t().to(dtype), fc1.bias.detach(), fc2.weight.detach().t().to(dtype),
        gelu_approx=True)
    assert torch.equal(xm.grad, want[0])
    assert torch.equal(fc1.weight.grad, want[3].t()) and torch.equal(fc2.weight.grad, want[5].t())
    after = (block.fused_attn_sublayer_bwd.launches, block.fused_mlp_sublayer_bwd.launches)
    assert after == before


def test_backward_launchers_refuse_cpu_tensors():
    """The CUDA launchers never fall back: a CPU operand is an error."""
    x, dy, p = _inputs(17)
    bf = torch.bfloat16
    with pytest.raises(ValueError, match="CUDA"):
        block._attn_sublayer_bwd_cuda(_t(x, bf), _t(dy, bf), _t(p["ln_s"]), _t(p["ln_b"]),
                                      _t(p["wqkv"], bf), None, _t(p["wp"], bf), num_heads=1,
                                      eps=1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        block._mlp_sublayer_bwd_cuda(_t(x, bf), _t(dy, bf), _t(p["ln_s"]), _t(p["ln_b"]),
                                     _t(p["w1"], bf), _t(p["b1"]), _t(p["w2"], bf),
                                     gelu_approx=False, eps=1e-5)


@pytest.mark.parametrize("impl, dtype, match", [
    ("fused", torch.float32, "--use_amp"),
    ("fused_int8", torch.bfloat16, "no backward"),
])
def test_block_training_refusals(impl, dtype, match):
    """Training never falls back: fused trains in bf16 only, int8 not at all."""
    blk = Block(D, HEADS, attn_impl=impl).train()
    with pytest.raises(ValueError, match=match):
        blk(torch.zeros(1, 17, D, dtype=dtype))


@pytest.mark.parametrize("impl", ["fused", "plain"])
def test_block_training_forward_equals_packed_forward(impl):
    """In training mode the block reads its live parameters; the values are
    those of the packed eval path."""
    blk = Block(D, HEADS, qkv_bias=True, skip=True, attn_impl=impl)
    x = torch.randn(2, 17, D, generator=torch.Generator().manual_seed(0)).bfloat16()
    skip = torch.randn(2, 17, D, generator=torch.Generator().manual_seed(1)).bfloat16()
    train_out = blk.train()(x, skip)
    assert train_out.requires_grad
    blk.eval().pack(torch.bfloat16)
    with torch.no_grad():
        assert torch.equal(train_out.detach(), blk(x, skip))
