"""The port's sublayer wrappers (duodiff_tpu_torch.ops.block) on CPU
tensors, where they run their plain PyTorch versions, against the Pallas
kernels of duodiff_tpu/ops/pallas_block.py run with interpret=True, on the
same numpy inputs. Tolerances: fp32 rtol/atol 1e-5 (as tests/test_ops.py),
bf16 5e-2 (the bound the JAX tests allow between bf16 paths)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from duodiff_tpu.ops.pallas_block import fused_attn_sublayer as jax_attn
from duodiff_tpu.ops.pallas_block import fused_mlp_sublayer as jax_mlp
from duodiff_tpu_torch.ops import block

torch.set_num_threads(1)

D, HEADS = 64, 4
DTYPES = {"fp32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


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


def _attn_ops(p, dtype):
    return block.pack_attn(_norm(p), _linear(p["wqkv"], p["bqkv"]),
                           _linear(p["wp"], p["bp"]), num_heads=HEADS, dtype=dtype)


def _mlp_ops(p, dtype):
    return block.pack_mlp(_norm(p), _linear(p["w1"], p["b1"]),
                          _linear(p["w2"], p["b2"]), dtype=dtype)


def _inputs(seq_len, dtype_name, qkv_bias=False, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, seq_len, D).astype(np.float32)
    jdt, tdt, tol = DTYPES[dtype_name]
    return (x, jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt),
            _params(rng, qkv_bias), tol)


def _assert_close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("seq_len", [17, 33])
@pytest.mark.parametrize("qkv_bias", [False, True])
@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
def test_attn_sublayer_matches_pallas(seq_len, qkv_bias, dtype_name):
    _, xj, xt, p, tol = _inputs(seq_len, dtype_name, qkv_bias)
    want = jax_attn(xj, p["ln_s"], p["ln_b"], p["wqkv"], p["bqkv"], p["wp"], p["bp"],
                    num_heads=HEADS, interpret=True)
    got = block.fused_attn_sublayer(xt, *_attn_ops(p, xt.dtype), num_heads=HEADS)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    _assert_close(got, want, tol)


@pytest.mark.parametrize("seq_len", [17, 33])
@pytest.mark.parametrize("gelu_approx", [False, True])
@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
def test_mlp_sublayer_matches_pallas(seq_len, gelu_approx, dtype_name):
    _, xj, xt, p, tol = _inputs(seq_len, dtype_name)
    want = jax_mlp(xj, p["ln_s"], p["ln_b"], p["w1"], p["b1"], p["w2"], p["b2"],
                   gelu_approx=gelu_approx, interpret=True)
    got = block.fused_mlp_sublayer(xt, *_mlp_ops(p, xt.dtype), gelu_approx=gelu_approx)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    _assert_close(got, want, tol)


def test_cpu_tensors_take_the_plain_path_without_counting():
    _, _, xt, p, _ = _inputs(17, "bf16", qkv_bias=True)
    attn_ops, mlp_ops = _attn_ops(p, xt.dtype), _mlp_ops(p, xt.dtype)
    before = (block.fused_attn_sublayer.launches, block.fused_mlp_sublayer.launches)
    y = block.fused_attn_sublayer(xt, *attn_ops, num_heads=HEADS)
    assert torch.equal(y, block.attn_sublayer_plain(xt, *attn_ops, num_heads=HEADS))
    y = block.fused_mlp_sublayer(xt, *mlp_ops)
    assert torch.equal(y, block.mlp_sublayer_plain(xt, *mlp_ops))
    after = (block.fused_attn_sublayer.launches, block.fused_mlp_sublayer.launches)
    assert after == before


def test_kernel_launchers_refuse_cpu_tensors():
    """The CUDA launchers never fall back: a CPU operand is an error."""
    _, _, xt, p, _ = _inputs(17, "bf16")
    with pytest.raises(ValueError, match="CUDA"):
        block._attn_sublayer_cuda(xt, *_attn_ops(p, xt.dtype), num_heads=1, eps=1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        block._mlp_sublayer_cuda(xt, *_mlp_ops(p, xt.dtype), gelu_approx=False, eps=1e-5)


def test_pack_attn_folds_the_softmax_scale_into_q():
    rng = np.random.RandomState(1)
    p = _params(rng, qkv_bias=True)
    _, _, wqkv, bqkv, wp, _ = _attn_ops(p, torch.float32)
    scale = (D // HEADS) ** -0.5
    np.testing.assert_allclose(wqkv[:, :D].numpy(), p["wqkv"][:, :D] * scale, rtol=1e-6)
    np.testing.assert_array_equal(wqkv[:, D:].numpy(), p["wqkv"][:, D:])
    np.testing.assert_allclose(bqkv[:D].numpy(), p["bqkv"][:D] * scale, rtol=1e-6)
    np.testing.assert_array_equal(wp.numpy(), p["wp"])
