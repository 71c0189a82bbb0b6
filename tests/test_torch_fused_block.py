"""The port's whole-block kernel K5 and per-head attention sublayer K1-v1
(duodiff_tpu_torch.ops.block.fused_block, FusedBlockFn and
fused_attn_sublayer(variant="v1")) on CPU tensors, where they run their
plain PyTorch versions, against the Pallas fused_block,
fused_block_trainable and fused_attn_sublayer(variant="v1") of
duodiff_tpu/ops/pallas_block.py run with interpret=True on the same numpy
inputs.

Tolerances: forward fp32 1e-5 (summation order), bf16 5e-2 (the bound
tests/test_ops.py allows between the package's bf16 paths; block_plain in
fact equals the Pallas block to the bit there). Gradients fp32 rtol 2e-4 /
atol 2e-5, tests/test_ops.py's bound for the chained backward; bf16 2 %
relative Frobenius per gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duodiff_tpu.ops import pallas_block as pb
from duodiff_tpu_torch.ops import block
from duodiff_tpu_torch.utils.convert import block_params_from_jax

torch.set_num_threads(1)

B, L, D, HEADS, HID = 3, 33, 64, 4, 256
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
JAX_ORDER = ("ln1_s", "ln1_b", "wqkv", "bqkv", "wp", "bp", "ln2_s", "ln2_b", "w1", "b1", "w2",
             "b2")


def _inputs(qkv_bias, seed=0):
    """numpy x, dy and the 12 block parameters in the JAX layout (kernels
    (in, out), the qkv kernel unscaled)."""
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


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _jax_args(p):
    return [p[k] for k in JAX_ORDER]


def _packed(p, tdt):
    """(v2 attention operands, v1 attention operands, MLP operands)."""
    params = block_params_from_jax(p)
    return (block.attn_operands(*params[:6], num_heads=HEADS, dtype=tdt),
            block.attn_operands_v1(*params[:6], dtype=tdt),
            block.mlp_operands(*params[6:], dtype=tdt))


def _close(got, want, dtype_name):
    tol = 1e-5 if dtype_name == "fp32" else 5e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("qkv_bias", [False, True])
@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
def test_attn_sublayer_v1_matches_pallas(qkv_bias, dtype_name):
    x, _, p = _inputs(qkv_bias)
    jdt, tdt = DTYPES[dtype_name]
    want = pb.fused_attn_sublayer(jnp.asarray(x, jdt), *_jax_args(p)[:6], num_heads=HEADS,
                                  interpret=True, variant="v1")
    _, v1, _ = _packed(p, tdt)
    before = block.fused_attn_sublayer.launches_v1
    got = block.fused_attn_sublayer(_t(x, tdt), *v1, num_heads=HEADS, variant="v1")
    assert got.dtype == tdt and block.fused_attn_sublayer.launches_v1 == before
    _close(got, want, dtype_name)


@pytest.mark.parametrize("variant", ["v1", "v2"])
def test_each_variant_refuses_the_other_packing(variant):
    """v2's packed weight carries the softmax scale, v1's does not: handing
    one to the other would scale the scores twice or never, so the shapes
    differ and the wrong one is refused, on the wrapper and on the plain
    versions alike."""
    x, _, p = _inputs(True)
    v2, v1, mlp = _packed(p, torch.float32)
    wrong = v2 if variant == "v1" else v1
    with pytest.raises(ValueError, match="belong to the other variant"):
        block.fused_attn_sublayer(_t(x), *wrong, num_heads=HEADS, variant=variant)
    if variant == "v1":
        with pytest.raises(ValueError, match="belong to the other variant"):
            block.attn_sublayer_v1_plain(_t(x), *v2, num_heads=HEADS)
    else:
        with pytest.raises(ValueError, match="belong to the other variant"):
            block.fused_block(_t(x), *v1, *mlp, num_heads=HEADS)
    with pytest.raises(ValueError, match="variant must be"):
        block.fused_attn_sublayer(_t(x), *v2, num_heads=HEADS, variant="v3")


def test_v1_and_v2_compute_the_same_function():
    """In fp32 the two variants differ by summation order only, so the scale
    is applied exactly once in each."""
    x, _, p = _inputs(True, seed=1)
    v2, v1, _ = _packed(p, torch.float32)
    a = block.fused_attn_sublayer(_t(x), *v2, num_heads=HEADS)
    b = block.fused_attn_sublayer(_t(x), *v1, num_heads=HEADS, variant="v1")
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def test_v1_refuses_a_rectangular_form():
    x, _, p = _inputs(False)
    _, v1, _ = _packed(p, torch.float32)
    ops = list(v1)
    ops[2], ops[4] = ops[2][:, :, :32].contiguous(), ops[4][:32].contiguous()  # A = 32 != D
    with pytest.raises(ValueError, match="square residual form"):
        block.fused_attn_sublayer(_t(x), *ops, num_heads=2, variant="v1")


@pytest.mark.parametrize("qkv_bias", [False, True])
@pytest.mark.parametrize("gelu_approx", [False, True], ids=["erf", "tanh"])
@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
def test_fused_block_matches_pallas(qkv_bias, gelu_approx, dtype_name):
    x, _, p = _inputs(qkv_bias)
    jdt, tdt = DTYPES[dtype_name]
    want = pb.fused_block(jnp.asarray(x, jdt), *_jax_args(p), num_heads=HEADS,
                          gelu_approx=gelu_approx, interpret=True)
    v2, _, mlp = _packed(p, tdt)
    before = block.fused_block.launches
    got = block.fused_block(_t(x, tdt), *v2, *mlp, num_heads=HEADS, gelu_approx=gelu_approx)
    assert got.dtype == tdt and block.fused_block.launches == before
    _close(got, want, dtype_name)


def test_fused_block_keeps_the_intermediate_stream_in_fp32():
    """K5 is not K2 after K1: those round the intermediate u to bf16 between
    them, the block feeds the fp32 u to the second LayerNorm and the last
    residual. In bf16 block_plain reproduces the Pallas block to the bit,
    and the two plain sublayers in a row do not."""
    x, _, p = _inputs(True, seed=2)
    want = np.asarray(pb.fused_block(jnp.asarray(x, jnp.bfloat16), *_jax_args(p),
                                     num_heads=HEADS, interpret=True).astype(jnp.float32))
    v2, _, mlp = _packed(p, torch.bfloat16)
    xt = _t(x, torch.bfloat16)
    whole = block.block_plain(xt, *v2, *mlp, num_heads=HEADS).float().numpy()
    two = block.mlp_sublayer_plain(block.attn_sublayer_plain(xt, *v2, num_heads=HEADS),
                                   *mlp).float().numpy()
    assert np.array_equal(whole, want)
    assert (two != want).mean() > 0.05
    assert np.abs(two - want).max() > np.abs(whole - want).max()


def _jax_block_grads(x, dy, p, jdt, gelu_approx):
    """jax.grad of sum(fused_block_trainable(...) * dy) for x and every
    parameter the block has, in JAX_ORDER."""
    names = [k for k in JAX_ORDER if p[k] is not None]

    def loss(xv, params):
        args = [params.get(k) for k in JAX_ORDER]
        y = pb.fused_block_trainable(xv, *args, HEADS, 1e-5, gelu_approx, True)
        return jnp.sum(y.astype(jnp.float32) * dy)

    gx, gp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x, jdt), {k: p[k] for k in names})
    return gx, gp


@pytest.mark.parametrize("qkv_bias", [False, True])
@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
def test_fused_block_fn_gradients_match_pallas(qkv_bias, dtype_name, monkeypatch):
    monkeypatch.delenv("DUODIFF_MLP_BWD_SPLIT", raising=False)
    x, dy, p = _inputs(qkv_bias, seed=3)
    jdt, tdt = DTYPES[dtype_name]
    gx, gp = _jax_block_grads(x, dy, p, jdt, False)
    params = [None if t is None else torch.nn.Parameter(t) for t in block_params_from_jax(p)]
    xt = _t(x, tdt).requires_grad_(True)
    y = block.FusedBlockFn.apply(xt, *params, HEADS, False, 1e-5)
    assert y.dtype == tdt
    y.backward(_t(dy, tdt))
    # torch layout (out, in) back to the JAX one for the four kernels
    got = {"x": xt.grad}
    for name, t in zip(JAX_ORDER, params):
        if t is not None:
            got[name] = t.grad.t() if t.grad.dim() == 2 else t.grad
    want = {"x": gx, **gp}
    assert set(got) == set(want)
    for name in want:
        g, w = got[name].float().numpy(), np.asarray(want[name], np.float32)
        if dtype_name == "fp32":
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-5, err_msg=name)
        else:
            rel = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert rel <= 2e-2, (name, rel)


def test_fused_block_fn_backward_takes_the_split_kernel_when_asked(monkeypatch):
    """The chained backward goes through the same dispatch as the MLP
    sublayer's: DUODIFF_MLP_BWD_SPLIT=1 takes K8 at the recomputed u."""
    x, dy, p = _inputs(True, seed=4)
    grads = {}
    for env in ("0", "1"):
        monkeypatch.setenv("DUODIFF_MLP_BWD_SPLIT", env)
        calls = []
        fn = block.fused_mlp_sublayer_bwd_split
        monkeypatch.setattr(block, "fused_mlp_sublayer_bwd_split",
                            lambda *a, _fn=fn, **kw: calls.append(kw["splits"]) or _fn(*a, **kw))
        params = [torch.nn.Parameter(t) for t in block_params_from_jax(p)]
        xt = _t(x).requires_grad_(True)
        block.FusedBlockFn.apply(xt, *params, HEADS, True, 1e-5).backward(_t(dy))
        assert calls == ([4] if env == "1" else [])
        grads[env] = [xt.grad] + [t.grad for t in params]
        monkeypatch.setattr(block, "fused_mlp_sublayer_bwd_split", fn)
    for a, b in zip(grads["0"], grads["1"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def test_new_launchers_refuse_cpu_tensors():
    x, _, p = _inputs(True)
    v2, v1, mlp = _packed(p, torch.bfloat16)
    xt = _t(x, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        block._attn_sublayer_cuda(xt, *v1, num_heads=1, eps=1e-5, variant="v1")
    with pytest.raises(ValueError, match="CUDA"):
        block._fused_block_cuda(xt, *v2, *mlp, num_heads=1, gelu_approx=False, eps=1e-5)
