"""The two fused sublayers of a U-ViT block (counterpart of the forward
halves of ``duodiff_tpu/ops/pallas_block.py``).

- :func:`fused_attn_sublayer`: ``y = x + proj(SDPA(qkv(LN(x)))) + b_proj``
  (K1, ``csrc/attn_sublayer.cu``; the Pallas ``_kernel_v2``);
- :func:`fused_mlp_sublayer`: ``y = x + fc2(gelu(fc1(LN(x)) + b1)) + b2``
  (K2, ``csrc/mlp_sublayer.cu``; the Pallas ``_mlp_kernel``).

Each wrapper takes the plain PyTorch version (:func:`attn_sublayer_plain`,
:func:`mlp_sublayer_plain`) for a tensor on the CPU. For a CUDA tensor it
launches its kernel or raises; it counts its launches in ``.launches``.

Both take packed operands (:func:`pack_attn`, :func:`pack_mlp`): weights
transposed to (in, out) and cast to the activation dtype, the softmax scale
folded into the q columns of the qkv weight and bias before the cast (as the
Pallas wrapper does), biases and LayerNorm affine in fp32. Numerics follow
the Pallas kernels: LayerNorm two-pass in fp32, matmuls on operands in the
activation dtype with fp32 accumulation, fp32 softmax normalised after the
value product, residual and bias added in fp32, one rounding to the
activation dtype at each point where the Pallas kernel rounds.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# what the CUDA kernels take: bf16 activations, head width 64, a 16-byte
# aligned row of every operand (widths multiple of 8), and the attention
# core's dynamic shared memory within a block's 227 KB opt-in limit, less
# the core's 256 bytes of static shared memory
HEAD_DIM = 64
_MAX_SMEM_BYTES = 227 * 1024 - 256


def pack_attn(norm, qkv, proj, *, num_heads: int, dtype):
    """(ln_scale, ln_bias, wqkv (D, 3A), bqkv (3A,) or None, wp (A, D),
    bp (D,)) from torch-layout LayerNorm and Linear modules."""
    a = proj.weight.shape[1]
    scale = float(a // num_heads) ** -0.5
    w = qkv.weight.detach().float().t()
    wqkv = torch.cat([w[:, :a] * scale, w[:, a:]], dim=1).to(dtype).contiguous()
    bqkv = None
    if qkv.bias is not None:
        b = qkv.bias.detach().float()
        bqkv = torch.cat([b[:a] * scale, b[a:]]).contiguous()
    return (
        norm.weight.detach().float().contiguous(),
        norm.bias.detach().float().contiguous(),
        wqkv,
        bqkv,
        proj.weight.detach().t().to(dtype).contiguous(),
        proj.bias.detach().float().contiguous(),
    )


def pack_mlp(norm, fc1, fc2, *, dtype):
    """(ln_scale, ln_bias, w1 (D, 4D), b1, w2 (4D, D), b2) from torch-layout
    LayerNorm and Linear modules."""
    return (
        norm.weight.detach().float().contiguous(),
        norm.bias.detach().float().contiguous(),
        fc1.weight.detach().t().to(dtype).contiguous(),
        fc1.bias.detach().float().contiguous(),
        fc2.weight.detach().t().to(dtype).contiguous(),
        fc2.bias.detach().float().contiguous(),
    )


def _layer_norm(xv, scale, bias, eps):
    """fp32 two-pass LayerNorm (pallas_block._ln_fwd)."""
    mean = xv.mean(-1, keepdim=True)
    var = (xv - mean).square().mean(-1, keepdim=True)
    return (xv - mean) * torch.rsqrt(var + eps) * scale + bias


def attention_core_plain(qkv, num_heads: int, dtype):
    """The SDPA core of K1 and K11 on a packed (B, L, 3A) qkv whose values
    are ``dtype``-rounded and whose q is pre-scaled: fp32 scores, e rounded
    to ``dtype`` for the value product, fp32 denominator applied after it;
    returns the merged heads (B, L, A) in ``dtype``."""
    b, l, three_a = qkv.shape
    a = three_a // 3
    qkv = qkv.float()
    q, k, v = (qkv[..., i * a:(i + 1) * a].reshape(b, l, num_heads, a // num_heads)
               for i in range(3))
    s = torch.einsum("blhe,bmhe->bhlm", q, k)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    denom = e.sum(-1, keepdim=True)
    o = torch.einsum("bhlm,bmhe->blhe", e.to(dtype).float(), v)
    return (o / denom.transpose(1, 2)).to(dtype).reshape(b, l, a)


def attn_sublayer_plain(x, ln_scale, ln_bias, wqkv, bqkv, wp, bp, *,
                        num_heads: int, eps: float = 1e-5):
    """Plain PyTorch K1 (pallas_block._attn_sublayer_reference with the
    scale pre-folded into ``wqkv``)."""
    dt = x.dtype
    xv = x.float()
    xn = _layer_norm(xv, ln_scale.float(), ln_bias.float(), eps).to(dt)
    qkv = torch.matmul(xn.float(), wqkv.float())
    if bqkv is not None:
        qkv = qkv + bqkv.float()
    merged = attention_core_plain(qkv.to(dt), num_heads, dt)
    proj = torch.matmul(merged.float(), wp.float())
    return (proj + xv + bp.float()).to(dt)


def mlp_sublayer_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, *,
                       gelu_approx: bool = False, eps: float = 1e-5):
    """Plain PyTorch K2 (pallas_block._mlp_reference)."""
    dt = x.dtype
    xv = x.float()
    xn = _layer_norm(xv, ln_scale.float(), ln_bias.float(), eps).to(dt)
    hidden = torch.matmul(xn.float(), w1.float()) + b1.float()
    hidden = F.gelu(hidden, approximate="tanh" if gelu_approx else "none").to(dt)
    out = torch.matmul(hidden.float(), w2.float())
    return (out + xv + b2.float()).to(dt)


def _check(name, t, shape, dtype, device):
    if t.device.type != "cuda":
        raise ValueError(f"{name} is on {t.device}: the kernels take CUDA tensors")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on_error(lib, name: str, err: int) -> None:
    if err:
        msg = lib.duodiff_error_string(err).decode()
        raise RuntimeError(f"{name} failed: CUDA error {err} ({msg})")


def _attn_sublayer_cuda(x, ln_scale, ln_bias, wqkv, bqkv, wp, bp, *,
                        num_heads: int, eps: float):
    """Check the operands and launch K1 (the LayerNorm, qkv GEMM, attention
    core and proj GEMM launches of csrc/attn_sublayer.cu)."""
    from duodiff_tpu_torch.ops._build import load_library

    if x.dim() != 3:
        raise ValueError(f"x must be (B, L, D), got {tuple(x.shape)}")
    b, l, d = x.shape
    a = wp.shape[0]
    if a != d or a != num_heads * HEAD_DIM:
        raise ValueError(
            f"the kernel takes the square form A == D == num_heads * {HEAD_DIM}: "
            f"A={a}, D={d}, num_heads={num_heads}"
        )
    if d % 8:
        raise ValueError(f"D must be a multiple of 8, got {d}")
    dev, bf16, f32 = x.device, torch.bfloat16, torch.float32
    _check("x", x, (b, l, d), bf16, dev)
    _check("ln_scale", ln_scale, (d,), f32, dev)
    _check("ln_bias", ln_bias, (d,), f32, dev)
    _check("wqkv", wqkv, (d, 3 * a), bf16, dev)
    if bqkv is not None:
        _check("bqkv", bqkv, (3 * a,), f32, dev)
    _check("wp", wp, (a, d), bf16, dev)
    _check("bp", bp, (d,), f32, dev)
    lib = load_library()
    if lib.duodiff_attn_core_smem_bytes(l) > _MAX_SMEM_BYTES:
        raise ValueError(f"sequence length {l} does not fit the attention core")
    xn = torch.empty_like(x)
    qkv = torch.empty((b, l, 3 * a), dtype=bf16, device=dev)
    merged = torch.empty((b, l, a), dtype=bf16, device=dev)
    y = torch.empty_like(x)
    err = lib.duodiff_attn_sublayer(
        _ptr(x), _ptr(ln_scale), _ptr(ln_bias), _ptr(wqkv), _ptr(bqkv),
        _ptr(wp), _ptr(bp), _ptr(xn), _ptr(qkv), _ptr(merged), _ptr(y),
        b, l, d, num_heads, eps, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on_error(lib, "attention sublayer kernel", err)
    return y


def _mlp_sublayer_cuda(x, ln_scale, ln_bias, w1, b1, w2, b2, *,
                       gelu_approx: bool, eps: float):
    """Check the operands and launch K2 (the LayerNorm, fc1 GEMM and fc2 GEMM
    launches of csrc/mlp_sublayer.cu)."""
    from duodiff_tpu_torch.ops._build import load_library

    if x.dim() != 3:
        raise ValueError(f"x must be (B, L, D), got {tuple(x.shape)}")
    b, l, d = x.shape
    hid = w1.shape[1]
    if d % 8 or hid % 8:
        raise ValueError(f"D and the hidden width must be multiples of 8: {d}, {hid}")
    dev, bf16, f32 = x.device, torch.bfloat16, torch.float32
    _check("x", x, (b, l, d), bf16, dev)
    _check("ln_scale", ln_scale, (d,), f32, dev)
    _check("ln_bias", ln_bias, (d,), f32, dev)
    _check("w1", w1, (d, hid), bf16, dev)
    _check("b1", b1, (hid,), f32, dev)
    _check("w2", w2, (hid, d), bf16, dev)
    _check("b2", b2, (d,), f32, dev)
    lib = load_library()
    xn = torch.empty_like(x)
    hidden = torch.empty((b, l, hid), dtype=bf16, device=dev)
    y = torch.empty_like(x)
    err = lib.duodiff_mlp_sublayer(
        _ptr(x), _ptr(ln_scale), _ptr(ln_bias), _ptr(w1), _ptr(b1), _ptr(w2),
        _ptr(b2), _ptr(xn), _ptr(hidden), _ptr(y), b * l, d, hid,
        2 if gelu_approx else 1, eps, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on_error(lib, "MLP sublayer kernel", err)
    return y


def fused_attn_sublayer(x, ln_scale, ln_bias, wqkv, bqkv, wp, bp, *,
                        num_heads: int, eps: float = 1e-5):
    """K1 on packed operands (:func:`pack_attn`); x (B, L, D)."""
    if x.device.type == "cpu":
        return attn_sublayer_plain(x, ln_scale, ln_bias, wqkv, bqkv, wp, bp,
                                   num_heads=num_heads, eps=eps)
    y = _attn_sublayer_cuda(x, ln_scale, ln_bias, wqkv, bqkv, wp, bp,
                            num_heads=num_heads, eps=eps)
    fused_attn_sublayer.launches += 1
    return y


def fused_mlp_sublayer(x, ln_scale, ln_bias, w1, b1, w2, b2, *,
                       gelu_approx: bool = False, eps: float = 1e-5):
    """K2 on packed operands (:func:`pack_mlp`); x (B, L, D)."""
    if x.device.type == "cpu":
        return mlp_sublayer_plain(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                  gelu_approx=gelu_approx, eps=eps)
    y = _mlp_sublayer_cuda(x, ln_scale, ln_bias, w1, b1, w2, b2,
                           gelu_approx=gelu_approx, eps=eps)
    fused_mlp_sublayer.launches += 1
    return y


fused_attn_sublayer.launches = 0
fused_mlp_sublayer.launches = 0
