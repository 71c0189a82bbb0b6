"""The two fused sublayers of a U-ViT block and their backwards
(counterpart of ``duodiff_tpu/ops/pallas_block.py``).

- :func:`fused_attn_sublayer`: ``y = x + proj(SDPA(qkv(LN(x)))) + b_proj``
  (K1, ``csrc/attn_sublayer.cu``; the Pallas ``_kernel_v2``);
- :func:`fused_mlp_sublayer`: ``y = x + fc2(gelu(fc1(LN(x)) + b1)) + b2``
  (K2, ``csrc/mlp_sublayer.cu``; the Pallas ``_mlp_kernel``);
- :func:`fused_attn_sublayer_bwd` (K6, ``csrc/attn_sublayer_bwd.cu``; the
  Pallas ``_attn_bwd_kernel``) and :func:`fused_mlp_sublayer_bwd` (K7,
  ``csrc/mlp_sublayer_bwd.cu``; the Pallas ``_mlp_bwd_kernel``), paired
  with K1 and K2 in the autograd Functions :class:`FusedAttnSublayerFn`
  and :class:`FusedMlpSublayerFn` for training.

Each wrapper takes the plain PyTorch version (:func:`attn_sublayer_plain`,
:func:`mlp_sublayer_plain`, :func:`attn_sublayer_bwd_plain`,
:func:`mlp_sublayer_bwd_plain`) for a tensor on the CPU. For a CUDA tensor
it launches its kernel or raises; it counts its launches in ``.launches``.

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


def attn_operands(ln_w, ln_b, qkv_w, qkv_b, proj_w, proj_b, *, num_heads: int, dtype):
    """The packed K1 operands (ln_scale, ln_bias, wqkv (D, 3A), bqkv (3A,) or
    None, wp (A, D), bp (D,)) from torch-layout parameters, differentiably
    (the plain training path runs autograd through them)."""
    a = proj_w.shape[1]
    scale = float(a // num_heads) ** -0.5
    w = qkv_w.float().t()
    wqkv = torch.cat([w[:, :a] * scale, w[:, a:]], dim=1).to(dtype).contiguous()
    bqkv = None
    if qkv_b is not None:
        b = qkv_b.float()
        bqkv = torch.cat([b[:a] * scale, b[a:]]).contiguous()
    return (ln_w.float().contiguous(), ln_b.float().contiguous(), wqkv, bqkv,
            proj_w.t().to(dtype).contiguous(), proj_b.float().contiguous())


def mlp_operands(ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, *, dtype):
    """The packed K2 operands (ln_scale, ln_bias, w1 (D, 4D), b1, w2 (4D, D),
    b2) from torch-layout parameters, differentiably."""
    return (ln_w.float().contiguous(), ln_b.float().contiguous(),
            fc1_w.t().to(dtype).contiguous(), fc1_b.float().contiguous(),
            fc2_w.t().to(dtype).contiguous(), fc2_b.float().contiguous())


def _detached(ops):
    return tuple(None if t is None else t.detach() for t in ops)


def pack_attn(norm, qkv, proj, *, num_heads: int, dtype):
    """:func:`attn_operands` of torch LayerNorm and Linear modules, detached."""
    return _detached(attn_operands(norm.weight, norm.bias, qkv.weight, qkv.bias, proj.weight,
                                   proj.bias, num_heads=num_heads, dtype=dtype))


def pack_mlp(norm, fc1, fc2, *, dtype):
    """:func:`mlp_operands` of torch LayerNorm and Linear modules, detached."""
    return _detached(mlp_operands(norm.weight, norm.bias, fc1.weight, fc1.bias, fc2.weight,
                                  fc2.bias, dtype=dtype))


def _ln_fwd(xv, scale, bias, eps):
    """fp32 two-pass LayerNorm pieces (pallas_block._ln_fwd): (x_hat, rstd, xn)."""
    mean = xv.mean(-1, keepdim=True)
    var = (xv - mean).square().mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    x_hat = (xv - mean) * rstd
    return x_hat, rstd, x_hat * scale + bias


def _layer_norm(xv, scale, bias, eps):
    return _ln_fwd(xv, scale, bias, eps)[2]


def _ln_bwd_dx(dxn, x_hat, rstd, gamma):
    """dL/dx of the LayerNorm from dL/dxn, fp32 (pallas_block._ln_bwd_dx)."""
    dxh = dxn * gamma
    m1 = dxh.mean(-1, keepdim=True)
    m2 = (dxh * x_hat).mean(-1, keepdim=True)
    return rstd * (dxh - m1 - x_hat * m2)


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


def _rows(t):
    """(B, L, N) -> (B*L, N)."""
    return t.reshape(-1, t.shape[-1])


def attn_sublayer_bwd_plain(x, dy, ln_s, ln_b, wqkv, bqkv, wp, *, num_heads: int,
                            eps: float = 1e-5):
    """Plain PyTorch K6 (pallas_block._attn_bwd_kernel): the gradients of
    K1 for the UNSCALED qkv weight ``wqkv`` (D, 3A), the scale applied to q
    inside. Returns (dx, dgamma, dbeta, dWqkv (D, 3A), dbqkv (3A,) or None,
    dWp (A, D), dbp (D,)): dx in x's dtype, the rest fp32. Rounds to the
    activation dtype where the Pallas kernel does: xn, qkv, dm, bf16(e),
    bf16(do * r), dsp, bf16(qsc * r) and the dq / dk / dv heads; fp32
    elsewhere."""
    dt = x.dtype
    b, l, d = x.shape
    a = wp.shape[0]
    dh = a // num_heads
    scale = float(dh) ** -0.5
    gamma = ln_s.float()
    x_hat, rstd, xn = _ln_fwd(x.float(), gamma, ln_b.float(), eps)
    xn = xn.to(dt).float()
    wq, wpf = wqkv.to(dt).float(), wp.to(dt).float()
    qkv = xn @ wq
    if bqkv is not None:
        qkv = qkv + bqkv.float()
    qkv = qkv.to(dt).float()
    dyf = dy.to(dt).float()
    dm = (dyf @ wpf.t()).to(dt).float()

    def heads(t):  # (B, L, A) -> (B, H, L, Dh)
        return t.reshape(b, l, num_heads, dh).transpose(1, 2)

    def merge(t):
        return t.transpose(1, 2).reshape(b, l, a)

    q, k, v = (heads(qkv[..., i * a:(i + 1) * a]) for i in range(3))
    do = heads(dm)
    qsc = (q * scale).to(dt).float()
    s = qsc @ k.transpose(-1, -2)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    r = 1.0 / e.sum(-1, keepdim=True)
    eb = e.to(dt).float()
    merged = ((eb @ v) * r).to(dt).float()
    dv = (eb.transpose(-1, -2) @ (do * r).to(dt).float()).to(dt)
    dp = do @ v.transpose(-1, -2)
    c = (dp * e).sum(-1, keepdim=True) * r
    dsp = (e * (dp - c)).to(dt).float()
    dq = ((dsp @ k) * (r * scale)).to(dt)
    dk = (dsp.transpose(-1, -2) @ (qsc * r).to(dt).float()).to(dt)
    dqkv = torch.cat([merge(dq), merge(dk), merge(dv)], dim=-1).float()
    dwp = _rows(merge(merged)).t() @ _rows(dyf)
    dwqkv = _rows(xn).t() @ _rows(dqkv)
    dbqkv = dqkv.sum((0, 1)) if bqkv is not None else None
    dxn = dqkv @ wq.t()
    dx = (_ln_bwd_dx(dxn, x_hat, rstd, gamma) + dyf).to(dt)
    return (dx, (dxn * x_hat).sum((0, 1)), dxn.sum((0, 1)), dwqkv, dbqkv, dwp,
            dyf.sum((0, 1)))


def gelu_grad(h, approx: bool):
    """d gelu(h) / dh in fp32 (pallas_block._gelu_grad, exact erf)."""
    if approx:
        c, a = 0.7978845608028654, 0.044715
        t = torch.tanh(c * (h + a * h * h * h))
        return 0.5 * (1.0 + t) + 0.5 * h * (1.0 - t * t) * c * (1.0 + 3.0 * a * h * h)
    phi = torch.exp(-0.5 * h * h) * 0.3989422804014327
    return 0.5 * (1.0 + torch.erf(h * 2.0 ** -0.5)) + h * phi


def mlp_sublayer_bwd_plain(x, dy, ln_s, ln_b, w1, b1, w2, *, gelu_approx: bool = False,
                           eps: float = 1e-5):
    """Plain PyTorch K7 (pallas_block._mlp_bwd_kernel): the gradients of K2.
    Returns (dx, dgamma, dbeta, dW1 (D, Hd), db1, dW2 (Hd, D), db2): dx in
    x's dtype, the rest fp32. Rounds xn, gelu(h_pre) and dh * gelu'(h_pre)
    to the activation dtype, as the Pallas kernel does; db1 sums the
    unrounded fp32 dh * gelu'(h_pre)."""
    dt = x.dtype
    gamma = ln_s.float()
    x_hat, rstd, xn = _ln_fwd(x.float(), gamma, ln_b.float(), eps)
    xn = xn.to(dt).float()
    w1f, w2f = w1.to(dt).float(), w2.to(dt).float()
    dyf = dy.to(dt).float()
    h_pre = xn @ w1f + b1.float()
    hgb = F.gelu(h_pre, approximate="tanh" if gelu_approx else "none").to(dt).float()
    dhp = (dyf @ w2f.t()) * gelu_grad(h_pre, gelu_approx)
    dhpb = dhp.to(dt).float()
    dxn = dhpb @ w1f.t()
    dx = (_ln_bwd_dx(dxn, x_hat, rstd, gamma) + dyf).to(dt)
    return (dx, (dxn * x_hat).sum((0, 1)), dxn.sum((0, 1)), _rows(xn).t() @ _rows(dhpb),
            dhp.sum((0, 1)), _rows(hgb).t() @ _rows(dyf), dyf.sum((0, 1)))


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


def _attn_dims(x, wp, num_heads: int):
    """(B, L, D, A) of an attention sublayer the kernels take."""
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
    return b, l, d, a


def _attn_sublayer_cuda(x, ln_scale, ln_bias, wqkv, bqkv, wp, bp, *,
                        num_heads: int, eps: float):
    """Check the operands and launch K1 (the LayerNorm, qkv GEMM, attention
    core and proj GEMM launches of csrc/attn_sublayer.cu)."""
    from duodiff_tpu_torch.ops._build import load_library

    b, l, d, a = _attn_dims(x, wp, num_heads)
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


def _attn_sublayer_bwd_cuda(x, dy, ln_s, ln_b, wqkv, bqkv, wp, *, num_heads: int, eps: float):
    """Check the operands and launch K6 (csrc/attn_sublayer_bwd.cu) with one
    scratch workspace; returns what :func:`attn_sublayer_bwd_plain` does."""
    from duodiff_tpu_torch.ops._build import load_library

    b, l, d, a = _attn_dims(x, wp, num_heads)
    dev, bf16, f32 = x.device, torch.bfloat16, torch.float32
    _check("x", x, (b, l, d), bf16, dev)
    _check("dy", dy, (b, l, d), bf16, dev)
    _check("ln_scale", ln_s, (d,), f32, dev)
    _check("ln_bias", ln_b, (d,), f32, dev)
    _check("wqkv", wqkv, (d, 3 * a), bf16, dev)
    if bqkv is not None:
        _check("bqkv", bqkv, (3 * a,), f32, dev)
    _check("wp", wp, (a, d), bf16, dev)
    lib = load_library()
    if lib.duodiff_attn_bwd_core_smem_bytes(l) > _MAX_SMEM_BYTES:
        raise ValueError(f"sequence length {l} does not fit the attention backward core")
    ws = torch.empty(lib.duodiff_attn_sublayer_bwd_workspace(b, l, d, num_heads),
                     dtype=torch.uint8, device=dev)
    dx = torch.empty_like(x)
    dg, db, dbp = (torch.empty(d, dtype=f32, device=dev) for _ in range(3))
    dwqkv = torch.empty((d, 3 * a), dtype=f32, device=dev)
    dbqkv = None if bqkv is None else torch.empty(3 * a, dtype=f32, device=dev)
    dwp = torch.empty((a, d), dtype=f32, device=dev)
    err = lib.duodiff_attn_sublayer_bwd(
        _ptr(x), _ptr(dy), _ptr(ln_s), _ptr(ln_b), _ptr(wqkv), _ptr(bqkv), _ptr(wp),
        _ptr(dx), _ptr(dg), _ptr(db), _ptr(dwqkv), _ptr(dbqkv), _ptr(dwp), _ptr(dbp),
        _ptr(ws), b, l, d, num_heads, eps, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on_error(lib, "attention sublayer backward kernel", err)
    return dx, dg, db, dwqkv, dbqkv, dwp, dbp


def _mlp_sublayer_bwd_cuda(x, dy, ln_s, ln_b, w1, b1, w2, *, gelu_approx: bool, eps: float):
    """Check the operands and launch K7 (csrc/mlp_sublayer_bwd.cu) with one
    scratch workspace; returns what :func:`mlp_sublayer_bwd_plain` does."""
    from duodiff_tpu_torch.ops._build import load_library

    if x.dim() != 3:
        raise ValueError(f"x must be (B, L, D), got {tuple(x.shape)}")
    b, l, d = x.shape
    hid = w1.shape[1]
    if d % 8 or hid % 8:
        raise ValueError(f"D and the hidden width must be multiples of 8: {d}, {hid}")
    dev, bf16, f32 = x.device, torch.bfloat16, torch.float32
    _check("x", x, (b, l, d), bf16, dev)
    _check("dy", dy, (b, l, d), bf16, dev)
    _check("ln_scale", ln_s, (d,), f32, dev)
    _check("ln_bias", ln_b, (d,), f32, dev)
    _check("w1", w1, (d, hid), bf16, dev)
    _check("b1", b1, (hid,), f32, dev)
    _check("w2", w2, (hid, d), bf16, dev)
    lib = load_library()
    ws = torch.empty(lib.duodiff_mlp_sublayer_bwd_workspace(b * l, d, hid), dtype=torch.uint8,
                     device=dev)
    dx = torch.empty_like(x)
    dg, db, db2 = (torch.empty(d, dtype=f32, device=dev) for _ in range(3))
    dw1 = torch.empty((d, hid), dtype=f32, device=dev)
    db1 = torch.empty(hid, dtype=f32, device=dev)
    dw2 = torch.empty((hid, d), dtype=f32, device=dev)
    err = lib.duodiff_mlp_sublayer_bwd(
        _ptr(x), _ptr(dy), _ptr(ln_s), _ptr(ln_b), _ptr(w1), _ptr(b1), _ptr(w2),
        _ptr(dx), _ptr(dg), _ptr(db), _ptr(dw1), _ptr(db1), _ptr(dw2), _ptr(db2),
        _ptr(ws), b * l, d, hid, 2 if gelu_approx else 1, eps,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on_error(lib, "MLP sublayer backward kernel", err)
    return dx, dg, db, dw1, db1, dw2, db2


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


def fused_attn_sublayer_bwd(x, dy, ln_s, ln_b, wqkv, bqkv, wp, *, num_heads: int,
                            eps: float = 1e-5):
    """K6: the gradients of K1 (:func:`attn_sublayer_bwd_plain`); wqkv
    (D, 3A) unscaled, wp (A, D), both in x's dtype."""
    if x.device.type == "cpu":
        return attn_sublayer_bwd_plain(x, dy, ln_s, ln_b, wqkv, bqkv, wp,
                                       num_heads=num_heads, eps=eps)
    grads = _attn_sublayer_bwd_cuda(x, dy, ln_s, ln_b, wqkv, bqkv, wp,
                                    num_heads=num_heads, eps=eps)
    fused_attn_sublayer_bwd.launches += 1
    return grads


def fused_mlp_sublayer_bwd(x, dy, ln_s, ln_b, w1, b1, w2, *, gelu_approx: bool = False,
                           eps: float = 1e-5):
    """K7: the gradients of K2 (:func:`mlp_sublayer_bwd_plain`); w1 (D, Hd)
    and w2 (Hd, D) in x's dtype."""
    if x.device.type == "cpu":
        return mlp_sublayer_bwd_plain(x, dy, ln_s, ln_b, w1, b1, w2,
                                      gelu_approx=gelu_approx, eps=eps)
    grads = _mlp_sublayer_bwd_cuda(x, dy, ln_s, ln_b, w1, b1, w2,
                                   gelu_approx=gelu_approx, eps=eps)
    fused_mlp_sublayer_bwd.launches += 1
    return grads


fused_attn_sublayer.launches = 0
fused_mlp_sublayer.launches = 0
fused_attn_sublayer_bwd.launches = 0
fused_mlp_sublayer_bwd.launches = 0


class FusedAttnSublayerFn(torch.autograd.Function):
    """K1 forward, K6 backward, on the live torch-layout parameters: the
    counterpart of pallas_block.fused_attn_sublayer_trainable. The forward
    packs the operands as :func:`pack_attn` does (scale folded into q); the
    backward takes the unscaled qkv weight in x's dtype, as K6 does, and
    returns fp32 parameter gradients in torch layout."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, qkv_w, qkv_b, proj_w, proj_b, num_heads, eps):
        ops = _detached(attn_operands(ln_w, ln_b, qkv_w, qkv_b, proj_w, proj_b,
                                      num_heads=num_heads, dtype=x.dtype))
        ctx.save_for_backward(x, ln_w, ln_b, qkv_w, qkv_b, proj_w)
        ctx.num_heads, ctx.eps = num_heads, eps
        return fused_attn_sublayer(x, *ops, num_heads=num_heads, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x, ln_w, ln_b, qkv_w, qkv_b, proj_w = ctx.saved_tensors
        dt = x.dtype
        dx, dg, db, dwqkv, dbqkv, dwp, dbp = fused_attn_sublayer_bwd(
            x, dy.to(dt).contiguous(), ln_w.float().contiguous(), ln_b.float().contiguous(),
            qkv_w.t().to(dt).contiguous(),
            None if qkv_b is None else qkv_b.float().contiguous(),
            proj_w.t().to(dt).contiguous(), num_heads=ctx.num_heads, eps=ctx.eps,
        )
        return dx, dg, db, dwqkv.t(), dbqkv, dwp.t(), dbp, None, None


class FusedMlpSublayerFn(torch.autograd.Function):
    """K2 forward, K7 backward, on the live torch-layout parameters: the
    counterpart of pallas_block.fused_mlp_sublayer_trainable."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, gelu_approx, eps):
        ops = _detached(mlp_operands(ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, dtype=x.dtype))
        ctx.save_for_backward(x, ln_w, ln_b, fc1_w, fc1_b, fc2_w)
        ctx.gelu_approx, ctx.eps = gelu_approx, eps
        return fused_mlp_sublayer(x, *ops, gelu_approx=gelu_approx, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x, ln_w, ln_b, fc1_w, fc1_b, fc2_w = ctx.saved_tensors
        dt = x.dtype
        dx, dg, db, dw1, db1, dw2, db2 = fused_mlp_sublayer_bwd(
            x, dy.to(dt).contiguous(), ln_w.float().contiguous(), ln_b.float().contiguous(),
            fc1_w.t().to(dt).contiguous(), fc1_b.float().contiguous(),
            fc2_w.t().to(dt).contiguous(), gelu_approx=ctx.gelu_approx, eps=ctx.eps,
        )
        return dx, dg, db, dw1.t(), db1, dw2.t(), db2, None, None
