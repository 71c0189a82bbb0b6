"""Standalone scaled dot-product attention and its backward (counterpart of
``duodiff_tpu/ops/pallas_attention.py``).

- :func:`flash_attention`: ``softmax(q k^T / sqrt(Dh)) v`` on (B, H, L, Dh)
  tensors (K9, ``csrc/flash_attention.cu``; the Pallas ``_kernel``);
- :func:`flash_attention_bwd`: dq, dk, dv from q, k, v and do (K10,
  ``csrc/flash_attention_bwd.cu``; the Pallas ``_bwd_kernel``);
- :class:`FlashAttentionFn`: the two paired for autograd (the counterpart of
  ``flash_attention_trainable``). The forward saves only q, k and v: the
  backward rebuilds the softmax, so no (L, L) tensor is ever written to
  device memory.

Each wrapper takes the plain PyTorch version (:func:`flash_attention_plain`,
:func:`flash_attention_bwd_plain`) for a tensor on the CPU. For a CUDA
tensor it launches its kernel or raises; it counts its launches in
``.launches``. The kernels take bf16 and head width 64.

Numerics follow the Pallas kernels: q * scale in fp32 rounded to the input
dtype, fp32 scores, row max and exp, the fp32 sum of the unrounded e as the
denominator, e rounded to the input dtype for the value product, fp32
accumulation, the division after the value product, one rounding of each
output.
"""

from __future__ import annotations

import torch

from duodiff_tpu_torch.ops.block import HEAD_DIM, _check, _check_seq_len, _ptr, _raise_on_error


def _softmax_parts(q, k):
    """(qsc, e, r) of the Pallas kernels in fp32: qsc = q * scale rounded to
    q's dtype, e = exp(s - rowmax(s)) for s = qsc k^T, r = 1 / rowsum(e)."""
    dt = q.dtype
    scale = float(q.shape[-1]) ** -0.5
    qsc = (q.float() * scale).to(dt).float()
    s = qsc @ k.float().transpose(-1, -2)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return qsc, e, 1.0 / e.sum(-1, keepdim=True)


def flash_attention_plain(q, k, v):
    """Plain PyTorch K9 (pallas_attention._kernel); (B, H, L, Dh) in q's dtype."""
    dt = q.dtype
    _, e, _ = _softmax_parts(q, k)
    o = e.to(dt).float() @ v.float()
    return (o / e.sum(-1, keepdim=True)).to(dt)


def flash_attention_bwd_plain(q, k, v, do):
    """Plain PyTorch K10 (pallas_attention._bwd_kernel): (dq, dk, dv) in q's
    dtype for the unscaled q. Rounds to the input dtype where the Pallas
    kernel does: qsc, bf16(e), bf16(do * r), bf16(do), dsp, bf16(qsc * r) and
    the three outputs."""
    dt = q.dtype
    scale = float(q.shape[-1]) ** -0.5
    qsc, e, r = _softmax_parts(q, k)
    kf, vf, dof = k.float(), v.float(), do.float()
    eb = e.to(dt).float()
    dv = eb.transpose(-1, -2) @ (dof * r).to(dt).float()
    dp = dof.to(dt).float() @ vf.transpose(-1, -2)
    c = (dp * e).sum(-1, keepdim=True) * r
    dsp = (e * (dp - c)).to(dt).float()
    dq = (dsp @ kf) * (r * scale)
    dk = dsp.transpose(-1, -2) @ (qsc * r).to(dt).float()
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _dims(q, tensors: dict):
    """(B, H, L) of (B, H, L, 64) bf16 CUDA tensors the kernels take."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, L, Dh), got {tuple(q.shape)}")
    b, h, l, dh = q.shape
    if dh != HEAD_DIM:
        raise ValueError(f"the attention kernels take head width {HEAD_DIM}, got {dh}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the attention kernels take bfloat16 on a CUDA device, got {q.dtype}: "
                        "use impl 'xla' for other dtypes")
    for name, t in tensors.items():
        _check(name, t, (b, h, l, dh), torch.bfloat16, q.device)
    return b, h, l


def _flash_attention_cuda(q, k, v):
    """Check the operands and launch K9 (csrc/flash_attention.cu)."""
    from duodiff_tpu_torch.ops._build import load_library

    b, h, l = _dims(q, {"q": q, "k": k, "v": v})
    lib = load_library()
    _check_seq_len(lib, l)
    out = torch.empty_like(q)
    err = lib.duodiff_flash_attention(_ptr(q), _ptr(k), _ptr(v), _ptr(out), b, h, l,
                                      torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on_error(lib, "attention kernel", err)
    return out


def _flash_attention_bwd_cuda(q, k, v, do):
    """Check the operands and launch K10 (csrc/flash_attention_bwd.cu)."""
    from duodiff_tpu_torch.ops._build import load_library

    b, h, l = _dims(q, {"q": q, "k": k, "v": v, "do": do})
    lib = load_library()
    _check_seq_len(lib, l, backward=True)
    stats = torch.empty(lib.duodiff_flash_attention_bwd_stats(b, h, l), dtype=torch.float32,
                        device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    err = lib.duodiff_flash_attention_bwd(
        _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(dq), _ptr(dk), _ptr(dv), _ptr(stats),
        b, h, l, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on_error(lib, "attention backward kernel", err)
    return dq, dk, dv


def flash_attention(q, k, v):
    """K9: q, k, v (B, H, L, Dh) contiguous -> (B, H, L, Dh) in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    out = _flash_attention_cuda(q, k, v)
    flash_attention.launches += 1
    return out


def flash_attention_bwd(q, k, v, do):
    """K10: (dq, dk, dv) of :func:`flash_attention` for the output gradient
    ``do``, each (B, H, L, Dh) in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, do)
    grads = _flash_attention_bwd_cuda(q, k, v, do)
    flash_attention_bwd.launches += 1
    return grads


flash_attention.launches = 0
flash_attention_bwd.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """K9 forward, K10 backward; saves q, k and v only."""

    @staticmethod
    def forward(ctx, q, k, v):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        ctx.save_for_backward(q, k, v)
        return flash_attention(q, k, v)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return flash_attention_bwd(q, k, v, do.to(q.dtype).contiguous())


class FlashAttentionPlainFn(torch.autograd.Function):
    """The plain versions of K9 and K10 paired the same way, on any device:
    what :class:`FlashAttentionFn` is held against."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return flash_attention_plain(q, k, v)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return flash_attention_bwd_plain(q, k, v, do.to(q.dtype))
