"""Standalone scaled dot-product attention and its backward (counterpart of
``duodiff_tpu/ops/pallas_attention.py``).

- :func:`flash_attention`: ``softmax(q k^T / sqrt(Dh)) v`` on (B, H, L, Dh)
  tensors (K9, ``csrc/flash_attention.cu``; the Pallas ``_kernel``);
- :func:`flash_attention_bwd`: dq, dk, dv from q, k, v and do (K10,
  ``csrc/flash_attention_bwd.cu``; the Pallas ``_bwd_kernel``);
- :class:`FlashAttentionFn`: the two paired for autograd (the counterpart of
  ``flash_attention_trainable``). The forward saves only q, k and v: the
  backward rebuilds the softmax, so no (L, L) tensor is ever written to
  device memory;
- :func:`attn_core_form` and :func:`attn_bwd_core_form`: the forward and
  the backward core alone in either of their forms, measuring entries
  (``csrc/attn_core_entry.cu``) that no model calls.

Each wrapper takes the plain PyTorch version (:func:`flash_attention_plain`,
:func:`flash_attention_bwd_plain`) for a tensor on the CPU. For a CUDA
tensor it launches its kernel or raises; it counts its launches in
``.launches``. The kernels take bf16 and head width 64 or 72 (``HEAD_WIDTHS``),
and the lengths the library reports (``duodiff_attn_core_max_len`` and
``duodiff_attn_bwd_core_max_len``: each core's register form up to 272 and
its blocked form past it, at least 1,025, the CelebA-64 U-ViT at patch 2).

Numerics follow the Pallas kernels: q * scale in fp32 rounded to the input
dtype, fp32 scores, row max and exp, the fp32 sum of the unrounded e as the
denominator, e rounded to the input dtype for the value product, fp32
accumulation, the division after the value product, one rounding of each
output.
"""

from __future__ import annotations

import torch

from duodiff_tpu_torch.ops.block import (
    HEAD_WIDTHS,
    _check,
    _check_seq_len,
    _ptr,
    _raise_on_error,
    _widths_text,
)


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


def _dims(q, tensors: dict, widths=HEAD_WIDTHS):
    """(B, H, L, Dh) of (B, H, L, Dh) bf16 CUDA tensors the kernels take, Dh
    one of ``widths``."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, L, Dh), got {tuple(q.shape)}")
    b, h, l, dh = q.shape
    if dh not in widths:
        raise ValueError(f"the attention kernels take head width {_widths_text(widths)}, "
                         f"got {dh}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the attention kernels take bfloat16 on a CUDA device, got {q.dtype}: "
                        "use impl 'xla' for other dtypes")
    for name, t in tensors.items():
        _check(name, t, (b, h, l, dh), torch.bfloat16, q.device)
    return b, h, l, dh


def _flash_attention_cuda(q, k, v):
    """Check the operands and launch K9 (csrc/flash_attention.cu)."""
    from duodiff_tpu_torch.ops._build import load_library

    b, h, l, dh = _dims(q, {"q": q, "k": k, "v": v})
    lib = load_library()
    _check_seq_len(lib, l, dh)
    out = torch.empty_like(q)
    err = lib.duodiff_flash_attention(_ptr(q), _ptr(k), _ptr(v), _ptr(out), b, h, l, dh,
                                      torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on_error(lib, "attention kernel", err)
    return out


def _flash_attention_bwd_cuda(q, k, v, do):
    """Check the operands and launch K10 (csrc/flash_attention_bwd.cu)."""
    from duodiff_tpu_torch.ops._build import load_library

    b, h, l, dh = _dims(q, {"q": q, "k": k, "v": v, "do": do})
    lib = load_library()
    _check_seq_len(lib, l, dh, backward=True)
    stats = torch.empty(lib.duodiff_flash_attention_bwd_stats(b, h, l), dtype=torch.float32,
                        device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    err = lib.duodiff_flash_attention_bwd(
        _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(dq), _ptr(dk), _ptr(dv), _ptr(stats),
        b, h, l, dh, torch.cuda.current_stream(q.device).cuda_stream,
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

# the forms of a core the measuring entries take (csrc/attn_tiles.cuh
# CoreForm): by L as the kernels pick it, or one of the two forced
CORE_FORMS = {"auto": 0, "registers": 1, "blocked": 2}


def _check_form(lib, form: str, l: int, what: str) -> None:
    """Raise unless ``form`` is one of CORE_FORMS and, forced to the register
    form, L fits it (the limit the library reports)."""
    if form not in CORE_FORMS:
        raise ValueError(f"form must be one of {sorted(CORE_FORMS)}, got {form!r}")
    if form == "registers" and l > lib.duodiff_attn_core_registers_max_len():
        raise ValueError(f"sequence length {l} does not fit the register form of the {what} "
                         f"(at most {lib.duodiff_attn_core_registers_max_len()})")


def attn_core_form_plain(q, k, v, *, norm_first: bool = False, scale: float | None = None):
    """Plain PyTorch forward core on (B, H, L, Dh) in q's dtype, ``scale``
    1 / sqrt(Dh) by default. The default form is K9's with any scale (q *
    scale rounded to q's dtype, the division after e v; scale 1 leaves q
    as it is, K15's bf16 form); ``norm_first`` is K1-v1's per-head core
    (the fp32 scores times scale, p = e / sum rounded before p v)."""
    dt = q.dtype
    scale = float(q.shape[-1]) ** -0.5 if scale is None else scale
    kt, vf = k.float().transpose(-1, -2), v.float()
    if norm_first:
        s = (q.float() @ kt) * scale
        p = torch.softmax(s, dim=-1).to(dt).float()
        return (p @ vf).to(dt)
    qsc = q.float() if scale == 1.0 else (q.float() * scale).to(dt).float()
    s = qsc @ kt
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return ((e.to(dt).float() @ vf) / e.sum(-1, keepdim=True)).to(dt)


def attn_core_form(q, k, v, *, form: str = "auto", norm_first: bool = False,
                   scale: float | None = None):
    """The forward attention core alone (``csrc/attn_core_entry.cu``, a
    measuring entry that no model calls): q, k, v (B, H, L, Dh) bf16
    contiguous -> (B, H, L, Dh), in the form ``form`` (``CORE_FORMS``: the
    register form takes L <= 272, the blocked one any L the core takes), the
    default or the normalise-first form, as :func:`attn_core_form_plain`.
    On the CPU it is that plain version; it counts its launches in
    ``.launches``."""
    if q.device.type == "cpu":
        return attn_core_form_plain(q, k, v, norm_first=norm_first, scale=scale)
    from duodiff_tpu_torch.ops._build import load_library

    b, h, l, dh = _dims(q, {"q": q, "k": k, "v": v})
    lib = load_library()
    _check_seq_len(lib, l, dh)
    _check_form(lib, form, l, "attention core")
    out = torch.empty_like(q)
    err = lib.duodiff_attn_core_form(
        _ptr(q), _ptr(k), _ptr(v), _ptr(out), b, h, l, dh, CORE_FORMS[form], int(norm_first),
        float(dh) ** -0.5 if scale is None else scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on_error(lib, "attention core", err)
    attn_core_form.launches += 1
    return out


attn_core_form.launches = 0


def attn_bwd_core_form_plain(q, k, v, do, *, with_o: bool = False):
    """Plain PyTorch backward core on (B, H, L, Dh) in q's dtype: K10's
    (dq, dk, dv), and with ``with_o`` K6's core, which also gives the forward
    output first: (o, dq, dk, dv)."""
    grads = flash_attention_bwd_plain(q, k, v, do)
    return (flash_attention_plain(q, k, v), *grads) if with_o else grads


def attn_bwd_core_form(q, k, v, do, *, form: str = "auto", with_o: bool = False):
    """The backward attention core alone (``csrc/attn_core_entry.cu``, a
    measuring entry that no model calls): q, k, v, do (B, H, L, Dh) bf16
    contiguous -> (dq, dk, dv), or (o, dq, dk, dv) with ``with_o`` (K6's
    core writes the forward output too), in the form ``form``
    (``CORE_FORMS``: the register form takes L <= 272, the blocked one any
    L the core takes), as :func:`attn_bwd_core_form_plain`. On the CPU it
    is that plain version; it counts its launches in ``.launches``."""
    if q.device.type == "cpu":
        return attn_bwd_core_form_plain(q, k, v, do, with_o=with_o)
    from duodiff_tpu_torch.ops._build import load_library

    b, h, l, dh = _dims(q, {"q": q, "k": k, "v": v, "do": do})
    lib = load_library()
    _check_seq_len(lib, l, dh, backward=True)
    _check_form(lib, form, l, "attention backward core")
    stats = torch.empty(lib.duodiff_flash_attention_bwd_stats(b, h, l), dtype=torch.float32,
                        device=q.device)
    outs = [torch.empty_like(q) for _ in range(4 if with_o else 3)]
    o = _ptr(outs[0]) if with_o else None
    dq, dk, dv = outs[-3:]
    err = lib.duodiff_attn_bwd_core_form(
        _ptr(q), _ptr(k), _ptr(v), _ptr(do), o, _ptr(dq), _ptr(dk), _ptr(dv), _ptr(stats),
        b, h, l, dh, CORE_FORMS[form], torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on_error(lib, "attention backward core", err)
    attn_bwd_core_form.launches += 1
    return tuple(outs)


attn_bwd_core_form.launches = 0


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
