"""Attention dispatch (counterpart of ``duodiff_tpu/ops/attention.py``).

``softmax(q k^T / sqrt(Dh)) v`` on (B, H, L, Dh) tensors, always with an
fp32 softmax: as plain PyTorch (:func:`xla_attention`, the JAX package's
plain XLA path, which has no Pallas kernel) or through the attention
kernels K9 and K10 (``impl="pallas"``). The impl names are the JAX
package's, so its CLIs' flag values carry over.
"""

from __future__ import annotations

import math

import torch

from duodiff_tpu_torch.ops.flash_attention import FlashAttentionFn, FlashAttentionPlainFn

ATTENTION_IMPLS = ("auto", "xla", "pallas", "pallas_plain")


def xla_attention(q, k, v):
    """Plain scaled dot-product attention: fp32 logits times the scale, fp32
    softmax, the weights cast to v's dtype for the value product with fp32
    accumulation. Returns (B, H, L, Dh) fp32."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    weights = torch.softmax(logits, dim=-1)
    return torch.matmul(weights.to(v.dtype).float(), v.float())


def multi_head_attention(q, k, v, *, impl: str = "auto"):
    """Dispatch by ``impl``:

    - ``"xla"`` / ``"auto"``: :func:`xla_attention`, differentiable by autograd;
    - ``"pallas"``: K9 forward and K10 backward (:class:`FlashAttentionFn`; on
      the CPU their plain versions), output in q's dtype;
    - ``"pallas_plain"``: the plain versions of K9 and K10 on any device.
    """
    if impl == "pallas":
        return FlashAttentionFn.apply(q, k, v)
    if impl == "pallas_plain":
        return FlashAttentionPlainFn.apply(q, k, v)
    if impl in ("xla", "auto"):
        return xla_attention(q, k, v)
    raise ValueError(f"impl must be one of {ATTENTION_IMPLS}, got {impl!r}")
