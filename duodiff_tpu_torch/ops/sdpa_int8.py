"""The attention chain alone, bf16 and int8 (counterpart of the two kernel
bodies of the repository's ``tools/probe_int8_sdpa.py``, K15).

Both forms compute ``softmax(q k^T) v`` on (B, H, L, Dh) tensors **without**
the ``1/sqrt(Dh)`` scale: the probe times the chain, not an attention layer.

- :func:`sdpa_chain_bf16`: fp32 scores, ``e = exp(s - max)`` rounded to the
  input dtype for the value product, the division by the fp32 sum of the
  unrounded e after it (``_sdpa_bf16_kernel``). On the card it is the
  attention core of K1 and K9 (``csrc/attn_core.cuh``) launched with no
  scale through ``csrc/sdpa_int8.cu``.
- :func:`sdpa_chain_int8`: q and k quantized per row from fp32, the int32
  scores dequantized as ``float(s32) * (sq * sk^T)``, an fp32 softmax,
  ``e8 = round(e * 127)`` (the largest e is 1, so no clip), v quantized per
  column over the tokens, ``o = float(o32) * ((vmax / 127) / 127)``, then the
  division by the sum of the unrounded e (``_sdpa_int8_kernel``;
  ``csrc/attn_core_int8.cuh``, with the score rows in registers as in the
  bf16 core).

Each wrapper takes its plain PyTorch version (:func:`sdpa_chain_bf16_plain`,
:func:`sdpa_chain_int8_plain`) for a tensor on the CPU. For a CUDA tensor it
launches its kernel or raises; it counts its launches in ``.launches``. The
kernels take bf16; the bf16 form head width 64 or 72 and the forward core's
lengths (its blocked form past 272), the int8 form head width 64 and
L <= 272. The plain int8 products go through
float64, which holds every partial sum of int8 products exactly, as XLA's
int32 ``dot_general`` does.
"""

from __future__ import annotations

import torch

from duodiff_tpu_torch.ops.block import (
    _MAX_SMEM_BYTES,
    HEAD_WIDTHS,
    _check_seq_len,
    _ptr,
    _raise_on_error,
)
from duodiff_tpu_torch.ops.block_int8 import _quant_rows
from duodiff_tpu_torch.ops.flash_attention import _dims


def sdpa_chain_bf16_plain(q, k, v):
    """Plain PyTorch ``_sdpa_bf16_kernel``; (B, H, L, Dh) in q's dtype."""
    dt = q.dtype
    s = q.float() @ k.float().transpose(-1, -2)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    o = e.to(dt).float() @ v.float()
    return (o / e.sum(-1, keepdim=True)).to(dt)


def sdpa_int8_parts(q, k, v) -> dict:
    """The int8 chain's intermediates: the codes ``q8``, ``k8`` (per row),
    ``v8`` (per column over the tokens) and ``e8`` as int8, the scales
    ``sq``, ``sk`` (..., L, 1) and ``vmax`` (..., 1, Dh), and ``denom``, the
    fp32 row sum of the unrounded e."""
    q8, sq = _quant_rows(q.float())
    k8, sk = _quant_rows(k.float())
    s32 = torch.matmul(q8.double(), k8.double().transpose(-1, -2)).float()
    s = s32 * (sq * sk.transpose(-1, -2))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    vf = v.float()
    vmax = vf.abs().amax(-2, keepdim=True)
    vinv = torch.where(vmax > 0, vmax.new_tensor(127.0) / vmax, torch.ones_like(vmax))
    v8 = torch.clamp(torch.round(vf * vinv), -127, 127).to(torch.int8)
    return {"q8": q8, "sq": sq, "k8": k8, "sk": sk, "v8": v8, "vmax": vmax,
            "e8": torch.round(e * 127.0).to(torch.int8), "denom": e.sum(-1, keepdim=True)}


def sdpa_chain_int8_plain(q, k, v):
    """Plain PyTorch ``_sdpa_int8_kernel``; (B, H, L, Dh) in q's dtype."""
    p = sdpa_int8_parts(q, k, v)
    o32 = torch.matmul(p["e8"].double(), p["v8"].double()).float()
    o = o32 * ((p["vmax"] / 127.0) / 127.0)
    return (o / p["denom"]).to(q.dtype)


def _launch(entry: str, smem_entry: str | None, what: str, q, k, v):
    """Check the operands and launch one form of K15 (csrc/sdpa_int8.cu).
    smem_entry names the C entry that gives the int8 form's shared memory at
    a length, whose own limit on the length is held first; None holds the
    length to the bf16 core's limit."""
    from duodiff_tpu_torch.ops._build import load_library

    int8 = smem_entry is not None
    b, h, l, dh = _dims(q, {"q": q, "k": k, "v": v}, widths=(64,) if int8 else HEAD_WIDTHS)
    lib = load_library()
    _check_seq_len(lib, l, dh, int8=int8)
    if smem_entry is not None and getattr(lib, smem_entry)(l) > _MAX_SMEM_BYTES:
        raise ValueError(f"sequence length {l} does not fit the {what}")
    out = torch.empty_like(q)
    # the int8 entry has no width argument: its core takes 64 only
    err = getattr(lib, entry)(_ptr(q), _ptr(k), _ptr(v), _ptr(out), b, h, l,
                              *(() if int8 else (dh,)),
                              torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on_error(lib, what, err)
    return out


def sdpa_chain_bf16(q, k, v):
    """K15, bf16 form: q, k, v (B, H, L, Dh) contiguous -> (B, H, L, Dh)."""
    if q.device.type == "cpu":
        return sdpa_chain_bf16_plain(q, k, v)
    out = _launch("duodiff_sdpa_chain_bf16", None, "attention core", q, k, v)
    sdpa_chain_bf16.launches += 1
    return out


def sdpa_chain_int8(q, k, v):
    """K15, int8 form: q, k, v (B, H, L, Dh) contiguous -> (B, H, L, Dh)."""
    if q.device.type == "cpu":
        return sdpa_chain_int8_plain(q, k, v)
    out = _launch("duodiff_sdpa_chain_int8", "duodiff_sdpa_int8_smem_bytes",
                  "int8 attention core", q, k, v)
    sdpa_chain_int8.launches += 1
    return out


def reset_launch_counts() -> None:
    """Set both forms' launch counters to 0."""
    sdpa_chain_bf16.launches = 0
    sdpa_chain_int8.launches = 0


reset_launch_counts()
