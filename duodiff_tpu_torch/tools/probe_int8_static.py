"""Probe: do static (calibrated) activation scales beat the dynamic per-row
quantization inside the int8 sublayer kernels? (Counterpart of the
repository's ``tools/probe_int8_static.py``.)

    python -m duodiff_tpu_torch.tools.probe_int8_static

The W8A8 sublayers quantize activations per row: a row maximum, a
reciprocal and a (row x column) dequant, after each LayerNorm, on the merged
heads and on the GELU output. With one static scale per site that becomes a
multiply, round and clip, with the row factor folded into the weights'
column scales. The probe times the dynamic and the static twin of both
sublayers (K13: the MLP, ``ops/block_int8.py:fused_mlp_sublayer_int8``; K14:
attention, ``fused_attn_sublayer_int8``) at the flagship sampling geometry
(batch 128, L = 257, D = 512, hidden 2048, 8 heads of 64, tanh GELU), on
operands drawn from ``np.random.RandomState(0)`` in the JAX tool's order,
with its scales (8.0 / 6.0 for the MLP, 8.0 / 4.0 for attention).

Timing: ``--iters`` calls chained (``y * 0.999`` rounded to bf16 feeds the
next call, so the int8 codes see moving data), one warm-up chain, then CUDA
events around the timed chain. It prints the card's name and power limit,
then for each sublayer the ms per call of both twins and the saving, and the
saving projected onto a depth-13 step. It runs on the card unless ``--device
cpu``, where every wrapper takes its plain version and the times say nothing
about the card; ``--batch`` and ``--iters`` cut that rehearsal to size. A
kernel that fails to launch raises.

RESULT (NVIDIA H100 80GB HBM3, 700.00 W; four runs of this tool): static
scales pay in the MLP and hardly in attention. MLP 1.149-1.168 ms a call
dynamic against 0.903-0.908 static (21.1-22.7 % saved: the dynamic form
writes the fp32 hidden to device memory and reads it back for its row
maxima, the static fc1 epilogue quantizes directly); attention 1.797-1.830
against 1.743-1.776 (2.8-3.4 %: two row-maximum passes over rows already in
cache; the bf16 core, most of the sublayer, is the same); 3.85-4.11 ms
projected onto a depth-13 step.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from duodiff_tpu_torch.ops import block_int8 as q8
from duodiff_tpu_torch.tools._measure import card_line, chain_ms, device_from_arg

B, L, D, HID, H = 128, 257, 512, 2048, 8
MLP_SCALES = (8.0, 6.0)    # post-LayerNorm, post-GELU: representative calibrated amax values
ATTN_SCALES = (8.0, 4.0)   # post-LayerNorm, merged heads
ITERS = 50
DEPTH = 13


def _packed(w: np.ndarray, device, extra_col_scale=None):
    """A (K, N) fp32 kernel as the wrappers take it: int8 codes (N, K) and
    fp32 column scales (N,)."""
    w8, scale = q8.quantize_weight_int8(torch.from_numpy(w), extra_col_scale=extra_col_scale)
    return w8.t().contiguous().to(device), scale.contiguous().to(device)


def operands(batch: int, device) -> dict:
    """x and the two sublayers' operands, dynamic and static, from one
    ``RandomState(0)`` in the JAX tool's order of draws."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(batch, L, D).astype(np.float32)).to(torch.bfloat16).to(device)
    gamma = torch.from_numpy(rng.randn(D).astype(np.float32) * 0.1 + 1.0).to(device)
    beta = torch.from_numpy(rng.randn(D).astype(np.float32) * 0.1).to(device)

    w1_8, s1 = _packed(rng.randn(D, HID).astype(np.float32) * 0.02, device)
    w2_8, s2 = _packed(rng.randn(HID, D).astype(np.float32) * 0.02, device)
    b1, b2 = torch.zeros(HID, device=device), torch.zeros(D, device=device)
    sx, sh = MLP_SCALES
    mlp = {
        "dynamic": (gamma, beta, w1_8, s1, b1, w2_8, s2, b2, None),
        "static": (gamma, beta, w1_8, s1 * (sx / 127.0), b1, w2_8, s2 * (sh / 127.0), b2,
                   q8.static_inv(MLP_SCALES, device)),
    }

    softmax_scale = (D // H) ** -0.5
    col_extra = torch.cat([torch.full((D,), softmax_scale), torch.ones(2 * D)])
    wqkv8, sqkv = _packed(rng.randn(D, 3 * D).astype(np.float32) * 0.02, device, col_extra)
    wp8, sp = _packed(rng.randn(D, D).astype(np.float32) * 0.02, device)
    bp = torch.zeros(D, device=device)
    sxa, sm = ATTN_SCALES
    attn = {
        "dynamic": (gamma, beta, wqkv8, sqkv, None, wp8, sp, bp, None),
        "static": (gamma, beta, wqkv8, sqkv * (sxa / 127.0), None, wp8, sp * (sm / 127.0), bp,
                   q8.static_inv(ATTN_SCALES, device)),
    }
    return {"x": x, "mlp": mlp, "attn": attn}


def _next_input(y: torch.Tensor) -> torch.Tensor:
    return (y.float() * 0.999).to(y.dtype)


def main(argv=None) -> dict:
    """Run the probe; returns {"card", "ms": {"mlp_dynamic", "mlp_static",
    "attn_dynamic", "attn_static"}, "projected_step_saving_ms", "launches":
    {"mlp": {"dynamic", "static"}, "attn": {"dynamic", "static"}}}, the
    launches as the wrappers counted them during the run."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--batch", type=int, default=B, help="samples per call (default 128)")
    p.add_argument("--iters", type=int, default=ITERS, help="calls per chain")
    args = p.parse_args(argv)
    device = device_from_arg(args.device)
    card = card_line(device)
    print(card)
    ops = operands(args.batch, device)
    x = ops["x"]
    wrappers = {"mlp": q8.fused_mlp_sublayer_int8, "attn": q8.fused_attn_sublayer_int8}
    before = {k: (w.launches_dynamic, w.launches_static) for k, w in wrappers.items()}

    ms = {}
    with torch.no_grad():
        for mode, args_ in ops["mlp"].items():
            ms[f"mlp_{mode}"] = chain_ms(
                lambda t, a=args_: _next_input(q8.fused_mlp_sublayer_int8(t, *a, gelu_approx=True)),
                x, args.iters)
        for mode, args_ in ops["attn"].items():
            ms[f"attn_{mode}"] = chain_ms(
                lambda t, a=args_: _next_input(q8.fused_attn_sublayer_int8(t, *a, num_heads=H)),
                x, args.iters)
    for name, key in (("MLP ", "mlp"), ("ATTN", "attn")):
        dyn, sta = ms[f"{key}_dynamic"], ms[f"{key}_static"]
        print(f"{name} int8 dynamic {dyn:.3f} ms/call   static {sta:.3f} ms/call   "
              f"saving {dyn - sta:.3f} ms ({(1 - sta / dyn) * 100:.1f}%)")
    per_block = (ms["mlp_dynamic"] - ms["mlp_static"]) + (ms["attn_dynamic"] - ms["attn_static"])
    print(f"projected step saving at depth {DEPTH}: {per_block * DEPTH:.2f} ms")
    launches = {k: {"dynamic": w.launches_dynamic - before[k][0],
                    "static": w.launches_static - before[k][1]} for k, w in wrappers.items()}
    return {"card": card, "ms": ms, "projected_step_saving_ms": per_block * DEPTH,
            "launches": launches}


if __name__ == "__main__":
    main()
