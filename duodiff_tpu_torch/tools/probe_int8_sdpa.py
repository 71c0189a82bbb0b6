"""Probe: is an int8 attention core worth adding to the int8 sublayer kernel?
(Counterpart of the repository's ``tools/probe_int8_sdpa.py``.)

    python -m duodiff_tpu_torch.tools.probe_int8_sdpa

The W8A8 attention sublayer leaves its core in bf16: the scores q k^T (K =
Dh = 64) and the probability-value product e v (K = L = 257). This probe
times kernels of just that chain, without the softmax scale, at the flagship
geometry (batch 128, 8 heads, L = 257, Dh = 64), K15's two forms
(``ops/sdpa_int8.py``):

  bf16:  s = q k^T; e = exp(s - max); o = (e v) / denom
  int8:  q, k quantized per row (rank-1 dequant of s), e quantized with the
         exact scale 1/127 (max(e) == 1 by construction), v per column;
         the softmax stays fp32

Timing: ``--iters`` calls chained (``o * 1.01`` rounded to bf16 feeds q),
one warm-up chain, then CUDA events around the timed chain: an event pair
times the device's work itself, so the JAX tool's difference of two trip
counts, its way around a dispatch it could not time, has no counterpart. It
prints the card's name and power limit, the ms per call of both forms and
per 13-block step, their ratio, and the relative L2 error of the int8 form
against the bf16 one on one call. It runs on the card unless ``--device
cpu``, where both wrappers take their plain versions and the times say
nothing about the card. A kernel that fails to launch raises.

RESULT (NVIDIA H100 80GB HBM3, 700.00 W; runs of this tool):
NEGATIVE on this card too. With both cores in their first design (fp32
score rows in shared memory, the same two-pass softmax, one block an SM)
the int8 chain took 1.83 ms a call against 1.34-1.36 for bf16 (0.73-0.74x),
at 2.56e-2 relative L2 from the bf16 output: the tensor-core products are a
small part of such a block's time, so halving them buys less than
quantizing q, k, v and e costs. A first int8 form that quantized k and v
straight from device memory took 2.16-2.17 ms (0.62-0.63x). Since the bf16
core keeps its scores in registers (csrc/attn_core.cuh) its chain takes
0.27-0.34 ms a call, and the int8 core, still in its first design at
1.84-1.85 ms, stands at 0.15-0.18x. The W8A8 attention sublayer therefore
keeps its core in bf16.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from duodiff_tpu_torch.ops import sdpa_int8
from duodiff_tpu_torch.tools._measure import card_line, chain_ms, device_from_arg

L, DH, H = 257, 64, 8
B = 128
ITERS = 50
DEPTH = 13


def main(argv=None) -> dict:
    """Run the probe; returns {"card", "ms": {"bf16", "int8"}, "speedup",
    "rel_l2_err", "launches": {"bf16", "int8"}}, the launches as the wrappers
    counted them during the run."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--batch", type=int, default=B, help="samples per call (default 128)")
    p.add_argument("--iters", type=int, default=ITERS, help="calls per chain")
    args = p.parse_args(argv)
    device = device_from_arg(args.device)
    card = card_line(device)
    print(card)
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(args.batch, H, L, DH).astype(np.float32))
               .to(torch.bfloat16).to(device) for _ in range(3))
    forms = {"bf16": sdpa_int8.sdpa_chain_bf16, "int8": sdpa_int8.sdpa_chain_int8}
    before = {name: fn.launches for name, fn in forms.items()}

    ms = {}
    with torch.no_grad():
        for name, fn in forms.items():
            ms[name] = chain_ms(lambda t, fn=fn: (fn(t, k, v).float() * 1.01).to(t.dtype),
                                q, args.iters)
        a, b = forms["int8"](q, k, v).float(), forms["bf16"](q, k, v).float()
        rel = ((a - b).norm() / b.norm()).item()
    for name in forms:
        print(f"sdpa {name}: {ms[name]:.3f} ms/call ({ms[name] * DEPTH:.2f} ms/{DEPTH}-block step)")
    print(f"speedup: {ms['bf16'] / ms['int8']:.2f}x")
    print(f"rel l2 err int8 vs bf16: {rel}")
    launches = {name: fn.launches - before[name] for name, fn in forms.items()}
    return {"card": card, "ms": ms, "speedup": ms["bf16"] / ms["int8"], "rel_l2_err": rel,
            "launches": launches}


if __name__ == "__main__":
    main()
