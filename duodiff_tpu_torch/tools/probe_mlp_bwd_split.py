"""Probe of the split MLP backward kernel K8 (counterpart of the
repository's ``tools/probe_mlp_bwd_split.py``). ``splits`` bounds K8's
scratch: the JAX kernel cuts the hidden width into that many slices, the
port's kernel cuts the rows into that many chunks, each over the whole
hidden width (``ops/block.py:fused_mlp_sublayer_bwd_split``):

    python -m duodiff_tpu_torch.tools.probe_mlp_bwd_split [imagenet64|imagenet256] [splits ...]

At the MLP sublayer's shape in that model (batch 128, L = 258; D = 768 or
1024, hidden 4 D, bf16) it prints the card's name and power limit, the time
per call of K8 for each ``splits`` (default: what
``mlp_bwd_split_config`` picks), of the monolithic kernel K7, and of
autograd through the plain MLP sublayer (the JAX tool's "xla recompute
bwd"), then the largest absolute difference of dx, dW1 and dW2 between each
kernel and the latter. Inputs come from a seed. It runs on the card unless
``--device cpu``, where every wrapper takes its plain version and the times
say nothing about the card. A kernel that fails to launch raises.
"""

from __future__ import annotations

import argparse

import torch

from duodiff_tpu_torch.ops import block
from duodiff_tpu_torch.tools._measure import card_line, device_from_arg, time_ms

SHAPES = {"imagenet64": (128, 258, 768, 3072), "imagenet256": (128, 258, 1024, 4096)}
REPS = 10


def main(argv=None) -> dict:
    """Run the probe; returns {"card", "shape", "ms": {name: ms}, "max_abs_err":
    {name: {"dx", "dw1", "dw2"}}}."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("shape", nargs="?", default="imagenet64", choices=sorted(SHAPES))
    p.add_argument("splits", nargs="*", type=int)
    p.add_argument("--device", default="cuda")
    p.add_argument("--batch", type=int, default=None, help="override the shape's batch")
    p.add_argument("--reps", type=int, default=REPS)
    args = p.parse_args(argv)
    device = device_from_arg(args.device)
    b, l, d, hidden = SHAPES[args.shape]
    b = args.batch or b
    auto = block.mlp_bwd_split_config(hidden)
    card = card_line(device)
    print(card)
    print(f"shape={args.shape}: B={b} L={l} D={d} hidden={hidden} auto-splits={auto}")

    g = torch.Generator().manual_seed(0)
    bf = torch.bfloat16
    x = torch.randn((b, l, d), generator=g).to(bf).to(device)
    dy = torch.randn((b, l, d), generator=g).to(bf).to(device)
    ln_s, ln_b = torch.ones(d, device=device), torch.zeros(d, device=device)
    w1 = (torch.randn((d, hidden), generator=g) * 0.02).to(bf).to(device)
    w2 = (torch.randn((hidden, d), generator=g) * 0.02).to(bf).to(device)
    b1, b2 = torch.zeros(hidden, device=device), torch.zeros(d, device=device)
    ops = (x, dy, ln_s, ln_b, w1, b1, w2)

    def autograd_bwd():
        # fp32 copies of the bf16 weights, so their gradients come in fp32 as the kernels' do
        leaves = [x.detach().clone().requires_grad_(), w1.float().requires_grad_(),
                  w2.float().requires_grad_()]
        y = block.mlp_sublayer_plain(leaves[0], ln_s, ln_b, leaves[1], b1, leaves[2], b2)
        return torch.autograd.grad(y, leaves, dy)

    runs = {"autograd through mlp_sublayer_plain": autograd_bwd,
            "K7 monolithic": lambda: block.fused_mlp_sublayer_bwd(*ops)}
    for n in args.splits or [auto]:
        runs[f"K8 splits={n}"] = lambda n=n: block.fused_mlp_sublayer_bwd_split(*ops, splits=n)
    ms = {name: time_ms(fn, device, args.reps) for name, fn in runs.items()}
    ref = autograd_bwd()
    errs = {}
    for name, fn in runs.items():
        print(f"{name}: {ms[name]:.6g} ms/call")
        if name.startswith("autograd"):
            continue
        out = fn()
        errs[name] = {k: (a.float() - r.float()).abs().max().item()
                      for k, a, r in (("dx", out[0], ref[0]), ("dw1", out[3], ref[1]),
                                      ("dw2", out[5], ref[2]))}
        print("  " + ", ".join(f"{k}: max abs err vs autograd {v:.3e}"
                               for k, v in errs[name].items()))
    return {"card": card, "shape": args.shape, "ms": ms, "max_abs_err": errs}


if __name__ == "__main__":
    main()
