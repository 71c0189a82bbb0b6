"""Fit the cross-layer probe calibration of an early-exit model
(counterpart of the repository's ``tools/calibrate_probes.py``).

    python -m duodiff_tpu_torch.tools.calibrate_probes \\
        --config configs/deediff_celeba.yaml --checkpoint model.pth \\
        --out probe_calibration.json

Runs one dense early-exit trajectory driven by the backbone, logs each
probe's batch mean beside its head's realized error against the backbone,
fits an affine map per probe slot
(:mod:`duodiff_tpu_torch.diffusion.calibration`) and writes the JSON that
``python -m duodiff_tpu_torch.eesample --adaptive_bidirectional
--probe_calibration FILE`` reads (the JAX package's file: its ``meta``
carries the card's name and power limit as ``card`` in place of
``backend``). Without ``--checkpoint`` the weights are random from
``--seed``. It runs on the card unless ``--device cpu``. On the card the
trajectory replays a step graph (``diffusion/graphs.py``), the counterpart
of the JAX tool's one scan.
"""

from __future__ import annotations

import argparse
import time

import torch

from duodiff_tpu_torch.diffusion.calibration import (
    collect_probe_stats,
    fit_probe_calibration,
    save_probe_calibration,
)
from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
from duodiff_tpu_torch.tools._measure import card_line, device_from_arg
from duodiff_tpu_torch.utils.model_loading import load_model


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", type=str, required=True, help="model YAML")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="torch .pth (default: random init from --seed, a smoke test only)")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--class_id", type=int, default=None,
                   help="conditional models: fixed class (default: random labels in "
                        "[1, num_classes))")
    p.add_argument("--attn_impl", type=str, default=None,
                   choices=["fused", "plain", "pallas", "xla"],
                   help="Block (default: fused on CUDA, plain on the CPU)")
    p.add_argument("--gelu_approx", action="store_true", default=None)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the tool; returns {"calibration", "u_rows", "e_rows", "card", "seconds"}."""
    args = get_args(argv)
    device = device_from_arg(args.device)
    card = card_line(device)
    print(card)
    model, cfg = load_model(
        args.config, args.checkpoint, device=device, seed=args.seed,
        attn_impl=args.attn_impl or ("fused" if device.type == "cuda" else "plain"),
        gelu_approx=bool(args.gelu_approx), early_exit=True,
    )
    model.eval().pack_for_kernels()
    schedule = NoiseSchedule.create(steps=args.steps, device=device)
    shape = (args.batch, cfg.img_size, cfg.img_size, cfg.in_chans)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    y = None
    if cfg.num_classes > 0:
        if args.class_id is not None:
            y = torch.full((args.batch,), args.class_id, dtype=torch.long, device=device)
        else:
            y = torch.randint(1, cfg.num_classes, (args.batch,), generator=generator,
                              device=device)

    print(f"collecting probe stats: {args.steps} steps, batch {args.batch}, on {device} ...")
    tic = time.perf_counter()
    with torch.inference_mode():
        u_rows, e_rows = collect_probe_stats(model, schedule, generator, shape, y=y)
    seconds = time.perf_counter() - tic
    calib = fit_probe_calibration(u_rows, e_rows)
    save_probe_calibration(args.out, calib, meta={
        "config": args.config,
        "checkpoint": args.checkpoint,
        "seed": args.seed,
        "batch": args.batch,
        "steps": args.steps,
        "card": card,
    })

    print("| slot | mean probe | mean realized err | slope a | intercept b | corr r |")
    print("|---|---|---|---|---|---|")
    for i in range(len(calib["a"])):
        print(f"| {i} | {float(u_rows[:, i].mean()):.6g} | {calib['mean_error'][i]:.6g} "
              f"| {calib['a'][i]:.6g} | {calib['b'][i]:.6g} | {calib['r'][i]:+.3f} |")
    print(f"\nwrote {args.out}; thresholds for --adaptive_bidirectional are now in "
          "mse-vs-backbone units (pick one between the deep and shallow slots' mean realized "
          "errors above)")
    return {"calibration": calib, "u_rows": u_rows, "e_rows": e_rows, "card": card,
            "seconds": seconds}


if __name__ == "__main__":
    main()
