"""Calibrate static int8 MLP activation scales for ``--attn_impl fused_int8``
(counterpart of the repository's ``tools/calibrate_int8.py``).

    python -m duodiff_tpu_torch.tools.calibrate_int8 \\
        --config_path configs/uvit_celeba.yaml --random_init --seed 1 \\
        --mode search --search_grid 99.5,99.9 --margin 1.1 --gelu_approx \\
        --output int8_scales.json

One reverse DDPM trajectory runs the model's calibration forward
(``UViT.forward_calib``: each block's attention sublayer with dynamic scales,
K11 on the card, then the dynamic-int8 MLP in plain PyTorch, which returns
its post-LN and post-GELU amaxes and their per-row amaxes;
``utils/int8_calib.py``). The JSON it writes feeds ``--int8_scales`` of the
sampling CLI. Modes:

- ``amax``: each site's largest amax times ``--margin``;
- ``percentile``: the ``--percentile``-th percentile of the union of the
  per-row amaxes over all steps, times ``--margin``;
- ``search``: the ``amax`` candidate (``--margin``) and one ``percentile``
  candidate for each value of ``--search_grid`` (``--search_margin``), each
  scored by final-sample PSNR against the dynamic-int8 kernels (K11 and K12
  with per-row scales) on one more trajectory; the best is saved. The
  reference and every candidate draw the same noise: a generator seeded with
  ``--seed + 17``, made anew for each run.

``--early_exit`` calibrates an early-exit model (the config's
``classifier_type`` names its probes): the trajectory steps on its
backbone, and the sites are its backbone blocks, under the names a plain
U-ViT's scales file has. ``--mode search`` is refused there, as in the JAX
tool: the early-exit sampler steps on the exit heads' outputs, not on the
backbone's that the search would score.

It runs on the card unless ``--device cpu`` (the kernels' plain versions).
On the card the calibration trajectory and the search's runs replay step
graphs (``diffusion/graphs.py``), the counterparts of the JAX tool's scans.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

import torch

from duodiff_tpu_torch.diffusion.sampling import ddpm_sample
from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
from duodiff_tpu_torch.tools._measure import card_line, device_from_arg
from duodiff_tpu_torch.utils.int8_calib import (
    calibrate_int8_mlp_scales,
    calibrate_int8_stats,
    save_int8_scales,
    scales_from_stats,
)
from duodiff_tpu_torch.utils.model_loading import load_model


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config_path", type=str, required=True)
    p.add_argument("--checkpoint_path", type=str, default=None)
    p.add_argument("--random_init", action="store_true",
                   help="calibrate on random weights from --seed")
    p.add_argument("--output", type=str, required=True, help="where to write the scales JSON")
    p.add_argument("--early_exit", action="store_true",
                   help="the config is an early-exit model")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--num_timesteps", type=int, default=1000)
    p.add_argument("--margin", type=float, default=1.1,
                   help="headroom multiplier on the calibrated scales")
    p.add_argument("--mode", type=str, default="amax", choices=["amax", "percentile", "search"])
    p.add_argument("--percentile", type=float, default=99.9,
                   help="row-amax percentile for --mode percentile")
    p.add_argument("--search_grid", type=str, default="99.5,99.9,99.99,99.999",
                   help="comma-separated percentiles for --mode search")
    p.add_argument("--search_margin", type=float, default=1.0,
                   help="margin of the percentile candidates in search mode (the amax "
                        "candidate takes --margin)")
    p.add_argument("--report", type=str, default=None,
                   help="optional JSON path for the search candidate table")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--parametrization", type=str, default="predict_noise",
                   choices=["predict_noise", "predict_original", "predict_previous"])
    p.add_argument("--gelu_approx", action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--fixed_class", type=int, default=None,
                   help="class-conditional models: calibrate on this label (default: "
                        "uniform random labels)")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the tool; returns {"scales": {block: (sx, sh)}, "meta", "card",
    "seconds": {"stats", "search"}}."""
    args = get_args(argv)
    if not args.random_init and args.checkpoint_path is None:
        raise SystemExit("--checkpoint_path is required (or --random_init)")
    if args.early_exit and args.mode == "search":
        raise SystemExit("--mode search supports backbone models only (the EE serve path steps "
                         "on exit-head outputs; calibrate EE scales with --mode percentile "
                         "instead)")
    device = device_from_arg(args.device)
    card = card_line(device)
    print(card)

    def load(scales_path=None):
        model, cfg = load_model(
            args.config_path, None if args.random_init else args.checkpoint_path,
            device=device, seed=args.seed, attn_impl="fused_int8",
            gelu_approx=args.gelu_approx, use_ema=args.use_ema, int8_scales=scales_path,
            early_exit=args.early_exit,
        )
        model.eval().pack_for_kernels()
        return model, cfg

    model, cfg = load()
    schedule = NoiseSchedule.create(steps=args.num_timesteps, device=device)
    shape = (args.batch_size, cfg.img_size, cfg.img_size, cfg.in_chans)
    y = None
    if cfg.num_classes > 0:
        if args.fixed_class is not None:
            if not 0 <= args.fixed_class < cfg.num_classes:
                raise SystemExit(f"--fixed_class must be in [0, {cfg.num_classes})")
            y = torch.full((args.batch_size,), args.fixed_class, dtype=torch.long)
        else:
            y = torch.randint(0, cfg.num_classes, (args.batch_size,),
                              generator=torch.Generator().manual_seed(args.seed + 1))
        y = y.to(device)

    print(f"calibrating {args.num_timesteps}-step trajectory, batch={args.batch_size}, "
          f"mode={args.mode} ...")
    tic = time.perf_counter()
    generator = torch.Generator(device=device).manual_seed(args.seed)
    with torch.inference_mode():
        if args.mode == "search":
            amax, quants = calibrate_int8_stats(model, schedule, generator, shape,
                                                parametrization=args.parametrization, y=y)
        else:
            scales = calibrate_int8_mlp_scales(
                model, schedule, generator, shape, margin=args.margin, mode=args.mode,
                percentile=args.percentile, parametrization=args.parametrization, y=y)
    seconds = {"stats": time.perf_counter() - tic}
    meta = {
        "config_path": args.config_path,
        "checkpoint_path": args.checkpoint_path,
        "num_timesteps": args.num_timesteps,
        "batch_size": args.batch_size,
        "margin": args.margin,
        "mode": args.mode,
        "parametrization": args.parametrization,
        "gelu_approx": args.gelu_approx,
        "seed": args.seed,
        "early_exit": args.early_exit,
        "use_ema": args.use_ema,
        "card": card,
    }
    if args.mode == "percentile":
        meta["percentile"] = args.percentile
    elif args.mode == "search":
        tic = time.perf_counter()
        scales, table = clip_search(args, amax, quants, schedule, shape, y, model, load)
        seconds["search"] = time.perf_counter() - tic
        meta["search"] = table
        meta["search_winner"] = max(table, key=lambda r: r["psnr_vs_dynamic_db"])
        if args.report:
            with open(args.report, "w") as f:
                json.dump(table, f, indent=2)
            print(f"wrote search report {args.report}")

    for name, (sx, sh) in sorted(scales.items()):
        print(f"  {name:16s} post-LN clip {sx:8.3f}  post-GELU clip {sh:8.3f}")
    save_int8_scales(args.output, scales, meta=meta)
    print(f"wrote {args.output}")
    return {"scales": scales, "meta": meta, "card": card, "seconds": seconds}


def clip_search(args, amax, quants, schedule, shape, y, dynamic_model, load):
    """Score candidate scale sets by final-sample PSNR against the dynamic-int8
    model; returns (the best candidate's scales, the candidate table)."""
    device = schedule.betas.device

    def sample(model):
        generator = torch.Generator(device=device).manual_seed(args.seed + 17)
        with torch.inference_mode():
            return ddpm_sample(model, generator, schedule=schedule, shape=shape,
                               parametrization=args.parametrization, y=y)[0]

    print("search: dynamic-int8 reference trajectory ...")
    ref = sample(dynamic_model)
    grid = [float(p) for p in args.search_grid.split(",") if p]
    candidates = [("amax", None, args.margin)] + [("percentile", p, args.search_margin)
                                                  for p in grid]
    table, best = [], None
    with tempfile.TemporaryDirectory(prefix="int8_search_") as tmp:
        for i, (mode, pct, margin) in enumerate(candidates):
            cand = scales_from_stats(amax, quants, mode=mode,
                                     percentile=pct if pct is not None else 100.0, margin=margin)
            path = f"{tmp}/cand_{i}.json"
            save_int8_scales(path, cand)
            x = sample(load(path)[0])
            err = torch.mean((x.float() - ref.float()) ** 2).item()
            psnr = 10.0 * torch.log10(torch.tensor(4.0 / max(err, 1e-12))).item()
            label = mode if pct is None else f"p{pct}"
            row = {"candidate": label, "mode": mode, "percentile": pct, "margin": margin,
                   "psnr_vs_dynamic_db": round(psnr, 2)}
            table.append(row)
            print(f"search: {label:12s} psnr vs dynamic {psnr:6.2f} dB")
            if best is None or psnr > best[0]:
                best = (psnr, cand, row)
    print(f"search: best candidate {best[2]['candidate']} ({best[0]:.2f} dB)")
    return best[1], table


if __name__ == "__main__":
    main()
