"""Quality-vs-speed matrix on a trained checkpoint (counterpart of the
repository's ``tools/quality_matrix.py``, its rows and flags plus
``--device``).

Given a backbone trained on the convergence probe's synthetic distribution
(``duodiff_tpu_torch.tools.convergence_probe``), it runs every requested
sampler through the port's CLIs (``duodiff_tpu_torch.sample`` and
``eesample``) on the same checkpoint, one folder a row under ``--out``, and
scores each row's mode statistics (``convergence_probe.measure``): within-
image std, mean distance to the nearest mode, mode coverage. Each row
records its own batch, steps and seed (reruns into one ``--out`` merge),
its sampling time and the kernel launches it made. A row whose flags the
port refuses is kept as ``{"refused": <the CLI's message>}`` and printed.
``duodiff_tpu_torch.tools.score_quality`` then adds FD-rand and the
spectral distance.

    python -m duodiff_tpu_torch.tools.quality_matrix \\
        --config configs/uvit_cifar10.yaml --checkpoint <run>/checkpoint.pth \\
        --methods ddpm,int8,cache3,cache3_int8,ddim50,dpm20 --batch 64 --out DIR

Rows: ddpm, int8, int8_static, ddim50, dpm20, dpm20_cache3, cache3,
cache3_int8, cache3_int8_static, cache5, cache5_int8, cache7, cache7_int8,
cache_derived, cache_derived_int8, cache_derived_int8_static (with
``--int8_scales`` / ``--cache_schedule`` where they need them); with
``--shallow_config`` and ``--shallow_checkpoint`` duodiff, duodiff_int8,
duodiff_cache3, duodiff_cache_derived_int8; with
``--interleave_shallow_checkpoint`` interleave2, interleave4; with
``--ee_config`` and ``--ee_checkpoint`` ee_adaptive, ee_adaptive_bidir
(``--probe_calibration``), ee_dynamic, ee_static, ee_static_int8,
ee_static_cache3, ee_static_cache_derived_int8.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from duodiff_tpu_torch.tools.convergence_probe import PALETTES, TEXTURE_PALETTE, measure


def get_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=str, required=True)
    ap.add_argument("--checkpoint", type=str, required=True)
    ap.add_argument("--ee_config", type=str, default=None)
    ap.add_argument("--ee_checkpoint", type=str, default=None)
    ap.add_argument("--ee_threshold", type=float, default=0.08)
    ap.add_argument("--adaptive_layers", type=str, default="4,9,13",
                    help="candidate exit layers of the ee_adaptive rows")
    ap.add_argument("--shallow_config", type=str, default=None)
    ap.add_argument("--shallow_checkpoint", type=str, default=None)
    ap.add_argument("--t_switch", type=int, default=300)
    ap.add_argument("--interleave_shallow_checkpoint", type=str, default=None,
                    help="a shallow model distilled over all timesteps: the interleave rows")
    ap.add_argument("--palette_k", type=int, default=4, choices=[1, 4, 8])
    ap.add_argument("--distribution", type=str, default="palette",
                    choices=["palette", "textured"])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--num_timesteps", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", type=str, required=True)
    ap.add_argument("--int8_scales", type=str, default=None,
                    help="calibrate_int8 JSON of the checkpoint: the *_int8_static rows")
    ap.add_argument("--cache_schedule", type=str, default=None,
                    help="derive_cache_schedule JSON of the checkpoint: the cache_derived rows")
    ap.add_argument("--cache_schedule_duodiff", type=str, default=None,
                    help="schedule of the DuoDiff rows (default: --cache_schedule)")
    ap.add_argument("--cache_schedule_ee", type=str, default=None,
                    help="schedule of the static-exit rows (default: --cache_schedule)")
    ap.add_argument("--probe_calibration", type=str, default=None,
                    help="calibrate_probes JSON: the ee_adaptive_bidir row")
    ap.add_argument("--methods", type=str, default=None,
                    help="comma list of the rows to run (default: every row whose inputs "
                         "are given)")
    ap.add_argument("--device", type=str, default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = get_args(argv)
    from duodiff_tpu_torch import eesample, sample
    from duodiff_tpu_torch.tools._measure import device_from_arg, launch_counts, launches_since

    device_from_arg(args.device)
    palette = TEXTURE_PALETTE if args.distribution == "textured" else PALETTES[args.palette_k]
    out_root = Path(args.out)
    only = set(args.methods.split(",")) if args.methods else None

    def want(name):
        return only is None or name in only

    dynamic_indices = out_root / "ee_dynamic" / "indices_by_timestep.npy"
    if (args.ee_config and args.ee_checkpoint and (want("ee_static") or want("ee_static_int8"))
            and not want("ee_dynamic") and not dynamic_indices.exists()):
        raise SystemExit("ee_static derives its schedule from the ee_dynamic run's "
                         "indices_by_timestep.npy — include ee_dynamic in --methods (or reuse "
                         "an --out dir that already has it)")

    rows = {}
    common = ["--batch_size", str(args.batch), "--num_timesteps", str(args.num_timesteps),
              "--seed", str(args.seed), "--device", args.device]

    def run_row(name, cli, argv):
        """One row through a CLI's ``main``; its time, launches and provenance."""
        before = launch_counts()
        tic = time.time()
        try:
            cli.main(argv + ["--output_folder", str(out_root / name)] + common)
        except SystemExit as refusal:  # the CLI's refusal of the row's flags
            rows[name] = {"refused": str(refusal)}
            print(json.dumps({"method": name, **rows[name]}))
            return
        r = measure(out_root / name, palette)
        r.update({"elapsed_s": round(time.time() - tic, 2), "launches": launches_since(before),
                  "batch": args.batch, "num_timesteps": args.num_timesteps, "seed": args.seed})
        rows[name] = r
        print(json.dumps({"method": name, **r}))

    def run_sampler(name, extra):
        run_row(name, sample, ["--config_path", args.config, "--checkpoint_path",
                               args.checkpoint, "--parametrization", "predict_noise"] + extra)

    int8 = ["--attn_impl", "fused_int8"]
    single = [
        ("ddpm", []),
        ("int8", int8),
        ("int8_static", int8 + ["--int8_scales", args.int8_scales or ""]),
        ("ddim50", ["--use_ddim", "--ddim_steps", "50"]),
        ("dpm20", ["--use_dpm_solver", "--dpm_steps", "20"]),
        ("dpm20_cache3", ["--use_dpm_solver", "--dpm_steps", "20", "--cache_every", "3"]),
        ("cache3", ["--cache_every", "3"]),
        ("cache3_int8", ["--cache_every", "3"] + int8),
        ("cache3_int8_static", ["--cache_every", "3"] + int8
         + ["--int8_scales", args.int8_scales or ""]),
        ("cache5", ["--cache_every", "5"]),
        ("cache5_int8", ["--cache_every", "5"] + int8),
        ("cache7", ["--cache_every", "7"]),
        ("cache7_int8", ["--cache_every", "7"] + int8),
        ("cache_derived", ["--cache_schedule", args.cache_schedule or ""]),
        ("cache_derived_int8", ["--cache_schedule", args.cache_schedule or ""] + int8),
        ("cache_derived_int8_static", ["--cache_schedule", args.cache_schedule or ""] + int8
         + ["--int8_scales", args.int8_scales or ""]),
    ]
    for name, extra in single:
        if not want(name):
            continue
        if "static" in name and not args.int8_scales:
            continue
        if "derived" in name and not args.cache_schedule:
            continue
        run_sampler(name, extra)

    if args.shallow_config and args.shallow_checkpoint:
        # --config_path is the early (shallow) model, --config_path_late the full one
        duo_sched = args.cache_schedule_duodiff or args.cache_schedule
        for name, extra in (
            ("duodiff", []),
            ("duodiff_int8", int8),
            ("duodiff_cache3", ["--cache_every", "3"]),
            ("duodiff_cache_derived_int8", ["--cache_schedule", duo_sched or ""] + int8),
        ):
            if not want(name) or (name == "duodiff_cache_derived_int8" and not duo_sched):
                continue
            run_row(name, sample, [
                "--config_path", args.shallow_config, "--checkpoint_path",
                args.shallow_checkpoint, "--config_path_late", args.config,
                "--checkpoint_path_late", args.checkpoint, "--t_switch", str(args.t_switch),
                "--parametrization", "predict_noise"] + extra)

    if args.shallow_config and args.interleave_shallow_checkpoint:
        for n in (2, 4):
            if want(f"interleave{n}"):
                run_row(f"interleave{n}", sample, [
                    "--config_path", args.shallow_config, "--checkpoint_path",
                    args.interleave_shallow_checkpoint, "--config_path_late", args.config,
                    "--checkpoint_path_late", args.checkpoint, "--interleave_every", str(n),
                    "--parametrization", "predict_noise"])

    if args.ee_config and args.ee_checkpoint:
        ee = ["--config_path", args.ee_config, "--checkpoint_path", args.ee_checkpoint]
        if want("ee_adaptive"):
            # probe-driven bucket choice chunk by chunk, the input-adaptive
            # counterpart of the static rows
            run_row("ee_adaptive", eesample, ee + [
                "--threshold", str(args.ee_threshold), "--adaptive_layers",
                args.adaptive_layers, "--adaptive_chunk", "50"])
        if want("ee_adaptive_bidir") and args.probe_calibration:
            # the calibrated bidirectional walk: the threshold is twice the
            # deepest slot's mean realised error, and depth - 1 joins the
            # candidates so the gate has a nearly free rung
            from duodiff_tpu_torch.diffusion.calibration import load_probe_calibration

            calib = load_probe_calibration(args.probe_calibration)
            depth = len(calib["mean_error"])
            layers = sorted({int(v) for v in args.adaptive_layers.split(",")} | {depth - 1})
            run_row("ee_adaptive_bidir", eesample, ee + [
                "--threshold", str(2.0 * calib["mean_error"][depth - 1]),
                "--adaptive_layers", ",".join(str(v) for v in layers), "--adaptive_chunk", "50",
                "--adaptive_bidirectional", "--probe_calibration", args.probe_calibration])
        if want("ee_dynamic"):
            run_row("ee_dynamic", eesample, ee + ["--threshold", str(args.ee_threshold)])
        ee_sched = args.cache_schedule_ee or args.cache_schedule
        for name, extra in (
            ("ee_static", []),
            ("ee_static_int8", int8),
            ("ee_static_cache3", ["--cache_every", "3"]),
            ("ee_static_cache_derived_int8", ["--cache_schedule", ee_sched or ""] + int8),
        ):
            if not want(name) or (name == "ee_static_cache_derived_int8" and not ee_sched):
                continue
            run_row(name, eesample, ee + ["--derive_schedule_from", str(dynamic_indices)]
                    + extra)

    # merge: a partial rerun keeps the rows measured before
    out_path = out_root / "quality_matrix.json"
    if out_path.exists():
        try:
            prior = json.loads(out_path.read_text())
        except (json.JSONDecodeError, OSError):
            prior = {}
        rows = {**prior, **rows}
    print(json.dumps(rows))
    out_root.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rows, indent=1))
    return rows


if __name__ == "__main__":
    main()
