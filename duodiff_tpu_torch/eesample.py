"""Early-exit (DeeDiff / AdaDiff) sampling CLI (counterpart of the
repository's ``eesampler.py``, all of its flags).

    python -m duodiff_tpu_torch.eesample \\
        --config_path configs/deediff_celeba.yaml --random_init \\
        --threshold 0.5 --batch_size 16 --output_folder out --device cuda

Three routes, in the JAX CLI's order:

- ``--adaptive_layers L1,L2,...`` (with ``--threshold``): chunk by chunk
  (``--adaptive_chunk`` steps) one truncated backbone runs and sums its
  probe; between chunks the host moves one candidate deeper, or with
  ``--adaptive_bidirectional`` (which needs ``--probe_calibration``, a file
  from ``python -m duodiff_tpu_torch.tools.calibrate_probes``) also
  shallower (``--adaptive_margin``). Writes ``adaptive_log.json``.
- ``--static_schedule 'hi-lo:layer,...'`` or ``--derive_schedule_from
  indices_by_timestep.npy`` (``--derive_buckets``, ``--derive_quantile``):
  one truncated backbone per timestep bucket, optionally block-cached inside
  each bucket (``--cache_every`` / ``--cache_schedule``, ``--cache_outer``).
- ``--threshold`` alone: the dynamic rule; every block, head and probe runs
  at every step and each sample takes the first head whose probe reads at
  most the threshold.

Every route writes ``{i}.png``, ``statistics.txt``,
``error_prediction_by_timestep.{npy,pt}`` (T x depth, NaN where a probe was
not read) and ``indices_by_timestep.{npy,pt}`` (T x B). The CLI refuses what
``eesampler.py`` refuses, and also: ``--int8_scales`` with the static or
adaptive route, which the JAX CLI silently drops there (its truncated
backbones are built without the scales), and ``--model_parallel`` with an
int8 or ``plain`` block, as ``sample.py`` does.

Under ``python -m torch.distributed.run`` the CLI samples on the grid of
``sample.py``: ``--model_parallel`` on the dynamic-threshold route only (the
JAX CLI's refusals; the heads' decoder and the attention probes sharded
too, every exit decided on the summed probe outputs), data parallelism on
the dynamic and static routes, the
probe means averaged and the exit indices gathered over the data ranks; the
adaptive route, whose host decides from the whole batch's probes, runs the
whole batch on every rank. Unguided class labels
follow ``sample.py``'s rule. A latent-diffusion config
(``configs/deediff_imagenet256.yaml``) samples latents and decodes them with
its frozen KL autoencoder before writing, as ``sample.py`` does.

On a CUDA device every route replays each kind of step as a CUDA graph, as
``sample.py`` does, on one run of step graphs (the adaptive route's kinds
are its candidates, its host reading one probe sum a chunk), and runs
eagerly under ``--model_parallel``; ``main(argv, graphs=False)`` runs the
step bodies eagerly. A line says which route a run takes.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from duodiff_tpu_torch.diffusion.cache_schedule import load_cache_schedule
from duodiff_tpu_torch.diffusion.calibration import load_probe_calibration
from duodiff_tpu_torch.diffusion.graphs import StepGraphs
from duodiff_tpu_torch.diffusion.sampling import (
    RowDraws,
    early_exit_sample,
    make_guided_apply_ee,
)
from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
from duodiff_tpu_torch.diffusion.static_exit import (
    derive_exit_schedule,
    make_adaptive_exit_sampler,
    parse_exit_schedule,
    static_exit_sample,
)
from duodiff_tpu_torch.parallel.mesh import close, sampling_grid
from duodiff_tpu_torch.sample import (
    check_parallel_flags,
    class_labels,
    decode_all,
    graph_route,
    latent_decoder,
)
from duodiff_tpu_torch.utils.image import save_samples
from duodiff_tpu_torch.utils.model_loading import load_model


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--threshold", type=float, default=None,
                        help="Dynamic exit threshold (required unless --static_schedule "
                             "is given)")
    parser.add_argument("--checkpoint_path", type=str, default=None)
    parser.add_argument("--batch_size", type=int, required=True)
    parser.add_argument("--output_folder", type=str, required=True)
    parser.add_argument("--config_path", type=str, required=True)
    parser.add_argument("--class_id", type=int, default=None,
                        help="Class-conditional sampling. Unguided: random labels in "
                             "[1, min(1001, num_classes)). Guided (--guidance_scale): sample "
                             "this class; -1 for uniform random real classes")
    parser.add_argument("--guidance_scale", type=float, default=None,
                        help="Classifier-free guidance weight w: the backbone and every "
                             "head are guided (out_null + w*(out_cond - out_null)); the "
                             "probes gate on the conditional half")
    parser.add_argument("--null_class", type=int, default=None,
                        help="Null-label index for guidance (default num_classes-1)")
    parser.add_argument("--random_init", action="store_true")
    parser.add_argument("--num_timesteps", type=int, default=1000)
    parser.add_argument("--model_parallel", type=int, default=1,
                        help="Tensor-parallel degree over the ranks of torch.distributed.run "
                             "(the dynamic-threshold route)")
    parser.add_argument("--multihost", action="store_true",
                        help="Let the torch.distributed.run grid span nodes")
    parser.add_argument("--attn_impl", type=str, default=None,
                        choices=["fused", "plain", "fused_int8", "pallas", "xla"],
                        help="Block (default: fused on CUDA, plain on the CPU)")
    parser.add_argument("--gelu_approx", action="store_true",
                        help="tanh-approx GELU (below bf16 rounding)")
    parser.add_argument("--use_ema", action="store_true",
                        help="Sample with the EMA shadow params of an --ema_decay-trained "
                             "checkpoint")
    parser.add_argument("--int8_scales", type=str, default=None,
                        help="tools/calibrate_int8.py JSON: static MLP activation scales for "
                             "--attn_impl fused_int8 (the dynamic-threshold route only)")
    parser.add_argument("--static_schedule", type=str, default=None,
                        help="Timestep-bucketed static exits, e.g. '999-700:3,699-300:8,"
                             "299-0:13': truncated backbones per bucket")
    parser.add_argument("--adaptive_layers", type=str, default=None,
                        help="Probe-driven bucket selection: comma list of candidate exit "
                             "layers, e.g. '3,8,13' (per-layer probe families only)")
    parser.add_argument("--adaptive_chunk", type=int, default=50,
                        help="steps per adaptive decision chunk")
    parser.add_argument("--adaptive_margin", type=float, default=0.7,
                        help="bidirectional mode only: go shallower when the shallower "
                             "candidate's probe <= threshold * margin")
    parser.add_argument("--adaptive_bidirectional", action="store_true",
                        help="allow shallower moves (requires --probe_calibration)")
    parser.add_argument("--probe_calibration", type=str, default=None,
                        help="Probe calibration JSON (tools/calibrate_probes.py): adaptive "
                             "decisions and --threshold in mse-vs-backbone units")
    parser.add_argument("--derive_schedule_from", type=str, default=None,
                        help="A dynamic run's indices_by_timestep.npy: derive the static "
                             "bucket schedule from it (--derive_buckets N) and sample with it")
    parser.add_argument("--derive_buckets", type=int, default=4)
    parser.add_argument("--cache_every", type=int, default=None,
                        help="Block caching inside the static-exit buckets (anchors on "
                             "t %% N == 0 and each bucket's first step)")
    parser.add_argument("--cache_schedule", type=str, default=None,
                        help="Anchor-table JSON (tools/derive_cache_schedule.py) in place of "
                             "--cache_every inside the static-exit buckets")
    parser.add_argument("--cache_outer", type=int, default=None,
                        help="Blocks kept live at each end under --cache_every/"
                             "--cache_schedule (default ceil(depth/2/3), raised per bucket)")
    parser.add_argument("--derive_quantile", type=float, default=0.5,
                        help="Per-bucket exit depth = ceil of this quantile of the logged "
                             "per-sample exits")
    parser.add_argument("--device", type=str, default="cuda")
    parser.set_defaults(fixed_class=None)  # sample.class_labels reads it
    return parser.parse_args(argv)


def check_flags(args) -> None:
    """The refusals of ``eesampler.py``, in its order, and the port's own;
    ``--derive_schedule_from`` is resolved into ``args.static_schedule`` on
    the way."""
    if not args.random_init and args.checkpoint_path is None:
        raise SystemExit("--checkpoint_path is required (or pass --random_init)")
    if args.derive_schedule_from is not None:
        if args.static_schedule is not None:
            raise SystemExit("--derive_schedule_from and --static_schedule are mutually "
                             "exclusive")
        idx = np.load(args.derive_schedule_from)
        if idx.shape[0] != args.num_timesteps:
            raise SystemExit(f"--derive_schedule_from table covers {idx.shape[0]} timesteps "
                             f"but --num_timesteps is {args.num_timesteps}")
        buckets = derive_exit_schedule(idx, n_buckets=args.derive_buckets,
                                       quantile=args.derive_quantile)
        args.static_schedule = ",".join(f"{hi}-{lo}:{layer}" for hi, lo, layer in buckets)
        print(f"Derived static schedule from {args.derive_schedule_from}: "
              f"{args.static_schedule}")
    if args.threshold is None and args.static_schedule is None:
        raise SystemExit("--threshold is required (or pass --static_schedule)")
    if args.adaptive_layers is not None:
        if args.static_schedule is not None:
            raise SystemExit("--adaptive_layers and --static_schedule are mutually exclusive")
        if args.threshold is None:
            raise SystemExit("--adaptive_layers needs --threshold (the probe exit rule it "
                             "decides against)")
        if args.cache_every is not None or args.cache_schedule is not None:
            raise SystemExit("--adaptive_layers does not combine with block caching yet "
                             "(bucket switches would invalidate the cached delta mid-chunk)")
        if args.guidance_scale is not None:
            raise SystemExit("--adaptive_layers does not combine with --guidance_scale")
        if args.adaptive_bidirectional and args.probe_calibration is None:
            raise SystemExit("--adaptive_bidirectional needs --probe_calibration: raw probe "
                             "scales are not cross-layer comparable; fit one with "
                             "tools/calibrate_probes.py")
    if args.cache_every is not None or args.cache_schedule is not None:
        if args.cache_every is not None and args.cache_schedule is not None:
            raise SystemExit("--cache_schedule and --cache_every are mutually exclusive")
        if args.static_schedule is None:
            raise SystemExit("--cache_every/--cache_schedule requires --static_schedule or "
                             "--derive_schedule_from (the dynamic-threshold path must compute "
                             "every layer — caching would change the probe inputs it selects "
                             "on)")
        if args.guidance_scale is not None:
            raise SystemExit("--cache_every/--cache_schedule does not combine with "
                             "--guidance_scale")
    elif args.cache_outer is not None:
        raise SystemExit("--cache_outer requires --cache_every or --cache_schedule")
    if (args.model_parallel or 1) > 1 and args.adaptive_layers:
        raise SystemExit("--model_parallel does not combine with --adaptive_layers")
    if (args.model_parallel or 1) > 1 and args.static_schedule:
        raise SystemExit("--model_parallel does not combine with --static_schedule")
    if args.int8_scales is not None and (args.static_schedule or args.adaptive_layers):
        raise SystemExit("--int8_scales applies to the dynamic-threshold route only: the "
                         "static and adaptive routes' truncated backbones run int8 with "
                         "dynamic MLP scales (the JAX CLI drops the file there silently)")


def main(argv=None, *, graphs: bool = True) -> dict:
    """Run the CLI; returns {"samples": float (B, H, W, C) in about [0, 1]
    (decoded images for a latent config), "err_by_t" (T, depth), "idx_by_t"
    (T, B), "log" (the adaptive route's rows, else None), "seconds":
    sampling wall time, "decode_seconds": the decode's (0 without one)}.
    ``graphs=False`` runs the step bodies eagerly on a CUDA device too (a
    library caller's comparison, never a flag)."""
    args = get_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available")
    check_flags(args)
    mp = args.model_parallel or 1
    attn_impl = args.attn_impl or ("fused" if args.device.startswith("cuda") or mp > 1
                                   else "plain")
    check_parallel_flags(args, attn_impl)
    grid = sampling_grid(mp, args.batch_size, args.device, args.multihost,
                         split=args.adaptive_layers is None)
    try:
        return _sample(args, grid, attn_impl, graphs)
    finally:
        close(grid)


def _sample(args, grid, attn_impl, use_graphs: bool) -> dict:
    """:func:`main` once the flags are checked and the grid is formed."""
    device = grid.device
    output_folder = Path(args.output_folder)
    if grid.is_main:
        output_folder.mkdir(parents=True, exist_ok=True)

    model, cfg = load_model(
        args.config_path, None if args.random_init else args.checkpoint_path, device=device,
        seed=args.seed, attn_impl=attn_impl, gelu_approx=args.gelu_approx,
        int8_scales=args.int8_scales, use_ema=args.use_ema, early_exit=True, grid=grid,
    )
    model.eval().pack_for_kernels()
    decode = latent_decoder(args.config_path, device)
    schedule = NoiseSchedule.create(steps=args.num_timesteps, device=device)
    steps = schedule.steps
    graphed, route = graph_route(device, grid.model, use_graphs)
    graphs = StepGraphs(device, graphed)  # the run's graphs, buffers and memory pool
    rows = grid.rows(args.batch_size)  # this rank's rows of the global batch
    shape = (rows[1] - rows[0], cfg.img_size, cfg.img_size, cfg.in_chans)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    y, null_label = class_labels(args, cfg.num_classes, generator)
    if y is not None:
        y = y[rows[0]:rows[1]]
    if grid.distributed:
        generator = RowDraws(generator, rows)
    if cfg.num_classes > 0 and y is None:
        raise SystemExit("a class-conditional model needs labels: pass --class_id (with or "
                         "without --guidance_scale)")
    guidance = None if null_label is None else (args.guidance_scale, null_label)

    # each route's run() -> (x, (err_by_t, idx_by_t) on the device or None, log or None)
    if args.adaptive_layers is not None:
        layers = [int(v) for v in args.adaptive_layers.split(",")]
        calibration = (None if args.probe_calibration is None
                       else load_probe_calibration(args.probe_calibration))
        sampler = make_adaptive_exit_sampler(
            model, schedule=schedule, layers=layers, chunk=args.adaptive_chunk,
            threshold=args.threshold, margin=args.adaptive_margin,
            monotone=not args.adaptive_bidirectional, calibration=calibration, graphs=graphs)
        kind = (f"adaptive exits (layers={sorted(set(layers))}, chunk={args.adaptive_chunk}, "
                f"threshold={args.threshold})")

        def run():
            x, log = sampler(generator, shape, y)
            return x, None, log
    elif args.static_schedule:
        buckets = parse_exit_schedule(args.static_schedule)
        cache_rule = args.cache_every
        if args.cache_schedule is not None:
            cache_rule = load_cache_schedule(args.cache_schedule, num_timesteps=steps)
        kind = (f"static exits (buckets={buckets}"
                + (f", cache_every={args.cache_every}" if args.cache_every else "")
                + (f", cache_schedule={args.cache_schedule}" if args.cache_schedule else "")
                + ")")

        def run():
            return static_exit_sample(
                model, generator, schedule=schedule, shape=shape, buckets=buckets, y=y,
                guidance=guidance, cache_every=cache_rule, cache_outer=args.cache_outer,
                graphs=graphs,
            ), None, [{"t_hi": hi, "t_lo": lo, "layer": layer} for hi, lo, layer in buckets]
    else:
        apply = model if guidance is None else make_guided_apply_ee(model, *guidance)
        kind = f"early exit (threshold={args.threshold})"

        def run():
            x, err, idx = early_exit_sample(apply, generator, schedule=schedule, shape=shape,
                                            threshold=args.threshold, y=y, graphs=graphs)
            return x, (err, idx), None

    if grid.is_main:
        print(f"Sampling {args.batch_size} images on {device} ({kind}, attn_impl={attn_impl}, "
              f"grid data {grid.data} x model {grid.model})...")
        print(route)
    with torch.inference_mode():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        tic = time.perf_counter()
        x, tables, ranges = run()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        elapsed = time.perf_counter() - tic
        x, _, decode_seconds = decode_all(decode, x, {}, device)
        samples = grid.gather_rows(((x + 1.0) / 2.0).cpu()).numpy()

    if tables is not None:
        # the batch means of the probes averaged, the exit indices gathered
        err, idx = (v.cpu() for v in tables)
        if grid.distributed and not grid.replicated:
            err = torch.stack(grid.gather_host(err)[::grid.model]).mean(0)
            idx = grid.gather_rows(idx.t().contiguous()).t()
        err_by_t, idx_by_t = err.numpy(), idx.numpy()
    else:  # implied by the buckets or the walk's chunks
        idx_by_t = np.zeros((steps, args.batch_size), np.int32)
        err_by_t = np.full((steps, cfg.depth), np.nan, np.float32)
        for row in ranges:
            idx_by_t[row["t_lo"]: row["t_hi"] + 1] = row["layer"]
            if "mean_probe" in row:  # the walk read the layer's own probe slot
                err_by_t[row["t_lo"]: row["t_hi"] + 1, min(row["layer"], cfg.depth - 1)] = (
                    row["mean_probe"])
    log = ranges if args.adaptive_layers is not None else None
    result = {"samples": samples, "err_by_t": err_by_t, "idx_by_t": idx_by_t, "log": log,
              "seconds": elapsed, "decode_seconds": decode_seconds}
    if not grid.is_main:
        return result
    if log is not None:
        (output_folder / "adaptive_log.json").write_text(json.dumps(log, indent=1))
        print(f"adaptive chunks: {len(log)}, mean layer "
              f"{float(np.mean([r['layer'] for r in log])):.2f}")

    with open(output_folder / "statistics.txt", "w") as f:
        f.write(f"Elapsed time: {elapsed} s\n")
    np.save(output_folder / "error_prediction_by_timestep.npy", err_by_t)
    np.save(output_folder / "indices_by_timestep.npy", idx_by_t)
    torch.save(torch.from_numpy(np.asarray(err_by_t)),
               output_folder / "error_prediction_by_timestep.pt")
    torch.save(torch.from_numpy(np.asarray(idx_by_t, dtype=np.float32)),
               output_folder / "indices_by_timestep.pt")
    save_samples(samples, output_folder, with_grid=False)
    if decode is not None:
        print(f"Decode time: {decode_seconds:.2f} s")
    print(f"Elapsed time: {elapsed:.2f} s -> {output_folder}")
    print(f"mean exit index: {np.asarray(idx_by_t).mean():.2f} (depth={cfg.depth})")
    return result


if __name__ == "__main__":
    main()
