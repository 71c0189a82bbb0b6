"""Capture a profiler trace of the sampling or training hot loop and print
where the device's time goes (counterpart of the repository's
``tools/trace_step.py``).

    python -m duodiff_tpu_torch.tools.trace_step [--attn fused|pallas|xla]
        [--config YAML] [--gelu tanh|exact] [--batch 128] [--steps 20]
        [--out DIR] [--mode sample|train] [--top 15] [--device cuda]
    python -m duodiff_tpu_torch.tools.trace_step --summarize_only --out DIR --steps N

``--mode sample``: one ``--steps``-step DDPM loop from t = steps - 1
(``diffusion/sampling.py:ddpm_loop``) of the model (default the flagship
CelebA-64 U-ViT) at ``--batch`` in bf16, after a two-step loop that warms
it up, run once outside the trace, then once inside it. ``--mode train``: three train steps
(forward, loss, backward, AdamW with the JAX package's settings), then
``--steps`` more inside the trace. The trace is ``--out/trace.json``
(``utils/profiling.py:trace``); the traced loop is also timed with CUDA
events. On the card both modes run what the CLIs run, step graphs
(``diffusion/graphs.py``): a sampling step and a train step graph (the
batch in the run's static buffers, as ``training/trainer.py`` stages it),
whose eager warm-up and capture fall in the untraced steps, so the traced
window holds replays only; ``main(argv, graphs=False)`` traces the eager
step bodies.

The summary reads the newest Chrome trace under ``--out`` (a training run's
``--profile`` folder works too) and sums the device's time, the
counterpart of the JAX tool's HLO categories: by kernel family
(:data:`KERNEL_FAMILIES`), per step, and the top ``--top`` kernels by name.
It also prints the traced span and the device's idle share within it (the
union of the device's events over the span): what remains between the
replays (the host's noise draw, its choice of the next graph), where a JAX
scan had no host gaps to show. The kernels a replay launches are device
events of the trace as an eager step's are. A trace with no device events
is reported as such, with no shares.

It runs on the card unless ``--device cpu``, where the wrappers take their
plain versions and the trace holds host events only. ``--rng rbg`` is
refused: torch has one generator family.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

# device-kernel families of a trace, by what their names contain (first match
# wins); everything else counts as "other"
KERNEL_FAMILIES = (
    ("own kernels", ("duodiff::",)),
    ("cuBLAS matrix products", ("nvjet", "cublas", "cutlass", "gemm", "gemv", "xmma")),
    ("PyTorch elementwise", ("elementwise", "CatArrayBatchedCopy", "fill", "copy")),
    ("PyTorch reductions", ("reduce", "softmax", "norm")),
    ("copies and memsets", ("Memcpy", "Memset")),
)
# the Chrome trace categories of the device's own events
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
WARMUP_TRAIN_STEPS = 3
SCHEDULE_STEPS = 1000


def kernel_family(name: str) -> str:
    for family, marks in KERNEL_FAMILIES:
        if any(m in name for m in marks):
            return family
    return "other"


def _model(args, device):
    from duodiff_tpu_torch.config import flagship_config, load_model_config
    from duodiff_tpu_torch.models.uvit import init_uvit

    cfg = load_model_config(args.config) if args.config else flagship_config()
    model = init_uvit(cfg, device=device, dtype=torch.bfloat16,
                      generator=torch.Generator().manual_seed(0), attn_impl=args.attn,
                      gelu_approx=args.gelu == "tanh")
    return model, cfg


def _timed(run, device, n_steps: int) -> float:
    """CUDA-event (host-clock on the CPU) ms per step of ``run()``."""
    from duodiff_tpu_torch.tools._measure import elapsed_ms

    return elapsed_ms(run, device) / n_steps


def capture(args, device, graphs: bool = True) -> dict:
    """Trace one ``--steps``-step DDPM loop after an untraced one, both on
    one run of step graphs (``graphs``) that a two-step loop before them
    warmed up and captured; returns {"trace", "step_ms" (the traced loop),
    "untraced_step_ms"}."""
    from duodiff_tpu_torch.diffusion.graphs import StepGraphs
    from duodiff_tpu_torch.diffusion.sampling import ddpm_loop
    from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
    from duodiff_tpu_torch.utils.profiling import TRACE_FILE, trace

    model, cfg = _model(args, device)
    model.eval().pack_for_kernels()
    y = (torch.zeros((args.batch,), dtype=torch.long, device=device)
         if cfg.num_classes > 0 else None)
    schedule = NoiseSchedule.create(steps=SCHEDULE_STEPS, device=device)
    shape = (args.batch, cfg.img_size, cfg.img_size, cfg.in_chans)
    run_graphs = StepGraphs(device, graphs)
    apply = model  # one apply for both loops, so they share the run's graphs

    def run(seed: int, n_steps: int) -> None:
        g = torch.Generator(device=device).manual_seed(seed)
        x = torch.randn(shape, generator=g, device=device)
        out = ddpm_loop(apply, schedule, "predict_noise", x, g, range(n_steps - 1, -1, -1), y,
                        graphs=run_graphs)
        if not bool(torch.isfinite(out).all()):
            raise RuntimeError("the sampling loop gave non-finite values")

    with torch.inference_mode():
        run(0, 2)  # the step's eager warm-up and its capture, untimed
        untraced = _timed(lambda: run(0, args.steps), device, args.steps)
        with trace(args.out, device):
            traced = _timed(lambda: run(1, args.steps), device, args.steps)
    print(f"trace written to {args.out}", file=sys.stderr)
    return {"trace": str(Path(args.out) / TRACE_FILE), "step_ms": traced,
            "untraced_step_ms": untraced}


def capture_train(args, device, graphs: bool = True) -> dict:
    """Trace ``--steps`` train steps after three untraced ones (the eager
    warm-up and the capture among them), the step on a run of step graphs
    (``graphs``) with the batch in its static buffers; returns {"trace",
    "step_ms" (the traced steps), "loss"}."""
    from duodiff_tpu_torch.diffusion.graphs import StepGraphs
    from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
    from duodiff_tpu_torch.training.train_state import (
        TrainState,
        make_optimizer,
        make_train_step,
        step_buffer,
    )
    from duodiff_tpu_torch.utils.profiling import TRACE_FILE, trace

    model, cfg = _model(args, device)
    optimizer = make_optimizer(dict(model.named_parameters()), lr=2e-4, weight_decay=0.03,
                               beta1=0.99, beta2=0.999, max_grad_norm=1.0,
                               num_warmup_steps=1500, num_training_steps=500000)
    state = TrainState.create(model, optimizer)
    run_graphs = StepGraphs(device, graphs)
    step = make_train_step(model, NoiseSchedule.create(steps=SCHEDULE_STEPS, device=device),
                           parametrization="predict_noise", seed=1, model_kind="uvit",
                           has_labels=cfg.num_classes > 0, graphs=run_graphs)
    image = np.random.RandomState(0).randn(args.batch, cfg.img_size, cfg.img_size, cfg.in_chans)
    batch = {"image": torch.from_numpy(image.astype(np.float32)),
             "label": torch.zeros((args.batch,), dtype=torch.long)}
    batch = {k: step_buffer(run_graphs, k, v).copy_(v) for k, v in batch.items()}
    metrics = {}

    def run(n: int) -> None:
        for _ in range(n):
            # one step's draws throughout, as the JAX tool keeps one key
            metrics.update(step(state, batch, 1))

    run(WARMUP_TRAIN_STEPS)
    with trace(args.out, device):
        traced = _timed(lambda: run(args.steps), device, args.steps)
    loss = float(metrics["train_loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"the train steps gave a non-finite loss {loss}")
    print(f"train trace written to {args.out}", file=sys.stderr)
    return {"trace": str(Path(args.out) / TRACE_FILE), "step_ms": traced, "loss": loss}


def newest_trace(out) -> tuple:
    """(path, events) of ``out`` itself when it is a file, else of the newest
    ``*.json`` under it that is a Chrome trace (holds ``traceEvents``)."""
    out = Path(out)
    paths = [out] if out.is_file() else sorted(out.rglob("*.json"),
                                                key=lambda p: p.stat().st_mtime, reverse=True)
    for path in paths:
        with open(path) as f:
            data = json.load(f)
        if isinstance(data, dict) and "traceEvents" in data:
            return path, data["traceEvents"]
    raise FileNotFoundError(f"no Chrome trace (*.json with traceEvents) at {out}")


def _union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def summarize(out_dir, n_steps: int, top: int = 15) -> dict:
    """Device time of the newest trace under ``out_dir`` by family, per step,
    and by kernel; the traced span and the device's idle share. Returns
    {"trace", "span_ms", "device_events", "busy_ms", "per_step_ms",
    "idle_share", "families" (ms), "top" ([name, ms])}; with no device
    events the device numbers are None."""
    path, events = newest_trace(out_dir)
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e and "ts" in e]
    if not complete:
        raise ValueError(f"{path} holds no complete events")
    start = min(float(e["ts"]) for e in complete)
    span_us = max(float(e["ts"]) + float(e["dur"]) for e in complete) - start
    device = [e for e in complete if str(e.get("cat", "")).lower() in DEVICE_CATEGORIES]
    result = {"trace": str(path), "span_ms": span_us / 1e3, "device_events": len(device),
              "busy_ms": None, "per_step_ms": None, "idle_share": None, "families": None,
              "top": None}
    print(f"\ntrace {path}: span {span_us / 1e3:.6g} ms, {len(complete)} complete events, "
          f"{len(device)} on the device")
    if not device:
        print("  no device events in the trace: the device's time, shares and idle share are "
              "not measured")
        return result
    busy_us = _union_us((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device)
    by_name, by_family = {}, {}
    for e in device:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"])
    for name, us in by_name.items():
        by_family[kernel_family(name)] = by_family.get(kernel_family(name), 0.0) + us
    total_us = sum(by_name.values())
    result.update(busy_ms=busy_us / 1e3, per_step_ms=busy_us / 1e3 / n_steps,
                  idle_share=1.0 - busy_us / span_us,
                  families={k: v / 1e3 for k, v in by_family.items()})
    print(f"  device busy {busy_us / 1e3:.6g} ms over {n_steps} steps "
          f"({busy_us / 1e3 / n_steps:.6g} ms/step), idle share {1.0 - busy_us / span_us:.6g} "
          "of the span")
    for family, us in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"  {family:<28s} {us / 1e3:9.3f} ms  ({100 * us / total_us:5.1f}%)  "
              f"[{us / 1e3 / n_steps:7.3f} ms/step]")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    result["top"] = [[name, us / 1e3] for name, us in ranked]
    print(f"\ntop {top} kernels:")
    for name, us in ranked:
        print(f"  {us / 1e3:9.3f} ms  [{us / 1e3 / n_steps:7.3f} ms/step]  "
              f"{kernel_family(name):<24s} {name[:90]}")
    return result


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--attn", default="fused")
    p.add_argument("--config", default=None, help="model YAML (default: flagship CelebA-64)")
    p.add_argument("--gelu", default="tanh", choices=["tanh", "exact"])
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "duodiff_trace"))
    p.add_argument("--summarize_only", action="store_true")
    p.add_argument("--top", type=int, default=15)
    p.add_argument("--mode", default="sample", choices=["sample", "train"])
    p.add_argument("--rng", default="threefry", choices=["threefry", "rbg"],
                   help="threefry only: torch has one generator family")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.rng != "threefry":
        p.error(f"--rng {args.rng}: torch has one generator family, so the port has no rbg "
                "programs to match")
    return args


def main(argv=None, graphs: bool = True) -> dict:
    """Capture (unless ``--summarize_only``) and summarize; returns {"card",
    "capture", "summary", "launches"}, the launches as the wrappers counted
    them during the capture. ``graphs=False`` traces the eager step bodies
    on the card too."""
    from duodiff_tpu_torch.tools._measure import (
        card_line,
        device_from_arg,
        launch_counts,
        launches_since,
    )

    args = get_args(argv)
    result = {"card": None, "capture": None, "launches": {}}
    if not args.summarize_only:
        device = device_from_arg(args.device)
        result["card"] = card_line(device)
        print(result["card"])
        before = launch_counts()
        result["capture"] = (capture_train if args.mode == "train" else capture)(args, device,
                                                                                 graphs)
        result["launches"] = launches_since(before)
        clock = "CUDA events" if device.type == "cuda" else "host clock, not a device time"
        print(f"{args.mode} {args.steps} steps at batch {args.batch}, attn {args.attn}: "
              f"{result['capture']['step_ms']:.6g} ms/step traced ({clock}); "
              f"launches {result['launches']}")
    result["summary"] = summarize(args.out, args.steps, top=args.top)
    return result


if __name__ == "__main__":
    main()
