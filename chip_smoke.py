#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``duodiff_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's main path at the full CelebA-64 U-ViT width and checks
it, in phases, each printing its results on its own lines:

1. set-up: the card (name and power limit from nvidia-smi), torch and CUDA
   versions, and the build of the CUDA kernels from ``duodiff_tpu_torch/csrc``;
2. each kernel against its plain PyTorch version on the card, at the
   sampling shapes (L = 257, D = 512, 8 heads, hidden 2048, bf16): K1 with
   and without a qkv bias, K2 with exact and tanh GELU; both timed;
3. the full depth-13 flagship forward, fused kernels against plain
   PyTorch on the same weights; and a short DuoDiff trajectory (depth 3 ->
   depth 13, full width) both ways from the same noise;
4. the main path: ``python -m duodiff_tpu_torch.sample`` in-process,
   1000-step DuoDiff DDPM (depth 3 for the first 300 steps, then depth
   13), random weights from a seed; the launch counters show every step
   went through the kernels.

The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``. Any failed check exits non-zero. There is
no CPU fallback: without a CUDA device the script exits with code 1.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

CHECK_BATCH = 8      # kernel and forward checks
MAIN_BATCH = 128     # the 1000-step main path (bench.py's batch)
STEPS = 1000
T_SWITCH = 300
REPO = Path(__file__).resolve().parent
EARLY_CONFIG = str(REPO / "configs/uvit_celeba_3.yaml")
LATE_CONFIG = str(REPO / "configs/uvit_celeba.yaml")
L, D, HEADS, HIDDEN = 257, 512, 8, 2048
# |kernel - plain| <= ATOL + RTOL * |plain| elementwise: the bound the JAX
# tests allow between the package's own bf16 paths (tests/test_ops.py)
ATOL = RTOL = 5e-2
TIMING_REPS = 25

KERNELS = {
    "fused_attn_sublayer": {
        "source": "duodiff_tpu_torch/csrc/attn_sublayer.cu",
        "replaces": "duodiff_tpu/ops/pallas_block.py:97",
    },
    "fused_mlp_sublayer": {
        "source": "duodiff_tpu_torch/csrc/mlp_sublayer.cu",
        "replaces": "duodiff_tpu/ops/pallas_block.py:395",
    },
}


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def errors(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float, bool]:
    """(max abs error, max error relative to |want|, within the bound)."""
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        return float("inf"), float("inf"), False
    diff = (got - want).abs()
    max_abs = diff.max().item()
    max_rel = (diff / want.abs().clamp_min(1e-6)).max().item()
    ok = bool((diff <= ATOL + RTOL * want.abs()).all())
    return max_abs, max_rel, ok


def time_ms(fns: dict, reps: int = TIMING_REPS) -> dict:
    """Median CUDA-event time of each callable, taken in turns."""
    for fn in fns.values():  # warm-up
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: statistics.median(ts) for name, ts in times.items()}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def setup() -> str:
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    from duodiff_tpu_torch.ops._build import build, load_library

    tic = time.perf_counter()
    path = build()
    load_library()
    print(f"phase 1: kernels built and loaded in {time.perf_counter() - tic:.1f} s "
          f"({path.name})", flush=True)
    return card


def sublayer_operands(batch: int, qkv_bias: bool, device, seed: int = 0):
    """Random bf16 input and packed operands of one block at flagship width."""
    from torch import nn

    from duodiff_tpu_torch.ops.block import pack_attn, pack_mlp

    g = torch.Generator().manual_seed(seed)

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale

    norm = nn.LayerNorm(D)
    qkv, proj = nn.Linear(D, 3 * D, bias=qkv_bias), nn.Linear(D, D)
    fc1, fc2 = nn.Linear(D, HIDDEN), nn.Linear(HIDDEN, D)
    with torch.no_grad():
        for mod in (norm, qkv, proj, fc1, fc2):
            mod.weight.copy_(rand(*mod.weight.shape, scale=0.05))
            if mod.bias is not None:
                mod.bias.copy_(rand(*mod.bias.shape, scale=0.05))
        norm.weight.add_(1.0)
    x = rand(batch, L, D).to(torch.bfloat16)
    attn_ops = pack_attn(norm, qkv, proj, num_heads=HEADS, dtype=torch.bfloat16)
    mlp_ops = pack_mlp(norm, fc1, fc2, dtype=torch.bfloat16)
    move = lambda ops: tuple(None if t is None else t.to(device) for t in ops)  # noqa: E731
    return x.to(device), move(attn_ops), move(mlp_ops)


def check_kernels(device) -> dict:
    """Phase 2: each kernel against its plain version; returns per-kernel
    {max_abs_err, ms, plain_ms} (errors over every variant and batch,
    times at the main path's batch)."""
    from duodiff_tpu_torch.ops import block

    results = {name: {"max_abs_err": 0.0} for name in KERNELS}
    for batch in sorted({CHECK_BATCH, MAIN_BATCH}):
        for variant in (False, True):
            x, attn_ops, mlp_ops = sublayer_operands(batch, qkv_bias=variant, device=device)
            cases = {
                "fused_attn_sublayer": (
                    f"qkv_bias={variant}",
                    lambda: block.fused_attn_sublayer(x, *attn_ops, num_heads=HEADS),
                    lambda: block.attn_sublayer_plain(x, *attn_ops, num_heads=HEADS),
                ),
                "fused_mlp_sublayer": (
                    f"gelu={'tanh' if variant else 'erf'}",
                    lambda: block.fused_mlp_sublayer(x, *mlp_ops, gelu_approx=variant),
                    lambda: block.mlp_sublayer_plain(x, *mlp_ops, gelu_approx=variant),
                ),
            }
            for name, (label, kernel, plain) in cases.items():
                got = kernel()
                torch.cuda.synchronize()
                max_abs, max_rel, ok = errors(got, plain())
                ms = time_ms({"kernel": kernel, "plain": plain})
                print(f"phase 2: {name} B={batch} {label}: max_abs_err={max_abs:.6g} "
                      f"max_rel_err={max_rel:.6g} bound={ATOL}+{RTOL}*|plain| ok={ok} "
                      f"kernel_ms={ms['kernel']:.6g} plain_ms={ms['plain']:.6g}",
                      flush=True)
                if not ok:
                    fail(f"{name} B={batch} {label} disagrees with its plain version")
                res = results[name]
                res["max_abs_err"] = max(res["max_abs_err"], max_abs)
                if batch == MAIN_BATCH and not variant:  # the main path's variant
                    res["ms"], res["plain_ms"] = ms["kernel"], ms["plain"]
    return results


def set_attn_impl(model, impl: str) -> None:
    for blk in model.blocks():
        blk.attn_impl = impl


def check_model(device) -> None:
    """Phase 3: flagship forward and a short DuoDiff trajectory, fused
    kernels against plain PyTorch on the same weights and inputs."""
    from duodiff_tpu_torch.diffusion.sampling import duodiff_sample
    from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
    from duodiff_tpu_torch.utils.model_loading import load_model

    late, cfg = load_model(LATE_CONFIG, device=device, seed=1)
    early, _ = load_model(EARLY_CONFIG, device=device, seed=0)
    for m in (early, late):
        m.pack_for_kernels()
    g = torch.Generator().manual_seed(0)
    shape = (CHECK_BATCH, cfg.img_size, cfg.img_size, cfg.in_chans)
    x = torch.randn(shape, generator=g).to(device)
    t = torch.tensor([999.0, 700.0, 500.0, 300.0, 100.0, 10.0, 1.0, 0.0],
                     device=device)[:CHECK_BATCH]
    outs = {}
    with torch.inference_mode():
        for impl in ("fused", "plain"):
            set_attn_impl(late, impl)
            outs[impl] = late(x, t)
    max_abs, max_rel, ok = errors(outs["fused"], outs["plain"])
    print(f"phase 3: depth-{cfg.depth} forward B={CHECK_BATCH} fused vs plain: "
          f"max_abs_err={max_abs:.6g} max_rel_err={max_rel:.6g} "
          f"max_abs_out={outs['plain'].abs().max().item():.6g} ok={ok}", flush=True)
    if not ok:
        fail("the fused flagship forward disagrees with the plain one")

    steps, t_switch = 20, 6
    schedule = NoiseSchedule.create(steps=steps, device=device)
    small = (2,) + shape[1:]
    noise = torch.randn((steps,) + small, generator=g).to(device)
    x0 = torch.randn(small, generator=g).to(device)
    outs = {}
    with torch.inference_mode():
        for impl in ("fused", "plain"):
            set_attn_impl(early, impl)
            set_attn_impl(late, impl)
            outs[impl] = duodiff_sample(
                early, late, None, schedule=schedule, shape=small,
                t_switch=t_switch, x_init=x0, noise_table=noise,
            )
    max_abs, max_rel, ok = errors(outs["fused"], outs["plain"])
    print(f"phase 3: {steps}-step DuoDiff trajectory (depth 3 -> {cfg.depth}, "
          f"t_switch {t_switch}) B=2 fused vs plain: max_abs_err={max_abs:.6g} "
          f"max_rel_err={max_rel:.6g} ok={ok}", flush=True)
    if not ok:
        fail("the fused DuoDiff trajectory disagrees with the plain one")


def run_main_path(card: str) -> dict:
    """Phase 4: the sampling CLI, in-process; returns the launch counts."""
    from duodiff_tpu_torch import sample
    from duodiff_tpu_torch.ops import block

    with tempfile.TemporaryDirectory() as out:
        argv = [
            "--config_path", EARLY_CONFIG, "--config_path_late", LATE_CONFIG,
            "--t_switch", str(T_SWITCH), "--random_init",
            "--num_timesteps", str(STEPS), "--batch_size", str(MAIN_BATCH),
            "--parametrization", "predict_noise", "--device", "cuda",
            "--output_folder", out, "--seed", "0",
        ]
        block.fused_attn_sublayer.launches = 0
        block.fused_mlp_sublayer.launches = 0
        tic = time.perf_counter()
        result = sample.main(argv)
        wall = time.perf_counter() - tic
        launches = {
            "fused_attn_sublayer": block.fused_attn_sublayer.launches,
            "fused_mlp_sublayer": block.fused_mlp_sublayer.launches,
        }
        saved = np.load(f"{out}/samples.npy")
    samples = result["samples"]
    expected = T_SWITCH * 3 + (STEPS - T_SWITCH) * 13
    print(f"phase 4: DuoDiff {STEPS} steps (depth 3 x {T_SWITCH}, depth 13 x "
          f"{STEPS - T_SWITCH}) batch {MAIN_BATCH}: sampling {result['seconds']:.6g} s, "
          f"{MAIN_BATCH / result['seconds']:.6g} samples/s, CLI wall {wall:.6g} s, "
          f"launches {launches} (expected {expected} each), card {card}", flush=True)
    shape = (MAIN_BATCH, 64, 64, 3)
    if samples.shape != shape or saved.shape != shape or saved.dtype != np.uint8:
        fail(f"samples have shape {samples.shape} / {saved.shape} {saved.dtype}, "
             f"expected {shape} uint8")
    if not np.isfinite(samples).all():
        fail("samples are not finite")
    for name, n in launches.items():
        if n != expected:
            fail(f"{name} launched {n} times on the main path, expected {expected}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("FAILED: no CUDA device; chip_smoke.py runs only on a GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = setup()
    results = check_kernels(device)
    check_model(device)
    launches = run_main_path(card)
    record = [
        {"name": name, "route": "cuda", **KERNELS[name], "launches": launches[name],
         **results[name]}
        for name in KERNELS
    ]
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
