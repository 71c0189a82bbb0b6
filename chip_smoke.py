#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``duodiff_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's main path at the full CelebA-64 U-ViT width and checks
it, in phases, each printing its results on its own lines:

1. set-up: the card (name and power limit from nvidia-smi), torch and CUDA
   versions, and the build of the CUDA kernels from ``duodiff_tpu_torch/csrc``;
2. each kernel against its plain PyTorch version on the card, at the
   sampling shapes (L = 257, D = 512, 8 heads, hidden 2048, bf16) and
   batches 8 and 128: K1 with and without a qkv bias, K2 with exact and
   tanh GELU, the int8 K11 with and without a qkv bias, K12 with dynamic
   and static activation scales, each with exact and tanh GELU; all timed;
3. the full depth-13 flagship forward, fused kernels against plain
   PyTorch on the same weights, and a short DuoDiff trajectory (depth 3 ->
   depth 13, full width) both ways from the same noise; then the same for
   int8 (static scales from ``assets/int8_scales_celeba_flagship.json``),
   ``forward_anchor`` / ``forward_cached`` against the forward, and a short
   block-cached int8 DuoDiff trajectory;
4. the main path: ``python -m duodiff_tpu_torch.sample`` in-process,
   1000-step DuoDiff DDPM (depth 3 for the first 300 steps, then depth
   13), random weights from a seed; the launch counters show every step
   went through the kernels;
4b. the headline composition through the same CLI: int8 sublayers (depth 3
   with dynamic scales, depth 13 with the static ones), the depth-13
   segment block-cached on ``assets/cache_schedule_celeba_duodiff.json``,
   tanh GELU; the counters must equal what the schedule implies.

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
N_OUTER = 2          # the default for depth 13: ceil((13 // 2) / 3)
REPO = Path(__file__).resolve().parent
EARLY_CONFIG = str(REPO / "configs/uvit_celeba_3.yaml")
LATE_CONFIG = str(REPO / "configs/uvit_celeba.yaml")
L, D, HEADS, HIDDEN = 257, 512, 8, 2048
# |kernel - plain| <= ATOL + RTOL * |plain| elementwise: the bound the JAX
# tests allow between the package's own bf16 paths (tests/test_ops.py)
ATOL = RTOL = 5e-2
# The whole int8 forward is held to a relative bound instead: a 1-ulp change
# of a block's bf16 input flips an int8 code wherever x * inv lies near .5,
# moving the block's output by a quantization step, and through 13 blocks
# such flips compound to a few percent, the size of int8's own error against
# bf16 (PERF.md). The blocks one by one meet the elementwise bound.
INT8_REL_FRO = 5e-2
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
INT8_KERNELS = {
    "fused_attn_sublayer_int8": {
        "source": "duodiff_tpu_torch/csrc/attn_sublayer_int8.cu",
        "replaces": "duodiff_tpu/ops/pallas_block_int8.py:103",
    },
    "fused_mlp_sublayer_int8": {
        "source": "duodiff_tpu_torch/csrc/mlp_sublayer_int8.cu",
        "replaces": "duodiff_tpu/ops/pallas_block_int8.py:155",
    },
}
INT8_SCALES = str(REPO / "assets/int8_scales_celeba_flagship.json")
CACHE_SCHEDULE = str(REPO / "assets/cache_schedule_celeba_duodiff.json")


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


def rel_fro(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want|| over all elements (inf if got is not finite)."""
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    return ((got - want).norm() / want.norm()).item()


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


def block_modules(batch: int, qkv_bias: bool, seed: int = 0):
    """Random bf16 input (CPU) and the torch modules of one block at
    flagship width: (x, norm, qkv, proj, fc1, fc2)."""
    from torch import nn

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
    return x, norm, qkv, proj, fc1, fc2


def to_device(ops, device):
    return tuple(None if t is None else t.to(device) for t in ops)


def sublayer_operands(batch: int, qkv_bias: bool, device, seed: int = 0):
    """Random bf16 input and packed operands of one block at flagship width."""
    from duodiff_tpu_torch.ops.block import pack_attn, pack_mlp

    x, norm, qkv, proj, fc1, fc2 = block_modules(batch, qkv_bias, seed)
    attn_ops = pack_attn(norm, qkv, proj, num_heads=HEADS, dtype=torch.bfloat16)
    mlp_ops = pack_mlp(norm, fc1, fc2, dtype=torch.bfloat16)
    return x.to(device), to_device(attn_ops, device), to_device(mlp_ops, device)


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
                compare_kernel(results[name], f"{name} B={batch} {label}", kernel, plain,
                               keep_time=batch == MAIN_BATCH and not variant)
    return results


def compare_kernel(res: dict, label: str, kernel, plain, keep_time: bool) -> None:
    """One kernel call against its plain version on the same inputs, both
    timed; folds the error into ``res`` and, for the main path's variant,
    the times."""
    got = kernel()
    torch.cuda.synchronize()
    max_abs, max_rel, ok = errors(got, plain())
    ms = time_ms({"kernel": kernel, "plain": plain})
    print(f"phase 2: {label}: max_abs_err={max_abs:.6g} max_rel_err={max_rel:.6g} "
          f"bound={ATOL}+{RTOL}*|plain| ok={ok} kernel_ms={ms['kernel']:.6g} "
          f"plain_ms={ms['plain']:.6g}", flush=True)
    if not ok:
        fail(f"{label} disagrees with its plain version")
    res["max_abs_err"] = max(res["max_abs_err"], max_abs)
    if keep_time:
        res["ms"], res["plain_ms"] = ms["kernel"], ms["plain"]


def check_int8_kernels(device) -> dict:
    """Phase 2, int8: K11 with and without a qkv bias, K12 with dynamic and
    static scales (the asset's mid-block pair), each with erf and tanh
    GELU, against their plain versions. The recorded times are those of
    the main path's variants at batch 128: K11 without bias, K12 static
    with tanh GELU (the late model's 3529 of 4429 launches)."""
    from duodiff_tpu_torch.ops import block_int8 as q
    from duodiff_tpu_torch.utils.int8_scales import load_int8_scales

    static = load_int8_scales(INT8_SCALES)["mid_block"]
    results = {name: {"max_abs_err": 0.0} for name in INT8_KERNELS}
    for batch in sorted({CHECK_BATCH, MAIN_BATCH}):
        for qkv_bias in (False, True):
            x, norm, qkv, proj, _, _ = block_modules(batch, qkv_bias)
            x = x.to(device)
            ops = to_device(q.pack_attn_int8(norm, qkv, proj, num_heads=HEADS), device)
            compare_kernel(
                results["fused_attn_sublayer_int8"],
                f"fused_attn_sublayer_int8 B={batch} qkv_bias={qkv_bias}",
                lambda: q.fused_attn_sublayer_int8(x, *ops, num_heads=HEADS),
                lambda: q.attn_sublayer_int8_plain(x, *ops, num_heads=HEADS),
                keep_time=batch == MAIN_BATCH and not qkv_bias,
            )
        x, norm, _, _, fc1, fc2 = block_modules(batch, False)
        x = x.to(device)
        for scales in (None, static):
            ops = to_device(q.pack_mlp_int8(norm, fc1, fc2, static_scales=scales), device)
            for tanh in (False, True):
                compare_kernel(
                    results["fused_mlp_sublayer_int8"],
                    f"fused_mlp_sublayer_int8 B={batch} "
                    f"scales={'static' if scales else 'dynamic'} gelu={'tanh' if tanh else 'erf'}",
                    lambda: q.fused_mlp_sublayer_int8(x, *ops, gelu_approx=tanh),
                    lambda: q.mlp_sublayer_int8_plain(x, *ops, gelu_approx=tanh),
                    keep_time=batch == MAIN_BATCH and scales is not None and tanh,
                )
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


def check_int8_model(device) -> None:
    """Phase 3, int8: the depth-13 fused_int8 forward with the asset's static
    MLP scales against plain_int8; forward_anchor / forward_cached on the
    card; and a short block-cached int8 DuoDiff trajectory, kernels against
    plain, from one noise table."""
    from duodiff_tpu_torch.diffusion.sampling import ddpm_loop, make_block_cached_apply
    from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
    from duodiff_tpu_torch.utils.model_loading import load_model

    late, cfg = load_model(LATE_CONFIG, device=device, seed=1, attn_impl="fused_int8",
                           gelu_approx=True, int8_scales=INT8_SCALES)
    early, _ = load_model(EARLY_CONFIG, device=device, seed=0, attn_impl="fused_int8",
                          gelu_approx=True)
    for m in (early, late):
        m.pack_for_kernels()
    g = torch.Generator().manual_seed(1)
    shape = (CHECK_BATCH, cfg.img_size, cfg.img_size, cfg.in_chans)
    x = torch.randn(shape, generator=g).to(device)
    t = torch.tensor([999.0, 700.0, 500.0, 300.0, 100.0, 10.0, 1.0, 0.0],
                     device=device)[:CHECK_BATCH]
    outs = {}
    with torch.inference_mode():
        check_int8_blocks(late, x, t)
        for impl in ("fused_int8", "plain_int8"):
            set_attn_impl(late, impl)
            outs[impl] = late(x, t)
        set_attn_impl(late, "fused_int8")
        anchor, delta = late.forward_anchor(x, t, n_outer=N_OUTER)
        cached = late.forward_cached(x, t, n_outer=N_OUTER, delta=delta)
    max_abs, max_rel, _ = errors(outs["fused_int8"], outs["plain_int8"])
    rel = rel_fro(outs["fused_int8"], outs["plain_int8"])
    ok = rel <= INT8_REL_FRO
    print(f"phase 3: depth-{cfg.depth} int8 forward (static scales) B={CHECK_BATCH} "
          f"fused_int8 vs plain_int8: rel_fro_err={rel:.6g} (bound {INT8_REL_FRO}) "
          f"max_abs_err={max_abs:.6g} max_rel_err={max_rel:.6g} "
          f"max_abs_out={outs['plain_int8'].abs().max().item():.6g} ok={ok}", flush=True)
    if not ok:
        fail("the fused_int8 flagship forward disagrees with the plain_int8 one")
    same = torch.equal(anchor, outs["fused_int8"])
    c_rel = rel_fro(cached, anchor)
    c_abs, _, _ = errors(cached, anchor)
    print(f"phase 3: forward_anchor (n_outer {N_OUTER}) equals forward: {same}; "
          f"forward_cached at the anchor's x vs the anchor: rel_fro_err={c_rel:.6g} "
          f"(bound {INT8_REL_FRO}) max_abs_err={c_abs:.6g}", flush=True)
    if not (same and c_rel <= INT8_REL_FRO):
        fail("forward_anchor / forward_cached do not reproduce the forward")

    steps, t_switch = 20, 6
    handoff = steps - t_switch
    table = np.zeros(steps, dtype=bool)
    table[[0, 4, 9]] = True  # plus the forced anchor at t = handoff - 1
    schedule = NoiseSchedule.create(steps=steps, device=device)
    small = (2,) + shape[1:]
    noise = torch.randn((steps,) + small, generator=g).to(device)
    noise[0] = 0.0
    x0 = torch.randn(small, generator=g).to(device)
    apply = make_block_cached_apply(
        lambda xx, tt, yy: late.forward_anchor(xx, tt, yy, n_outer=N_OUTER),
        lambda xx, tt, yy, d: late.forward_cached(xx, tt, yy, n_outer=N_OUTER, delta=d),
        table, handoff - 1,
    )
    tokens = cfg.extras + cfg.num_patches
    outs = {}
    with torch.inference_mode():
        for impl in ("fused_int8", "plain_int8"):
            set_attn_impl(early, impl)
            set_attn_impl(late, impl)
            xe = ddpm_loop(early, schedule, "predict_noise", x0, None,
                           range(steps - 1, handoff - 1, -1), noise_table=noise)
            state = torch.zeros((2, tokens, cfg.embed_dim), dtype=late.dtype, device=device)
            outs[impl], _ = ddpm_loop(apply, schedule, "predict_noise", xe, None,
                                      range(handoff - 1, -1, -1), noise_table=noise,
                                      state=state)
    max_abs, max_rel, ok = errors(outs["fused_int8"], outs["plain_int8"])
    print(f"phase 3: {steps}-step block-cached int8 DuoDiff trajectory (depth 3 -> "
          f"{cfg.depth}, t_switch {t_switch}, anchors {[0, 4, 9, handoff - 1]}) B=2 "
          f"fused_int8 vs plain_int8: max_abs_err={max_abs:.6g} max_rel_err={max_rel:.6g} "
          f"ok={ok}", flush=True)
    if not ok:
        fail("the cached int8 DuoDiff trajectory disagrees with its plain version")


def check_int8_blocks(model, x, t) -> None:
    """Each block of the int8 model, kernels against plain, on the same
    input: the plain model's own activations, so no error carries from one
    block to the next. Every block must meet the elementwise bound."""
    h = model.embed_tokens(x, t)
    k = len(model.in_blocks)
    skips, worst = [], 0.0
    for i, blk in enumerate(model.blocks()):
        skip = skips.pop() if i > k else None
        blk.attn_impl = "fused_int8"
        got = blk(h, skip)
        blk.attn_impl = "plain_int8"
        h = blk(h, skip)
        max_abs, _, ok = errors(got, h)
        worst = max(worst, max_abs)
        if not ok:
            fail(f"int8 block {i} (kernels) disagrees with its plain version: "
                 f"max_abs_err={max_abs:.6g}")
        if i < k:
            skips.append(h)
    print(f"phase 3: each of the {len(model.blocks())} int8 blocks (static scales) "
          f"on the plain model's inputs, kernels vs plain: max_abs_err={worst:.6g} "
          f"bound={ATOL}+{RTOL}*|plain| ok=True", flush=True)


def reset_counts() -> None:
    from duodiff_tpu_torch.ops import block, block_int8

    block.fused_attn_sublayer.launches = 0
    block.fused_mlp_sublayer.launches = 0
    block_int8.reset_launch_counts()


def read_counts() -> dict:
    from duodiff_tpu_torch.ops import block, block_int8

    k12 = block_int8.fused_mlp_sublayer_int8
    return {
        "fused_attn_sublayer": block.fused_attn_sublayer.launches,
        "fused_mlp_sublayer": block.fused_mlp_sublayer.launches,
        "fused_attn_sublayer_int8": block_int8.fused_attn_sublayer_int8.launches,
        "fused_mlp_sublayer_int8": k12.launches,
        "fused_mlp_sublayer_int8 dynamic": k12.launches_dynamic,
        "fused_mlp_sublayer_int8 static": k12.launches_static,
    }


def run_cli(label: str, extra: list, card: str, expected: dict) -> dict:
    """One 1000-step DuoDiff run of the sampling CLI, in-process, with every
    launch counter set to 0 just before and read just after; checks the
    samples and that the counts equal ``expected`` (unlisted kernels: 0)."""
    from duodiff_tpu_torch import sample

    with tempfile.TemporaryDirectory() as out:
        argv = [
            "--config_path", EARLY_CONFIG, "--config_path_late", LATE_CONFIG,
            "--t_switch", str(T_SWITCH), "--random_init",
            "--num_timesteps", str(STEPS), "--batch_size", str(MAIN_BATCH),
            "--parametrization", "predict_noise", "--device", "cuda",
            "--output_folder", out, "--seed", "0", *extra,
        ]
        reset_counts()
        tic = time.perf_counter()
        result = sample.main(argv)
        wall = time.perf_counter() - tic
        launches = read_counts()
        saved = np.load(f"{out}/samples.npy")
    samples = result["samples"]
    print(f"{label} batch {MAIN_BATCH}: sampling {result['seconds']:.6g} s, "
          f"{MAIN_BATCH / result['seconds']:.6g} samples/s, CLI wall {wall:.6g} s, "
          f"launches {launches} (expected {expected}), card {card}", flush=True)
    shape = (MAIN_BATCH, 64, 64, 3)
    if samples.shape != shape or saved.shape != shape or saved.dtype != np.uint8:
        fail(f"samples have shape {samples.shape} / {saved.shape} {saved.dtype}, "
             f"expected {shape} uint8")
    if not np.isfinite(samples).all():
        fail("samples are not finite")
    for name, n in launches.items():
        if n != expected.get(name, 0):
            fail(f"{name} launched {n} times on the path, expected {expected.get(name, 0)}")
    return launches


def run_main_path(card: str) -> dict:
    """Phase 4: the bf16 DuoDiff run of the sampling CLI; returns the
    launch counts."""
    expected = T_SWITCH * 3 + (STEPS - T_SWITCH) * 13
    return run_cli(
        f"phase 4: DuoDiff {STEPS} steps (depth 3 x {T_SWITCH}, depth 13 x "
        f"{STEPS - T_SWITCH}), bf16",
        [], card, {"fused_attn_sublayer": expected, "fused_mlp_sublayer": expected},
    )


def run_int8_main_path(card: str) -> dict:
    """Phase 4b: the headline composition through the sampling CLI: depth 3
    with dynamic int8 for t = 999..700, then depth 13 with the asset's
    static MLP scales, block-cached on the committed anchor schedule,
    tanh GELU. The expected counts follow from the schedule: the late
    segment anchors its listed steps below the handoff plus its first
    step and runs 2 * n_outer blocks on every other step."""
    from duodiff_tpu_torch.diffusion.cache_schedule import load_cache_schedule

    table = load_cache_schedule(CACHE_SCHEDULE, num_timesteps=STEPS)
    handoff = STEPS - T_SWITCH
    anchors = int(table[:handoff].sum()) + (not table[handoff - 1])
    early = T_SWITCH * 3
    late = anchors * 13 + (handoff - anchors) * 2 * N_OUTER
    expected = {
        "fused_attn_sublayer_int8": early + late,
        "fused_mlp_sublayer_int8": early + late,
        "fused_mlp_sublayer_int8 dynamic": early,
        "fused_mlp_sublayer_int8 static": late,
    }
    return run_cli(
        f"phase 4b: DuoDiff {STEPS} steps int8 (depth 3 x {T_SWITCH} dynamic scales, "
        f"depth 13 x {handoff} static scales, block-cached: {anchors} anchored, "
        f"{handoff - anchors} cached at n_outer {N_OUTER}), tanh GELU",
        ["--attn_impl", "fused_int8", "--int8_scales_late", INT8_SCALES,
         "--cache_schedule", CACHE_SCHEDULE, "--gelu_approx"],
        card, expected,
    )


def main() -> int:
    if not torch.cuda.is_available():
        print("FAILED: no CUDA device; chip_smoke.py runs only on a GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = setup()
    results = {**check_kernels(device), **check_int8_kernels(device)}
    check_model(device)
    check_int8_model(device)
    launches = run_main_path(card)
    launches.update({name: n for name, n in run_int8_main_path(card).items()
                     if name in INT8_KERNELS})
    kernels = {**KERNELS, **INT8_KERNELS}
    record = [
        {"name": name, "route": "cuda", **kernels[name], "launches": launches[name],
         **results[name]}
        for name in kernels
    ]
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
