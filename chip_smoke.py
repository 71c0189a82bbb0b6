#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``duodiff_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--phases 2,3,4,4b,5,5b,6,7,8,9]

Drives the port's main paths at the full width of the CelebA-64 U-ViT
(D = 512) and of the class-conditional ImageNet-64 U-ViT (D = 768) and
checks them, in phases, each printing its results on its own lines:

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
   tanh GELU; the counters must equal what the schedule implies;
5. training, the main path of the third slice: ``python -m
   duodiff_tpu_torch.train`` in-process on ``configs/uvit_cifar10.yaml``
   (L = 257, D = 512, depth 13) with ``--use_amp`` at batch 128, on
   synthetic palette images in the CIFAR-10 layout written to a temporary
   directory: the loss must fall, every block must run K1, K2, K6 and K7
   once a step, a ``--resume`` run must continue from the saved step and
   sampler state, and the checkpoint must load into the sampling CLI's
   ``load_model`` and give the trainer's forward; then a profile of one
   step;
5b. DuoDiff distillation through the same CLI: a depth-3 student
   (``configs/uvit_cifar10_3.yaml``) from a depth-13 teacher;
6. class-conditional sampling: the sampling CLI on ``configs/uvit_imagenet64_3.yaml`` ->
   ``configs/uvit_imagenet64.yaml`` (D = 768, 12 heads, depth 17, L = 258),
   ``--attn_impl pallas`` (the unfused block around the attention kernel
   K9) with classifier-free guidance on random classes at batch 64, so
   every forward runs at batch 128; then one guided step timed and profiled;
7. class-conditional training through the training CLI on
   ``configs/uvit_imagenet64.yaml`` at batch 128 in bf16 on a synthetic
   ImageNet-64 cache with label dropout: 100 steps with ``--attn_impl
   pallas`` (K9 forward, K10 backward; the loss must fall), a step's split,
   profile and peak memory, then 20 steps with ``--attn_impl fused`` (K1,
   K2, K6, K7 at D = 768);
8. the same fused training with ``DUODIFF_MLP_BWD_SPLIT=1``, so that the MLP
   sublayer's backward is the hidden-split kernel K8 and K7 never runs: 40
   steps (the loss must fall; split, profile and peak memory beside phase
   7's), 20 steps with ``--grad_accum 2 --skip_nonfinite 3`` (10 optimizer
   updates), a run loaded from that one's checkpoint of step 13, inside an
   accumulation window, which must end where the unbroken run ended, and 10
   steps with ``--use_checkpoint`` (every block's forward twice a step);
   then ``duodiff_tpu_torch.tools.probe_mlp_bwd_split``;
9. the int8 probe tools, the main path of the sixth slice:
   ``duodiff_tpu_torch.tools.probe_int8_static`` (K13, K14: the dynamic and
   the static twin of both W8A8 sublayers, chained) and
   ``duodiff_tpu_torch.tools.probe_int8_sdpa`` (K15: the attention chain alone,
   bf16 and int8), each once through its ``main`` at its full geometry
   (batch 128, L = 257, D = 512, 8 heads), with the launch counts they imply.

Phase 4's run also passes ``--timesteps_save 300 1000`` and checks the PNG
files the CLI writes. ``--phases`` runs a subset (phase 1 always runs); the
launch counts and the per-kernel record then cover the phases run.

Phase 2 also holds the backward kernels K6 (with and without a qkv bias)
and K7 (exact and tanh GELU) against their plain versions, the attention
kernels K9 and K10 at three (B, H, L) with
``F.scaled_dot_product_attention`` timed beside them as a yardstick, and
K1, K2, K6, K7, K11 and K12 at the ImageNet-64 width, and at both widths
the rest of ``ops/pallas_block.py``: the per-head attention sublayer K1-v1
and the whole-block kernel K5 against their plain versions, K5 timed beside
K1 then K2 and K1-v1 beside K1, and K8 at 2, 4 and 8 slices against its
plain version and against K7, timed beside K7; and at the probes' geometry
K13 and K14, dynamic and static, and K15's two forms (the int8 one within
1 % relative Frobenius of its plain version, equal bits on a repeat call,
under 5 % from the bf16 form) with ``F.scaled_dot_product_attention(scale=1)``
timed beside them. Phase 3 also holds
the gradients of the whole depth-13 model and a few optimizer steps, fused
against plain, and the depth-17 ImageNet-64 forward, gradients and a guided
DuoDiff trajectory, attention kernels against their plain versions; a stack
of the depth-17 model's blocks through ``FusedBlockFn`` (K5 and its chained
backward) and through K1-v1, against the plain block; and the depth-17
model's gradients with K8 against those with K7.

The line before the last is the per-kernel JSON record (its ``bound_ms``
is the least time the card could take at the published H100 SXM peaks, its
``library_ms`` one PyTorch call of the same function where there is one);
the last line is ``{"ok": true, "device": {...}}``. Any failed check exits non-zero. There is
no CPU fallback: without a CUDA device the script exits with code 1.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

CHECK_BATCH = 8      # kernel and forward checks
MAIN_BATCH = 128     # the 1000-step main path (bench.py's batch)
STEPS = 1000
T_SWITCH = 300
REPO = Path(__file__).resolve().parent
EARLY_CONFIG = str(REPO / "configs/uvit_celeba_3.yaml")
LATE_CONFIG = str(REPO / "configs/uvit_celeba.yaml")


class Width(NamedTuple):
    """Tokens, embedding width and heads of one model family (hidden 4 D)."""

    l: int
    d: int
    heads: int


CELEBA = Width(257, 512, 8)      # configs/uvit_celeba.yaml, uvit_cifar10.yaml
IMAGENET = Width(258, 768, 12)   # configs/uvit_imagenet64.yaml (time + label tokens)
N_OUTER = 2          # the default for depth 13: ceil((13 // 2) / 3)
# published dense peaks of one H100 SXM at its full 700 W limit (NVIDIA's
# data sheet): the rates every bound_ms below is computed against
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
# |kernel - plain| <= ATOL + RTOL * |plain| elementwise: the bound the JAX
# tests allow between the package's own bf16 paths (tests/test_ops.py)
ATOL = RTOL = 5e-2
# The whole int8 forward is held to a relative bound instead: a 1-ulp change
# of a block's bf16 input flips an int8 code wherever x * inv lies near .5,
# moving the block's output by a quantization step, and through 13 blocks
# such flips compound to a few percent, the size of int8's own error against
# bf16 (PERF.md). The blocks one by one meet the elementwise bound.
INT8_REL_FRO = 5e-2
# The attention kernel K9 and the models that run through it are held to
# their plain versions as a whole and entry by entry, both scaled to the
# output: the attention output is a mean of 258 values, far below 0.05, so
# the bound above would pass a kernel that is wrong by its whole size.
# One kernel call: ||got - plain|| / ||plain|| <= FWD_REL_FRO (an unmasked
# padded key column moves every row by ~3 %; measured 9e-5) and |got - plain|
# <= KERNEL_MAX_FRAC * max|plain| for every entry, one flipped bf16 rounding
# (at most 2**-7 of the value) of the largest value.
# A depth-17 forward: the two sides' bf16 residual streams round apart from
# the first flipped entry on, about 2**-9 of the stream per sublayer over
# 34 sublayers (measured 0.9e-2 and 1.0e-2), so it is held at twice that
# floor, MODEL_REL_FRO, and entry by entry at MODEL_MAX_FRAC of the largest
# value (measured 1.1e-2 of it). The fp32 trajectory meets FWD_REL_FRO.
FWD_REL_FRO = 1e-2
MODEL_REL_FRO = 2e-2
KERNEL_MAX_FRAC = 2.0**-7
MODEL_MAX_FRAC = 2.0**-5
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
ATTENTION_KERNELS = {
    "flash_attention": {
        "source": "duodiff_tpu_torch/csrc/flash_attention.cu",
        "replaces": "duodiff_tpu/ops/pallas_attention.py:30",
    },
    "flash_attention_bwd": {
        "source": "duodiff_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "duodiff_tpu/ops/pallas_attention.py:72",
    },
}
BWD_KERNELS = {
    "fused_attn_sublayer_bwd": {
        "source": "duodiff_tpu_torch/csrc/attn_sublayer_bwd.cu",
        "replaces": "duodiff_tpu/ops/pallas_block.py:232",
    },
    "fused_mlp_sublayer_bwd": {
        "source": "duodiff_tpu_torch/csrc/mlp_sublayer_bwd.cu",
        "replaces": "duodiff_tpu/ops/pallas_block.py:1035",
    },
}
# the rest of ops/pallas_block.py: the per-head attention sublayer, the
# whole-block kernel and the hidden-split MLP backward; their recorded times
# and bounds are those at the ImageNet-64 width, where training runs K8
BLOCK_KERNELS = {
    "fused_attn_sublayer_v1": {
        "source": "duodiff_tpu_torch/csrc/attn_sublayer_v1.cu",
        "replaces": "duodiff_tpu/ops/pallas_block.py:45",
    },
    "fused_block": {
        "source": "duodiff_tpu_torch/csrc/fused_block.cu",
        "replaces": "duodiff_tpu/ops/pallas_block.py:415",
    },
    "fused_mlp_sublayer_bwd_split": {
        "source": "duodiff_tpu_torch/csrc/mlp_sublayer_bwd_split.cu",
        "replaces": "duodiff_tpu/ops/pallas_block.py:1167",
    },
}
# the kernels of the int8 probe tools: K13 is K12's kernel and K14's dynamic
# form K11's, reached through the probes' own operands and scales; K14's
# static form and K15's int8 form are device code of their own; K15's bf16
# form launches the core of K1 / K9 with no scale
PROBE_KERNELS = {
    "probe_mlp_int8": {
        "source": "duodiff_tpu_torch/csrc/mlp_sublayer_int8.cu",
        "replaces": "tools/probe_int8_static.py:51",
    },
    "probe_attn_int8": {
        "source": "duodiff_tpu_torch/csrc/attn_sublayer_int8.cu",
        "replaces": "tools/probe_int8_static.py:111",
    },
    "sdpa_chain_bf16": {
        "source": "duodiff_tpu_torch/csrc/sdpa_int8.cu",
        "replaces": "tools/probe_int8_sdpa.py:46",
    },
    "sdpa_chain_int8": {
        "source": "duodiff_tpu_torch/csrc/sdpa_int8.cu",
        "replaces": "tools/probe_int8_sdpa.py:68",
    },
}
# K15's int8 form against its plain version: int32 sums are exact, so the two
# differ through expf against torch.exp and the order of the fp32 row sum, and
# where e * 127 lies near a half a code of e flips by one; such flips move
# single entries by more than a bf16 rounding, so the gate is the relative
# Frobenius error alone. Against the bf16 form it is held under SDPA_INT8_REL.
SDPA_INT8_REL = 5e-2
PHASES = ("2", "3", "4", "4b", "5", "5b", "6", "7", "8", "9")
# A stack of 17 blocks with no long skips carries every block's bf16
# roundings, forward and backward, through all the blocks behind it: the
# gradients of FusedBlockFn against autograd through block_plain over the
# whole stack measured 1.4e-2 at worst (median 9.7e-3), above the 1e-2 that
# models with long skips meet. So each block is held to BWD_REL_FRO on the
# plain stack's own input and upstream gradient, where nothing is carried,
# and the whole stack to STACK_GRAD_REL_FRO; a wrong backward is off by its
# whole size either way.
STACK_GRAD_REL_FRO = 3e-2
SPLITS = (2, 4, 8)       # K8's slice counts held in phase 2
MAIN_SPLITS = 4          # what mlp_bwd_split_config picks at hidden 2048 and 3072
# The backward kernels are held per output tensor to
# ||kernel - plain|| / ||plain|| <= BWD_REL_FRO: most gradient entries are
# far below 0.05, so the elementwise bound would pass nearly anything. Both
# sides round to bf16 at the Pallas kernels' points (2**-8 relative); their
# fp32 sums differ only in order, so 1e-2 (~2.5 bf16 ulps over the tensor)
# is a bound a wrong kernel cannot meet. dx is also held elementwise.
BWD_REL_FRO = 1e-2
# The gradients of a whole depth-13 model, fused (K6/K7) against plain
# (autograd through the plain sublayers), meet the same per-parameter bound:
# the two backwards round the activation gradients to bf16 at somewhat
# different points, which 13 blocks compound (measured worst 3.8e-3).
# A few AdamW steps, fused against plain: the loss of each step within
# STEP_LOSS_REL, and each parameter's total update within UPDATE_REL_FRO.
# Adam scales each entry's update by its own gradient's size, so entries
# whose gradient is near zero move by up to lr either way on bf16 noise;
# the bound holds the update as a whole (measured worst 4.4e-2).
OPT_STEPS = 3
STEP_LOSS_REL = 1e-3
UPDATE_REL_FRO = 0.1
# The logged train loss must end below LOSS_DROP times its first value: the
# logged values are single-batch losses, which after step 1 fell
# monotonically 0.65 -> 0.59 over steps 50-200 at the default lr 2e-4 from
# 1.19 at step 1, so a quarter's drop is far outside their spread.
LOSS_DROP = 0.75
TRAIN_CONFIG = str(REPO / "configs/uvit_cifar10.yaml")
STUDENT_CONFIG = str(REPO / "configs/uvit_cifar10_3.yaml")
TRAIN_BATCH = 128      # main.py's default
TRAIN_STEPS = 200
RESUME_STEPS = 20
DISTILL_STEPS = 20
WARMUP_STEPS = 20
IMAGENET_EARLY_CONFIG = str(REPO / "configs/uvit_imagenet64_3.yaml")
IMAGENET_CONFIG = str(REPO / "configs/uvit_imagenet64.yaml")
GUIDED_BATCH = 64          # every guided forward runs at twice this, MAIN_BATCH
GUIDANCE_SCALE = 1.5
IMAGENET_TRAIN_STEPS = 100
IMAGENET_FUSED_STEPS = 20
LABEL_DROPOUT = 0.1
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


def scaled_errors(got: torch.Tensor, want: torch.Tensor, frac: float,
                  rel_bound: float = FWD_REL_FRO):
    """(max abs error, its bound frac * max|want|, relative Frobenius error,
    within both that bound and ``rel_bound``)."""
    max_abs = errors(got, want)[0]
    limit = frac * want.float().abs().max().item()
    rel = rel_fro(got, want)
    return max_abs, limit, rel, max_abs <= limit and rel <= rel_bound


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


def block_modules(batch: int, qkv_bias: bool, seed: int = 0, width: Width = CELEBA):
    """Random bf16 input (CPU) and the torch modules of one block at
    ``width``: (x, norm, qkv, proj, fc1, fc2)."""
    from torch import nn

    g = torch.Generator().manual_seed(seed)

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale

    d = width.d
    norm = nn.LayerNorm(d)
    qkv, proj = nn.Linear(d, 3 * d, bias=qkv_bias), nn.Linear(d, d)
    fc1, fc2 = nn.Linear(d, 4 * d), nn.Linear(4 * d, d)
    with torch.no_grad():
        for mod in (norm, qkv, proj, fc1, fc2):
            mod.weight.copy_(rand(*mod.weight.shape, scale=0.05))
            if mod.bias is not None:
                mod.bias.copy_(rand(*mod.bias.shape, scale=0.05))
        norm.weight.add_(1.0)
    x = rand(batch, width.l, d).to(torch.bfloat16)
    return x, norm, qkv, proj, fc1, fc2


def to_device(ops, device):
    return tuple(None if t is None else t.to(device) for t in ops)


def sublayer_operands(batch: int, qkv_bias: bool, device, width: Width = CELEBA):
    """Random bf16 input and packed operands of one block at ``width``."""
    from duodiff_tpu_torch.ops.block import pack_attn, pack_mlp

    x, norm, qkv, proj, fc1, fc2 = block_modules(batch, qkv_bias, width=width)
    attn_ops = pack_attn(norm, qkv, proj, num_heads=width.heads, dtype=torch.bfloat16)
    mlp_ops = pack_mlp(norm, fc1, fc2, dtype=torch.bfloat16)
    return x.to(device), to_device(attn_ops, device), to_device(mlp_ops, device)


def new_results(names) -> dict:
    return {name: {"max_abs_err": 0.0} for name in names}


def keep_times(res: dict, ms: dict, suffix) -> None:
    """Record a comparison's times under ``ms`` / ``plain_ms`` + suffix
    (None: this variant's times are printed only)."""
    if suffix is not None:
        res["ms" + suffix], res["plain_ms" + suffix] = ms["kernel"], ms["plain"]


def check_kernels(device, results: dict, width: Width = CELEBA, variants=(False, True),
                  suffix: str = "") -> None:
    """Phase 2: K1 (with and without a qkv bias) and K2 (exact and tanh
    GELU) against their plain versions at batch 8 and 128; errors fold over
    every variant and batch, times are kept at batch 128, first variant."""
    from duodiff_tpu_torch.ops import block

    heads = width.heads
    for batch in sorted({CHECK_BATCH, MAIN_BATCH}):
        for variant in variants:
            x, attn_ops, mlp_ops = sublayer_operands(batch, variant, device, width)
            cases = {
                "fused_attn_sublayer": (
                    f"qkv_bias={variant}",
                    lambda: block.fused_attn_sublayer(x, *attn_ops, num_heads=heads),
                    lambda: block.attn_sublayer_plain(x, *attn_ops, num_heads=heads),
                ),
                "fused_mlp_sublayer": (
                    f"gelu={'tanh' if variant else 'erf'}",
                    lambda: block.fused_mlp_sublayer(x, *mlp_ops, gelu_approx=variant),
                    lambda: block.mlp_sublayer_plain(x, *mlp_ops, gelu_approx=variant),
                ),
            }
            for name, (label, kernel, plain) in cases.items():
                compare_kernel(results[name], f"{name} D={width.d} L={width.l} B={batch} {label}",
                               kernel, plain,
                               suffix if batch == MAIN_BATCH and not variant else None)


def compare_kernel(res: dict, label: str, kernel, plain, suffix,
                   scaled: bool = False) -> None:
    """One kernel call against its plain version on the same inputs, both
    timed; folds the error into ``res`` and keeps the times (keep_times).
    ``scaled`` holds it to the bounds scaled to the output (scaled_errors)
    instead of the elementwise ATOL + RTOL * |plain|."""
    got = kernel()
    torch.cuda.synchronize()
    if scaled:
        max_abs, limit, rel, ok = scaled_errors(got, plain(), KERNEL_MAX_FRAC)
        held = (f"max_abs_err={max_abs:.6g} (bound {limit:.6g} = {KERNEL_MAX_FRAC}*max|plain|) "
                f"rel_fro_err={rel:.6g} (bound {FWD_REL_FRO})")
    else:
        max_abs, max_rel, ok = errors(got, plain())
        held = (f"max_abs_err={max_abs:.6g} max_rel_err={max_rel:.6g} "
                f"bound={ATOL}+{RTOL}*|plain|")
    ms = time_ms({"kernel": kernel, "plain": plain})
    print(f"phase 2: {label}: {held} ok={ok} kernel_ms={ms['kernel']:.6g} "
          f"plain_ms={ms['plain']:.6g}", flush=True)
    if not ok:
        fail(f"{label} disagrees with its plain version")
    res["max_abs_err"] = max(res["max_abs_err"], max_abs)
    keep_times(res, ms, suffix)


def check_int8_kernels(device, results: dict, width: Width = CELEBA,
                       batches=(CHECK_BATCH, MAIN_BATCH), suffix: str = "") -> None:
    """Phase 2, int8: K11 with and without a qkv bias, K12 with dynamic and
    static scales (the asset's mid-block pair), each with erf and tanh
    GELU, against their plain versions. The times kept are those of the
    main path's variants at the largest batch: K11 without bias, K12 static
    with tanh GELU (the late model's 3529 of 4429 launches)."""
    from duodiff_tpu_torch.ops import block_int8 as q
    from duodiff_tpu_torch.utils.int8_scales import load_int8_scales

    static = load_int8_scales(INT8_SCALES)["mid_block"]
    heads = width.heads
    for batch in sorted(set(batches)):
        timed = batch == max(batches)
        for qkv_bias in (False, True):
            x, norm, qkv, proj, _, _ = block_modules(batch, qkv_bias, width=width)
            x = x.to(device)
            ops = to_device(q.pack_attn_int8(norm, qkv, proj, num_heads=heads), device)
            compare_kernel(
                results["fused_attn_sublayer_int8"],
                f"fused_attn_sublayer_int8 D={width.d} L={width.l} B={batch} qkv_bias={qkv_bias}",
                lambda: q.fused_attn_sublayer_int8(x, *ops, num_heads=heads),
                lambda: q.attn_sublayer_int8_plain(x, *ops, num_heads=heads),
                suffix if timed and not qkv_bias else None,
            )
        x, norm, _, _, fc1, fc2 = block_modules(batch, False, width=width)
        x = x.to(device)
        for scales in (None, static):
            ops = to_device(q.pack_mlp_int8(norm, fc1, fc2, static_scales=scales), device)
            for tanh in (False, True):
                compare_kernel(
                    results["fused_mlp_sublayer_int8"],
                    f"fused_mlp_sublayer_int8 D={width.d} L={width.l} B={batch} "
                    f"scales={'static' if scales else 'dynamic'} gelu={'tanh' if tanh else 'erf'}",
                    lambda: q.fused_mlp_sublayer_int8(x, *ops, gelu_approx=tanh),
                    lambda: q.mlp_sublayer_int8_plain(x, *ops, gelu_approx=tanh),
                    suffix if timed and scales is not None and tanh else None,
                )


def check_bwd_kernels(device, results: dict, width: Width = CELEBA, variants=(False, True),
                      suffix: str = "") -> None:
    """Phase 2, backward: K6 with and without a qkv bias and K7 with exact
    and tanh GELU against their plain versions at batch 8 and 128, each
    called twice for the same bits. The times kept are those of the
    training path's variants at batch 128 (no qkv bias, exact GELU, as
    configs/uvit_cifar10.yaml and configs/uvit_imagenet64.yaml)."""
    from duodiff_tpu_torch.ops import block

    bf = torch.bfloat16
    heads = width.heads
    for batch in sorted({CHECK_BATCH, MAIN_BATCH}):
        for variant in variants:
            x, norm, qkv, proj, fc1, fc2 = block_modules(batch, variant, width=width)
            dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(1)).to(bf)
            x, dy = x.to(device), dy.to(device)
            ln = to_device((norm.weight.detach(), norm.bias.detach()), device)
            attn = to_device((qkv.weight.detach().t().to(bf).contiguous(),
                              None if qkv.bias is None else qkv.bias.detach(),
                              proj.weight.detach().t().to(bf).contiguous()), device)
            mlp = to_device((fc1.weight.detach().t().to(bf).contiguous(), fc1.bias.detach(),
                             fc2.weight.detach().t().to(bf).contiguous()), device)
            cases = {
                "fused_attn_sublayer_bwd": (
                    f"qkv_bias={variant}", ("dx", "dg", "db", "dwqkv", "dbqkv", "dwp", "dbp"),
                    lambda: block.fused_attn_sublayer_bwd(x, dy, *ln, *attn, num_heads=heads),
                    lambda: block.attn_sublayer_bwd_plain(x, dy, *ln, *attn, num_heads=heads),
                ),
                "fused_mlp_sublayer_bwd": (
                    f"gelu={'tanh' if variant else 'erf'}",
                    ("dx", "dg", "db", "dw1", "db1", "dw2", "db2"),
                    lambda: block.fused_mlp_sublayer_bwd(x, dy, *ln, *mlp, gelu_approx=variant),
                    lambda: block.mlp_sublayer_bwd_plain(x, dy, *ln, *mlp, gelu_approx=variant),
                ),
            }
            for name, (label, outs, kernel, plain) in cases.items():
                compare_bwd_kernel(results[name],
                                   f"{name} D={width.d} L={width.l} B={batch} {label}", outs,
                                   kernel, plain,
                                   suffix if batch == MAIN_BATCH and not variant else None)


def compare_bwd_kernel(res: dict, label: str, outs, kernel, plain, suffix,
                       elementwise_first: bool = True) -> dict:
    """A backward kernel against its plain version: every output within
    BWD_REL_FRO, the first (dx) also elementwise unless told otherwise, and
    a repeat call equal to the bit. Returns the times."""
    got = kernel()
    again = kernel()
    want = plain()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again) if a is not None)
    rels = {n: rel_fro(g, w) for n, g, w in zip(outs, got, want) if w is not None}
    abs_err = max(errors(g, w)[0] for g, w in zip(got, want) if w is not None)
    dx_abs, _, dx_ok = errors(got[0], want[0])
    ms = time_ms({"kernel": kernel, "plain": plain})
    worst = max(rels, key=rels.get)
    ok = same and (dx_ok or not elementwise_first) and rels[worst] <= BWD_REL_FRO
    print(f"phase 2: {label}: rel_fro_err {', '.join(f'{n}={v:.3g}' for n, v in rels.items())} "
          f"(bound {BWD_REL_FRO}) {outs[0]} max_abs_err={dx_abs:.6g} "
          f"bound={ATOL}+{RTOL}*|plain| "
          f"max_abs_err={abs_err:.6g} repeat_equal={same} ok={ok} kernel_ms={ms['kernel']:.6g} "
          f"plain_ms={ms['plain']:.6g}", flush=True)
    if not ok:
        fail(f"{label} disagrees with its plain version or is not deterministic")
    res["max_abs_err"] = max(res["max_abs_err"], abs_err)
    res["max_rel_fro_err"] = max(res.get("max_rel_fro_err", 0.0), rels[worst])
    keep_times(res, ms, suffix)
    return ms


def check_block_kernels(device, results: dict, width: Width, suffix: str) -> None:
    """Phase 2, the per-head attention sublayer and the whole block: K1-v1
    against attn_sublayer_v1_plain (with and without a qkv bias) and K5
    against block_plain (exact and tanh GELU) at batch 8 and 128; then, at
    batch 128, K5 timed beside K1 followed by K2 on the same operands and
    K1-v1 beside K1, and how far K5's output lies from that of K1 then K2
    (they differ by the bf16 rounding of the intermediate residual stream)."""
    from duodiff_tpu_torch.ops import block

    bf = torch.bfloat16
    heads = width.heads
    for batch in sorted({CHECK_BATCH, MAIN_BATCH}):
        for variant in (False, True):
            x, norm, qkv, proj, fc1, fc2 = block_modules(batch, variant, width=width)
            x = x.to(device)
            v1 = to_device(block.pack_attn_v1(norm, qkv, proj, dtype=bf), device)
            v2 = to_device(block.pack_attn(norm, qkv, proj, num_heads=heads, dtype=bf), device)
            mlp = to_device(block.pack_mlp(norm, fc1, fc2, dtype=bf), device)
            keep = suffix if batch == MAIN_BATCH and not variant else None
            where = f"D={width.d} L={width.l} B={batch}"
            compare_kernel(
                results["fused_attn_sublayer_v1"],
                f"fused_attn_sublayer_v1 {where} qkv_bias={variant}",
                lambda: block.fused_attn_sublayer(x, *v1, num_heads=heads, variant="v1"),
                lambda: block.attn_sublayer_v1_plain(x, *v1, num_heads=heads), keep)
            compare_kernel(
                results["fused_block"],
                f"fused_block {where} qkv_bias={variant} gelu={'tanh' if variant else 'erf'}",
                lambda: block.fused_block(x, *v2, *mlp, num_heads=heads, gelu_approx=variant),
                lambda: block.block_plain(x, *v2, *mlp, num_heads=heads, gelu_approx=variant),
                keep)
            if keep is None:
                continue

            def chain():
                u = block.fused_attn_sublayer(x, *v2, num_heads=heads)
                return block.fused_mlp_sublayer(u, *mlp)

            ms = time_ms({
                "K5": lambda: block.fused_block(x, *v2, *mlp, num_heads=heads),
                "K1 then K2": chain,
                "K1-v1": lambda: block.fused_attn_sublayer(x, *v1, num_heads=heads, variant="v1"),
                "K1": lambda: block.fused_attn_sublayer(x, *v2, num_heads=heads),
            })
            got, two = block.fused_block(x, *v2, *mlp, num_heads=heads).float(), chain().float()
            differ = (got != two).float().mean().item()
            print(f"phase 2: {where}: K5 {ms['K5']:.6g} ms beside K1 then K2 "
                  f"{ms['K1 then K2']:.6g} ms; K1-v1 {ms['K1-v1']:.6g} ms beside K1 "
                  f"{ms['K1']:.6g} ms; K5 differs from K1 then K2 in {differ:.4g} of the "
                  f"entries, by at most {(got - two).abs().max().item():.6g}", flush=True)
            results["fused_block"]["two_sublayers_ms" + suffix] = ms["K1 then K2"]
            results["fused_attn_sublayer_v1"]["v2_ms" + suffix] = ms["K1"]


def check_split_kernel(device, results: dict, width: Width, variants, suffix: str) -> None:
    """Phase 2, the hidden-split MLP backward: K8 at 2, 4 and 8 slices
    against mlp_sublayer_bwd_split_plain (every output within BWD_REL_FRO, dx
    also elementwise, equal bits on a repeat call) and against K7's outputs
    on the same inputs within the same bound, at batch 8 and 128; at batch
    128 K8 timed beside K7, with the scratch each takes. The times kept are
    those of MAIN_SPLITS slices, exact GELU."""
    from duodiff_tpu_torch.ops import block
    from duodiff_tpu_torch.ops._build import load_library

    bf = torch.bfloat16
    lib = load_library()
    outs = ("dx", "dg", "db", "dw1", "db1", "dw2", "db2")
    res = results["fused_mlp_sublayer_bwd_split"]
    for batch in sorted({CHECK_BATCH, MAIN_BATCH}):
        for variant in variants:
            x, norm, _, _, fc1, fc2 = block_modules(batch, False, width=width)
            dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(1)).to(bf)
            x, dy = x.to(device), dy.to(device)
            ops = to_device((norm.weight.detach(), norm.bias.detach(),
                             fc1.weight.detach().t().to(bf).contiguous(), fc1.bias.detach(),
                             fc2.weight.detach().t().to(bf).contiguous()), device)
            where = (f"D={width.d} L={width.l} B={batch} gelu={'tanh' if variant else 'erf'}")
            mono = block.fused_mlp_sublayer_bwd(x, dy, *ops, gelu_approx=variant)
            for splits in SPLITS:
                def kernel(splits=splits):
                    return block.fused_mlp_sublayer_bwd_split(x, dy, *ops, splits=splits,
                                                              gelu_approx=variant)

                def plain(splits=splits):
                    return block.mlp_sublayer_bwd_split_plain(x, dy, *ops, splits=splits,
                                                              gelu_approx=variant)

                main = batch == MAIN_BATCH and not variant and splits == MAIN_SPLITS
                compare_bwd_kernel(res, f"fused_mlp_sublayer_bwd_split {where} splits={splits}",
                                   outs, kernel, plain, suffix if main else None)
                rels = {n: rel_fro(g, w) for n, g, w in zip(outs, kernel(), mono)}
                worst = max(rels, key=rels.get)
                ok = rels[worst] <= BWD_REL_FRO
                print(f"phase 2: K8 splits={splits} against K7 {where}: worst rel_fro_err "
                      f"{rels[worst]:.3g} ({worst}) (bound {BWD_REL_FRO}) ok={ok}", flush=True)
                if not ok:
                    fail(f"K8 with {splits} slices disagrees with K7 at {where}")
            if batch != MAIN_BATCH or variant:
                continue
            fns = {f"K8 splits={n}": (lambda n=n: block.fused_mlp_sublayer_bwd_split(
                x, dy, *ops, splits=n)) for n in SPLITS}
            fns["K7"] = lambda: block.fused_mlp_sublayer_bwd(x, dy, *ops)
            ms = time_ms(fns)
            rows, hid = batch * width.l, 4 * width.d
            scratch = {f"K8 splits={n}": lib.duodiff_mlp_sublayer_bwd_split_workspace(
                rows, width.d, hid, n) for n in SPLITS}
            scratch["K7"] = lib.duodiff_mlp_sublayer_bwd_workspace(rows, width.d, hid)
            k6 = lib.duodiff_attn_sublayer_bwd_workspace(batch, width.l, width.d, width.heads)
            print(f"phase 2: {where}: " + "; ".join(
                f"{k} {ms[k]:.6g} ms, scratch {scratch[k] / 2**20:.6g} MiB" for k in ms)
                + f" (K6, the other backward kernel of a block, takes {k6 / 2**20:.6g} MiB)",
                flush=True)
            res["monolithic_ms" + suffix] = ms["K7"]


# (B, H, L) of the attention kernels' checks: the ImageNet-64 model at the
# check batch and at the main path's doubled guided batch, and the CelebA one
ATTENTION_SHAPES = ((CHECK_BATCH, IMAGENET.heads, IMAGENET.l),
                    (MAIN_BATCH, IMAGENET.heads, IMAGENET.l),
                    (MAIN_BATCH, CELEBA.heads, CELEBA.l))


def check_attention_kernels(device, results: dict) -> None:
    """Phase 2, standalone attention: K9 against flash_attention_plain
    (relative Frobenius and elementwise, both scaled to the output) and K10 against flash_attention_bwd_plain (dq, dk, dv each
    within BWD_REL_FRO, equal bits on a repeat call) at ATTENTION_SHAPES,
    timed, with F.scaled_dot_product_attention's forward and its autograd
    backward timed beside them as the library yardstick (the port never
    calls it). The times kept are those at (128, 12, 258)."""
    import torch.nn.functional as F

    from duodiff_tpu_torch.ops import flash_attention as fa

    for b, h, l in ATTENTION_SHAPES:
        g = torch.Generator().manual_seed(l)
        q, k, v, do = (torch.randn((b, h, l, 64), generator=g).to(torch.bfloat16).to(device)
                       for _ in range(4))
        main = (b, h, l) == ATTENTION_SHAPES[1]
        label = f"B={b} H={h} L={l}"
        compare_kernel(results["flash_attention"], f"flash_attention {label}",
                       lambda: fa.flash_attention(q, k, v),
                       lambda: fa.flash_attention_plain(q, k, v), "" if main else None,
                       scaled=True)
        compare_bwd_kernel(results["flash_attention_bwd"], f"flash_attention_bwd {label}",
                           ("dq", "dk", "dv"),
                           lambda: fa.flash_attention_bwd(q, k, v, do),
                           lambda: fa.flash_attention_bwd_plain(q, k, v, do),
                           "" if main else None, elementwise_first=False)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(*leaves)
            return torch.autograd.grad(out, leaves, do)

        lib = time_ms({"fwd": lambda: F.scaled_dot_product_attention(q, k, v),
                       "fwd_bwd": sdpa_fwd_bwd})
        lib_bwd = lib["fwd_bwd"] - lib["fwd"]
        sdpa_err = errors(F.scaled_dot_product_attention(q, k, v), fa.flash_attention(q, k, v))[0]
        print(f"phase 2: library yardstick {label}: F.scaled_dot_product_attention forward "
              f"{lib['fwd']:.6g} ms, backward (forward + backward less forward) {lib_bwd:.6g} ms; "
              f"max |SDPA - K9| {sdpa_err:.6g}", flush=True)
        if main:
            results["flash_attention"]["library_ms"] = lib["fwd"]
            results["flash_attention_bwd"]["library_ms"] = lib_bwd


def check_probe_kernels(device, results: dict) -> None:
    """Phase 2, the int8 probe tools' kernels at the probes' geometry (L = 257,
    D = 512, hidden 2048, 8 heads of 64) on the probes' own operands and
    scales, at batch 8 and 128. K13 (the MLP sublayer, tanh GELU) and K14
    (the attention sublayer, no qkv bias), each dynamic and static, against
    their plain versions elementwise. K15's bf16 form as K9 is held; its int8
    form within FWD_REL_FRO of its plain version as a whole, equal to the bit
    on a repeat call, and within SDPA_INT8_REL of the bf16 form; with
    F.scaled_dot_product_attention(scale=1) timed beside both as the library
    yardstick (the port never calls it). Times are kept at batch 128."""
    import torch.nn.functional as F

    from duodiff_tpu_torch.ops import block_int8 as q
    from duodiff_tpu_torch.ops import sdpa_int8
    from duodiff_tpu_torch.tools import probe_int8_static as probe

    for batch in sorted({CHECK_BATCH, MAIN_BATCH}):
        timed = batch == MAIN_BATCH
        ops = probe.operands(batch, device)
        x = ops["x"]
        where = f"D={probe.D} L={probe.L} B={batch}"
        for mode in ("dynamic", "static"):
            suffix = ("" if mode == "dynamic" else "_static") if timed else None
            mlp, attn = ops["mlp"][mode], ops["attn"][mode]
            compare_kernel(
                results["probe_mlp_int8"], f"K13 probe MLP sublayer int8 {where} scales={mode}",
                lambda: q.fused_mlp_sublayer_int8(x, *mlp, gelu_approx=True),
                lambda: q.mlp_sublayer_int8_plain(x, *mlp, gelu_approx=True), suffix)
            compare_kernel(
                results["probe_attn_int8"],
                f"K14 probe attention sublayer int8 {where} scales={mode}",
                lambda: q.fused_attn_sublayer_int8(x, *attn, num_heads=probe.H),
                lambda: q.attn_sublayer_int8_plain(x, *attn, num_heads=probe.H), suffix)

        g = torch.Generator().manual_seed(batch)
        qq, kk, vv = (torch.randn((batch, probe.H, probe.L, 64), generator=g)
                      .to(torch.bfloat16).to(device) for _ in range(3))
        label = f"B={batch} H={probe.H} L={probe.L}"
        compare_kernel(results["sdpa_chain_bf16"], f"K15 sdpa_chain_bf16 {label}",
                       lambda: sdpa_int8.sdpa_chain_bf16(qq, kk, vv),
                       lambda: sdpa_int8.sdpa_chain_bf16_plain(qq, kk, vv),
                       "" if timed else None, scaled=True)
        got = sdpa_int8.sdpa_chain_int8(qq, kk, vv)
        again = sdpa_int8.sdpa_chain_int8(qq, kk, vv)
        torch.cuda.synchronize()
        want = sdpa_int8.sdpa_chain_int8_plain(qq, kk, vv)
        same = torch.equal(got, again)
        rel, max_abs = rel_fro(got, want), errors(got, want)[0]
        from_bf16 = rel_fro(got, sdpa_int8.sdpa_chain_bf16(qq, kk, vv))
        ms = time_ms({"kernel": lambda: sdpa_int8.sdpa_chain_int8(qq, kk, vv),
                      "plain": lambda: sdpa_int8.sdpa_chain_int8_plain(qq, kk, vv),
                      "library": lambda: F.scaled_dot_product_attention(qq, kk, vv, scale=1.0)})
        ok = same and rel <= FWD_REL_FRO and from_bf16 <= SDPA_INT8_REL
        print(f"phase 2: K15 sdpa_chain_int8 {label}: rel_fro_err={rel:.6g} (bound {FWD_REL_FRO}) "
              f"max_abs_err={max_abs:.6g} repeat_equal={same} rel l2 from the bf16 form "
              f"{from_bf16:.6g} (bound {SDPA_INT8_REL}) ok={ok} kernel_ms={ms['kernel']:.6g} "
              f"plain_ms={ms['plain']:.6g}; library yardstick F.scaled_dot_product_attention("
              f"scale=1) {ms['library']:.6g} ms", flush=True)
        if not ok:
            fail(f"K15 sdpa_chain_int8 {label} disagrees with its plain version, with the bf16 "
                 "form, or is not deterministic")
        res = results["sdpa_chain_int8"]
        res["max_abs_err"] = max(res["max_abs_err"], max_abs)
        res["max_rel_fro_err"] = max(res.get("max_rel_fro_err", 0.0), rel)
        if timed:
            keep_times(res, ms, "")
            res["rel_l2_from_bf16"] = from_bf16
            res["library_ms"] = results["sdpa_chain_bf16"]["library_ms"] = ms["library"]


def bound(flops: float, int8_ops: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of the bytes over its
    memory rate and the operations over its peak rates for their types."""
    t_ops = flops / PEAK_BF16_FLOPS + int8_ops / PEAK_INT8_OPS
    t_bytes = nbytes / PEAK_BYTES
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def kernel_bounds(width: Width = CELEBA, batch: int = MAIN_BATCH,
                  attention_shape=ATTENTION_SHAPES[1], chain_shape=ATTENTION_SHAPES[2]) -> dict:
    """bound_ms / bound_by of each kernel at the shapes its main path gives
    it: every input read once and every output written once (activations
    bf16, weights bf16 or int8, weight gradients fp32) against the
    operations of its matrix products."""
    l, d, _ = width
    rows, act = batch * l, batch * l * d * 2  # one (B, L, D) bf16 tensor
    bh, la = attention_shape[0] * attention_shape[1], attention_shape[2]
    head = bh * la * 64 * 2  # one (B, H, L, 64) bf16 tensor
    ch, lc = chain_shape[0] * chain_shape[1], chain_shape[2]  # K15, the probe's (B, H, L)
    chain_ops, chain_bytes = 4 * ch * lc * lc * 64, 4 * ch * lc * 64 * 2
    return {
        "fused_attn_sublayer": bound(rows * (8 * d * d + 4 * l * d), 0, 2 * act + 8 * d * d),
        "fused_mlp_sublayer": bound(rows * 16 * d * d, 0, 2 * act + 16 * d * d),
        "fused_attn_sublayer_int8": bound(rows * 4 * l * d, rows * 8 * d * d, 2 * act + 4 * d * d),
        "fused_mlp_sublayer_int8": bound(0, rows * 16 * d * d, 2 * act + 8 * d * d),
        "fused_attn_sublayer_bwd": bound(rows * (22 * d * d + 12 * l * d), 0,
                                         3 * act + 8 * d * d + 16 * d * d),
        "fused_mlp_sublayer_bwd": bound(rows * 40 * d * d, 0, 3 * act + 16 * d * d + 32 * d * d),
        # K1-v1 and K8 compute K1's and K7's functions; K5 both sublayers'
        # products with x read and y written once
        "fused_attn_sublayer_v1": bound(rows * (8 * d * d + 4 * l * d), 0, 2 * act + 8 * d * d),
        "fused_block": bound(rows * (24 * d * d + 4 * l * d), 0, 2 * act + 24 * d * d),
        "fused_mlp_sublayer_bwd_split": bound(rows * 40 * d * d, 0,
                                              3 * act + 16 * d * d + 32 * d * d),
        "flash_attention": bound(4 * bh * la * la * 64, 0, 4 * head),
        "flash_attention_bwd": bound(10 * bh * la * la * 64, 0, 7 * head),
        # K13 and K14 compute K12's and K11's functions (no biases to speak of)
        "probe_mlp_int8": bound(0, rows * 16 * d * d, 2 * act + 8 * d * d),
        "probe_attn_int8": bound(rows * 4 * l * d, rows * 8 * d * d, 2 * act + 4 * d * d),
        "sdpa_chain_bf16": bound(chain_ops, 0, chain_bytes),
        "sdpa_chain_int8": bound(0, chain_ops, chain_bytes),
    }


def set_attn_impl(model, impl: str, mlp_impl: str = "auto") -> None:
    for blk in model.blocks():
        blk.attn_impl, blk.mlp_impl = impl, mlp_impl


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


def check_training(device) -> None:
    """Phase 3, training: the gradients of every parameter of the depth-13
    CIFAR-10 model at batch 8, fused (K1/K2 forward, K6/K7 backward)
    against plain (autograd through the plain sublayers), on the same
    weights, batch and draws; then OPT_STEPS AdamW steps both ways."""
    from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
    from duodiff_tpu_torch.training.train_state import TrainState, make_optimizer, make_train_step
    from duodiff_tpu_torch.utils.model_loading import load_model

    schedule = NoiseSchedule.create(device=device)
    models, steps, states = {}, {}, {}
    for impl in ("fused", "plain"):
        model, cfg = load_model(TRAIN_CONFIG, device=device, seed=0, attn_impl=impl)
        models[impl] = model.train()
        steps[impl] = make_train_step(model, schedule, parametrization="predict_noise", seed=0)
        states[impl] = TrainState.create(model, make_optimizer(
            dict(model.named_parameters()), lr=2e-4, weight_decay=0.03, beta1=0.99,
            beta2=0.999, max_grad_norm=1.0, num_warmup_steps=0, num_training_steps=100))
    g = torch.Generator().manual_seed(2)
    shape = (CHECK_BATCH, cfg.img_size, cfg.img_size, cfg.in_chans)
    batch = {"image": (torch.rand(shape, generator=g) * 2 - 1).to(device)}
    names = [n for n, _ in models["plain"].named_parameters()]
    draws = steps["plain"].draws(batch, 1)
    grads = {impl: steps[impl].backward(batch, *draws)[1] for impl in models}
    rels = {n: rel_fro(a, b) for n, a, b in zip(names, grads["fused"], grads["plain"])}
    worst = max(rels, key=rels.get)
    ok = rels[worst] <= BWD_REL_FRO
    print(f"phase 3: depth-{cfg.depth} training gradients B={CHECK_BATCH} fused vs plain, "
          f"{len(names)} parameters: worst rel_fro_err={rels[worst]:.6g} ({worst}), "
          f"median {statistics.median(rels.values()):.6g} (bound {BWD_REL_FRO}) ok={ok}",
          flush=True)
    if not ok:
        fail("the fused training gradients disagree with the plain ones")

    init = [p.detach().clone() for p in models["plain"].parameters()]
    losses = {impl: [] for impl in models}
    for s in range(1, OPT_STEPS + 1):
        draws = steps["plain"].draws(batch, s)
        for impl in models:
            losses[impl].append(steps[impl](states[impl], batch, s, *draws)["train_loss"].item())
    loss_rel = max(abs(a / b - 1) for a, b in zip(losses["fused"], losses["plain"]))
    upd = {n: rel_fro(pf.detach() - p0, pp.detach() - p0) for n, pf, pp, p0 in
           zip(names, models["fused"].parameters(), models["plain"].parameters(), init)}
    worst = max(upd, key=upd.get)
    ok = loss_rel <= STEP_LOSS_REL and upd[worst] <= UPDATE_REL_FRO
    print(f"phase 3: {OPT_STEPS} AdamW steps fused vs plain: losses "
          f"{[round(v, 6) for v in losses['fused']]} vs {[round(v, 6) for v in losses['plain']]} "
          f"max rel {loss_rel:.6g} (bound {STEP_LOSS_REL}); parameter updates worst rel_fro_err "
          f"{upd[worst]:.6g} ({worst}), median {statistics.median(upd.values()):.6g} "
          f"(bound {UPDATE_REL_FRO}) ok={ok}", flush=True)
    if not ok:
        fail("fused training steps disagree with plain ones")


def reset_counts() -> None:
    from duodiff_tpu_torch.ops import block, block_int8, flash_attention, sdpa_int8

    flash_attention.flash_attention.launches = 0
    flash_attention.flash_attention_bwd.launches = 0
    block.fused_attn_sublayer.launches = 0
    block.fused_mlp_sublayer.launches = 0
    block.fused_attn_sublayer_bwd.launches = 0
    block.fused_mlp_sublayer_bwd.launches = 0
    block.fused_attn_sublayer.launches_v1 = 0
    block.fused_block.launches = 0
    block.fused_mlp_sublayer_bwd_split.launches = 0
    block_int8.reset_launch_counts()
    sdpa_int8.reset_launch_counts()


def read_counts() -> dict:
    from duodiff_tpu_torch.ops import block, block_int8, flash_attention, sdpa_int8

    k12 = block_int8.fused_mlp_sublayer_int8
    return {
        "flash_attention": flash_attention.flash_attention.launches,
        "flash_attention_bwd": flash_attention.flash_attention_bwd.launches,
        "fused_attn_sublayer": block.fused_attn_sublayer.launches,
        "fused_mlp_sublayer": block.fused_mlp_sublayer.launches,
        "fused_attn_sublayer_bwd": block.fused_attn_sublayer_bwd.launches,
        "fused_mlp_sublayer_bwd": block.fused_mlp_sublayer_bwd.launches,
        "fused_attn_sublayer_v1": block.fused_attn_sublayer.launches_v1,
        "fused_block": block.fused_block.launches,
        "fused_mlp_sublayer_bwd_split": block.fused_mlp_sublayer_bwd_split.launches,
        "fused_attn_sublayer_int8": block_int8.fused_attn_sublayer_int8.launches,
        "fused_mlp_sublayer_int8": k12.launches,
        "fused_mlp_sublayer_int8 dynamic": k12.launches_dynamic,
        "fused_mlp_sublayer_int8 static": k12.launches_static,
        "fused_attn_sublayer_int8 static": block_int8.fused_attn_sublayer_int8.launches_static,
        "sdpa_chain_bf16": sdpa_int8.sdpa_chain_bf16.launches,
        "sdpa_chain_int8": sdpa_int8.sdpa_chain_int8.launches,
    }


def run_cli(label: str, extra: list, card: str, expected: dict,
            configs=(EARLY_CONFIG, LATE_CONFIG), batch: int = MAIN_BATCH,
            check_output=None) -> dict:
    """One 1000-step DuoDiff run of the sampling CLI, in-process, with every
    launch counter set to 0 just before and read just after; checks the
    samples and that the counts equal ``expected`` (unlisted kernels: 0).
    ``check_output(folder, result)`` looks at the files before they go."""
    from duodiff_tpu_torch import sample

    with tempfile.TemporaryDirectory() as out:
        argv = [
            "--config_path", configs[0], "--config_path_late", configs[1],
            "--t_switch", str(T_SWITCH), "--random_init",
            "--num_timesteps", str(STEPS), "--batch_size", str(batch),
            "--parametrization", "predict_noise", "--device", "cuda",
            "--output_folder", out, "--seed", "0", *extra,
        ]
        reset_counts()
        tic = time.perf_counter()
        result = sample.main(argv)
        wall = time.perf_counter() - tic
        launches = read_counts()
        saved = np.load(f"{out}/samples.npy")
        if check_output is not None:
            check_output(Path(out), result)
    samples = result["samples"]
    print(f"{label} batch {batch}: sampling {result['seconds']:.6g} s, "
          f"{batch / result['seconds']:.6g} samples/s, CLI wall {wall:.6g} s, "
          f"launches {launches} (expected {expected}), card {card}", flush=True)
    shape = (batch, 64, 64, 3)
    if samples.shape != shape or saved.shape != shape or saved.dtype != np.uint8:
        fail(f"samples have shape {samples.shape} / {saved.shape} {saved.dtype}, "
             f"expected {shape} uint8")
    if not np.isfinite(samples).all():
        fail("samples are not finite")
    check_counts(launches, expected)
    return launches


def release_memory() -> float:
    """Drop what earlier phases left behind (a trainer's closures keep its
    model and optimizer alive until the cycle collector runs), return the
    freed blocks to the device and start a new peak reading. Returns the
    GiB still allocated, the floor of that reading."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated() / 2**30


def check_counts(launches: dict, expected: dict) -> None:
    """Every counter equals ``expected`` (unlisted kernels: 0)."""
    for name, n in launches.items():
        if n != expected.get(name, 0):
            fail(f"{name} launched {n} times on the path, expected {expected.get(name, 0)}")


def png_header(path: Path) -> tuple:
    """(width, height, bit depth, colour type) of a PNG file; fails on a file
    without the PNG signature or whose first chunk is not IHDR."""
    head = path.read_bytes()[:33]
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        fail(f"{path.name} is not a PNG file")
    return struct.unpack(">IIBB", head[16:26])


def check_sample_files(folder: Path, result: dict) -> None:
    """Phase 4's files: every sample as {i}.png, the state after T_SWITCH
    reverse steps (the handoff) as {i}_{T_SWITCH}.png, the grid, all 8-bit RGB
    of the right size; --timesteps_save STEPS is the end, so its state must
    equal the samples."""
    grid = int(np.ceil(np.sqrt(MAIN_BATCH))) * 64
    names = {f"{i}.png": 64 for i in range(MAIN_BATCH)}
    names.update({f"{i}_{T_SWITCH}.png": 64 for i in range(MAIN_BATCH)})
    names["grid_image.png"] = grid
    for name, size in names.items():
        if not (folder / name).exists():
            fail(f"the sampling CLI did not write {name}")
        if png_header(folder / name) != (size, size, 8, 2):
            fail(f"{name} has header {png_header(folder / name)}, expected {size}x{size} 8-bit RGB")
    inter = result["intermediates"]
    if sorted(inter) != [T_SWITCH, STEPS] or not np.array_equal(inter[STEPS], result["samples"]):
        fail("--timesteps_save did not keep the handoff state and the final state")
    if inter[T_SWITCH].shape != result["samples"].shape or not np.isfinite(inter[T_SWITCH]).all():
        fail("the state kept at the handoff is not a finite batch of images")
    print(f"phase 4: {len(names)} PNG files written ({MAIN_BATCH} samples, {MAIN_BATCH} "
          f"states at the handoff, a {grid}x{grid} grid), 8-bit RGB; the state kept after "
          f"{STEPS} steps equals the samples", flush=True)


def run_main_path(card: str) -> dict:
    """Phase 4: the bf16 DuoDiff run of the sampling CLI, which also saves
    the state at the handoff and at the end and writes PNG files; returns
    the launch counts."""
    expected = T_SWITCH * 3 + (STEPS - T_SWITCH) * 13
    return run_cli(
        f"phase 4: DuoDiff {STEPS} steps (depth 3 x {T_SWITCH}, depth 13 x "
        f"{STEPS - T_SWITCH}), bf16",
        ["--timesteps_save", str(T_SWITCH), str(STEPS)], card,
        {"fused_attn_sublayer": expected, "fused_mlp_sublayer": expected},
        check_output=check_sample_files,
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


def train_argv(work: str, exp: str, n_steps: int, *extra, config: str = TRAIN_CONFIG,
               dataset: str = "cifar10") -> list:
    return ["--config_path", config, "--dataset", dataset, "--data_path", f"{work}/data",
            "--log_path", f"{work}/logs", "--exp_name", exp, "--n_steps", str(n_steps),
            "--batch_size", str(TRAIN_BATCH), "--use_amp", "--num_warmup_steps",
            str(WARMUP_STEPS), "--device", "cuda", "--seed", "0", *extra]


def run_train_cli(label: str, argv: list, card: str, expected: dict):
    """One in-process run of the training CLI with every launch counter set
    to 0 just before and read just after; checks finite losses and the
    counts. Returns (trainer, launches)."""
    from duodiff_tpu_torch import train

    reset_counts()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    trainer = train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    launches = read_counts()
    logs = trainer.logs
    steps = logs[-1]["step"] - trainer.start_step
    steady = (f"{logs[-1]['steps_per_sec']:.6g} steps/s over steps {logs[-2]['step'] + 1}-"
              f"{logs[-1]['step']}, " if len(logs) > 1 else "")
    print(f"{label}: {steps} steps at batch {TRAIN_BATCH}, losses "
          f"{[(log['step'], round(log['train_loss'], 6)) for log in logs]}, {steady}"
          f"CLI wall {wall:.6g} s ({steps / wall:.6g} steps/s, set-up included), "
          f"launches {launches} (expected {expected}), card {card}", flush=True)
    if not all(np.isfinite(log["train_loss"]) and np.isfinite(log["grad_norm"]) for log in logs):
        fail(f"{label}: non-finite loss or gradient norm")
    check_counts(launches, expected)
    return trainer, launches


def run_train_path(device, card: str) -> dict:
    """Phase 5: the training CLI on configs/uvit_cifar10.yaml at batch 128,
    bf16, on synthetic palette data; then the checkpoint in the sampling
    CLI's load_model, a --resume run, and a profile of one step. Returns
    the main run's launch counts."""
    from duodiff_tpu_torch.data.sampler import ResumableSeedableSampler
    from duodiff_tpu_torch.data.synthetic import write_palette_cifar
    from duodiff_tpu_torch.training.checkpointer import CHECKPOINT_FILE, Checkpointer
    from duodiff_tpu_torch.utils.model_loading import load_model

    per_step = 13 * TRAIN_STEPS
    with tempfile.TemporaryDirectory() as work:
        write_palette_cifar(Path(work) / "data", seed=0)
        trainer, launches = run_train_cli(
            f"phase 5: train {TRAIN_CONFIG.rsplit('/', 1)[-1]}", train_argv(work, "main", TRAIN_STEPS),
            card, {k: per_step for k in ("fused_attn_sublayer", "fused_mlp_sublayer",
                                         "fused_attn_sublayer_bwd", "fused_mlp_sublayer_bwd")})
        first, last = trainer.logs[0]["train_loss"], trainer.logs[-1]["train_loss"]
        if not last < LOSS_DROP * first:
            fail(f"the train loss did not fall clearly: {first:.6g} -> {last:.6g}")

        ckpt = trainer.log_path / "cifar10_uvit_last"
        saved = Checkpointer.restore(ckpt)
        model, cfg = load_model(TRAIN_CONFIG, str(ckpt / CHECKPOINT_FILE), device=device,
                                attn_impl="fused")
        for m in (model, trainer.model):
            m.pack_for_kernels()
            m.eval()
        g = torch.Generator().manual_seed(3)
        x = torch.randn((CHECK_BATCH, cfg.img_size, cfg.img_size, cfg.in_chans), generator=g)
        t = torch.linspace(0, 999, CHECK_BATCH)
        with torch.inference_mode():
            same = torch.equal(model(x.to(device), t.to(device)),
                               trainer.model(x.to(device), t.to(device)))
        print(f"phase 5: checkpoint step {saved['step']} loaded strictly by the sampling CLI's "
              f"load_model; its forward equals the trainer's: {same}", flush=True)
        if not same or saved["step"] != TRAIN_STEPS:
            fail("the checkpoint does not reproduce the trained model")
        del trainer, model

        per_step = 13 * RESUME_STEPS
        resumed, _ = run_train_cli(
            "phase 5: --resume", train_argv(work, "main", TRAIN_STEPS + RESUME_STEPS, "--resume"),
            card, {k: per_step for k in ("fused_attn_sublayer", "fused_mlp_sublayer",
                                         "fused_attn_sublayer_bwd", "fused_mlp_sublayer_bwd")})
        sampler = ResumableSeedableSampler(len(saved["sampler_state"]["perm"]), seed=0)
        sampler.set_state(saved["sampler_state"])
        sampler.next_indices(TRAIN_BATCH * RESUME_STEPS)
        want, got = sampler.get_state(), resumed.dataloader.get_state()
        ok = (resumed.start_step == TRAIN_STEPS and resumed.logs[0]["step"] == TRAIN_STEPS + 1
              and np.array_equal(want["perm"], got["perm"])
              and (want["perm_index"], want["epoch"]) == (got["perm_index"], got["epoch"]))
        print(f"phase 5: resumed at step {resumed.start_step}, sampler at epoch {got['epoch']} "
              f"index {got['perm_index']} after {RESUME_STEPS} more steps, as the saved state "
              f"implies: {ok}", flush=True)
        if not ok:
            fail("--resume did not continue from the saved step and sampler state")
        profile_train_step(resumed, card, "phase 5")
    return launches


# device-kernel families of a profile, by what their names contain (first
# match wins); everything else counts as "other"
KERNEL_FAMILIES = (
    ("own kernels", ("duodiff::",)),
    ("cuBLAS matrix products", ("nvjet", "cublas", "cutlass", "gemm", "gemv", "xmma")),
    ("PyTorch elementwise", ("elementwise", "CatArrayBatchedCopy", "fill", "copy")),
    ("PyTorch reductions", ("reduce", "softmax", "norm")),
    ("copies and memsets", ("Memcpy", "Memset")),
)


def kernel_family(name: str) -> str:
    for family, marks in KERNEL_FAMILIES:
        if any(m in name for m in marks):
            return family
    return "other"


def profile_steps(label: str, one_step, n: int = 3) -> None:
    """torch.profiler over ``n`` calls of ``one_step``: device busy time, idle
    share, the share of every kernel family (all device events, summing to
    1) and the largest kernels by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        for _ in range(n):
            one_step()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - tic) * 1e6
    kernels = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(kernels.values())
    if not busy:
        print(f"{label}: the profiler recorded no device time (idle share not measured)",
              flush=True)
        return
    families = {}
    for name, us in kernels.items():
        families[kernel_family(name)] = families.get(kernel_family(name), 0.0) + us

    def by_size(d):
        return sorted(d.items(), key=lambda kv: -kv[1])

    others = [k[:60] for k, _ in by_size(kernels) if kernel_family(k) == "other"][:3]
    print(f"{label}: profiler over {n} steps: device busy {busy / 1e3:.6g} ms of "
          f"{window_us / 1e3:.6g} ms, idle share {1 - busy / window_us:.6g}; families: "
          + "; ".join(f"{k} {v / busy:.4f}" for k, v in by_size(families))
          + (f" (other: {', '.join(others)})" if others else "")
          + "; largest kernels: "
          + "; ".join(f"{k[:60]} {v / busy:.4f}" for k, v in by_size(kernels)[:10]), flush=True)


def profile_train_step(trainer, card: str, phase: str) -> None:
    """One training step of the trainer's model split into forward, backward
    and optimizer with CUDA events (medians of 5), then :func:`profile_steps`
    over 3 steps."""
    step_fn, state, model = trainer._train_step, trainer.state, trainer.model
    model.train()
    params = list(model.parameters())
    batch = trainer._to_device(trainer.dataloader.next_batch())
    trainer.dataloader.close()
    draws = (*step_fn.draws(batch, 1), step_fn.drop_mask(batch, 1))

    def one_step():
        events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        for p in params:
            p.grad = None
        events[0].record()
        loss, _ = step_fn.loss_fn(batch, *draws)
        events[1].record()
        loss.backward()
        events[2].record()
        state.optimizer.step([p.grad for p in params])
        state.update_ema()
        events[3].record()
        return events

    for _ in range(2):
        one_step()
    phases = {"forward": [], "backward": [], "optimizer": [], "step": []}
    for _ in range(5):
        ev = one_step()
        ev[3].synchronize()
        for i, name in enumerate(("forward", "backward", "optimizer")):
            phases[name].append(ev[i].elapsed_time(ev[i + 1]))
        phases["step"].append(ev[0].elapsed_time(ev[3]))
    ms = {k: statistics.median(v) for k, v in phases.items()}
    print(f"{phase}: one train step at batch {TRAIN_BATCH} (CUDA events, median of 5): "
          f"forward {ms['forward']:.6g} ms, backward {ms['backward']:.6g} ms, optimizer + EMA "
          f"{ms['optimizer']:.6g} ms, step {ms['step']:.6g} ms; card {card}", flush=True)
    profile_steps(phase, one_step)


def run_distill_path(card: str) -> None:
    """Phase 5b: DuoDiff distillation through the training CLI: a depth-3
    student from a random depth-13 teacher; the teacher runs K1/K2 forward
    only, the student K1/K2 and K6/K7."""
    from duodiff_tpu_torch.data.synthetic import write_palette_cifar

    with tempfile.TemporaryDirectory() as work:
        write_palette_cifar(Path(work) / "data", seed=0)
        fwd, bwd = (13 + 3) * DISTILL_STEPS, 3 * DISTILL_STEPS
        trainer, _ = run_train_cli(
            "phase 5b: distil depth 3 from depth 13",
            train_argv(work, "distill", DISTILL_STEPS, "--config_path", STUDENT_CONFIG,
                       "--distill_config", TRAIN_CONFIG),
            card, {"fused_attn_sublayer": fwd, "fused_mlp_sublayer": fwd,
                   "fused_attn_sublayer_bwd": bwd, "fused_mlp_sublayer_bwd": bwd})
        last = trainer.logs[-1]
        if not {"distill_loss", "task_loss"} <= set(last) or not np.isfinite(last["distill_loss"]):
            fail("the distillation run reported no finite distillation loss")


# (attn_impl, mlp_impl) of the unfused block's variants checked in phase 3,
# each against ("pallas_plain", "auto"), the plain versions throughout
UNFUSED_VARIANTS = {"pallas": ("pallas", "auto"), "pallas + fused MLP": ("pallas", "fused")}
UNFUSED_PLAIN = ("pallas_plain", "auto")


def check_imagenet_model(device) -> None:
    """Phase 3, ImageNet-64: the depth-17 class-conditional forward with the
    attention kernel (attn_impl "pallas"), alone and paired with the fused
    MLP sublayer (mlp_impl "fused": K2, and K7 in training), against the
    plain versions ("pallas_plain" and the plain MLP) on the same weights
    and labels; the gradients of every parameter the same ways; and a short
    guided DuoDiff trajectory (depth 3 -> depth 17, full width) with and
    without the attention kernel from one noise table."""
    from duodiff_tpu_torch.diffusion.sampling import duodiff_sample, make_guided_apply
    from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
    from duodiff_tpu_torch.training.train_state import make_train_step
    from duodiff_tpu_torch.utils.model_loading import load_model

    late, cfg = load_model(IMAGENET_CONFIG, device=device, seed=1, attn_impl="pallas")
    early, _ = load_model(IMAGENET_EARLY_CONFIG, device=device, seed=0, attn_impl="pallas")
    late.pack_for_kernels()  # the fused MLP sublayer reads packed operands in eval
    g = torch.Generator().manual_seed(4)
    shape = (CHECK_BATCH, cfg.img_size, cfg.img_size, cfg.in_chans)
    x = torch.randn(shape, generator=g).to(device)
    y = torch.randint(0, cfg.num_classes - 1, (CHECK_BATCH,), generator=g).to(device)
    t = torch.tensor([999.0, 700.0, 500.0, 300.0, 100.0, 10.0, 1.0, 0.0],
                     device=device)[:CHECK_BATCH]

    def forward(impls):
        set_attn_impl(late, *impls)
        with torch.inference_mode():
            return late.eval()(x, t, y)

    want = forward(UNFUSED_PLAIN)
    for name, impls in UNFUSED_VARIANTS.items():
        max_abs, limit, rel, ok = scaled_errors(forward(impls), want, MODEL_MAX_FRAC,
                                                MODEL_REL_FRO)
        print(f"phase 3: depth-{cfg.depth} class-conditional forward (D={cfg.embed_dim}, "
              f"L={cfg.extras + cfg.num_patches}) B={CHECK_BATCH} {name} vs pallas_plain: "
              f"rel_fro_err={rel:.6g} (bound {MODEL_REL_FRO}) max_abs_err={max_abs:.6g} (bound "
              f"{limit:.6g} = {MODEL_MAX_FRAC}*max|plain|) ok={ok}", flush=True)
        if not ok:
            fail(f"the ImageNet-64 forward through {name} disagrees with the plain one")

    schedule = NoiseSchedule.create(device=device)
    step = make_train_step(late, schedule, parametrization="predict_noise", seed=0,
                           has_labels=True)
    batch = {"image": (torch.rand(shape, generator=g) * 2 - 1).to(device), "label": y}
    draws = step.draws(batch, 1)

    def gradients(impls):
        set_attn_impl(late, *impls)
        return [t.clone() for t in step.backward(batch, *draws)[1]]

    names = [n for n, _ in late.named_parameters()]
    want = gradients(UNFUSED_PLAIN)
    for name, impls in UNFUSED_VARIANTS.items():
        rels = {n: rel_fro(a, b) for n, a, b in zip(names, gradients(impls), want)}
        worst = max(rels, key=rels.get)
        ok = rels[worst] <= BWD_REL_FRO
        print(f"phase 3: depth-{cfg.depth} ImageNet-64 training gradients B={CHECK_BATCH} {name} "
              f"vs pallas_plain, {len(names)} parameters: worst rel_fro_err={rels[worst]:.6g} "
              f"({worst}), median {statistics.median(rels.values()):.6g} (bound {BWD_REL_FRO}) "
              f"ok={ok}", flush=True)
        if not ok:
            fail(f"the gradients through {name} disagree with the plain ones")
    for p in late.parameters():
        p.grad = None

    steps, t_switch = 20, 6
    schedule = NoiseSchedule.create(steps=steps, device=device)
    small = (2,) + shape[1:]
    noise = torch.randn((steps,) + small, generator=g).to(device)
    x0 = torch.randn(small, generator=g).to(device)
    null = cfg.num_classes - 1
    outs = {}
    with torch.inference_mode():
        for impl in ("pallas", "pallas_plain"):
            set_attn_impl(early, impl)
            set_attn_impl(late, impl)
            outs[impl] = duodiff_sample(
                make_guided_apply(early.eval(), GUIDANCE_SCALE, null),
                make_guided_apply(late.eval(), GUIDANCE_SCALE, null), None, schedule=schedule,
                shape=small, t_switch=t_switch, y=y[:2], x_init=x0, noise_table=noise,
            )
    max_abs, limit, rel, ok = scaled_errors(outs["pallas"], outs["pallas_plain"], MODEL_MAX_FRAC)
    print(f"phase 3: {steps}-step guided DuoDiff trajectory (depth 3 -> {cfg.depth}, t_switch "
          f"{t_switch}, w={GUIDANCE_SCALE}) B=2 pallas vs pallas_plain: rel_fro_err={rel:.6g} "
          f"(bound {FWD_REL_FRO}) max_abs_err={max_abs:.6g} (bound {limit:.6g} = "
          f"{MODEL_MAX_FRAC}*max|plain|) ok={ok}", flush=True)
    if not ok:
        fail("the guided DuoDiff trajectory through the attention kernel disagrees with the "
             "plain one")


def run_imagenet_sampling(device, card: str) -> dict:
    """Phase 6: the sampling CLI on the ImageNet-64 pair (depth 3 for 300
    steps, then depth 17), class-conditional with classifier-free guidance
    on random real classes, the unfused block around K9; every guided
    forward runs at batch 2 * GUIDED_BATCH. Then one guided depth-17 step
    alone, timed and profiled by kernel."""
    from duodiff_tpu_torch.diffusion.sampling import make_guided_apply
    from duodiff_tpu_torch.utils.model_loading import load_model

    expected = T_SWITCH * 3 + (STEPS - T_SWITCH) * 17
    launches = run_cli(
        f"phase 6: guided DuoDiff {STEPS} steps on ImageNet-64 (depth 3 x {T_SWITCH}, depth 17 x "
        f"{STEPS - T_SWITCH}), attn_impl pallas, w={GUIDANCE_SCALE}, forwards at batch "
        f"{2 * GUIDED_BATCH},",
        ["--attn_impl", "pallas", "--class_id", "-1", "--guidance_scale", str(GUIDANCE_SCALE)],
        card, {"flash_attention": expected}, configs=(IMAGENET_EARLY_CONFIG, IMAGENET_CONFIG),
        batch=GUIDED_BATCH,
    )
    model, cfg = load_model(IMAGENET_CONFIG, device=device, seed=1, attn_impl="pallas")
    apply = make_guided_apply(model.eval(), GUIDANCE_SCALE, cfg.num_classes - 1)
    g = torch.Generator().manual_seed(5)
    x = torch.randn((GUIDED_BATCH, cfg.img_size, cfg.img_size, cfg.in_chans), generator=g)
    y = torch.randint(0, cfg.num_classes - 1, (GUIDED_BATCH,), generator=g)
    x, y = x.to(device), y.to(device)
    t = torch.full((GUIDED_BATCH,), 350.0, device=device)
    with torch.inference_mode():
        ms = time_ms({"step": lambda: apply(x, t, y)}, reps=5)["step"]
        print(f"phase 6: one guided depth-{cfg.depth} forward at batch {2 * GUIDED_BATCH} "
              f"(CUDA events, median of 5): {ms:.6g} ms; card {card}", flush=True)
        profile_steps("phase 6", lambda: apply(x, t, y))
    return launches


def run_imagenet_training(card: str) -> tuple:
    """Phase 7: the training CLI on configs/uvit_imagenet64.yaml (D = 768,
    depth 17, L = 258) at batch 128 in bf16 on the synthetic ImageNet-64
    cache, with label dropout: first the unfused block around K9 and K10
    (losses must fall, 17 launches of each a step, a step's split and
    profile, peak device memory), then a short run of the fused block
    (K1, K2, K6, K7) at this width. Returns the first run's launch counts
    and the fused leg's peak device memory."""
    from duodiff_tpu_torch.data.synthetic import write_palette_imagenet64_cache

    def argv(work, exp, n_steps, impl):
        return train_argv(work, exp, n_steps, "--attn_impl", impl, "--label_dropout",
                          str(LABEL_DROPOUT), config=IMAGENET_CONFIG, dataset="imagenet64")

    with tempfile.TemporaryDirectory() as work:
        write_palette_imagenet64_cache(Path(work) / "data", seed=0)
        floor = release_memory()
        n = 17 * IMAGENET_TRAIN_STEPS
        trainer, launches = run_train_cli(
            "phase 7: train uvit_imagenet64.yaml, attn_impl pallas",
            argv(work, "pallas", IMAGENET_TRAIN_STEPS, "pallas"), card,
            {"flash_attention": n, "flash_attention_bwd": n})
        peak = torch.cuda.max_memory_allocated()
        first, last = trainer.logs[0]["train_loss"], trainer.logs[-1]["train_loss"]
        print(f"phase 7: peak device memory {peak / 2**30:.6g} GiB ({floor:.6g} GiB held before "
              f"the run); loss {first:.6g} -> {last:.6g}", flush=True)
        if not last < LOSS_DROP * first:
            fail(f"the ImageNet-64 train loss did not fall clearly: {first:.6g} -> {last:.6g}")
        profile_train_step(trainer, card, "phase 7 (pallas)")
        del trainer
        floor = release_memory()
        n = 17 * IMAGENET_FUSED_STEPS
        trainer, _ = run_train_cli(
            "phase 7: train uvit_imagenet64.yaml, attn_impl fused",
            argv(work, "fused", IMAGENET_FUSED_STEPS, "fused"), card,
            {k: n for k in ("fused_attn_sublayer", "fused_mlp_sublayer",
                            "fused_attn_sublayer_bwd", "fused_mlp_sublayer_bwd")})
        fused_peak = torch.cuda.max_memory_allocated()
        print(f"phase 7: peak device memory of the fused leg (K7) {fused_peak / 2**30:.6g} GiB "
              f"({floor:.6g} GiB held before the run)", flush=True)
        profile_train_step(trainer, card, "phase 7 (fused)")
        del trainer
        torch.cuda.empty_cache()
    return launches, fused_peak


class split_backward:
    """DUODIFF_MLP_BWD_SPLIT=1 inside the block (the MLP sublayer's backward
    is then K8), the variable as it was afterwards."""

    def __enter__(self):
        self.before = os.environ.get("DUODIFF_MLP_BWD_SPLIT")
        os.environ["DUODIFF_MLP_BWD_SPLIT"] = "1"

    def __exit__(self, *exc):
        if self.before is None:
            del os.environ["DUODIFF_MLP_BWD_SPLIT"]
        else:
            os.environ["DUODIFF_MLP_BWD_SPLIT"] = self.before


def block_parameters(blk) -> tuple:
    """A block's 12 parameters in FusedBlockFn's order."""
    qkv, proj, fc1, fc2 = blk.attn["qkv"], blk.attn["proj"], blk.mlp["fc1"], blk.mlp["fc2"]
    return (blk.norm1.weight, blk.norm1.bias, qkv.weight, qkv.bias, proj.weight, proj.bias,
            blk.norm2.weight, blk.norm2.bias, fc1.weight, fc1.bias, fc2.weight, fc2.bias)


def check_block_stack(device) -> dict:
    """Phase 3, the op-API paths of K5 and K1-v1 at D = 768: the 17 blocks of
    the ImageNet-64 model (their own parameters, no long skips) as a stack on
    random tokens at batch 8. FusedBlockFn (K5 forward; K1, the MLP backward
    and K6 in the backward) against autograd through block_plain: the output
    within MODEL_REL_FRO and the gradients of the input and of every
    parameter within STACK_GRAD_REL_FRO over the whole stack, and within
    BWD_REL_FRO block by block on the plain stack's inputs and upstream
    gradients. Then the forward of K1-v1 followed by K2 per block
    against their plain versions. Launch counts are set to 0 before each
    stack and checked after; returns those of K5 and K1-v1."""
    from duodiff_tpu_torch.ops import block
    from duodiff_tpu_torch.utils.model_loading import load_model

    model, cfg = load_model(IMAGENET_CONFIG, device=device, seed=1, attn_impl="fused")
    blocks = model.blocks()
    heads, bf = cfg.num_heads, torch.bfloat16
    g = torch.Generator().manual_seed(6)
    tokens = cfg.extras + cfg.num_patches
    x0 = torch.randn((CHECK_BATCH, tokens, cfg.embed_dim), generator=g).to(bf).to(device)
    dy = torch.randn(x0.shape, generator=g).to(bf).to(device)
    params = [t for blk in blocks for t in block_parameters(blk) if t is not None]

    def fused(x, blk):
        return block.FusedBlockFn.apply(x, *block_parameters(blk), heads, False, 1e-5)

    def plain(x, blk):
        p = block_parameters(blk)
        return block.block_plain(x, *block.attn_operands(*p[:6], num_heads=heads, dtype=bf),
                                 *block.mlp_operands(*p[6:], dtype=bf), num_heads=heads)

    def run(step):
        x = x0.clone().requires_grad_(True)
        y = x
        for blk in blocks:
            y = step(y, blk)
        grads = torch.autograd.grad(y, [x, *params], dy)
        return y.detach(), [t.float() for t in grads]

    reset_counts()
    y_fused, g_fused = run(fused)
    torch.cuda.synchronize()
    launches = read_counts()
    y_plain, g_plain = run(plain)
    n = len(blocks)
    check_counts(launches, {"fused_block": n, "fused_attn_sublayer": n,
                            "fused_attn_sublayer_bwd": n, "fused_mlp_sublayer_bwd": n})
    max_abs, limit, rel, ok = scaled_errors(y_fused, y_plain, MODEL_MAX_FRAC, MODEL_REL_FRO)
    rels = [rel_fro(a, b) for a, b in zip(g_fused, g_plain)]
    ok = ok and max(rels) <= STACK_GRAD_REL_FRO
    print(f"phase 3: FusedBlockFn on a stack of the depth-{n} model's blocks (D={cfg.embed_dim}, "
          f"L={tokens}) B={CHECK_BATCH} vs block_plain: output rel_fro_err={rel:.6g} (bound "
          f"{MODEL_REL_FRO}) max_abs_err={max_abs:.6g} (bound {limit:.6g}); gradients of the "
          f"input and {len(params)} parameters: worst rel_fro_err={max(rels):.6g}, median "
          f"{statistics.median(rels):.6g} (bound {STACK_GRAD_REL_FRO}); launches K5 "
          f"{launches['fused_block']}, K1 {launches['fused_attn_sublayer']}, K6 "
          f"{launches['fused_attn_sublayer_bwd']}, K7 {launches['fused_mlp_sublayer_bwd']} "
          f"ok={ok}", flush=True)
    if not ok:
        fail("FusedBlockFn disagrees with the plain block")

    # block by block: each on the plain stack's input, from the last block
    # back, each with the plain stack's upstream gradient
    inputs = []
    with torch.no_grad():
        y = x0
        for blk in blocks:
            inputs.append(y)
            y = plain(y, blk)
    upstream, worst = dy, (0.0, "")
    for i in reversed(range(n)):
        blk = blocks[i]
        own = [t for t in block_parameters(blk) if t is not None]
        grads = {}
        for name, step in (("fused", fused), ("plain", plain)):
            x = inputs[i].clone().requires_grad_(True)
            grads[name] = torch.autograd.grad(step(x, blk), [x, *own], upstream)
        rel = max(rel_fro(a, b) for a, b in zip(grads["fused"], grads["plain"]))
        worst = max(worst, (rel, f"block {i}"))
        upstream = grads["plain"][0]
    ok = worst[0] <= BWD_REL_FRO
    print(f"phase 3: FusedBlockFn block by block on the plain stack's inputs and upstream "
          f"gradients: worst rel_fro_err over the input's and the 11 parameters' gradients "
          f"{worst[0]:.6g} ({worst[1]}) (bound {BWD_REL_FRO}) ok={ok}", flush=True)
    if not ok:
        fail("FusedBlockFn's gradients disagree with the plain block's")

    packed = [(to_device(block.pack_attn_v1(b.norm1, b.attn["qkv"], b.attn["proj"], dtype=bf),
                         device),
               to_device(block.pack_mlp(b.norm2, b.mlp["fc1"], b.mlp["fc2"], dtype=bf), device))
              for b in blocks]
    outs = {}
    reset_counts()
    with torch.inference_mode():
        for name, attn, mlp in (
                ("kernels", lambda x, a: block.fused_attn_sublayer(x, *a, num_heads=heads,
                                                                    variant="v1"),
                 block.fused_mlp_sublayer),
                ("plain", lambda x, a: block.attn_sublayer_v1_plain(x, *a, num_heads=heads),
                 block.mlp_sublayer_plain)):
            y = x0
            for v1, mlp_ops in packed:
                y = mlp(attn(y, v1), *mlp_ops)
            outs[name] = y
    torch.cuda.synchronize()
    v1_launches = read_counts()
    check_counts(v1_launches, {"fused_attn_sublayer_v1": n, "fused_mlp_sublayer": n})
    max_abs, limit, rel, ok = scaled_errors(outs["kernels"], outs["plain"], MODEL_MAX_FRAC,
                                            MODEL_REL_FRO)
    print(f"phase 3: K1-v1 then K2 through the same {n} blocks B={CHECK_BATCH} vs their plain "
          f"versions: rel_fro_err={rel:.6g} (bound {MODEL_REL_FRO}) max_abs_err={max_abs:.6g} "
          f"(bound {limit:.6g}); launches K1-v1 {v1_launches['fused_attn_sublayer_v1']} ok={ok}",
          flush=True)
    if not ok:
        fail("the stack through K1-v1 disagrees with its plain version")
    return {"fused_block": launches["fused_block"],
            "fused_attn_sublayer_v1": v1_launches["fused_attn_sublayer_v1"]}


def check_split_training(device) -> None:
    """Phase 3, K8 in the model: the gradients of every parameter of the
    depth-17 ImageNet-64 model at batch 8 through the fused block with
    DUODIFF_MLP_BWD_SPLIT=1 (17 launches of K8, none of K7) against those
    without (K7), within BWD_REL_FRO per parameter."""
    from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
    from duodiff_tpu_torch.training.train_state import make_train_step
    from duodiff_tpu_torch.utils.model_loading import load_model

    model, cfg = load_model(IMAGENET_CONFIG, device=device, seed=1, attn_impl="fused")
    model.train()
    step = make_train_step(model, NoiseSchedule.create(device=device),
                           parametrization="predict_noise", seed=0, has_labels=True)
    g = torch.Generator().manual_seed(7)
    shape = (CHECK_BATCH, cfg.img_size, cfg.img_size, cfg.in_chans)
    batch = {"image": (torch.rand(shape, generator=g) * 2 - 1).to(device),
             "label": torch.randint(0, cfg.num_classes - 1, (CHECK_BATCH,), generator=g).to(device)}
    draws = step.draws(batch, 1)
    reset_counts()
    want = [t.clone() for t in step.backward(batch, *draws)[1]]
    mono = read_counts()
    reset_counts()
    with split_backward():
        got = [t.clone() for t in step.backward(batch, *draws)[1]]
    split = read_counts()
    n = cfg.depth
    same = {"fused_attn_sublayer": n, "fused_mlp_sublayer": n, "fused_attn_sublayer_bwd": n}
    check_counts(mono, {**same, "fused_mlp_sublayer_bwd": n})
    check_counts(split, {**same, "fused_mlp_sublayer_bwd_split": n})
    names = [k for k, _ in model.named_parameters()]
    rels = {k: rel_fro(a, b) for k, a, b in zip(names, got, want)}
    worst = max(rels, key=rels.get)
    ok = rels[worst] <= BWD_REL_FRO
    print(f"phase 3: depth-{n} ImageNet-64 training gradients B={CHECK_BATCH}, fused block with "
          f"DUODIFF_MLP_BWD_SPLIT=1 (K8 x {split['fused_mlp_sublayer_bwd_split']}) vs without "
          f"(K7 x {mono['fused_mlp_sublayer_bwd']}), {len(names)} parameters: worst "
          f"rel_fro_err={rels[worst]:.6g} ({worst}), median "
          f"{statistics.median(rels.values()):.6g} (bound {BWD_REL_FRO}) ok={ok}", flush=True)
    if not ok:
        fail("the gradients through the split MLP backward disagree with the monolithic ones")
    for p in model.parameters():
        p.grad = None


SPLIT_TRAIN_STEPS = 40
ACCUM_STEPS, ACCUM, ACCUM_SAVE_AT = 20, 2, 13   # saved inside the 7th window
CHECKPOINT_STEPS = 10
FUSED_KERNELS_SPLIT = ("fused_attn_sublayer", "fused_mlp_sublayer", "fused_attn_sublayer_bwd",
                       "fused_mlp_sublayer_bwd_split")


def run_split_training(card: str, fused_peak) -> dict:
    """Phase 8, fused training with the split MLP backward at full width:
    the training CLI on configs/uvit_imagenet64.yaml at batch 128 in bf16 on the synthetic
    ImageNet-64 cache, --attn_impl fused with DUODIFF_MLP_BWD_SPLIT=1, so
    every block runs K1, K2, K6 and K8 and none K7: (a) 40 steps, the loss
    must fall, a step's split, profile and peak memory beside the K7 leg's
    (``fused_peak``, None when phase 7 did not run); (b) 20 steps with
    --grad_accum 2 --skip_nonfinite 3: 10
    optimizer updates; (c) 10 steps with --use_checkpoint: every block's
    forward runs twice; (d) a run loaded from (b)'s checkpoint of step 13,
    the middle of an accumulation window, must end where (b) ended. Then the
    probe tool of K8. Returns (a)'s launch counts."""
    import shutil

    from duodiff_tpu_torch.data.synthetic import write_palette_imagenet64_cache
    from duodiff_tpu_torch.tools import probe_mlp_bwd_split
    from duodiff_tpu_torch.training.checkpointer import Checkpointer

    def argv(work, exp, n_steps, *extra):
        return train_argv(work, exp, n_steps, "--attn_impl", "fused", "--label_dropout",
                          str(LABEL_DROPOUT), *extra, config=IMAGENET_CONFIG,
                          dataset="imagenet64")

    def run(label, args, steps, forwards=1):
        floor = release_memory()
        print(f"phase 8{label.split(':')[0]}: {floor:.6g} GiB of device memory held before the "
              "run", flush=True)
        n = 17 * steps
        expected = {k: n for k in FUSED_KERNELS_SPLIT}
        expected["fused_attn_sublayer"] = expected["fused_mlp_sublayer"] = n * forwards
        trainer, launches = run_train_cli(f"phase 8{label}", args, card, expected)
        return trainer, launches, torch.cuda.max_memory_allocated()

    with tempfile.TemporaryDirectory() as work, split_backward():
        write_palette_imagenet64_cache(Path(work) / "data", seed=0)
        trainer, launches, peak = run(
            "a: train uvit_imagenet64.yaml, attn_impl fused, DUODIFF_MLP_BWD_SPLIT=1",
            argv(work, "split", SPLIT_TRAIN_STEPS), SPLIT_TRAIN_STEPS)
        first, last = trainer.logs[0]["train_loss"], trainer.logs[-1]["train_loss"]
        beside = "not measured" if fused_peak is None else f"{fused_peak / 2**30:.6g} GiB"
        print(f"phase 8a: peak device memory {peak / 2**30:.6g} GiB with K8 beside "
              f"{beside} in phase 7's fused leg with K7; loss {first:.6g} -> "
              f"{last:.6g}", flush=True)
        if not last < LOSS_DROP * first:
            fail(f"the train loss through K8 did not fall clearly: {first:.6g} -> {last:.6g}")
        profile_train_step(trainer, card, "phase 8a (fused, K8)")
        del trainer
        shutil.rmtree(Path(work) / "logs")

        accum = ("--grad_accum", str(ACCUM), "--skip_nonfinite", "3")
        trainer, _, accum_peak = run(
            f"b: --grad_accum {ACCUM} --skip_nonfinite 3",
            argv(work, "accum", ACCUM_STEPS, *accum, "--save_new_every_n_steps",
                 str(ACCUM_SAVE_AT)), ACCUM_STEPS)
        opt = trainer.state.optimizer
        updates, bad = opt.count, int(opt.total_notfinite)
        ok = updates == ACCUM_STEPS // ACCUM and opt.mini_step == 0 and bad == 0
        print(f"phase 8b: {ACCUM_STEPS} data steps made {updates} optimizer updates (the "
              f"learning-rate position), mini-step {opt.mini_step}, {bad} non-finite updates "
              f"skipped; {trainer.logs[-1]['steps_per_sec']:.6g} data steps/s; peak device memory "
              f"{accum_peak / 2**30:.6g} GiB ok={ok}", flush=True)
        if not ok:
            fail("--grad_accum did not make one update per window")
        want = [p.detach().clone() for p in trainer.model.parameters()]
        cut = trainer.log_path / f"imagenet64_uvit_step-{ACCUM_SAVE_AT}"
        saved = Checkpointer.restore(cut)["optimizer"]
        held = max(float(t.abs().max()) for t in saved["acc_grads"].values())
        # the optimizer's share of a data step, on gradients of zeros: the
        # steps that only fold into the running mean, and those that update
        zeros = [torch.zeros_like(p) for p in opt.params]
        ms = {"accumulate": [], "update": []}
        for _ in range(8):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            opt.step(zeros)
            end.record()
            end.synchronize()
            ms["update" if opt.mini_step == 0 else "accumulate"].append(start.elapsed_time(end))
        print(f"phase 8b: the optimizer's part of a data step (CUDA events, median of 4): "
              f"{statistics.median(ms['accumulate']):.6g} ms folding into the running mean, "
              f"{statistics.median(ms['update']):.6g} ms folding, clipping, checking and updating; "
              "the logged steps/s above include the 2.6 GB checkpoint of step "
              f"{ACCUM_SAVE_AT}", flush=True)
        del trainer, saved, opt, zeros

        steps = ACCUM_STEPS - ACCUM_SAVE_AT
        resumed, _, _ = run(
            f"d: resume of (b) from its checkpoint of step {ACCUM_SAVE_AT}",
            argv(work, "accum_resumed", ACCUM_STEPS, *accum, "--load_checkpoint_path", str(cut)),
            steps)
        got = list(resumed.model.parameters())
        rels = [rel_fro(a.detach(), b) for a, b in zip(got, want)]
        equal = all(torch.equal(a.detach(), b) for a, b in zip(got, want))
        ok = (resumed.start_step == ACCUM_SAVE_AT and held > 0.0 and max(rels) <= 1e-6
              and resumed.state.optimizer.count == ACCUM_STEPS // ACCUM)
        print(f"phase 8d: resumed at step {resumed.start_step} with mini-step 1 and the saved "
              f"running mean (max |entry| {held:.6g}); after {steps} more steps its parameters "
              f"are those of the unbroken run: equal to the bit {equal}, worst rel_fro_err "
              f"{max(rels):.3g} (bound 1e-6); {resumed.state.optimizer.count} updates ok={ok}",
              flush=True)
        if not ok:
            fail("a resume inside an accumulation window did not continue the window")
        del resumed, want, got
        shutil.rmtree(Path(work) / "logs")

        trainer, _, ckpt_peak = run(
            "c: --use_checkpoint", argv(work, "checkpointed", CHECKPOINT_STEPS,
                                        "--use_checkpoint"), CHECKPOINT_STEPS, forwards=2)
        print(f"phase 8c: peak device memory {ckpt_peak / 2**30:.6g} GiB with --use_checkpoint "
              f"beside {peak / 2**30:.6g} GiB without (8a); "
              f"{trainer.logs[-1]['steps_per_sec']:.6g} steps/s over steps 2-"
              f"{CHECKPOINT_STEPS}", flush=True)
        profile_train_step(trainer, card, "phase 8c (fused, K8, --use_checkpoint)")
        del trainer
        torch.cuda.empty_cache()
    probe = probe_mlp_bwd_split.main(["imagenet64", *map(str, SPLITS)])
    if probe["card"] != card:
        fail(f"the probe tool saw another card: {probe['card']}")
    return launches


def run_probe_tools(card: str) -> dict:
    """Phase 9: the two int8 probe tools through their ``main`` at their full
    geometry, every launch counter set to 0 just before each and read just
    after. Each form of each sublayer runs a warm-up chain and a timed chain
    of ``ITERS`` calls; the attention-chain probe adds one call of each form
    for its error. A static twin slower than its dynamic one, or int8 slower
    than bf16, is a finding, printed and not a failure. Returns the launches
    of the probes' kernels."""
    from duodiff_tpu_torch.tools import probe_int8_sdpa, probe_int8_static

    reset_counts()
    static = probe_int8_static.main([])
    torch.cuda.synchronize()
    launches = read_counts()
    chains = 2 * probe_int8_static.ITERS
    check_counts(launches, {
        "fused_mlp_sublayer_int8": 2 * chains, "fused_mlp_sublayer_int8 dynamic": chains,
        "fused_mlp_sublayer_int8 static": chains, "fused_attn_sublayer_int8": 2 * chains,
        "fused_attn_sublayer_int8 static": chains})
    told = static["launches"]
    if told != {"mlp": {"dynamic": chains, "static": chains},
                "attn": {"dynamic": chains, "static": chains}}:
        fail(f"probe_int8_static reports launches {told}, expected {chains} of each form")
    ms = static["ms"]
    if not all(np.isfinite(v) and v > 0 for v in ms.values()):
        fail(f"probe_int8_static reports times {ms}")
    out = {"probe_mlp_int8": launches["fused_mlp_sublayer_int8"],
           "probe_attn_int8": launches["fused_attn_sublayer_int8"]}
    print(f"phase 9: probe_int8_static: launches {launches}; static beats dynamic for the MLP: "
          f"{ms['mlp_static'] < ms['mlp_dynamic']}, for attention: "
          f"{ms['attn_static'] < ms['attn_dynamic']}; card {card}", flush=True)

    reset_counts()
    sdpa = probe_int8_sdpa.main([])
    torch.cuda.synchronize()
    launches = read_counts()
    calls = 2 * probe_int8_sdpa.ITERS + 1
    check_counts(launches, {"sdpa_chain_bf16": calls, "sdpa_chain_int8": calls})
    if sdpa["launches"] != {"bf16": calls, "int8": calls}:
        fail(f"probe_int8_sdpa reports launches {sdpa['launches']}, expected {calls} of each")
    if not 0.0 < sdpa["rel_l2_err"] <= SDPA_INT8_REL:
        fail(f"probe_int8_sdpa: int8 lies {sdpa['rel_l2_err']:.6g} from bf16 "
             f"(bound {SDPA_INT8_REL})")
    if static["card"] != card or sdpa["card"] != card:
        fail(f"a probe tool saw another card: {static['card']} / {sdpa['card']}")
    print(f"phase 9: probe_int8_sdpa: launches {launches}; int8 beats bf16: "
          f"{sdpa['speedup'] > 1.0} ({sdpa['speedup']:.6g}x); card {card}", flush=True)
    out.update({k: launches[k] for k in ("sdpa_chain_bf16", "sdpa_chain_int8")})
    return out


def parse_phases(argv) -> set:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help=f"comma list of the phases to run, of {', '.join(PHASES)} "
                             "(default: all; phase 1, the set-up, always runs)")
    phases = [p.strip() for p in parser.parse_args(argv).phases.split(",") if p.strip()]
    unknown = sorted(set(phases) - set(PHASES))
    if unknown or not phases:
        parser.error(f"--phases takes a comma list of {', '.join(PHASES)}; got {unknown or 'none'}")
    return set(phases)


def main(argv=None) -> int:
    run = parse_phases(argv)
    if not torch.cuda.is_available():
        print("FAILED: no CUDA device; chip_smoke.py runs only on a GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = setup()
    kernels = {**KERNELS, **INT8_KERNELS, **BWD_KERNELS, **ATTENTION_KERNELS, **BLOCK_KERNELS,
               **PROBE_KERNELS}
    results = new_results(kernels)
    launches = {}
    if "2" in run:
        check_kernels(device, results)
        check_int8_kernels(device, results)
        check_bwd_kernels(device, results)
        check_attention_kernels(device, results)
        check_kernels(device, results, IMAGENET, variants=(False,), suffix="_d768")
        check_bwd_kernels(device, results, IMAGENET, variants=(False,), suffix="_d768")
        check_int8_kernels(device, results, IMAGENET, batches=(CHECK_BATCH,), suffix="_d768_b8")
        check_block_kernels(device, results, IMAGENET, suffix="")
        check_split_kernel(device, results, IMAGENET, variants=(False,), suffix="")
        check_block_kernels(device, results, CELEBA, suffix="_d512")
        check_split_kernel(device, results, CELEBA, variants=(False, True), suffix="_d512")
        check_probe_kernels(device, results)
    if "3" in run:
        check_model(device)
        check_int8_model(device)
        check_training(device)
        check_imagenet_model(device)
        launches.update(check_block_stack(device))
        check_split_training(device)
    if "4" in run:
        launches.update({name: n for name, n in run_main_path(card).items() if name in KERNELS})
    if "4b" in run:
        launches.update({name: n for name, n in run_int8_main_path(card).items()
                         if name in INT8_KERNELS})
    if "5" in run:
        launches.update({name: n for name, n in run_train_path(device, card).items()
                         if name in BWD_KERNELS})
    if "5b" in run:
        run_distill_path(card)
    if "6" in run:
        launches["flash_attention"] = run_imagenet_sampling(device, card)["flash_attention"]
    fused_peak = None
    if "7" in run:
        imagenet_launches, fused_peak = run_imagenet_training(card)
        launches["flash_attention_bwd"] = imagenet_launches["flash_attention_bwd"]
    if "8" in run:
        split_launches = run_split_training(card, fused_peak)
        launches["fused_mlp_sublayer_bwd_split"] = split_launches["fused_mlp_sublayer_bwd_split"]
    if "9" in run:
        launches.update(run_probe_tools(card))
    if run == set(PHASES):
        idle = sorted(name for name in kernels if not launches.get(name))
        if idle:
            fail(f"kernels never launched on their paths: {idle}")
    # the bounds at the width of each kernel's main path: CelebA's for the
    # sublayers, their int8 and backward forms and the probes' kernels,
    # ImageNet-64's for K1-v1, K5 and K8
    bounds = {**kernel_bounds(), **{k: v for k, v in kernel_bounds(IMAGENET).items()
                                    if k in BLOCK_KERNELS}}
    # with a subset of the phases: the kernels that phase 2 timed or a path
    # launched, each with what was measured (launches null where its path did
    # not run)
    record = [
        {"name": name, "route": "cuda", **kernels[name], "launches": launches.get(name),
         "library_ms": None, **bounds[name], **results[name]}
        for name in kernels if "ms" in results[name] or name in launches
    ]
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
