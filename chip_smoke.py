#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``duodiff_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--phases 2,3,4,4b,5,5b,6,7,8,9,10,11,12,13,14,15]

Drives the port's main paths at the full width of the CelebA-64 U-ViT
(D = 512), of the class-conditional ImageNet-64 U-ViT (D = 768) and of the
latent ImageNet-256 U-ViT (D = 1024) and checks them, in phases, each
printing its results on its own lines:

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
   sublayer's backward is the split kernel K8 and K7 never runs: 40
   steps (the loss must fall; split, profile and peak memory beside phase
   7's), 20 steps with ``--grad_accum 2 --skip_nonfinite 3`` (10 optimizer
   updates), a run loaded from that one's checkpoint of step 13, inside an
   accumulation window, which must end where the unbroken run ended, and 10
   steps with ``--use_checkpoint`` (every block's forward twice a step);
   then ``duodiff_tpu_torch.tools.probe_mlp_bwd_split`` at D = 768 and 1024;
9. the int8 probe tools, the main path of the sixth slice:
   ``duodiff_tpu_torch.tools.probe_int8_static`` (K13, K14: the dynamic and
   the static twin of both W8A8 sublayers, chained) and
   ``duodiff_tpu_torch.tools.probe_int8_sdpa`` (K15: the attention chain alone,
   bf16 and int8), each once through its ``main`` at its full geometry
   (batch 128, L = 257, D = 512, 8 heads), with the launch counts they imply;
10. the other samplers and the tools that make the headline's two assets, at
   CelebA-64 width: (a) DDIM DuoDiff, 50 steps, bf16, through the sampling
   CLI, after a 10-step DDIM run at batch 8 held kernels against plain; (b)
   DPM-Solver++ 2M, 20 steps, on the depth-13 model in int8 with the asset's
   static scales, block-cached every 2 transitions, after the same run at
   batch 8 held against ``plain_int8``; (c) heavy-light interleaving every 4
   steps over 1000; (d) ``duodiff_tpu_torch.tools.derive_cache_schedule`` in
   DuoDiff mode for the pair phase 4b samples (seeds 0 and 1, at most 80
   anchors), its JSON loaded back; (e) ``duodiff_tpu_torch.tools.calibrate_int8
   --mode search`` on the depth-13 model at seed 1, batch 16, its PSNR table
   printed; (f) phase 4b's composition on the files (d) and (e) wrote. Each
   with exact launch counts and its wall time beside the card;
11. early-exit sampling through ``python -m duodiff_tpu_torch.eesample`` and
   ``duodiff_tpu_torch.tools.calibrate_probes``, random weights from seed 0:
   after gates on the depth-13 ``configs/deediff_celeba.yaml`` model (the
   forward triple at three timesteps, a short block-cached static-bucket
   trajectory on one noise table, fused against plain, and the share of
   agreeing exit indices of a short dynamic run), (a) the dynamic rule at a
   threshold picked from the model's own probes, 1000 steps, batch 128,
   bf16, then one such step timed beside its backbone alone and profiled;
   (b) four buckets derived from (a)'s indices, cached every 2; (c) a
   probe calibration (batch 16, 100 steps), the monotone adaptive walk and
   the bidirectional one on that file; (d) guided on
   ``configs/deediff_imagenet64.yaml`` (D = 768, depth 17), batch 64 doubled;
   (e) int8 with the asset's static MLP scales. The launch counts follow
   from each run's buckets and walk; they are added to the record of K1,
   K2, K11 and K12;
12. DeeDiff early-exit training through the training CLI on
   ``configs/deediff_celeba.yaml`` (L = 257, D = 512, depth 13, per-layer MLP
   probes) at batch 128 in bf16, fused, on a synthetic CelebA cache: (a)
   gates at batch 8, fused against plain (every gradient, the five loss
   terms, a few AdamW steps; with the backbone frozen, the backbone equal to
   its start, the heads moved, the logged norm over every gradient); (b)
   200 steps with ``--async_checkpoint``, sampling once at the last step
   (16 images, 1000 steps), the loss falling, the checkpoint in
   ``load_model(early_exit=True)``, a ``--resume`` run and ``eesample`` on it;
   (c) ``--load_backbone`` of a ``uvit_celeba.yaml`` checkpoint from a seed
   with ``--freeze_backbone`` and ``--profile``; (d) one early-exit step, the
   frozen one and the plain U-ViT step on the same backbone timed and
   profiled, with each run's peak memory; (e) ``derive_cache_schedule
   --static_schedule`` and ``calibrate_int8 --early_exit`` on the trained
   checkpoint, ``eesample`` on each file. Phase 12's launches are added to
   the record of K1, K2, K6, K7, K11 and K12;
13. latent ImageNet-256 (``configs/uvit_imagenet256.yaml``: 32 x 32 x 4
   latents, L = 258, D = 1024, 16 heads, depth 21) with a random frozen KL
   autoencoder written under the reference's names (seed 0, the default
   configuration) and copies of the three ImageNet-256 configs pointing at
   it, in a temporary directory: (a) gates: a 20-step guided DuoDiff
   trajectory at D = 1024, fused against plain on one noise table, and the
   autoencoder's decode and encode in bf16 against fp32; (b) guided
   DuoDiff sampling through the sampling CLI (``uvit_imagenet256_3.yaml``
   for 300 steps, then ``uvit_imagenet256.yaml``), batch 16, decoded to
   256 x 256 PNG files; (c) the cached int8 operating point on
   ``assets/cache_schedule_imagenet256.json``, batch 32, decoded; (d)
   ``eesample``'s dynamic rule on ``deediff_imagenet256.yaml``, 100 steps,
   batch 16, decoded; (e) the training CLI with ``--dataset imagenet256`` on
   a synthetic 256 x 256 cache, every batch encoded, batch 128, bf16, fused,
   label dropout, 40 steps (the loss must fall; a step's split into encode,
   forward, backward and AdamW, peak memory), its checkpoint in
   ``load_model`` and 10 sampling steps from it, decoded. Phase 13's
   launches are added to the record of K1, K2, K6, K7, K11 and K12;
14. evaluation and the quality tools: (a) the FD-rand extractor (the
   InceptionV3 graph, seed 2026) on the card with the caller's TF32 on,
   against the same weights on the CPU (1e-4 of the largest feature), a
   control without the extractor's own TF32 switch, the weights as a
   pytorch-fid ``.pth`` in ``load_inception`` (equal bits), and
   ``extract_features`` timed at batch 128; (b) FD-rand and the spectral
   distance of two textured draws (the floor) and of a 3 x 3 box blur, the
   blur above the floor, a repeated ``fd_rand`` call equal to the bit; (c)
   ``tools.convergence_probe`` trains ``uvit_cifar10.yaml`` on palette data
   (batch 128, bf16, fused; the loss must fall), ``tools.quality_matrix``
   samples it with ddpm, int8, cache3, cache3_int8, ddim50 and dpm20 at
   batch 64, each row's launches held exactly, ``tools.score_quality``
   scores them, and the table is printed; (d) ``python -m
   duodiff_tpu_torch.fid`` on random-init weights, ``tools.t_switch_sweep``
   on the trained backbone and a random depth-3 model,
   ``tools.probe_cache_gamma`` and ``tools.trajectory_parity`` (every row;
   ``attn pallas vs fused`` launches K9) at 100 steps, each row's launches
   held exactly. Phase 14's launches are added to the record of K1, K2, K6,
   K7, K9, K11 and K12.
15. serving, at the CelebA-64 width (``configs/uvit_celeba.yaml``, random
   weights from seed 0): (a) K1, K2, K11 (with and without a qkv bias) and
   K12 (dynamic and static) against their plain versions at the serving
   batches 1, 3 and 16, phase 2's bounds, timed beside their bounds, and
   each kernel on the first element alone against the first row of the
   batch, to the bit; (b) ``duodiff_tpu_torch.serve.main`` in-process on an
   ephemeral port, the bucket-1 server (ddpm, fused bf16):
   ``POST /sample {"n": 2, "seed": 7}`` twice, each with K1 = K2 = 26,000
   launches, the PNG images decoded to 64 x 64 x 3, the two answers equal to
   the byte, ``/healthz`` naming the card; (c) the 8-slot continuous server
   (int8 with the asset's static scales, ``--cache_pattern 1,0,0``): one
   request of 8 images on one wave (K11 = K12 = 7,006, every K12 launch
   static), each image against the bucket-1 server's on the same flags and
   seed (equal bits, or 1 % relative Frobenius and 2**-5 of the largest
   value), then a failure injected into the device loop answered 503 to
   both waiting requests, to a later one and to ``/healthz``; (d)
   ``duodiff_tpu_torch.tools.bench_serving``, bucket 1 against 8 slots, 8
   clients x 4 requests, DPM-Solver++ 20 steps, both JSON lines and their
   ratio beside the card, and a profile of three ``advance()`` calls of an
   8-slot batcher (idle share, host time a step). Phase 15's launches are
   added to the record of K1, K2, K11 and K12, and kept apart as
   ``launches_15``.

Phase 4's run also passes ``--timesteps_save 300 1000`` and checks the PNG
files the CLI writes. ``--phases`` runs a subset (phase 1 always runs); the
launch counts and the per-kernel record then cover the phases run.

Phase 2 starts with the bf16 GEMM that carries every projection of K1, K2,
K5, K1-v1 and K6's qkv recompute (``csrc/gemm.cuh``), alone through
``ops/gemm.py``: what ptxas and the occupancy call say of it, each of the
eight main-path projections (qkv, proj, fc1, fc2 at D = 512 and 768) at
batch 8 and the ragged row counts 1, 127, 129, 2056 in every epilogue form
against its plain version, the refusal of a misaligned operand, and at batch
128 its time beside ``torch.matmul`` on the same operands (TFLOP/s, share of
the peak, host time a call); then the same for the int8 GEMM of K11 / K12
(``csrc/gemm_int8.cuh``, through ``ops/gemm.py:gemm_int8``): ptxas's report of
every form, the eight W8A8 projections at batch 8 and M in {1, 127, 129, 2056} x
N in {144, 272, 512} x K in {80, 512} in every epilogue with and without row
scales, the refusal of K % 16 != 0, of N % 16 != 0 into int8 codes and of a
misaligned operand, and at batch 128 TOP/s beside ``torch._int_mm`` and the
bf16 GEMM; and the one-read LayerNorm + quant pass equal to the bit to its
first form at D = 512, 768 and 1024; then the backward GEMMs of K6, K7 and K8 alone
(``csrc/gemm.cuh`` in the forms ``csrc/gemm_t.cuh`` launches, and the MLP
backward's hidden stage ``csrc/mlp_bwd_hidden.cuh``, through
``ops/gemm.py:gemm_t`` and ``mlp_bwd_hidden``): ptxas's report of every form
(no spill and no warning allowed), the eight backward products at batch 8 at
both widths, the rows {1, 127, 129, 2056} x N {136, 264, 512} x K {72, 512}
in every form (weight gradients also with three row splits), a repeat call
equal to the bit, the refusals, K6's / K7's / K8's scratch before and after
the 16 fp32 partials went, and at batch 128 TFLOP/s back to back beside
``torch.matmul`` on the same transposed views and beside the forward GEMM
(one JSON line ``{"gemm_t": ...}``). It also holds the backward kernels K6 (with and
without a qkv bias) and K7 (exact and tanh GELU) against their plain
versions, the attention
kernels K9 and K10 at three (B, H, L) with
``F.scaled_dot_product_attention`` timed beside them as a yardstick, and
K1, K2, K6, K7, K11 and K12 at the ImageNet-64 width and at D = 1024 (batch
8 and 128, timed at 128; K1-v1, K5 and K8 at batch 8; the scratch of K6, K7
and K8), and at both widths
the rest of ``ops/pallas_block.py``: the per-head attention sublayer K1-v1
and the whole-block kernel K5 against their plain versions, K5 timed beside
K1 then K2 and K1-v1 beside K1, and K8 at 2, 4 and 8 splits (row chunks,
the last ragged at batch 8) against its plain version and against K7 (dx,
db1 and db2 equal to K7's bits), timed in turns beside K7; and at the
probes' geometry K13 and K14, dynamic and static, and K15's two forms (the
int8 one within 1 % relative Frobenius of its plain version, equal bits on a
repeat call, under 5 % from the bf16 form, also at ragged lengths 1 to 272)
with ``F.scaled_dot_product_attention(scale=1)`` timed beside them. It prints
what the compiler and the runtime say of the attention cores, the int8 one
included (registers and spills a thread, shared memory and resident blocks
an SM, which must hold eight warps), holds K9 and K10 against their
plain versions at the lengths where a 16-row tile and the cores' 272-key
limit break (1, 63, 64, 65, 129, 257, 272) and K1-v1 at 65 and 257, and times
K9, K10 and the library call 20 calls back to back beside the call-by-call
medians. Phases 4 and 4b also time and profile one bf16 dense, one int8
anchored and one int8 cached depth-13 step at batch 128. Phase 3 also holds
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
import base64
import ctypes
import gc
import json
import os
import re
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from typing import NamedTuple

STARTED = time.perf_counter()  # the whole run's wall time counts from here

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
# configs/uvit_imagenet256.yaml: 32 x 32 x 4 latents in patches of 2, time + label
IMAGENET256 = Width(258, 1024, 16)
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
# K11 / K12 at D = 1024 and batch 128 (33.8 M outputs) are held as a whole:
# FWD_REL_FRO, and every entry within 2**-5 of the largest value, the bound
# of compounded roundings. With this file's 0.05-scaled weights the merged
# heads' row maxima grow with the width, and with them the int8 step of the
# proj input; an fp32 rounding difference flips an int8 code there now and
# then, and over 33.8 M outputs one flip may land past 0.05 + 0.05 |plain|
# (K11 with a qkv bias: 0.066 on an H100). At batch 8 both keep the
# elementwise bound.
INT8_WHOLE_MAX_FRAC = 2.0**-5
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
# whole-block kernel and the split MLP backward; their recorded times
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
PHASES = ("2", "3", "4", "4b", "5", "5b", "6", "7", "8", "9", "10", "11", "12", "13", "14",
          "15")
# A stack of 17 blocks with no long skips carries every block's bf16
# roundings, forward and backward, through all the blocks behind it: the
# gradients of FusedBlockFn against autograd through block_plain over the
# whole stack measured 1.4e-2 at worst (median 9.7e-3), above the 1e-2 that
# models with long skips meet. So each block is held to BWD_REL_FRO on the
# plain stack's own input and upstream gradient, where nothing is carried,
# and the whole stack to STACK_GRAD_REL_FRO; a wrong backward is off by its
# whole size either way.
STACK_GRAD_REL_FRO = 3e-2
SPLITS = (2, 4, 8)       # K8's splits held in phase 2 (row chunks on the card)
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


def burst_ms(fn, n: int = 20) -> float:
    """CUDA-event time of ``n`` calls of ``fn`` launched back to back, over n:
    the device's time a call where the host runs ahead of it, as in a model's
    step (time_ms, which waits for the device after every call, also counts
    the host's part of a call)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


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
    """Per kernel, what its comparisons measured; ``max_abs_err`` appears
    with the first comparison that ran."""
    return {name: {} for name in names}


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
                   scaled: bool = False, max_frac: float = KERNEL_MAX_FRAC,
                   phase: str = "phase 2") -> None:
    """One kernel call against its plain version on the same inputs, both
    timed; folds the error into ``res`` and keeps the times (keep_times).
    ``scaled`` holds it to the bounds scaled to the output (scaled_errors
    with ``max_frac``) instead of the elementwise ATOL + RTOL * |plain|, and
    counts the entries past the latter."""
    got = kernel()
    torch.cuda.synchronize()
    if scaled:
        want = plain()
        max_abs, limit, rel, ok = scaled_errors(got, want, max_frac)
        past = int(((got.float() - want.float()).abs() > ATOL + RTOL * want.float().abs()).sum())
        held = (f"max_abs_err={max_abs:.6g} (bound {limit:.6g} = {max_frac}*max|plain|) "
                f"rel_fro_err={rel:.6g} (bound {FWD_REL_FRO}); {past} of {got.numel()} entries "
                f"past {ATOL}+{RTOL}*|plain|")
    else:
        max_abs, max_rel, ok = errors(got, plain())
        held = (f"max_abs_err={max_abs:.6g} max_rel_err={max_rel:.6g} "
                f"bound={ATOL}+{RTOL}*|plain|")
    ms = time_ms({"kernel": kernel, "plain": plain})
    print(f"{phase}: {label}: {held} ok={ok} kernel_ms={ms['kernel']:.6g} "
          f"plain_ms={ms['plain']:.6g}", flush=True)
    if not ok:
        fail(f"{label} disagrees with its plain version")
    res["max_abs_err"] = max(res.get("max_abs_err", 0.0), max_abs)
    keep_times(res, ms, suffix)


def check_int8_kernels(device, results: dict, width: Width = CELEBA,
                       batches=(CHECK_BATCH, MAIN_BATCH), suffix: str = "",
                       whole_batches=()) -> None:
    """Phase 2, int8: K11 with and without a qkv bias, K12 with dynamic and
    static scales (the asset's mid-block pair), each with erf and tanh
    GELU, against their plain versions; at ``whole_batches`` as a whole
    (INT8_WHOLE_MAX_FRAC) instead of entry by entry. The times kept are those
    of the main path's variants at the largest batch: K11 without bias, K12
    static with tanh GELU (the late model's 3529 of 4429 launches)."""
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
                scaled=batch in whole_batches, max_frac=INT8_WHOLE_MAX_FRAC,
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
                    scaled=batch in whole_batches, max_frac=INT8_WHOLE_MAX_FRAC,
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
    res["max_abs_err"] = max(res.get("max_abs_err", 0.0), abs_err)
    res["max_rel_fro_err"] = max(res.get("max_rel_fro_err", 0.0), rels[worst])
    keep_times(res, ms, suffix)
    return ms


def check_block_kernels(device, results: dict, width: Width, suffix: str,
                        batches=(CHECK_BATCH, MAIN_BATCH)) -> None:
    """Phase 2, the per-head attention sublayer and the whole block: K1-v1
    against attn_sublayer_v1_plain (with and without a qkv bias) and K5
    against block_plain (exact and tanh GELU) at batch 8 and 128; then, at
    batch 128, K5 timed beside K1 followed by K2 on the same operands and
    K1-v1 beside K1, and how far K5's output lies from that of K1 then K2
    (they differ by the bf16 rounding of the intermediate residual stream)."""
    from duodiff_tpu_torch.ops import block

    bf = torch.bfloat16
    heads = width.heads
    for batch in sorted(set(batches)):
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


def check_latent_width_kernels(device, results: dict) -> None:
    """Phase 2 at the latent ImageNet-256 width (D = 1024, 16 heads, L =
    258, hidden 4096), the limit of the one-read LayerNorm + quant pass and
    of the LayerNorm backward, which hold 32 values of a row a lane: K1, K2
    (batch 8 and 128), K11 and K12 dynamic and static (batch 8, and as a
    whole at 128: INT8_WHOLE_MAX_FRAC), K6 and K7 (batch 8 and 128) against
    their plain versions and timed at batch 128 (``_d1024``); K1-v1, K5 and
    K8 at batch 8 only; K6's, K7's and K8's scratch at batch 128."""
    from duodiff_tpu_torch.ops._build import load_library

    w = IMAGENET256
    check_kernels(device, results, w, variants=(False,), suffix="_d1024")
    check_int8_kernels(device, results, w, suffix="_d1024", whole_batches=(MAIN_BATCH,))
    check_bwd_kernels(device, results, w, variants=(False,), suffix="_d1024")
    check_block_kernels(device, results, w, suffix="_d1024", batches=(CHECK_BATCH,))
    check_split_kernel(device, results, w, variants=(False,), suffix="_d1024",
                       batches=(CHECK_BATCH,))
    ws = workspace_bytes(load_library(), w, MAIN_BATCH)
    print(f"phase 2: scratch at D={w.d} L={w.l} B={MAIN_BATCH}: " + "; ".join(
        f"{k} {v['now'] / 2**20:.6g} MiB" for k, v in ws.items()), flush=True)


# K8's outputs that do not depend on how the rows are chunked: its chunks are
# whole 128-row tiles, so every per-row value and every per-tile sum of the
# hidden stage is K7's; the fp32 sums of dW1 and dW2 run over the chunks, and
# those of dgamma and dbeta over smaller blocks where a chunk is small, in
# another order
SPLIT_EQUAL_TO_K7 = ("dx", "db1", "db2")


def check_split_kernel(device, results: dict, width: Width, variants, suffix: str,
                       batches=(CHECK_BATCH, MAIN_BATCH)) -> None:
    """Phase 2, the split MLP backward: K8 at 2, 4 and 8 splits against
    mlp_sublayer_bwd_split_plain (every output within BWD_REL_FRO, dx also
    elementwise, equal bits on a repeat call) and against K7's outputs on the
    same inputs within the same bound, SPLIT_EQUAL_TO_K7 equal to K7's bits,
    at batch 8 (whose rows leave a ragged last chunk) and 128; at batch 128
    K8 timed in turns beside K7, with the scratch each takes. The times kept
    are those of MAIN_SPLITS chunks, exact GELU."""
    from duodiff_tpu_torch.ops import block
    from duodiff_tpu_torch.ops._build import load_library

    bf = torch.bfloat16
    lib = load_library()
    outs = ("dx", "dg", "db", "dw1", "db1", "dw2", "db2")
    res = results["fused_mlp_sublayer_bwd_split"]
    for batch in sorted(set(batches)):
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
                got = kernel()
                rels = {n: rel_fro(g, w) for n, g, w in zip(outs, got, mono)}
                worst = max(rels, key=rels.get)
                same = [n for n, g, w in zip(outs, got, mono)
                        if n in SPLIT_EQUAL_TO_K7 and torch.equal(g, w)]
                ok = rels[worst] <= BWD_REL_FRO and len(same) == len(SPLIT_EQUAL_TO_K7)
                rows = x.shape[0] * x.shape[1]
                chunk = lib.duodiff_mlp_sublayer_bwd_split_chunk_rows(rows, splits)
                n_chunks = -(-rows // chunk)
                print(f"phase 2: K8 splits={splits} against K7 {where}: {rows} rows in {n_chunks} "
                      f"chunks of {chunk}, the last {rows - (n_chunks - 1) * chunk}; worst "
                      f"rel_fro_err {rels[worst]:.3g} ({worst}) (bound {BWD_REL_FRO}); equal to "
                      f"K7's bits: {', '.join(same) or 'none'} (of {', '.join(SPLIT_EQUAL_TO_K7)}) "
                      f"ok={ok}", flush=True)
                if not ok:
                    fail(f"K8 with {splits} splits disagrees with K7 at {where}")
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
            print(f"phase 2: {where}, in turns: " + "; ".join(
                f"{k} {ms[k]:.6g} ms ({ms[k] / ms['K7']:.4g} x K7), scratch "
                f"{scratch[k] / 2**20:.6g} MiB" for k in ms)
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
        burst = {"K9": burst_ms(lambda: fa.flash_attention(q, k, v)),
                 "K10": burst_ms(lambda: fa.flash_attention_bwd(q, k, v, do)),
                 "fwd": burst_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
                 "fwd_bwd": burst_ms(sdpa_fwd_bwd)}
        print(f"phase 2: {label}, 20 calls back to back, ms a call: K9 {burst['K9']:.6g}, "
              f"K10 {burst['K10']:.6g}; F.scaled_dot_product_attention forward "
              f"{burst['fwd']:.6g}, backward (forward + backward less forward) "
              f"{burst['fwd_bwd'] - burst['fwd']:.6g}", flush=True)
        sdpa_err = errors(F.scaled_dot_product_attention(q, k, v), fa.flash_attention(q, k, v))[0]
        print(f"phase 2: library yardstick {label}: F.scaled_dot_product_attention forward "
              f"{lib['fwd']:.6g} ms, backward (forward + backward less forward) {lib_bwd:.6g} ms; "
              f"max |SDPA - K9| {sdpa_err:.6g}", flush=True)
        if main:
            results["flash_attention"]["library_ms"] = lib["fwd"]
            results["flash_attention_bwd"]["library_ms"] = lib_bwd
            results["flash_attention"]["burst_ms"] = burst["K9"]
            results["flash_attention"]["library_burst_ms"] = burst["fwd"]
            results["flash_attention_bwd"]["burst_ms"] = burst["K10"]
            results["flash_attention_bwd"]["library_burst_ms"] = burst["fwd_bwd"] - burst["fwd"]


# The bf16 GEMM of the block kernels (csrc/gemm.cuh) alone, at the main
# path's projections: (name, width, N, K, epilogue) with M = batch * L.
# Epilogues as the sublayers use them: qkv bias only; proj and fc2 the bf16
# residual and the bias; fc1 the bias and exact GELU.
GEMM_SHAPES = tuple(
    (f"{name} D={w.d}", w, n, k, epi)
    for w in (CELEBA, IMAGENET)
    for name, n, k, epi in (("qkv", 3 * w.d, w.d, "bias"), ("proj", w.d, w.d, "residual"),
                            ("fc1", 4 * w.d, w.d, "gelu"), ("fc2", w.d, 4 * w.d, "residual"))
)
# M where a 128-row tile breaks, with N = 136 (a ragged 128-column tile), 264
# (three column tiles, the last with 8 columns) and 512, at K = 72 (a ragged
# 64-deep slab), in every (residual, output) form the kernel has, GELU modes
# in turn
GEMM_RAGGED_M = (1, 127, 129, 2056)
GEMM_RAGGED_N = (136, 264, 512)
GEMM_RAGGED_FORMS = ((None, torch.bfloat16, "none"), (torch.bfloat16, torch.bfloat16, "erf"),
                     (torch.float32, torch.bfloat16, "tanh"),
                     (torch.bfloat16, torch.float32, "none"),
                     (torch.float32, torch.float32, "erf"), (None, torch.float32, "tanh"))
# |kernel - plain| <= GEMM_REL * |plain| + GEMM_ABS_FRAC * max|plain| entry by
# entry: both sum the same bf16 products in fp32, in another order (~1e-6 of
# the sum), and apply the same fp32 epilogue, so they differ by at most one
# flipped rounding of the output (2**-7 of the value in bf16) plus the
# order of the sums, which the small absolute term covers where GELU brings
# a value near zero. A wrong tile or slab is off by the value's whole size.
GEMM_REL = 2.0**-7
GEMM_ABS_FRAC = 2.0**-10
GEMM_UNITS = ("gemm_bf16", "attn_sublayer", "attn_sublayer_v1", "mlp_sublayer", "fused_block",
              "attn_sublayer_bwd")


def gemm_errors(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float, bool]:
    """(max abs error, largest error over its bound, within GEMM_REL and
    GEMM_ABS_FRAC everywhere)."""
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        return float("inf"), float("inf"), False
    diff = (got - want).abs()
    limit = GEMM_REL * want.abs() + GEMM_ABS_FRAC * want.abs().max().clamp_min(1e-30)
    worst = (diff / limit).max().item()
    return diff.max().item(), worst, worst <= 1.0


def gemm_operands(m: int, n: int, k: int, device, residual_dtype, seed: int):
    """bf16 a (M, K) ~ N(0, 1), b (K, N) ~ N(0, 1/K), fp32 bias ~ N(0, 0.1^2)
    and a residual ~ N(0, 1) of the given type (or None), on the card."""
    g = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn((m, k), generator=g, device=device).to(torch.bfloat16)
    b = (torch.randn((k, n), generator=g, device=device) * k ** -0.5).to(torch.bfloat16)
    bias = torch.randn((n,), generator=g, device=device) * 0.1
    residual = None
    if residual_dtype is not None:
        residual = torch.randn((m, n), generator=g, device=device).to(residual_dtype)
    return a, b, bias, residual


def report_gemm() -> None:
    """Phase 2: what ptxas says of every form of the bf16 GEMM kernel in
    every unit that compiles it (registers a thread, spills, stack; any
    warning, such as a serialised wgmma), and what the runtime says of a
    block (warps, stages, dynamic shared memory, resident blocks an SM)."""
    from duodiff_tpu_torch.ops._build import kernel_resources, load_library, ptxas_warnings

    for unit in GEMM_UNITS:
        for rec in kernel_resources(unit):
            if "gemm_bf16_kernel" not in rec["entry"]:
                continue
            print(f"phase 2: gemm_bf16_kernel <{gemm_form(rec['entry'])}> ({unit}.cu): "
                  f"{rec['registers']} registers a thread, spill stores {rec['spill_stores']} B, "
                  f"spill loads {rec['spill_loads']} B, stack {rec['stack']} B", flush=True)
        for line in ptxas_warnings(unit):
            if "gemm" in line or "wgmma" in line:
                print(f"phase 2: ptxas on {unit}.cu: {line}", flush=True)
    lib = load_library()
    print(f"phase 2: gemm_bf16: {lib.duodiff_gemm_bf16_threads() // 32} warps a block (a "
          f"producer, two MMA and two epilogue warpgroups), {lib.duodiff_gemm_bf16_stages()} "
          f"stages, {lib.duodiff_gemm_bf16_smem_bytes()} B of dynamic shared memory, "
          f"{lib.duodiff_gemm_bf16_blocks_per_sm()} blocks an SM", flush=True)


def check_gemm(device) -> None:
    """Phase 2, the bf16 GEMM alone (ops/gemm.py, the measurement entry of
    csrc/gemm.cuh): against its plain version (gemm_errors) at the eight
    GEMM_SHAPES at batch 8, and at GEMM_RAGGED_M x GEMM_RAGGED_N in every
    form; the entry must refuse a misaligned operand and N % 8 != 0. Then
    at batch 128: kernel, plain version and torch.matmul on the same bf16
    operands (the library yardstick, no epilogue; the port never calls it),
    each call waited for (time_ms) and 20 back to back (burst_ms); TFLOP/s
    and the share of the 989 TFLOP/s peak from the back-to-back time; the
    host time of one call through the wrapper and through the C entry alone
    (tensor maps included); the batch-128 numbers also as one JSON line."""
    from duodiff_tpu_torch.ops import gemm
    from duodiff_tpu_torch.ops._build import load_library

    def run(a, b, bias, res, epi_gelu, out_dtype=torch.bfloat16):
        return gemm.gemm_bf16(a, b, bias, res, gelu=epi_gelu, out_dtype=out_dtype)

    def path_epilogue(epi):
        return (torch.bfloat16 if epi == "residual" else None), ("erf" if epi == "gelu" else "none")

    for i, (name, width, n, k, epi) in enumerate(GEMM_SHAPES):
        res_dtype, act = path_epilogue(epi)
        m = CHECK_BATCH * width.l
        a, b, bias, res = gemm_operands(m, n, k, device, res_dtype, seed=i)
        want = gemm.gemm_bf16_plain(a, b, bias, res, gelu=act)
        max_abs, worst, ok = gemm_errors(run(a, b, bias, res, act), want)
        print(f"phase 2: gemm_bf16 {name} M={m} N={n} K={k} {epi}: max_abs_err={max_abs:.6g}, "
              f"worst error over bound {worst:.4g} (bound {GEMM_REL}*|plain| + "
              f"{GEMM_ABS_FRAC}*max|plain|) ok={ok}", flush=True)
        if not ok:
            fail(f"gemm_bf16 {name} M={m} disagrees with its plain version")
    for m in GEMM_RAGGED_M:
        for n in GEMM_RAGGED_N:
            for j, (res_dtype, out_dtype, act) in enumerate(GEMM_RAGGED_FORMS):
                a, b, bias, res = gemm_operands(m, n, 72, device, res_dtype, seed=100 * m + j)
                got = run(a, b, bias if j % 2 == 0 else None, res, act, out_dtype)
                want = gemm.gemm_bf16_plain(a, b, bias if j % 2 == 0 else None, res, gelu=act,
                                            out_dtype=out_dtype)
                max_abs, worst, ok = gemm_errors(got, want)
                if not ok or got.dtype != out_dtype:
                    fail(f"gemm_bf16 ragged M={m} N={n} K=72 residual={res_dtype} out={out_dtype} "
                         f"gelu={act}: max_abs_err={max_abs:.6g}, worst over bound {worst:.4g}")
    torch.cuda.synchronize()
    print(f"phase 2: gemm_bf16 ragged: M in {GEMM_RAGGED_M} x N in {GEMM_RAGGED_N} x K=72 x "
          f"{len(GEMM_RAGGED_FORMS)} (residual, output, GELU) forms, bias every other: ok=True",
          flush=True)
    lib = load_library()
    a, b, bias, res = gemm_operands(64, 64, 64, device, torch.bfloat16, seed=7)
    c = torch.empty((64, 64), dtype=torch.bfloat16, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    refused = {
        "A 2 bytes off": lib.duodiff_gemm_bf16(a.data_ptr() + 2, b.data_ptr(), c.data_ptr(), None,
                                               None, 63, 64, 64, 0, 0, 0, stream),
        "N = 60": lib.duodiff_gemm_bf16(a.data_ptr(), b.data_ptr(), c.data_ptr(), None, None, 64,
                                        60, 64, 0, 0, 0, stream),
    }
    print("phase 2: gemm_bf16 refuses " + "; ".join(
        f"{what}: error {err} ({lib.duodiff_error_string(err).decode()})"
        for what, err in refused.items()), flush=True)
    if not all(refused.values()):
        fail("the GEMM entry launched on an operand it cannot take")

    timed = {}
    for i, (name, width, n, k, epi) in enumerate(GEMM_SHAPES):
        res_dtype, act = path_epilogue(epi)
        m = MAIN_BATCH * width.l
        a, b, bias, res = gemm_operands(m, n, k, device, res_dtype, seed=i)
        max_abs, worst, ok = gemm_errors(run(a, b, bias, res, act),
                                         gemm.gemm_bf16_plain(a, b, bias, res, gelu=act))
        if not ok:
            fail(f"gemm_bf16 {name} M={m} disagrees with its plain version")
        fns = {"kernel": lambda: run(a, b, bias, res, act),
               "plain": lambda: gemm.gemm_bf16_plain(a, b, bias, res, gelu=act),
               "library": lambda: torch.matmul(a, b)}
        ms = time_ms(fns)
        burst = {key: burst_ms(fns[key]) for key in ("kernel", "library")}
        flops = 2.0 * m * n * k
        tflops = flops / (burst["kernel"] * 1e-3) / 1e12
        c = torch.empty((m, n), dtype=torch.bfloat16, device=device)
        args = (a.data_ptr(), b.data_ptr(), c.data_ptr(), bias.data_ptr(),
                None if res is None else res.data_ptr(), m, n, k, gemm.GELU_MODES[act], 0, 0,
                stream)
        host = {}
        for key, fn in (("wrapper", lambda: run(a, b, bias, res, act)),
                        ("entry", lambda: lib.duodiff_gemm_bf16(*args))):
            fn()
            torch.cuda.synchronize()
            tic = time.perf_counter()
            for _ in range(20):
                fn()
            host[key] = (time.perf_counter() - tic) / 20 * 1e3
            torch.cuda.synchronize()
        timed[name] = {"M": m, "N": n, "K": k, "ms": ms["kernel"], "burst_ms": burst["kernel"],
                       "tflops": tflops, "peak_share": tflops / (PEAK_BF16_FLOPS / 1e12),
                       "plain_ms": ms["plain"],
                       "library_ms": ms["library"], "library_burst_ms": burst["library"],
                       "bound_ms": bound(flops, 0, 2 * (m * k + k * n + m * n) + 4 * n
                                         + (0 if res is None else 2 * m * n))["bound_ms"],
                       "host_ms_wrapper": host["wrapper"], "host_ms_entry": host["entry"],
                       "max_abs_err": max_abs}
        print(f"phase 2: gemm_bf16 {name} M={m} N={n} K={k} {epi}: kernel {ms['kernel']:.6g} ms "
              f"(back to back {burst['kernel']:.6g}: {tflops:.1f} TFLOP/s, "
              f"{100 * tflops / (PEAK_BF16_FLOPS / 1e12):.1f} % of 989), plain "
              f"{ms['plain']:.6g} ms; library yardstick torch.matmul "
              f"{ms['library']:.6g} ms (back to back {burst['library']:.6g}: "
              f"{flops / (burst['library'] * 1e-3) / 1e12:.1f} TFLOP/s); host time a call "
              f"{host['wrapper']:.4g} ms through the wrapper, {host['entry']:.4g} ms through "
              f"the C entry (tensor maps included)", flush=True)
    print(json.dumps({"gemm_bf16": timed}), flush=True)
    return timed


# The int8 GEMM of K11 / K12 (csrc/gemm_int8.cuh) alone, at the main path's
# W8A8 projections: (name, width, N, K, epilogue, row scales, GELU). K11 runs
# with dynamic scales in the model (row scales for qkv and proj), K12's
# late-model launches with static ones (fc1's epilogue quantizes the tanh
# GELU to int8 codes, no row scales for fc1 and fc2).
GEMM_INT8_SHAPES = tuple(
    (f"{name} D={w.d}", w, n, k, epi, rows, act)
    for w in (CELEBA, IMAGENET)
    for name, n, k, epi, rows, act in (
        ("qkv", 3 * w.d, w.d, "bias", True, "none"),
        ("proj", w.d, w.d, "residual", True, "none"),
        ("fc1", 4 * w.d, w.d, "gelu_quant", False, "tanh"),
        ("fc2", w.d, 4 * w.d, "residual", False, "none"))
)
# M where a 128-row tile breaks, N = 144 (a ragged 128-column tile), 272 (three
# column tiles, the last with 16 columns) and 512, K = 80 (a ragged 128-deep
# slab) and 512, in every epilogue, with and without row scales
GEMM_INT8_RAGGED_M = (1, 127, 129, 2056)
GEMM_INT8_RAGGED_N = (144, 272, 512)
GEMM_INT8_RAGGED_K = (80, 512)
GEMM_INT8_FORMS = (("bias", "none"), ("residual", "none"), ("gelu_f32", "erf"),
                   ("gelu_quant", "tanh"))
# Against the plain version on the same codes and scales: the int32 products
# are exact on both sides and the fp32 epilogue steps are the same roundings
# in the same order, so they differ only where erff / tanhf and torch's GELU
# differ by an ulp: a bf16 output by at most one rounding (2**-8 of the value,
# the small absolute term where GELU brings a value near zero), an fp32 one by
# a few ulps, and an int8 code by one where v * inv lies within an ulp of a
# half, which at most INT8_CODE_FLIPS of the entries may do.
GEMM_INT8_BOUNDS = {torch.bfloat16: (2.0**-8, 2.0**-12), torch.float32: (2.0**-20, 2.0**-24)}
INT8_CODE_FLIPS = 1e-4
GEMM_INT8_UNITS = ("gemm_int8_entry", "attn_sublayer_int8", "mlp_sublayer_int8")
INT8_EPILOGUE_NAMES = {"0": "bias", "1": "residual", "2": "gelu_f32", "3": "gelu_quant"}
GELU_NAMES = {"0": "none", "1": "erf", "2": "tanh"}


def gemm_int8_errors(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float, bool]:
    """(max abs error, largest error over its bound or, for int8 codes, the
    share of codes that differ, within the bound)."""
    if got.dtype == torch.int8:
        diff = (got.int() - want.int()).abs()
        share = (diff > 0).float().mean().item()
        return diff.max().item(), share, diff.max().item() <= 1 and share <= INT8_CODE_FLIPS
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        return float("inf"), float("inf"), False
    rel, frac = GEMM_INT8_BOUNDS[torch.float32 if got.dtype == torch.float32 else torch.bfloat16]
    diff = (got - want).abs()
    limit = rel * want.abs() + frac * want.abs().max().clamp_min(1e-30)
    worst = (diff / limit).max().item()
    return diff.max().item(), worst, worst <= 1.0


def gemm_int8_operands(m: int, n: int, k: int, device, epilogue: str, rows: bool, seed: int):
    """int8 codes a8 (M, K) and b8 (N, K) uniform in [-127, 127], column
    scales that bring the dequantized sums to ~N(0, 1), row scales in [0.5,
    1.5) (or None), an fp32 bias ~ N(0, 0.1^2), and the residual (bf16 ~ N(0,
    1)) and quant_inv (127 / 4) where the epilogue takes them, on the card."""
    g = torch.Generator(device=device).manual_seed(seed)
    a8 = torch.randint(-127, 128, (m, k), generator=g, device=device, dtype=torch.int8)
    b8 = torch.randint(-127, 128, (n, k), generator=g, device=device, dtype=torch.int8)
    col = (0.5 + torch.rand((n,), generator=g, device=device)) * (3.0 / (127.0**2 * k**0.5))
    row = 0.5 + torch.rand((m,), generator=g, device=device) if rows else None
    bias = torch.randn((n,), generator=g, device=device) * 0.1
    res = None
    if epilogue == "residual":
        res = torch.randn((m, n), generator=g, device=device).to(torch.bfloat16)
    inv = torch.tensor([127.0 / 4.0], device=device) if epilogue == "gelu_quant" else None
    return a8, b8, col, row, bias, res, inv


def report_gemm_int8() -> None:
    """Phase 2: what ptxas says of every form of the int8 GEMM kernel and of
    the LayerNorm + quant pass in every unit that compiles them (registers a
    thread, spills, stack; any warning, such as a serialised wgmma), and what
    the runtime says of a GEMM block (warps, stages, dynamic shared memory,
    resident blocks an SM)."""
    from duodiff_tpu_torch.ops._build import kernel_resources, load_library, ptxas_warnings

    for unit in GEMM_INT8_UNITS:
        for rec in kernel_resources(unit):
            # ..._kernelILi<epilogue>ELi<GELU>EEv... / ..._kernelILi<chunks>EEv...
            form = re.search(r"(gemm_int8_kernel|ln_quant_rows_kernel|ln_quant_rows_first_kernel)"
                             r"(?:ILi(\d+)E(?:Li(\d+)E)?)?", rec["entry"])
            if form is None:
                continue
            name = form.group(1)
            if name == "gemm_int8_kernel":
                name += (f" <{INT8_EPILOGUE_NAMES.get(form.group(2), form.group(2))}, GELU "
                         f"{GELU_NAMES.get(form.group(3), form.group(3))}>")
            elif form.group(2):
                name += f" <{form.group(2)} chunks>"
            print(f"phase 2: {name} ({unit}.cu): {rec['registers']} registers a thread, spill "
                  f"stores {rec['spill_stores']} B, spill loads {rec['spill_loads']} B, stack "
                  f"{rec['stack']} B", flush=True)
        for line in ptxas_warnings(unit):
            print(f"phase 2: ptxas on {unit}.cu: {line}", flush=True)
    lib = load_library()
    print(f"phase 2: gemm_int8: {lib.duodiff_gemm_int8_threads() // 32} warps a block (a "
          f"producer, two MMA and two epilogue warpgroups), {lib.duodiff_gemm_int8_stages()} "
          f"stages, {lib.duodiff_gemm_int8_smem_bytes()} B of dynamic shared memory, "
          f"{lib.duodiff_gemm_int8_blocks_per_sm()} blocks an SM", flush=True)


def check_gemm_int8(device, bf16_timed: dict | None = None) -> None:
    """Phase 2, the int8 GEMM alone (ops/gemm.py, the measurement entry of
    csrc/gemm_int8.cuh): against its plain version (gemm_int8_errors) at the
    eight GEMM_INT8_SHAPES at batch 8, and at GEMM_INT8_RAGGED_M x _N x _K in
    every epilogue with and without row scales; the entry must refuse K % 16
    != 0, N % 16 != 0 for int8 codes and a misaligned operand. Then at batch
    128: kernel, plain version and torch._int_mm on the same codes (the
    library yardstick, int32 out, no epilogue; the port never calls it), each
    call waited for (time_ms) and 20 back to back (burst_ms); TOP/s and the
    share of the 1,979 TOP/s peak from the back-to-back time, beside the bf16
    GEMM's TFLOP/s at the same shape (``bf16_timed``, check_gemm's record);
    the host time of one call through the wrapper and through the C entry
    alone (tensor maps included); the batch-128 numbers also as one JSON
    line."""
    from duodiff_tpu_torch.ops import gemm
    from duodiff_tpu_torch.ops._build import load_library

    def run(ops, epi, act):
        a8, b8, col, row, bias, res, inv = ops
        return gemm.gemm_int8(a8, b8, col, row, bias, res, inv, epilogue=epi, gelu=act)

    def plain(ops, epi, act):
        a8, b8, col, row, bias, res, inv = ops
        return gemm.gemm_int8_plain(a8, b8, col, row, bias, res, inv, epilogue=epi, gelu=act)

    for i, (name, width, n, k, epi, rows, act) in enumerate(GEMM_INT8_SHAPES):
        m = CHECK_BATCH * width.l
        ops = gemm_int8_operands(m, n, k, device, epi, rows, seed=i)
        max_abs, worst, ok = gemm_int8_errors(run(ops, epi, act), plain(ops, epi, act))
        print(f"phase 2: gemm_int8 {name} M={m} N={n} K={k} {epi} row_scales={rows} gelu={act}: "
              f"max_abs_err={max_abs:.6g}, worst error over bound (int8: share of flipped "
              f"codes) {worst:.4g} ok={ok}", flush=True)
        if not ok:
            fail(f"gemm_int8 {name} M={m} disagrees with its plain version")
    checked = 0
    for m in GEMM_INT8_RAGGED_M:
        for n in GEMM_INT8_RAGGED_N:
            for k in GEMM_INT8_RAGGED_K:
                for j, (epi, act) in enumerate(GEMM_INT8_FORMS):
                    for rows in (False, True):
                        ops = gemm_int8_operands(m, n, k, device, epi, rows,
                                                 seed=1000 * m + 10 * n + k + j)
                        if (j + rows) % 2:  # the bias in every other form
                            ops = ops[:4] + (None,) + ops[5:]
                        got, want = run(ops, epi, act), plain(ops, epi, act)
                        max_abs, worst, ok = gemm_int8_errors(got, want)
                        if not ok or got.dtype != want.dtype:
                            fail(f"gemm_int8 ragged M={m} N={n} K={k} {epi} row_scales={rows} "
                                 f"gelu={act}: max_abs_err={max_abs:.6g}, worst over bound "
                                 f"{worst:.4g}")
                        checked += 1
    torch.cuda.synchronize()
    print(f"phase 2: gemm_int8 ragged: M in {GEMM_INT8_RAGGED_M} x N in {GEMM_INT8_RAGGED_N} x K "
          f"in {GEMM_INT8_RAGGED_K} x {len(GEMM_INT8_FORMS)} epilogues x row scales or not, bias "
          f"every other: {checked} cases ok=True", flush=True)
    lib = load_library()
    a8, b8, col, _, _, _, inv = gemm_int8_operands(64, 64, 64, device, "gelu_quant", False, seed=7)
    c = torch.empty((64, 64), dtype=torch.int8, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream

    def entry(a_ptr, n, k, mode, inv_ptr=None):
        return lib.duodiff_gemm_int8(a_ptr, b8.data_ptr(), c.data_ptr(), None, col.data_ptr(),
                                     None, None, inv_ptr, 63, n, k, mode, 0, stream)

    refused = {
        "A 1 byte off": entry(a8.data_ptr() + 1, 64, 48, 0),
        "K = 72": entry(a8.data_ptr(), 64, 72, 0),
        "N = 56 into int8 codes": entry(a8.data_ptr(), 56, 64, 3, inv.data_ptr()),
        "int8 codes without quant_inv": entry(a8.data_ptr(), 64, 64, 3),
    }
    print("phase 2: gemm_int8 refuses " + "; ".join(
        f"{what}: error {err} ({lib.duodiff_error_string(err).decode()})"
        for what, err in refused.items()), flush=True)
    if not all(refused.values()):
        fail("the int8 GEMM entry launched on an operand it cannot take")

    timed = {}
    for i, (name, width, n, k, epi, rows, act) in enumerate(GEMM_INT8_SHAPES):
        m = MAIN_BATCH * width.l
        ops = gemm_int8_operands(m, n, k, device, epi, rows, seed=i)
        max_abs, worst, ok = gemm_int8_errors(run(ops, epi, act), plain(ops, epi, act))
        if not ok:
            fail(f"gemm_int8 {name} M={m} disagrees with its plain version")
        a8, b8, col, row, bias, res, inv = ops
        b8_t = b8.t()
        mode, out_dtype = gemm.INT8_EPILOGUES[epi]
        c = torch.empty((m, n), dtype=out_dtype, device=device)
        args = (a8.data_ptr(), b8.data_ptr(), c.data_ptr(), None if row is None else row.data_ptr(),
                col.data_ptr(), bias.data_ptr(), None if res is None else res.data_ptr(),
                None if inv is None else inv.data_ptr(), m, n, k, mode, gemm.GELU_MODES[act],
                stream)
        fns = {"kernel": lambda: run(ops, epi, act), "plain": lambda: plain(ops, epi, act),
               "library": lambda: torch._int_mm(a8, b8_t)}
        ms = time_ms(fns)
        # back to back through the C entry (~0.01 ms of host a call), so the
        # card, not the host, sets the pace; through the wrapper as well
        burst = {key: burst_ms(fns[key]) for key in ("kernel", "library")}
        burst["entry"] = burst_ms(lambda: lib.duodiff_gemm_int8(*args))
        int8_ops = 2.0 * m * n * k
        tops = int8_ops / (burst["entry"] * 1e-3) / 1e12
        host = {}
        for key, fn in (("wrapper", fns["kernel"]),
                        ("entry", lambda: lib.duodiff_gemm_int8(*args))):
            fn()
            torch.cuda.synchronize()
            tic = time.perf_counter()
            for _ in range(20):
                fn()
            host[key] = (time.perf_counter() - tic) / 20 * 1e3
            torch.cuda.synchronize()
        nbytes = (m * k + n * k + m * n * c.element_size() + 8 * n
                  + (0 if row is None else 4 * m) + (0 if res is None else 2 * m * n))
        bf16 = (bf16_timed or {}).get(name, {})
        timed[name] = {"M": m, "N": n, "K": k, "epilogue": epi, "row_scales": rows, "gelu": act,
                       "ms": ms["kernel"], "burst_ms": burst["entry"],
                       "wrapper_burst_ms": burst["kernel"], "tops": tops,
                       "peak_share": tops / (PEAK_INT8_OPS / 1e12), "plain_ms": ms["plain"],
                       "library_ms": ms["library"], "library_burst_ms": burst["library"],
                       "library_tops": int8_ops / (burst["library"] * 1e-3) / 1e12,
                       "bf16_burst_ms": bf16.get("burst_ms"), "bf16_tflops": bf16.get("tflops"),
                       "bound_ms": bound(0, int8_ops, nbytes)["bound_ms"],
                       "host_ms_wrapper": host["wrapper"], "host_ms_entry": host["entry"],
                       "max_abs_err": max_abs}
        vs_bf16 = (f"; the bf16 GEMM {bf16['burst_ms']:.6g} ms, {bf16['tflops']:.1f} TFLOP/s: "
                   f"{tops / bf16['tflops']:.3g}x its rate" if bf16 else "")
        print(f"phase 2: gemm_int8 {name} M={m} N={n} K={k} {epi}: kernel {ms['kernel']:.6g} ms "
              f"(back to back through the C entry {burst['entry']:.6g}: {tops:.1f} TOP/s, "
              f"{100 * tops / (PEAK_INT8_OPS / 1e12):.1f} % of 1979; through the wrapper "
              f"{burst['kernel']:.6g}), plain {ms['plain']:.6g} ms; "
              f"library yardstick torch._int_mm {ms['library']:.6g} ms (back to back "
              f"{burst['library']:.6g}: {timed[name]['library_tops']:.1f} TOP/s){vs_bf16}; host "
              f"time a call {host['wrapper']:.4g} ms through the wrapper, {host['entry']:.4g} ms "
              f"through the C entry (tensor maps included)", flush=True)
    print(json.dumps({"gemm_int8": timed}), flush=True)


# The LayerNorm + int8 row quant pass of K11 and K12 (csrc/quant.cuh): its
# one-read form against its first form, which stays in the measurement entry
# for this gate: the same arithmetic in the same order, so the codes and row
# scales must be equal to the bit.
def check_ln_quant(device) -> None:
    """Phase 2: ln_quant_rows at D = 512, 768 and 1024, its register limit
    (L = 257, 258, 258), batch 8 and
    128, dynamic and static (the asset's mid-block post-LN scale), against
    its first form, equal to the bit; at batch 128 both timed 20 calls back
    to back through the C entry (its host time is a fraction of the pass)
    beside the bound (bf16 read once, int8 and the row scales written
    once)."""
    from duodiff_tpu_torch.ops import gemm
    from duodiff_tpu_torch.ops._build import load_library
    from duodiff_tpu_torch.ops.block_int8 import static_inv
    from duodiff_tpu_torch.utils.int8_scales import load_int8_scales

    lib = load_library()
    stream = torch.cuda.current_stream(device).cuda_stream
    inv = static_inv(load_int8_scales(INT8_SCALES)["mid_block"], device)
    record = {}
    for width in (CELEBA, IMAGENET, IMAGENET256):
        for batch in (CHECK_BATCH, MAIN_BATCH):
            x, norm, *_ = block_modules(batch, False, seed=batch, width=width)
            x = x.reshape(-1, width.d).to(device)
            gamma = norm.weight.detach().float().to(device)
            beta = norm.bias.detach().float().to(device)
            m = x.shape[0]
            for mode, v in (("dynamic", None), ("static", inv)):
                new = gemm.ln_quant_rows(x, gamma, beta, v)
                first = gemm.ln_quant_rows(x, gamma, beta, v, first=True)
                torch.cuda.synchronize()
                same = torch.equal(new[0], first[0]) and (
                    v is not None or torch.equal(new[1], first[1]))
                line = (f"phase 2: ln_quant_rows D={width.d} M={m} {mode}: codes and row "
                        f"scales equal to the first form's to the bit: {same}")
                if batch == MAIN_BATCH:
                    x8 = torch.empty((m, width.d), dtype=torch.int8, device=device)
                    rs = torch.empty((m,), dtype=torch.float32, device=device)
                    args = (x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), x8.data_ptr(),
                            rs.data_ptr(), None if v is None else v.data_ptr(), m, width.d,
                            1e-5)
                    ms = {key: burst_ms(lambda f=f: lib.duodiff_ln_quant_rows(*args, f, stream))
                          for key, f in (("kernel", 0), ("first", 1))}
                    nbytes = 3 * m * width.d + 8 * width.d + (4 * m if v is None else 0)
                    bnd = bound(0, 0, nbytes)["bound_ms"]
                    record[f"D={width.d} {mode}"] = {"M": m, "burst_ms": ms["kernel"],
                                                     "first_burst_ms": ms["first"],
                                                     "bound_ms": bnd}
                    line += (f"; back to back {ms['kernel']:.6g} ms, the first form "
                             f"{ms['first']:.6g} ms, bound {bnd:.6g} ms (by bytes)")
                print(line, flush=True)
                if not same:
                    fail(f"ln_quant_rows D={width.d} M={m} {mode} differs from its first form")
    print(json.dumps({"ln_quant_rows": record}), flush=True)


# lengths at which a 16-row query tile, a 16-key step and the 272-key limit
# of the attention cores break
# The backward GEMMs of K6 / K7 / K8 alone: csrc/gemm.cuh in the forms
# csrc/gemm_t.cuh launches, and the MLP backward's hidden stage
# (csrc/mlp_bwd_hidden.cuh), through ops/gemm.py:gemm_t and mlp_bwd_hidden.
GEMM_T_UNITS = ("gemm_t_entry", "attn_sublayer_bwd", "mlp_sublayer_bwd", "mlp_sublayer_bwd_split")
# |kernel - plain| <= rel * |plain| + frac * max|plain| entry by entry: bf16
# outputs (dm, hgb, dhp) as the bf16 GEMM gate, one flipped rounding plus the
# order of the fp32 sums; fp32 outputs (weight gradients over up to 33,024
# rows, dxn, db1) by the order of the fp32 sums alone, ~1e-6 of the largest
# value. A missing split, slab or tile is off by the value's whole size.
GEMM_T_BOUNDS = {torch.bfloat16: (2.0**-7, 2.0**-10), torch.float32: (2.0**-12, 2.0**-12)}
# ragged cases in every form: the rows of the product (M of a K-major A, the
# contracted rows of a weight gradient) where a 128-row tile or a 64-row
# slab breaks, N = 136 / 264 / 512, and the other dimension 72 (a ragged
# 64-deep slab, or a weight gradient's ragged output tile) or 512; a weight
# gradient with the launcher's row splits and with GEMM_T_FORCED_SPLITS
GEMM_T_RAGGED_ROWS = (1, 127, 129, 2056)
GEMM_T_RAGGED_N = (136, 264, 512)
GEMM_T_RAGGED_K = (72, 512)
GEMM_T_FORCED_SPLITS = 3
GEMM_T_FORMS = {"wgrad": 0, "nt": 1, "nt_bf16": 2, "nt_acc": 3}
# row splits forced on each weight gradient at batch 128, timed beside the
# launcher's own choice (weight_grad_splits and its kSplitCostSlabs)
GEMM_T_SPLIT_SWEEP = (1, 2, 3, 4, 6, 8, 11, 16)


def gemm_t_products(width: Width, batch: int) -> list:
    """The backward products of K6 and K7 at (batch, width): (name, form, a
    shape, b shape). Forms: "wgrad" a stored (K, M), b (K, N) into fp32;
    "nt" / "nt_bf16" a (M, K), b stored (N, K) into fp32 / bf16; "hidden"
    xn and dy (M, D) with the hidden width as b's shape."""
    m, d = batch * width.l, width.d
    return [
        ("K6 dm = dy Wp^T", "nt_bf16", (m, d), (d, d)),
        ("K6 dWp = merged^T dy", "wgrad", (m, d), (m, d)),
        ("K6 dWqkv = xn^T dqkv", "wgrad", (m, d), (m, 3 * d)),
        ("K6 dxn = dqkv Wqkv^T", "nt", (m, 3 * d), (d, 3 * d)),
        ("K7 hidden stage", "hidden", (m, d), (4 * d,)),
        ("K7 dW2 = hgb^T dy", "wgrad", (m, 4 * d), (m, d)),
        ("K7 dW1 = xn^T dhp", "wgrad", (m, d), (m, 4 * d)),
        ("K7 dxn = dhp W1^T", "nt", (m, 4 * d), (d, 4 * d)),
    ]


def gemm_t_errors(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float, bool]:
    """(max abs error, largest error over its GEMM_T_BOUNDS bound, within it)."""
    rel, frac = GEMM_T_BOUNDS[got.dtype]
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        return float("inf"), float("inf"), False
    diff = (got - want).abs()
    limit = rel * want.abs() + frac * want.abs().max().clamp_min(1e-30)
    worst = (diff / limit).max().item()
    return diff.max().item(), worst, worst <= 1.0


def gemm_t_operands(form: str, a_shape, b_shape, device, seed: int):
    """bf16 a ~ N(0, 1) and b ~ N(0, 1 / K) (K the contracted length) of the
    given shapes, on the card."""
    g = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn(a_shape, generator=g, device=device).to(torch.bfloat16)
    k = a_shape[0] if form == "wgrad" else a_shape[1]
    b = torch.randn(b_shape, generator=g, device=device) * k**-0.5
    return a, b.to(torch.bfloat16)


def hidden_operands(m: int, d: int, hid: int, device, seed: int):
    """xn, W1 (D, Hd) ~ N(0, 1 / D), b1 ~ N(0, 0.1^2), dy, W2 (Hd, D) ~ N(0,
    1 / D), xn and dy (M, D) ~ N(0, 1), on the card."""
    g = torch.Generator(device=device).manual_seed(seed)
    xn = torch.randn((m, d), generator=g, device=device).to(torch.bfloat16)
    dy = torch.randn((m, d), generator=g, device=device).to(torch.bfloat16)
    w1 = (torch.randn((d, hid), generator=g, device=device) * d**-0.5).to(torch.bfloat16)
    w2 = (torch.randn((hid, d), generator=g, device=device) * d**-0.5).to(torch.bfloat16)
    b1 = torch.randn((hid,), generator=g, device=device) * 0.1
    return xn, w1, b1, dy, w2


def gemm_form(entry: str) -> str:
    """The form of a gemm_bf16_kernel instance from its mangled name
    (..._kernelILb<kTA>ELb<kTB>E<epilogue>...)."""
    form = re.search(r"gemm_bf16_kernelILb([01])ELb([01])E", entry)
    if form is None:
        return entry
    a = "A stored (K, M)" if form.group(1) == "1" else "A (M, K)"
    b = "B stored (N, K)" if form.group(2) == "1" else "B (K, N)"
    if "SplitSumEpilogue" in entry:
        pair = ", two products" if re.search(r"SplitSumEpilogueELi2E", entry) else ""
        return f"{a}, {b}, split sums{pair}"
    rows = re.search(r"RowEpilogueI(.*?)EE", entry)
    types = ", ".join("fp32" if t == "f" else "bf16"
                      for t in re.findall(r"13__nv_bfloat16|S\d*_|f", rows.group(1) if rows else ""))
    return f"{a}, {b}, rows <residual, output: {types}>"


def report_gemm_t() -> None:
    """Phase 2: what ptxas says of every form of the GEMM kernel and of the
    hidden-stage kernel in every backward unit (registers a thread, spills,
    stack; any warning, such as a serialised wgmma), and what the runtime
    says of a block of each. Fails on a spill or a warning."""
    from duodiff_tpu_torch.ops._build import kernel_resources, load_library, ptxas_warnings

    bad = []
    for unit in GEMM_T_UNITS:
        for rec in kernel_resources(unit):
            if "gemm_bf16_kernel" in rec["entry"]:
                name = f"gemm_bf16_kernel <{gemm_form(rec['entry'])}>"
            elif "mlp_bwd_hidden_kernel" in rec["entry"]:
                gelu = re.search(r"mlp_bwd_hidden_kernelILi(\d)E", rec["entry"])
                name = (f"mlp_bwd_hidden_kernel <GELU "
                        f"{GELU_NAMES.get(gelu.group(1) if gelu else '', '?')}>")
            else:
                continue
            print(f"phase 2: {name} ({unit}.cu): {rec['registers']} registers a thread, spill "
                  f"stores {rec['spill_stores']} B, spill loads {rec['spill_loads']} B, stack "
                  f"{rec['stack']} B", flush=True)
            if rec["spill_stores"] or rec["spill_loads"]:
                bad.append(f"{name} in {unit}.cu spills")
        for line in ptxas_warnings(unit):
            print(f"phase 2: ptxas on {unit}.cu: {line}", flush=True)
            bad.append(f"ptxas on {unit}.cu: {line}")
    lib = load_library()
    out = (ctypes.c_int * 8)()
    lib.duodiff_gemm_t_layout(ctypes.cast(out, ctypes.c_void_p))
    print(f"phase 2: gemm_t (gemm.cuh): {out[0] // 32} warps a block, {out[1]} stages, {out[2]} B "
          f"of dynamic shared memory, {out[3]} blocks an SM; mlp_bwd_hidden: {out[4] // 32} warps a "
          f"block, {out[5]} stages, {out[6]} B, {out[7]} blocks an SM", flush=True)
    if out[3] != 1 or out[7] != 1:
        bad.append("a backward GEMM block does not fit once an SM (the split flags need every "
                   "block of the grid resident)")
    if bad:
        fail("; ".join(bad))


def a256(n: int) -> int:
    return (n + 255) // 256 * 256


def split_slices_bytes(lib, m: int, d: int, splits: int) -> int:
    """K8's scratch when it cut the hidden width into `splits` slices (xn and
    the fp32 dxn of all rows, hgb and dhp of one slice, the slice's flags and
    db1 partials, the column-sum and LayerNorm partials), to set beside the
    row chunks' (duodiff_mlp_sublayer_bwd_split_workspace)."""
    hs, tiles = 4 * d // splits, -(-m // 128)
    return (a256(m * d * 2) + 2 * a256(m * hs * 2) + a256(m * d * 4)
            + a256(lib.duodiff_gemm_t_flag_bytes(d, hs)) + a256(tiles * hs * 4)
            + a256(-(-m // 256) * d * 4) + a256(2 * -(-m // 64) * d * 4))


def workspace_bytes(lib, width: Width, batch: int) -> dict:
    """K6's, K7's and K8's (MAIN_SPLITS chunks) scratch bytes at (width,
    batch): now, and as they were before: K6 and K7 with the split-K scratch
    the weight gradients took before their row splits summed through flags
    (the same layout with 16 fp32 partials of the largest weight gradient in
    place of the flags), K8 cutting the hidden width (split_slices_bytes)."""
    m, d = batch * width.l, width.d
    hid = 4 * d
    now = {"K6": lib.duodiff_attn_sublayer_bwd_workspace(batch, width.l, d, width.heads),
           "K7": lib.duodiff_mlp_sublayer_bwd_workspace(m, d, hid),
           "K8": lib.duodiff_mlp_sublayer_bwd_split_workspace(m, d, hid, MAIN_SPLITS)}
    flags = {"K6": max(lib.duodiff_gemm_t_flag_bytes(d, 3 * d), lib.duodiff_gemm_t_flag_bytes(d, d)),
             "K7": lib.duodiff_gemm_t_flag_bytes(d, hid)}
    partials = {"K6": 16 * 3 * d * d * 4, "K7": 16 * d * hid * 4}
    before = {k: now[k] - a256(flags[k]) + a256(partials[k]) for k in flags}
    before["K8"] = split_slices_bytes(lib, m, d, MAIN_SPLITS)
    return {k: {"now": now[k], "before": before[k]} for k in now}


def check_gemm_t(device) -> dict:
    """Phase 2, the backward GEMMs alone (ops/gemm.py:gemm_t and
    mlp_bwd_hidden, the measurement entry csrc/gemm_t_entry.cu): against
    their plain versions (gemm_t_errors) at the eight products of
    gemm_t_products at batch 8 at both widths, and at GEMM_T_RAGGED_ROWS x
    _N x _K in every form (the hidden stage's hgb, dhp and db1 with exact
    and tanh GELU in turn); a repeat call equal to the bit; the refusals of
    N % 8, M % 8 with a stored (K, M) A, K % 8 and a misaligned operand; the
    workspace bytes of K6, K7, K8 before and after. Then at batch 128 each
    product back to back through the C entry, call by call through the
    wrapper, beside torch.matmul on the same transposed views (the library
    yardstick, no epilogue; the port never calls it) and the forward GEMM
    on packed operands of the same (M, N, K) (the hidden stage: fc1's form,
    bias and exact GELU), each weight gradient also with the row splits of
    GEMM_T_SPLIT_SWEEP forced; one JSON line {"gemm_t": ...}."""
    from duodiff_tpu_torch.ops import gemm
    from duodiff_tpu_torch.ops._build import load_library

    lib = load_library()
    stream = torch.cuda.current_stream(device).cuda_stream

    def run(form, a, b, out=None, splits=0):
        if form == "wgrad":
            return gemm.gemm_t(a, b, trans_a=True, splits=splits)
        return gemm.gemm_t(a, b, trans_a=False, out=out,
                           out_dtype=torch.bfloat16 if form == "nt_bf16" else torch.float32)

    def plain(form, a, b, out=None):
        if form == "wgrad":
            return gemm.gemm_t_plain(a, b, trans_a=True)
        return gemm.gemm_t_plain(a, b, trans_a=False, out=out,
                                 out_dtype=torch.bfloat16 if form == "nt_bf16" else torch.float32)

    def hidden_check(ops, act, label):
        got, want = gemm.mlp_bwd_hidden(*ops, gelu=act), gemm.mlp_bwd_hidden_plain(*ops, gelu=act)
        worst = 0.0
        for what, g, w in zip(("hgb", "dhp", "db1"), got, want):
            max_abs, over, ok = gemm_t_errors(g, w)
            worst = max(worst, over)
            if not ok or g.dtype != w.dtype:
                fail(f"mlp_bwd_hidden {label} gelu={act}: {what} max_abs_err={max_abs:.6g}, worst "
                     f"over bound {over:.4g}")
        return worst

    for width in (CELEBA, IMAGENET):
        for i, (name, form, a_shape, b_shape) in enumerate(gemm_t_products(width, CHECK_BATCH)):
            label = f"{name} D={width.d} M={a_shape[0]}"
            if form == "hidden":
                m, d = a_shape
                worst = hidden_check(hidden_operands(m, d, b_shape[0], device, seed=i), "erf",
                                     label)
                print(f"phase 2: gemm_t {label} Hd={b_shape[0]}: hgb, dhp, db1 worst error over "
                      f"bound {worst:.4g} ok=True", flush=True)
                continue
            a, b = gemm_t_operands(form, a_shape, b_shape, device, seed=i)
            got = run(form, a, b)
            again = run(form, a, b)
            max_abs, worst, ok = gemm_t_errors(got, plain(form, a, b))
            same = torch.equal(got, again)
            print(f"phase 2: gemm_t {label} {form} a {tuple(a.shape)} b {tuple(b.shape)}: "
                  f"max_abs_err={max_abs:.6g}, worst error over bound {worst:.4g} (bound "
                  f"{GEMM_T_BOUNDS[got.dtype]}), repeat equal={same} ok={ok and same}", flush=True)
            if not (ok and same):
                fail(f"gemm_t {label} disagrees with its plain version or is not deterministic")
    checked = 0
    for rows in GEMM_T_RAGGED_ROWS:
        for n in GEMM_T_RAGGED_N:
            for k in GEMM_T_RAGGED_K:
                seed = 1000 * rows + 10 * n + k
                cases = {"nt": ((rows, k), (n, k)), "nt_bf16": ((rows, k), (n, k)),
                         "nt_acc": ((rows, k), (n, k)), "wgrad": ((rows, k), (rows, n))}
                for form, (a_shape, b_shape) in cases.items():
                    a, b = gemm_t_operands(form, a_shape, b_shape, device, seed)
                    outs = [(0, None)]
                    if form == "wgrad":
                        outs.append((GEMM_T_FORCED_SPLITS, None))
                    if form == "nt_acc":
                        g = torch.Generator(device=device).manual_seed(seed + 1)
                        outs = [(0, torch.randn((rows, n), generator=g, device=device))]
                    for splits, out in outs:
                        kind = "nt" if form == "nt_acc" else form
                        want = plain(kind, a, b, None if out is None else out.clone())
                        got = run(kind, a, b, out, splits)
                        max_abs, worst, ok = gemm_t_errors(got, want)
                        if not ok:
                            fail(f"gemm_t ragged {form} a {a_shape} b {b_shape} splits={splits}: "
                                 f"max_abs_err={max_abs:.6g}, worst over bound {worst:.4g}")
                        checked += 1
                act = "tanh" if (n + k) % 2 else "erf"
                hidden_check(hidden_operands(rows, k, n, device, seed), act,
                             f"ragged M={rows} D={k} Hd={n}")
                checked += 1
    torch.cuda.synchronize()
    print(f"phase 2: gemm_t ragged: rows in {GEMM_T_RAGGED_ROWS} x N in {GEMM_T_RAGGED_N} x K in "
          f"{GEMM_T_RAGGED_K}, forms {sorted(GEMM_T_FORMS)} (weight gradients also with "
          f"{GEMM_T_FORCED_SPLITS} splits) and the hidden stage: {checked} cases ok=True",
          flush=True)
    xn, w1, b1, dy, w2 = hidden_operands(CHECK_BATCH * CELEBA.l, CELEBA.d, 4 * CELEBA.d, device, 3)
    first, again = gemm.mlp_bwd_hidden(xn, w1, b1, dy, w2), gemm.mlp_bwd_hidden(xn, w1, b1, dy, w2)
    if not all(torch.equal(p, q) for p, q in zip(first, again)):
        fail("mlp_bwd_hidden is not deterministic")

    a, b = gemm_t_operands("wgrad", (64, 64), (64, 64), device, seed=7)
    c = torch.empty((64, 64), dtype=torch.float32, device=device)
    flags = torch.zeros(64, dtype=torch.int32, device=device)

    def entry(a_ptr, m, n, k, form):
        return lib.duodiff_gemm_t(a_ptr, b.data_ptr(), c.data_ptr(), flags.data_ptr(), m, n, k,
                                  form, 0, stream)

    refused = {
        "N = 60": entry(a.data_ptr(), 64, 60, 64, 1),
        "M = 60 with A stored (K, M)": entry(a.data_ptr(), 60, 64, 64, 0),
        "K = 60 read along K": entry(a.data_ptr(), 64, 64, 60, 1),
        "A 2 bytes off": entry(a.data_ptr() + 2, 64, 64, 56, 0),
        "hidden stage with D = 60": lib.duodiff_mlp_bwd_hidden(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), a.data_ptr(), b.data_ptr(), a.data_ptr(),
            b.data_ptr(), c.data_ptr(), c.data_ptr(), 8, 60, 64, 1, stream),
    }
    print("phase 2: gemm_t refuses " + "; ".join(
        f"{what}: error {err} ({lib.duodiff_error_string(err).decode()})"
        for what, err in refused.items()), flush=True)
    if not all(refused.values()):
        fail("the backward GEMM entry launched on an operand it cannot take")
    for width in (CELEBA, IMAGENET):
        ws = workspace_bytes(lib, width, MAIN_BATCH)
        print(f"phase 2: scratch at D={width.d} B={MAIN_BATCH} (K8 at {MAIN_SPLITS} chunks), MiB: "
              + "; ".join(f"{k} {v['now'] / 2**20:.6g} ("
                          + ("by hidden slices" if k == "K8" else "with 16 fp32 partials")
                          + f": {v['before'] / 2**20:.6g})" for k, v in ws.items()), flush=True)

    timed = {}
    for width in (CELEBA, IMAGENET):
        for i, (name, form, a_shape, b_shape) in enumerate(gemm_t_products(width, MAIN_BATCH)):
            key = f"{name} D={width.d}"
            if form == "hidden":
                m, d = a_shape
                hid = b_shape[0]
                ops = hidden_operands(m, d, hid, device, seed=i)
                xn, w1, b1, dy, w2 = ops
                worst = hidden_check(ops, "erf", key)
                outs = [torch.empty((m, hid), dtype=torch.bfloat16, device=device) for _ in range(2)]
                db1 = torch.empty(hid, device=device)
                part = torch.empty(lib.duodiff_mlp_bwd_hidden_part_bytes(m, hid),
                                   dtype=torch.uint8, device=device)
                args = (xn.data_ptr(), w1.data_ptr(), b1.data_ptr(), dy.data_ptr(), w2.data_ptr(),
                        outs[0].data_ptr(), outs[1].data_ptr(), db1.data_ptr(), part.data_ptr(),
                        m, d, hid, 1, stream)
                fns = {"kernel": lambda: gemm.mlp_bwd_hidden(*ops),
                       "plain": lambda: gemm.mlp_bwd_hidden_plain(*ops),
                       "library": lambda: (torch.matmul(xn, w1), torch.matmul(dy, w2.t()))}
                entry_fn = lambda: lib.duodiff_mlp_bwd_hidden(*args)  # noqa: E731
                fwd = (xn, w1, b1, "erf")
                flops, m_, n_, k_ = 4.0 * m * hid * d, m, hid, d
                nbytes = 2 * (2 * m * d + 2 * d * hid + 2 * m * hid) + 4 * hid * (1 + (m + 127) // 128)
                max_abs = worst
            else:
                a, b = gemm_t_operands(form, a_shape, b_shape, device, seed=i)
                got = run(form, a, b)
                max_abs, worst, ok = gemm_t_errors(got, plain(form, a, b))
                if not ok:
                    fail(f"gemm_t {key} disagrees with its plain version")
                if form == "wgrad":
                    (k_, m_), n_ = a.shape, b.shape[1]
                    lib_fn = lambda a=a, b=b: torch.matmul(a.t(), b)  # noqa: E731
                    fwd = (a.t().contiguous(), b, None, "none")
                else:
                    (m_, k_), n_ = a.shape, b.shape[0]
                    lib_fn = lambda a=a, b=b: torch.matmul(a, b.t())  # noqa: E731
                    fwd = (a, b.t().contiguous(), None, "none")
                c = torch.empty((m_, n_), dtype=got.dtype, device=device)
                fl = torch.empty(lib.duodiff_gemm_t_flag_bytes(m_, n_), dtype=torch.uint8,
                                 device=device)
                args = (a.data_ptr(), b.data_ptr(), c.data_ptr(), fl.data_ptr(), m_, n_, k_,
                        GEMM_T_FORMS[form], 0, stream)
                fns = {"kernel": lambda a=a, b=b, form=form: run(form, a, b),
                       "plain": lambda a=a, b=b, form=form: plain(form, a, b), "library": lib_fn}
                entry_fn = lambda args=args: lib.duodiff_gemm_t(*args)  # noqa: E731
                flops = 2.0 * m_ * n_ * k_
                nbytes = 2 * (m_ * k_ + k_ * n_) + m_ * n_ * got.element_size()
            ms = time_ms(fns)
            burst = {"entry": burst_ms(entry_fn), "library": burst_ms(fns["library"])}
            fa, fb, fbias, fact = fwd
            fc = torch.empty((fa.shape[0], fb.shape[1]), dtype=torch.bfloat16, device=device)
            burst["forward"] = burst_ms(lambda: lib.duodiff_gemm_bf16(
                fa.data_ptr(), fb.data_ptr(), fc.data_ptr(),
                None if fbias is None else fbias.data_ptr(), None, fa.shape[0], fb.shape[1],
                fa.shape[1], gemm.GELU_MODES[fact], 0, 0, stream))
            tflops = {k: flops / (v * 1e-3) / 1e12 for k, v in burst.items()}
            splits = lib.duodiff_gemm_t_splits(m_, n_, k_) if form == "wgrad" else None
            sweep = None
            if form == "wgrad":
                sweep = {n_s: burst_ms(lambda n_s=n_s, args=args: lib.duodiff_gemm_t(
                    *args[:8], n_s, stream)) for n_s in GEMM_T_SPLIT_SWEEP}
                print(f"phase 2: gemm_t {key} back to back by forced row splits, ms: "
                      + ", ".join(f"{n_s}: {t:.6g}" for n_s, t in sweep.items())
                      + f" (the launcher takes {splits})", flush=True)
            timed[key] = {"form": form, "M": m_, "N": n_, "K": k_, "splits": splits,
                          "split_sweep_ms": sweep,
                          "ms": ms["kernel"], "burst_ms": burst["entry"],
                          "tflops": tflops["entry"],
                          "peak_share": tflops["entry"] / (PEAK_BF16_FLOPS / 1e12),
                          "plain_ms": ms["plain"], "library_ms": ms["library"],
                          "library_burst_ms": burst["library"],
                          "library_tflops": tflops["library"],
                          "forward_burst_ms": burst["forward"],
                          "forward_tflops": tflops["forward"],
                          "bound_ms": bound(flops, 0, nbytes)["bound_ms"], "max_abs_err": max_abs}
            print(f"phase 2: gemm_t {key} ({form}, M={m_} N={n_} K={k_}"
                  f"{'' if splits is None else f', {splits} row splits'}): back to back through "
                  f"the C entry {burst['entry']:.6g} ms ({tflops['entry']:.1f} TFLOP/s, "
                  f"{100 * tflops['entry'] / (PEAK_BF16_FLOPS / 1e12):.1f} % of 989), call by "
                  f"call {ms['kernel']:.6g} ms, plain {ms['plain']:.6g} ms; library yardstick "
                  f"torch.matmul {burst['library']:.6g} ms back to back "
                  f"({tflops['library']:.1f} TFLOP/s){' (two calls, no epilogue)' if form == 'hidden' else ''}; "
                  f"the forward GEMM on packed operands of the same shape "
                  f"{burst['forward']:.6g} ms ({tflops['forward']:.1f} TFLOP/s)", flush=True)
    print(json.dumps({"gemm_t": timed}), flush=True)
    return timed


RAGGED_LENGTHS = (1, 63, 64, 65, 129, 257, 272)
NORM_FIRST_LENGTHS = (65, 257)


def report_attention_cores() -> None:
    """Phase 2: what the compiler and the runtime say of the two redesigned
    attention cores: registers a thread and spills of each kernel (ptxas),
    warps a block, dynamic shared memory and resident blocks an SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor) at both main lengths."""
    from duodiff_tpu_torch.ops._build import kernel_resources, load_library

    names = {"attn_core_kernelILb0": "forward core", "attn_core_kernelILb1": "forward core, "
             "normalise first", "attn_bwd_q_kernel": "backward core, row launch",
             "attn_bwd_kv_kernel": "backward core, key launch"}
    for unit in ("flash_attention", "attn_sublayer_v1", "flash_attention_bwd"):
        for rec in kernel_resources(unit):
            what = next((v for k, v in names.items() if k in rec["entry"]), None)
            if what is None or (unit == "attn_sublayer_v1" and "Lb1" not in rec["entry"]):
                continue
            # the cores are compiled once for each class of sequence length
            # (SeqClass<tiles of 8 keys, first masked tile> in attn_tiles.cuh)
            tiles = re.search(r"SeqClassILi(\d+)", rec["entry"])
            if tiles:
                what += f", up to {8 * int(tiles.group(1))} keys"
            print(f"phase 2: {what} ({unit}.cu): {rec['registers']} registers a thread, "
                  f"spill stores {rec['spill_stores']} B, spill loads {rec['spill_loads']} B, "
                  f"stack {rec['stack']} B", flush=True)
    lib = load_library()
    for l in (CELEBA.l, IMAGENET.l):
        fwd = (lib.duodiff_attn_core_warps(), lib.duodiff_attn_core_smem_bytes(l),
               lib.duodiff_attn_core_blocks_per_sm(l))
        row, key = ((lib.duodiff_attn_bwd_core_warps(k), lib.duodiff_attn_bwd_core_smem_bytes(l, k),
                     lib.duodiff_attn_bwd_core_blocks_per_sm(l, k)) for k in (0, 1))
        print(f"phase 2: L={l}: forward core {fwd[0]} warps a block, {fwd[1]} B of shared "
              f"memory, {fwd[2]} blocks an SM; backward row launch {row[0]} warps, {row[1]} B, "
              f"{row[2]} blocks an SM; backward key launch {key[0]} warps, {key[1]} B, "
              f"{key[2]} blocks an SM", flush=True)
        if min(fwd[0] * fwd[2], row[0] * row[2], key[0] * key[2]) < 8:
            fail(f"an attention core holds fewer than eight warps an SM at L={l}")


def check_ragged_attention(device, results: dict) -> None:
    """Phase 2, ragged lengths, untimed, at batch 8: K9 and K10 against their
    plain versions at RAGGED_LENGTHS with the bounds of
    check_attention_kernels (K10 also equal to the bit on a repeat call),
    and the per-head sublayer K1-v1, whose core normalises before the value
    product, against its plain version at NORM_FIRST_LENGTHS."""
    from duodiff_tpu_torch.ops import block
    from duodiff_tpu_torch.ops import flash_attention as fa

    b, h = CHECK_BATCH, 2
    for l in RAGGED_LENGTHS:
        g = torch.Generator().manual_seed(1000 + l)
        q, k, v, do = (torch.randn((b, h, l, 64), generator=g).to(torch.bfloat16).to(device)
                       for _ in range(4))
        max_abs, limit, rel, ok = scaled_errors(fa.flash_attention(q, k, v),
                                                fa.flash_attention_plain(q, k, v),
                                                KERNEL_MAX_FRAC)
        got = fa.flash_attention_bwd(q, k, v, do)
        again = fa.flash_attention_bwd(q, k, v, do)
        want = fa.flash_attention_bwd_plain(q, k, v, do)
        torch.cuda.synchronize()
        same = all(torch.equal(a, c) for a, c in zip(got, again))
        # at L = 1 the softmax is 1 and dq, dk are exact zeros: equal tensors
        # count as error 0 where the relative error would be 0 / 0
        rels = {n: 0.0 if torch.equal(a, w) else rel_fro(a, w)
                for n, a, w in zip(("dq", "dk", "dv"), got, want)}
        bwd_ok = same and max(rels.values()) <= BWD_REL_FRO
        print(f"phase 2: ragged B={b} H={h} L={l}: flash_attention max_abs_err={max_abs:.6g} "
              f"(bound {limit:.6g}) rel_fro_err={rel:.6g} (bound {FWD_REL_FRO}) ok={ok}; "
              f"flash_attention_bwd rel_fro_err "
              f"{', '.join(f'{n}={x:.3g}' for n, x in rels.items())} (bound {BWD_REL_FRO}) "
              f"repeat_equal={same} ok={bwd_ok}", flush=True)
        if not (ok and bwd_ok):
            fail(f"K9 or K10 disagrees with its plain version at L={l}")
        res = results["flash_attention"]
        res["max_abs_err"] = max(res.get("max_abs_err", 0.0), max_abs)
        res = results["flash_attention_bwd"]
        res["max_rel_fro_err"] = max(res.get("max_rel_fro_err", 0.0), max(rels.values()))
    for l in NORM_FIRST_LENGTHS:
        width = Width(l, CELEBA.d, CELEBA.heads)
        x, norm, qkv, proj, _, _ = block_modules(b, True, width=width)
        x = x.to(device)
        v1 = to_device(block.pack_attn_v1(norm, qkv, proj, dtype=torch.bfloat16), device)
        got = block.fused_attn_sublayer(x, *v1, num_heads=width.heads, variant="v1")
        torch.cuda.synchronize()
        max_abs, max_rel, ok = errors(got, block.attn_sublayer_v1_plain(x, *v1,
                                                                        num_heads=width.heads))
        print(f"phase 2: ragged fused_attn_sublayer_v1 D={width.d} L={l} B={b}: "
              f"max_abs_err={max_abs:.6g} max_rel_err={max_rel:.6g} "
              f"bound={ATOL}+{RTOL}*|plain| ok={ok}", flush=True)
        if not ok:
            fail(f"K1-v1 disagrees with its plain version at L={l}")
        res = results["fused_attn_sublayer_v1"]
        res["max_abs_err"] = max(res.get("max_abs_err", 0.0), max_abs)


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
                      "bf16": lambda: sdpa_int8.sdpa_chain_bf16(qq, kk, vv),
                      "plain": lambda: sdpa_int8.sdpa_chain_int8_plain(qq, kk, vv),
                      "library": lambda: F.scaled_dot_product_attention(qq, kk, vv, scale=1.0)})
        burst = {"int8": burst_ms(lambda: sdpa_int8.sdpa_chain_int8(qq, kk, vv)),
                 "bf16": burst_ms(lambda: sdpa_int8.sdpa_chain_bf16(qq, kk, vv))}
        ok = same and rel <= FWD_REL_FRO and from_bf16 <= SDPA_INT8_REL
        print(f"phase 2: K15 sdpa_chain_int8 {label}: rel_fro_err={rel:.6g} (bound {FWD_REL_FRO}) "
              f"max_abs_err={max_abs:.6g} repeat_equal={same} rel l2 from the bf16 form "
              f"{from_bf16:.6g} (bound {SDPA_INT8_REL}) ok={ok} kernel_ms={ms['kernel']:.6g} "
              f"plain_ms={ms['plain']:.6g}; in turns beside the bf16 form {ms['bf16']:.6g} ms "
              f"({ms['kernel'] / ms['bf16']:.4g} x); back to back int8 {burst['int8']:.6g}, bf16 "
              f"{burst['bf16']:.6g} ms ({burst['int8'] / burst['bf16']:.4g} x); library yardstick "
              f"F.scaled_dot_product_attention(scale=1) {ms['library']:.6g} ms", flush=True)
        if not ok:
            fail(f"K15 sdpa_chain_int8 {label} disagrees with its plain version, with the bf16 "
                 "form, or is not deterministic")
        res = results["sdpa_chain_int8"]
        res["max_abs_err"] = max(res.get("max_abs_err", 0.0), max_abs)
        res["max_rel_fro_err"] = max(res.get("max_rel_fro_err", 0.0), rel)
        if timed:
            keep_times(res, ms, "")
            res["rel_l2_from_bf16"] = from_bf16
            res["bf16_ms_in_turns"] = ms["bf16"]
            res["back_to_back_ms"] = burst["int8"]
            res["library_ms"] = results["sdpa_chain_bf16"]["library_ms"] = ms["library"]


# K15's int8 form at ragged lengths (batch 8, 8 heads): every class of the
# core's tile count, its edges, and the longest length it takes
RAGGED_INT8_LENGTHS = (1, 37, 63, 64, 65, 129, 257, 272)


def report_int8_chain() -> None:
    """Phase 2: what ptxas and the occupancy call say of K15's int8 core
    (registers, spills, warps, shared memory and blocks an SM at the probe's
    length and the longest). Fails on a spill, a ptxas warning, or fewer
    than eight warps an SM."""
    from duodiff_tpu_torch.ops._build import kernel_resources, load_library, ptxas_warnings

    bad = []
    for rec in kernel_resources("sdpa_int8"):
        if "attn_core_int8_kernel" not in rec["entry"]:
            continue
        tiles = re.search(r"SeqClassILi(\d+)", rec["entry"])
        keys = f"up to {8 * int(tiles.group(1))} keys" if tiles else rec["entry"]
        print(f"phase 2: K15 int8 core, {keys} (sdpa_int8.cu): {rec['registers']} registers a "
              f"thread, spill stores {rec['spill_stores']} B, spill loads {rec['spill_loads']} B, "
              f"stack {rec['stack']} B", flush=True)
        if rec["spill_stores"] or rec["spill_loads"]:
            bad.append(f"the int8 core ({keys}) spills")
    for line in ptxas_warnings("sdpa_int8"):
        print(f"phase 2: ptxas on sdpa_int8.cu: {line}", flush=True)
        bad.append(f"ptxas on sdpa_int8.cu: {line}")
    lib = load_library()
    for l in (CELEBA.l, lib.duodiff_sdpa_int8_max_len()):
        warps, smem = lib.duodiff_sdpa_int8_warps(), lib.duodiff_sdpa_int8_smem_bytes(l)
        blocks = lib.duodiff_sdpa_int8_blocks_per_sm(l)
        print(f"phase 2: K15 int8 core at L={l}: {warps} warps a block, {smem} B of shared memory, "
              f"{blocks} blocks an SM", flush=True)
        if warps * blocks < 8:
            bad.append(f"the int8 core holds fewer than eight warps an SM at L={l}")
    if bad:
        fail("; ".join(bad))


def check_ragged_int8_chain(device, results: dict) -> None:
    """Phase 2, K15's int8 form at RAGGED_INT8_LENGTHS, untimed, batch 8, 8
    heads: within FWD_REL_FRO of its plain version, equal to the bit on a
    repeat call and within SDPA_INT8_REL of the bf16 form, as
    check_probe_kernels holds it at the probe's length."""
    from duodiff_tpu_torch.ops import sdpa_int8

    b, h = CHECK_BATCH, 8
    res = results["sdpa_chain_int8"]
    for l in RAGGED_INT8_LENGTHS:
        g = torch.Generator().manual_seed(2000 + l)
        qq, kk, vv = (torch.randn((b, h, l, 64), generator=g).to(torch.bfloat16).to(device)
                      for _ in range(3))
        got = sdpa_int8.sdpa_chain_int8(qq, kk, vv)
        again = sdpa_int8.sdpa_chain_int8(qq, kk, vv)
        torch.cuda.synchronize()
        same = torch.equal(got, again)
        want = sdpa_int8.sdpa_chain_int8_plain(qq, kk, vv)
        rel, max_abs = rel_fro(got, want), errors(got, want)[0]
        from_bf16 = rel_fro(got, sdpa_int8.sdpa_chain_bf16(qq, kk, vv))
        ok = same and rel <= FWD_REL_FRO and from_bf16 <= SDPA_INT8_REL
        print(f"phase 2: ragged K15 sdpa_chain_int8 B={b} H={h} L={l}: rel_fro_err={rel:.6g} "
              f"(bound {FWD_REL_FRO}) max_abs_err={max_abs:.6g} repeat_equal={same} rel l2 from "
              f"the bf16 form {from_bf16:.6g} (bound {SDPA_INT8_REL}) ok={ok}", flush=True)
        if not ok:
            fail(f"K15 sdpa_chain_int8 at L={l} disagrees with its plain version, with the bf16 "
                 "form, or is not deterministic")
        res["max_abs_err"] = max(res.get("max_abs_err", 0.0), max_abs)
        res["max_rel_fro_err"] = max(res.get("max_rel_fro_err", 0.0), rel)


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
    from duodiff_tpu_torch.tools._measure import reset_launch_counts

    reset_launch_counts()


def read_counts() -> dict:
    from duodiff_tpu_torch.tools._measure import launch_counts

    return launch_counts()


def run_cli(label: str, extra: list, card: str, expected: dict,
            configs=(EARLY_CONFIG, LATE_CONFIG), batch: int = MAIN_BATCH,
            check_output=None, t_switch: int | None = T_SWITCH, image_size: int = 64,
            steps: int | None = None, random_init: bool = True) -> dict:
    """One run of the sampling CLI over the 1000-step schedule, in-process,
    with every launch counter set to 0 just before and read just after;
    checks the samples and that the counts equal ``expected`` (unlisted
    kernels: 0). By default the DuoDiff pair with ``--t_switch``; one config
    samples one model, ``t_switch=None`` passes the pair without it (heavy-light
    interleaving). ``check_output(folder, result)`` looks at the files before
    they go. ``image_size`` is the side of the images written (a latent
    config's decoded ones). ``random_init=False`` with a ``--checkpoint_path``
    in ``extra`` samples a trained model."""
    from duodiff_tpu_torch import sample

    with tempfile.TemporaryDirectory() as out:
        argv = ["--config_path", configs[0]]
        if len(configs) > 1:
            argv += ["--config_path_late", configs[1]]
        if t_switch is not None:
            argv += ["--t_switch", str(t_switch)]
        argv += [
            *["--random_init"] * random_init,
            "--num_timesteps", str(steps or STEPS), "--batch_size", str(batch),
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
    decoded = (f", decode {result['decode_seconds']:.6g} s" if result["decode_seconds"]
               else "")
    print(f"{label} batch {batch}: sampling {result['seconds']:.6g} s, "
          f"{batch / result['seconds']:.6g} samples/s{decoded}, CLI wall {wall:.6g} s, "
          f"launches {launches} (expected {expected}), card {card}", flush=True)
    shape = (batch, image_size, image_size, 3)
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


def run_int8_main_path(card: str, schedule: str = CACHE_SCHEDULE, scales: str = INT8_SCALES,
                       phase: str = "phase 4b") -> dict:
    """Phase 4b: the headline composition through the sampling CLI: depth 3
    with dynamic int8 for t = 999..700, then depth 13 with the asset's
    static MLP scales, block-cached on the committed anchor schedule,
    tanh GELU (phase 10f: on the schedule and scales phase 10 made). The
    expected counts follow from the schedule: the late segment anchors its
    listed steps below the handoff plus its first step and runs 2 * n_outer
    blocks on every other step."""
    from duodiff_tpu_torch.diffusion.cache_schedule import load_cache_schedule

    table = load_cache_schedule(schedule, num_timesteps=STEPS)
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
        f"{phase}: DuoDiff {STEPS} steps int8 (depth 3 x {T_SWITCH} dynamic scales, "
        f"depth 13 x {handoff} static scales, block-cached: {anchors} anchored, "
        f"{handoff - anchors} cached at n_outer {N_OUTER}), tanh GELU",
        ["--attn_impl", "fused_int8", "--int8_scales_late", scales,
         "--cache_schedule", schedule, "--gelu_approx"],
        card, expected,
    )


def profile_sampling_steps(device, card: str, int8: bool) -> None:
    """One reverse step's model call of the depth-13 CelebA-64 model at batch
    128, timed with CUDA events and profiled by kernel: the bf16 dense
    forward (phase 4), or the int8 model's anchored and cached forwards
    with the asset's static scales (phase 4b)."""
    from duodiff_tpu_torch.utils.model_loading import load_model

    if int8:
        model, cfg = load_model(LATE_CONFIG, device=device, seed=1, attn_impl="fused_int8",
                                gelu_approx=True, int8_scales=INT8_SCALES)
    else:
        model, cfg = load_model(LATE_CONFIG, device=device, seed=1, attn_impl="fused",
                                dtype=torch.bfloat16)
    model.eval().pack_for_kernels()
    g = torch.Generator().manual_seed(7)
    x = torch.randn((MAIN_BATCH, cfg.img_size, cfg.img_size, cfg.in_chans), generator=g).to(device)
    t = torch.full((MAIN_BATCH,), 350.0, device=device)
    with torch.inference_mode():
        if int8:
            delta = model.forward_anchor(x, t, n_outer=N_OUTER)[1]
            steps = {
                "int8 anchored step (13 blocks)":
                    lambda: model.forward_anchor(x, t, n_outer=N_OUTER),
                f"int8 cached step ({2 * N_OUTER} blocks)":
                    lambda: model.forward_cached(x, t, n_outer=N_OUTER, delta=delta),
            }
            phase = "phase 4b"
        else:
            steps, phase = {"bf16 dense step (13 blocks)": lambda: model(x, t)}, "phase 4"
        for what, step in steps.items():
            ms = time_ms({"step": step}, reps=5)["step"]
            print(f"{phase}: one {what} at batch {MAIN_BATCH} (CUDA events, median of 5): "
                  f"{ms:.6g} ms; card {card}", flush=True)
            profile_steps(f"{phase}, {what}", step)
    del model
    release_memory()


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
    own = {}  # the port's kernels by function name, template arguments dropped
    for name, us in kernels.items():
        found = re.search(r"duodiff::\(anonymous namespace\)::(\w+)", name)
        if found:
            own[found.group(1)] = own.get(found.group(1), 0.0) + us
    print(f"{label}: profiler over {n} steps: device busy {busy / 1e3:.6g} ms of "
          f"{window_us / 1e3:.6g} ms, idle share {1 - busy / window_us:.6g}; families: "
          + "; ".join(f"{k} {v / busy:.4f}" for k, v in by_size(families))
          + (f" (other: {', '.join(others)})" if others else "")
          + "; largest kernels: "
          + "; ".join(f"{k[:60]} {v / busy:.4f}" for k, v in by_size(kernels)[:10])
          + "; own kernels by name: "
          + "; ".join(f"{k} {v / busy:.4f}" for k, v in by_size(own)), flush=True)


def profile_train_step(trainer, card: str, phase: str) -> dict:
    """One training step of the trainer's model (:func:`profile_step_fn`) on
    its loader's next batch and the draws of step 1."""
    step_fn = trainer._train_step
    batch = trainer._to_device(trainer.dataloader.next_batch())
    trainer.dataloader.close()
    draws = (*step_fn.draws(batch, 1), step_fn.drop_mask(batch, 1))
    return profile_step_fn(step_fn, trainer.state, trainer.model, batch, draws, card, phase)


def profile_step_fn(step_fn, state, model, batch, draws, card: str, phase: str) -> dict:
    """One training step (``make_train_step``'s function) split into
    forward, backward and optimizer with CUDA events (medians of 5), then
    :func:`profile_steps` over 3 steps. Returns the medians in ms."""
    model.train()
    params = list(model.parameters())
    batch_size = batch["image"].shape[0]

    def one_step():
        events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        for p in params:
            p.grad = None
        events[0].record()
        loss, _ = step_fn.loss_fn(batch, *draws)
        events[1].record()
        loss.backward()
        events[2].record()
        step_fn.update(state, [p.grad for p in params])
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
    print(f"{phase}: one train step at batch {batch_size} (CUDA events, median of 5): "
          f"forward {ms['forward']:.6g} ms, backward {ms['backward']:.6g} ms, optimizer + EMA "
          f"{ms['optimizer']:.6g} ms, step {ms['step']:.6g} ms; card {card}", flush=True)
    profile_steps(phase, one_step)
    return ms


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
    for shape in ("imagenet64", "imagenet256"):  # D = 768, then D = 1024
        probe = probe_mlp_bwd_split.main([shape, *map(str, SPLITS)])
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


DDIM_STEPS = 50           # sampler.py's --ddim_steps default
DDIM_CHECK_STEPS = 10
DPM_STEPS = 20            # sampler.py's --dpm_steps default
DPM_CACHE_EVERY = 2
INTERLEAVE_EVERY = 4
DERIVE_ANCHORS = 80       # the committed schedule's meta: num_anchors<=80, batch 128
CALIB_BATCH = 16          # the committed scales' meta: search 99.5, 99.9, margin 1.1
CALIB_GRID = "99.5,99.9"
CALIB_MARGIN = 1.1


def check_ddim(device) -> None:
    """Phase 10a's gate: a short DDIM DuoDiff run at eta 0, batch 8, the
    kernels against their plain versions from one x_init. It is held as the
    guided trajectory is, by relative Frobenius error (FWD_REL_FRO) and
    entry by entry against the largest value (MODEL_MAX_FRAC), not by 0.05 +
    0.05 |plain|: on random weights the eta-0 trajectory extrapolates its
    x0 prediction to values in the hundreds (max 734, mean 139), and two
    plain bf16 routes of the port (``plain`` and the unfused ``xla``) already
    differ by up to 2.1 there, 2.7 % of the entries past that bound, at
    2.6e-3 relative Frobenius (CPU, batch 2)."""
    from duodiff_tpu_torch.diffusion.sampling import ddim_sample
    from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
    from duodiff_tpu_torch.utils.model_loading import load_model

    early, _ = load_model(EARLY_CONFIG, device=device, seed=0)
    late, cfg = load_model(LATE_CONFIG, device=device, seed=1)
    shape = (CHECK_BATCH, cfg.img_size, cfg.img_size, cfg.in_chans)
    x0 = torch.randn(shape, generator=torch.Generator().manual_seed(10)).to(device)
    schedule = NoiseSchedule.create(steps=STEPS, device=device)
    outs = {}
    with torch.inference_mode():
        for impl in ("fused", "plain"):
            for m in (early, late):
                set_attn_impl(m, impl)
                m.eval().pack_for_kernels()
            outs[impl], _ = ddim_sample(early, None, schedule=schedule, shape=shape,
                                        ddim_steps=DDIM_CHECK_STEPS, eta=0.0, x_init=x0,
                                        late_apply_fn=late, t_switch=T_SWITCH)
    max_abs, limit, rel, ok = scaled_errors(outs["fused"], outs["plain"], MODEL_MAX_FRAC)
    print(f"phase 10a: {DDIM_CHECK_STEPS}-step DDIM DuoDiff (depth 3 -> {cfg.depth}, t_switch "
          f"{T_SWITCH}, eta 0) B={CHECK_BATCH} fused vs plain: rel_fro_err={rel:.6g} (bound "
          f"{FWD_REL_FRO}) max_abs_err={max_abs:.6g} (bound {limit:.6g}) max_abs_out="
          f"{outs['plain'].abs().max().item():.6g} ok={ok}", flush=True)
    if not ok:
        fail("the fused DDIM trajectory disagrees with the plain one")


def check_dpm(device) -> None:
    """Phase 10b's gate: the cached int8 DPM-Solver++ run at batch 8, the
    int8 kernels against plain_int8 from one x_init, held as a whole int8
    forward is (INT8_REL_FRO)."""
    from duodiff_tpu_torch.diffusion.sampling import dpm_solver_sample
    from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
    from duodiff_tpu_torch.utils.model_loading import load_model

    model, cfg = load_model(LATE_CONFIG, device=device, seed=0, attn_impl="fused_int8",
                            gelu_approx=True, int8_scales=INT8_SCALES)
    model.eval().pack_for_kernels()
    shape = (CHECK_BATCH, cfg.img_size, cfg.img_size, cfg.in_chans)
    x0 = torch.randn(shape, generator=torch.Generator().manual_seed(11)).to(device)
    tokens = cfg.extras + cfg.num_patches
    cache = (lambda x, t, y: model.forward_anchor(x, t, y, n_outer=N_OUTER),
             lambda x, t, y, d: model.forward_cached(x, t, y, n_outer=N_OUTER, delta=d),
             DPM_CACHE_EVERY,
             lambda x: torch.zeros((x.shape[0], tokens, cfg.embed_dim), dtype=model.dtype,
                                   device=x.device))
    outs = {}
    with torch.inference_mode():
        for impl in ("fused_int8", "plain_int8"):
            set_attn_impl(model, impl)
            outs[impl] = dpm_solver_sample(
                None, None, schedule=NoiseSchedule.create(steps=STEPS, device=device),
                shape=shape, dpm_steps=DPM_STEPS, x_init=x0, cache=cache)
    rel = rel_fro(outs["fused_int8"], outs["plain_int8"])
    max_abs, _, _ = errors(outs["fused_int8"], outs["plain_int8"])
    ok = rel <= INT8_REL_FRO and bool(torch.isfinite(outs["fused_int8"]).all())
    print(f"phase 10b: DPM-Solver++ 2M {DPM_STEPS} steps, int8 static scales, cached every "
          f"{DPM_CACHE_EVERY} transitions, B={CHECK_BATCH} fused_int8 vs plain_int8: "
          f"rel_fro_err={rel:.6g} (bound {INT8_REL_FRO}) max_abs_err={max_abs:.6g} ok={ok}",
          flush=True)
    if not ok:
        fail("the cached int8 DPM-Solver trajectory disagrees with its plain version")


def run_tool(label: str, tool_main, argv: list, card: str, expected: dict) -> tuple:
    """One of the port's tools through its ``main`` on the card, every launch
    counter set to 0 just before and read just after, the counts checked.
    Returns (what ``main`` returned, the launches)."""
    reset_counts()
    tic = time.perf_counter()
    result = tool_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    launches = read_counts()
    print(f"{label}: wall {wall:.6g} s, launches {launches} (expected {expected}), card {card}",
          flush=True)
    if result["card"] != card:
        fail(f"{label}: the tool saw another card: {result['card']}")
    check_counts(launches, expected)
    return result, launches


def run_other_samplers(device, card: str) -> dict:
    """Phase 10: the samplers after DDPM through the sampling CLI, then the
    tools that make the headline's two assets, then the headline on what
    they made. Returns the launches of each run, by run."""
    from duodiff_tpu_torch.diffusion.cache_schedule import load_cache_schedule
    from duodiff_tpu_torch.diffusion.sampling import ddim_pairs, dpm_solver_tables
    from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
    from duodiff_tpu_torch.tools import calibrate_int8, derive_cache_schedule
    from duodiff_tpu_torch.utils.int8_scales import load_int8_scales

    runs = {}
    check_ddim(device)
    early_pairs, late_pairs = ddim_pairs(STEPS, DDIM_STEPS, T_SWITCH)
    n = len(early_pairs) * 3 + len(late_pairs) * 13
    runs["10a"] = run_cli(
        f"phase 10a: DDIM DuoDiff {DDIM_STEPS} steps (depth 3 x {len(early_pairs)}, depth 13 x "
        f"{len(late_pairs)}), bf16", ["--use_ddim", "--ddim_steps", str(DDIM_STEPS)], card,
        {"fused_attn_sublayer": n, "fused_mlp_sublayer": n})

    check_dpm(device)
    transitions = len(dpm_solver_tables(NoiseSchedule.create(steps=STEPS), DPM_STEPS)["phi"])
    anchored = len(range(0, transitions, DPM_CACHE_EVERY))
    n = anchored * 13 + (transitions - anchored) * 2 * N_OUTER
    runs["10b"] = run_cli(
        f"phase 10b: DPM-Solver++ 2M {DPM_STEPS} steps, depth 13 int8 static scales, cached "
        f"every {DPM_CACHE_EVERY} transitions ({anchored} anchored, {transitions - anchored} "
        f"cached), tanh GELU",
        ["--use_dpm_solver", "--dpm_steps", str(DPM_STEPS), "--attn_impl", "fused_int8",
         "--int8_scales", INT8_SCALES, "--cache_every", str(DPM_CACHE_EVERY), "--gelu_approx"],
        card, {"fused_attn_sublayer_int8": n, "fused_mlp_sublayer_int8": n,
               "fused_mlp_sublayer_int8 static": n},
        configs=(LATE_CONFIG,), t_switch=None)

    full = len(range(0, STEPS, INTERLEAVE_EVERY))
    n = full * 13 + (STEPS - full) * 3
    runs["10c"] = run_cli(
        f"phase 10c: heavy-light interleaving every {INTERLEAVE_EVERY} over {STEPS} steps "
        f"(depth 13 x {full}, depth 3 x {STEPS - full}), bf16",
        ["--interleave_every", str(INTERLEAVE_EVERY)], card,
        {"fused_attn_sublayer": n, "fused_mlp_sublayer": n}, t_switch=None)

    with tempfile.TemporaryDirectory() as work:
        schedule_path, scales_path = f"{work}/cache_schedule.json", f"{work}/int8_scales.json"
        n = T_SWITCH * 3 + (STEPS - T_SWITCH) * 13
        derived, runs["10d"] = run_tool(
            f"phase 10d: derive_cache_schedule, DuoDiff mode (t_switch {T_SWITCH}, seeds 0 / 1), "
            f"batch {MAIN_BATCH}, <= {DERIVE_ANCHORS} anchors, tanh GELU",
            derive_cache_schedule.main,
            ["--config", LATE_CONFIG, "--shallow_config", EARLY_CONFIG, "--t_switch",
             str(T_SWITCH), "--seed", "0", "--full_seed", "1", "--batch", str(MAIN_BATCH),
             "--steps", str(STEPS), "--num_anchors", str(DERIVE_ANCHORS), "--gelu_approx",
             "--out", schedule_path, "--device", "cuda"],
            card, {"fused_attn_sublayer": n, "fused_mlp_sublayer": n})
        table = load_cache_schedule(schedule_path, num_timesteps=STEPS)
        late = int(table[:STEPS - T_SWITCH].sum())
        drift = np.asarray(derived["drift"][:STEPS - T_SWITCH - 1])
        print(f"phase 10d: the schedule loads: {late} anchors in the late segment (at most "
              f"{DERIVE_ANCHORS}), {int(table.sum())} in all; budget {derived['budget']:.6g}; "
              f"drift over t = 0..{STEPS - T_SWITCH - 2}: min {drift.min():.6g}, median "
              f"{np.median(drift):.6g}, max {drift.max():.6g}", flush=True)
        if not (0 < late <= DERIVE_ANCHORS and table[STEPS - T_SWITCH:].all()
                and np.isfinite(drift).all() and (drift > 0).all()):
            fail("the derived cache schedule is not what phase 10d asked for")

        candidates = 1 + len(CALIB_GRID.split(","))
        per_run = STEPS * 13
        calibrated, runs["10e"] = run_tool(
            f"phase 10e: calibrate_int8 --mode search (grid {CALIB_GRID}, margin "
            f"{CALIB_MARGIN}), depth 13 seed 1, batch {CALIB_BATCH}, tanh GELU",
            calibrate_int8.main,
            ["--config_path", LATE_CONFIG, "--random_init", "--seed", "1", "--mode", "search",
             "--search_grid", CALIB_GRID, "--margin", str(CALIB_MARGIN), "--gelu_approx",
             "--batch_size", str(CALIB_BATCH), "--num_timesteps", str(STEPS),
             "--output", scales_path, "--device", "cuda"],
            card, {"fused_attn_sublayer_int8": (2 + candidates) * per_run,
                   "fused_mlp_sublayer_int8": (1 + candidates) * per_run,
                   "fused_mlp_sublayer_int8 dynamic": per_run,
                   "fused_mlp_sublayer_int8 static": candidates * per_run})
        table_rows = calibrated["meta"]["search"]
        print("phase 10e: PSNR against the dynamic-int8 kernels: " + ", ".join(
            f"{r['candidate']} {r['psnr_vs_dynamic_db']} dB" for r in table_rows)
            + f"; winner {calibrated['meta']['search_winner']['candidate']}; statistics "
            f"{calibrated['seconds']['stats']:.6g} s, search {calibrated['seconds']['search']:.6g}"
            f" s", flush=True)
        scales = load_int8_scales(scales_path)
        if len(scales) != 13 or not all(np.isfinite(v).all() and min(v) > 0
                                        for v in scales.values()):
            fail(f"the calibrated scales are not 13 finite positive pairs: {scales}")
        runs["10f"] = run_int8_main_path(card, schedule_path, scales_path, phase="phase 10f")
    print(json.dumps({"phase10_launches": {
        run: {k: v for k, v in counts.items() if v} for run, counts in runs.items()}}), flush=True)
    return runs


EE_CONFIG = str(REPO / "configs/deediff_celeba.yaml")          # D 512, depth 13, per-layer MLP probes
EE_GUIDED_CONFIG = str(REPO / "configs/deediff_imagenet64.yaml")  # D 768, depth 17, 1000 classes
EE_BUCKETS = 4            # eesampler.py's --derive_buckets default
EE_CACHE_EVERY = 2
EE_CALIB_BATCH = 16
EE_CALIB_STEPS = 100
EE_ADAPTIVE_LAYERS = (4, 7, 10, 13)
EE_ADAPTIVE_CHUNK = 50    # eesampler.py's --adaptive_chunk default
EE_SHORT_STEPS = 50       # the guided (11d) and int8 (11e) runs
EE_GATE_STEPS = 20
EE_GATE_BUCKETS = [(19, 14, 4), (13, 7, 9), (6, 0, 13)]
EE_GATE_TIMESTEPS = (999.0, 500.0, 20.0)


def ee_model(config: str, device, seed: int = 0):
    """The early-exit model the CLI builds for ``--random_init --seed seed``."""
    from duodiff_tpu_torch.utils.model_loading import load_model

    model, cfg = load_model(config, device=device, seed=seed, attn_impl="fused",
                            early_exit=True)
    return model.eval(), cfg


def pick_threshold(u: torch.Tensor) -> float:
    """A threshold between the probe values ``u`` (depth, N) that spreads
    the first qualifying probe (the dynamic rule's exit) over the most
    layers, at least 1e-4 from every value."""
    u = u.float().cpu().numpy()
    values = np.sort(np.unique(u.ravel()))
    mids = [(a + b) / 2 for a, b in zip(values, values[1:]) if b - a > 2e-4]
    if not mids:
        fail("the probes read one value: no threshold splits them")
    spread = [len(set(np.argmax(u <= m, axis=0))) for m in mids]
    return float(mids[int(np.argmax(spread))])


def ee_static_launches(buckets, depth: int, cache_every=None) -> int:
    """Blocks a static-exit run launches: a bucket at exit layer e runs e
    blocks a step (all ``depth`` at e = depth); cached, a step off its
    anchors (t % cache_every == 0, or the anchor table ``cache_every[t]``,
    and the bucket's first step) runs the truncation's outer blocks only,
    e - 2k - 1 + 2 n_outer. n_outer is the CLI's default max(1, ceil(k/3))
    raised to 2k - e + 1, the least that keeps the cached region inside the
    truncation; past k the bucket has nothing to cache and runs uncached."""
    k = depth // 2
    n = 0
    for t_hi, t_lo, layer in buckets:
        p = max(1, -(-k // 3), 2 * k - layer + 1)
        if cache_every is None or p > k:
            p = None
        for t in range(t_hi, t_lo - 1, -1):
            anchor = t % cache_every == 0 if isinstance(cache_every, int) else cache_every[t]
            anchored = p is None or anchor or t == t_hi
            n += layer if anchored else layer - 2 * k - 1 + 2 * p
    return n


def check_early_exit(device) -> float:
    """Phase 11's gates, the fused kernels against their plain versions on
    one depth-13 early-exit model (the CLI's seed-0 weights): the forward
    triple at three timesteps, batch 8 (backbone and heads within 0.05 +
    0.05 |plain|, the probes within 2^-7 of the largest); a short
    static-bucket trajectory, block-cached every 2, on one injected noise
    table (relative Frobenius FWD_REL_FRO and MODEL_MAX_FRAC of the largest
    value, as phase 10a); and the share of exit indices on which a short
    fused and plain dynamic run agree (printed). Returns the threshold for
    the dynamic runs, picked from the model's own probe values."""
    from duodiff_tpu_torch.diffusion.sampling import early_exit_sample
    from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
    from duodiff_tpu_torch.diffusion.static_exit import static_exit_sample

    model, cfg = ee_model(EE_CONFIG, device)
    gen = torch.Generator().manual_seed(12)
    shape = (CHECK_BATCH, cfg.img_size, cfg.img_size, cfg.in_chans)
    x = torch.randn(shape, generator=gen).to(device)
    probes = []
    with torch.inference_mode():
        for t in EE_GATE_TIMESTEPS:
            tb = torch.full((CHECK_BATCH,), t, device=device)
            outs = {}
            for impl in ("fused", "plain"):
                set_attn_impl(model, impl)
                model.pack_for_kernels()
                outs[impl] = model(x, tb)
            (bb, u, g), (bb_p, u_p, g_p) = outs["fused"], outs["plain"]
            probes.append(u_p)
            ok_b, ok_g = errors(bb, bb_p)[2], errors(g, g_p)[2]
            u_err = (u - u_p).abs().max().item()
            u_limit = KERNEL_MAX_FRAC * u_p.abs().max().item()
            ok = ok_b and ok_g and u_err <= u_limit and u.shape == (cfg.depth, CHECK_BATCH)
            print(f"phase 11: early-exit forward t={t:g} B={CHECK_BATCH} fused vs plain: "
                  f"backbone max_abs_err={errors(bb, bb_p)[0]:.6g} rel_fro={rel_fro(bb, bb_p):.6g}"
                  f", heads max_abs_err={errors(g, g_p)[0]:.6g} rel_fro={rel_fro(g, g_p):.6g}, "
                  f"probes max_abs_err={u_err:.6g} (bound {u_limit:.6g}) ok={ok}", flush=True)
            if not ok:
                fail("the fused early-exit forward disagrees with the plain one")
        threshold = pick_threshold(torch.cat(probes, dim=1))

        schedule = NoiseSchedule.create(steps=EE_GATE_STEPS, device=device)
        table = torch.randn((EE_GATE_STEPS, *shape), generator=gen).to(device)
        runs = {}
        for impl in ("fused", "plain"):
            set_attn_impl(model, impl)
            model.pack_for_kernels()
            runs[impl] = (
                static_exit_sample(model, None, schedule=schedule, buckets=EE_GATE_BUCKETS,
                                   cache_every=EE_CACHE_EVERY, x_init=x, noise_table=table),
                early_exit_sample(model, None, schedule=schedule, shape=shape,
                                  threshold=threshold, x_init=x, noise_table=table))
    max_abs, limit, rel, ok = scaled_errors(runs["fused"][0], runs["plain"][0], MODEL_MAX_FRAC)
    print(f"phase 11: {EE_GATE_STEPS}-step static-exit trajectory (buckets {EE_GATE_BUCKETS}, "
          f"cached every {EE_CACHE_EVERY}) B={CHECK_BATCH} fused vs plain: rel_fro_err={rel:.6g} "
          f"(bound {FWD_REL_FRO}) max_abs_err={max_abs:.6g} (bound {limit:.6g}) ok={ok}",
          flush=True)
    if not ok:
        fail("the fused static-exit trajectory disagrees with the plain one")
    idx_f, idx_p = runs["fused"][1][2], runs["plain"][1][2]
    share = (idx_f == idx_p).float().mean().item()
    print(f"phase 11: {EE_GATE_STEPS}-step dynamic run at threshold {threshold:.6g}, "
          f"B={CHECK_BATCH}: fused and plain exit indices agree on {share:.6g} of (t, sample); "
          f"fused exits {np.bincount(idx_f.cpu().numpy().ravel(), minlength=cfg.depth + 1)}",
          flush=True)
    del model
    release_memory()
    return threshold


def profile_ee_step(device, card: str, threshold: float) -> None:
    """One dense early-exit step's model call at batch 128 (the depth-13
    model, its backbone, 13 heads and 13 probes, then the exit selection),
    timed with CUDA events beside its backbone alone (``model.uvit``) and
    profiled by kernel: what the heads and probes cost on top of the blocks."""
    model, cfg = ee_model(EE_CONFIG, device)
    model.pack_for_kernels()
    g = torch.Generator().manual_seed(13)
    x = torch.randn((MAIN_BATCH, cfg.img_size, cfg.img_size, cfg.in_chans), generator=g).to(device)
    t = torch.full((MAIN_BATCH,), 350.0, device=device)
    rows = torch.arange(MAIN_BATCH, device=device)

    def ee_step():
        backbone, u, heads = model(x, t)
        probes = torch.cat([u, torch.zeros_like(u[:1])])
        idx = (probes <= threshold).to(torch.int32).argmax(0)
        return torch.cat([heads, backbone[None]])[idx, rows]

    steps = {"early-exit step (13 blocks, 13 heads, 13 probes)": ee_step,
             "its backbone alone (13 blocks)": lambda: model.uvit(x, t)}
    with torch.inference_mode():
        ms = time_ms(steps, reps=5)  # in turns
        for what, step in steps.items():
            print(f"phase 11: one {what} at batch {MAIN_BATCH} (CUDA events, median of 5, in "
                  f"turns): {ms[what]:.6g} ms; card {card}", flush=True)
            profile_steps(f"phase 11, {what}", step)
    del model
    release_memory()


def run_ee_cli(label: str, argv: list, card: str, batch: int, expected,
               random_init: bool = True) -> tuple:
    """One run of ``python -m duodiff_tpu_torch.eesample`` in-process in a
    temporary folder (random weights unless ``argv`` names a checkpoint and
    ``random_init`` is False), every launch counter set to 0 just before and
    read just after; ``expected(result)`` gives the counts (unlisted kernels:
    0) from what the run chose. Returns (the CLI's result, the launches, the
    folder's indices_by_timestep.npy)."""
    from duodiff_tpu_torch import eesample

    with tempfile.TemporaryDirectory() as out:
        reset_counts()
        tic = time.perf_counter()
        result = eesample.main([*argv, *["--random_init"] * random_init, "--batch_size",
                                str(batch), "--device", "cuda", "--output_folder", out])
        wall = time.perf_counter() - tic
        launches = read_counts()
        idx = np.load(f"{out}/indices_by_timestep.npy")
        pngs = len(list(Path(out).glob("*.png")))
    want = expected(result)
    idx_mean = float(np.mean(result["idx_by_t"]))
    print(f"{label} batch {batch}: sampling {result['seconds']:.6g} s, "
          f"{batch / result['seconds']:.6g} samples/s, CLI wall {wall:.6g} s, mean exit index "
          f"{idx_mean:.6g}, launches {launches} (expected {want}), card {card}", flush=True)
    samples = result["samples"]
    if samples.shape[0] != batch or not np.isfinite(samples).all() or pngs != batch:
        fail(f"{label}: {samples.shape} samples, {pngs} PNG files, finite "
             f"{bool(np.isfinite(samples).all())}")
    if not np.array_equal(idx, result["idx_by_t"]):
        fail(f"{label}: indices_by_timestep.npy is not the run's table")
    check_counts(launches, want)
    return result, launches, idx


def run_early_exit(device, card: str) -> dict:
    """Phase 11: early-exit sampling through ``eesample.py`` and
    ``tools/calibrate_probes.py`` at full width: (a) the dynamic rule on
    ``configs/deediff_celeba.yaml``, 1000 steps, batch 128, bf16 fused (every
    block every step); (b) static buckets derived from (a)'s table, cached
    every 2; (c) a probe calibration (batch 16, 100 steps), then the
    adaptive walk, monotone and bidirectional on that file; (d) guided on
    ``configs/deediff_imagenet64.yaml`` (D 768, depth 17), batch 64 doubled;
    (e) int8 with the asset's static MLP scales. Returns the launches of
    each run, by run."""
    from duodiff_tpu_torch.diffusion.calibration import load_probe_calibration
    from duodiff_tpu_torch.diffusion.static_exit import derive_exit_schedule
    from duodiff_tpu_torch.tools import calibrate_probes

    threshold = check_early_exit(device)
    depth = 13
    runs = {}
    common = ["--config_path", EE_CONFIG, "--seed", "0"]
    dense = STEPS * depth
    result, runs["11a"], idx = run_ee_cli(
        f"phase 11a: dynamic early exit, {STEPS} steps, threshold {threshold:.6g}, bf16",
        [*common, "--num_timesteps", str(STEPS), "--threshold", repr(threshold)], card,
        MAIN_BATCH, lambda r: {"fused_attn_sublayer": dense, "fused_mlp_sublayer": dense})
    print(f"phase 11a: exits by layer {np.bincount(idx.ravel(), minlength=depth + 1).tolist()}",
          flush=True)
    profile_ee_step(device, card, threshold)

    with tempfile.TemporaryDirectory() as work:
        np.save(f"{work}/idx.npy", idx)
        buckets = derive_exit_schedule(idx, n_buckets=EE_BUCKETS)
        n = ee_static_launches(buckets, depth, EE_CACHE_EVERY)
        _, runs["11b"], _ = run_ee_cli(
            f"phase 11b: static buckets {buckets} derived from 11a, cached every "
            f"{EE_CACHE_EVERY}", [*common, "--num_timesteps", str(STEPS),
                                   "--derive_schedule_from", f"{work}/idx.npy",
                                   "--derive_buckets", str(EE_BUCKETS),
                                   "--cache_every", str(EE_CACHE_EVERY)],
            card, MAIN_BATCH, lambda r: {"fused_attn_sublayer": n, "fused_mlp_sublayer": n})

        calib_path = f"{work}/probe_calibration.json"
        n = EE_CALIB_STEPS * depth
        fitted, runs["11c calibration"] = run_tool(
            f"phase 11c: calibrate_probes, batch {EE_CALIB_BATCH}, {EE_CALIB_STEPS} steps",
            calibrate_probes.main,
            ["--config", EE_CONFIG, "--batch", str(EE_CALIB_BATCH), "--steps",
             str(EE_CALIB_STEPS), "--seed", "0", "--out", calib_path, "--device", "cuda"],
            card, {"fused_attn_sublayer": n, "fused_mlp_sublayer": n})
        calib = load_probe_calibration(calib_path)
        print(f"phase 11c: calibration slopes {[round(a, 6) for a in calib['a']]}, mean realized "
              f"errors {[round(e, 6) for e in calib['mean_error']]}", flush=True)

        def walk_launches(r):
            n = sum((row["t_hi"] - row["t_lo"] + 1) * row["layer"] for row in r["log"])
            return {"fused_attn_sublayer": n, "fused_mlp_sublayer": n}

        layers = ",".join(map(str, EE_ADAPTIVE_LAYERS))
        slots = [min(v, depth - 1) for v in EE_ADAPTIVE_LAYERS]
        u = fitted["u_rows"].mean(0)[slots]
        # monotone: starts at the shallowest and deepens while its probe is above
        first, deeper = u[0], u[1:].min()
        mono_threshold = float((first + deeper) / 2 if first > deeper else first - 1e-3)
        # bidirectional, in realized-error units: starts at the deepest, moves
        # shallower while the own and the shallower candidate's errors allow it
        err = np.asarray(calib["mean_error"])[slots]
        bidir_threshold = float(1.01 * max(err[-1], err[-2] / 0.7))
        for walk, extra in (("monotone", ["--threshold", repr(mono_threshold)]),
                            ("bidirectional", ["--threshold", repr(bidir_threshold),
                                               "--adaptive_bidirectional", "--probe_calibration",
                                               calib_path])):
            result, runs[f"11c {walk}"], _ = run_ee_cli(
                f"phase 11c: adaptive {walk} walk over layers {layers}, chunk "
                f"{EE_ADAPTIVE_CHUNK}, {STEPS} steps, threshold {extra[1]}",
                [*common, "--num_timesteps", str(STEPS), "--adaptive_layers", layers,
                 "--adaptive_chunk", str(EE_ADAPTIVE_CHUNK), *extra], card, MAIN_BATCH,
                walk_launches)
            print(f"phase 11c: {walk} walk layers by chunk "
                  f"{[row['layer'] for row in result['log']]}", flush=True)

    n = EE_SHORT_STEPS * 17
    runs["11d"] = run_ee_cli(
        f"phase 11d: guided dynamic early exit on the ImageNet-64 model (D 768, depth 17), "
        f"w 1.5, {EE_SHORT_STEPS} steps, batch 64 doubled to 128",
        ["--config_path", EE_GUIDED_CONFIG, "--seed", "0", "--num_timesteps",
         str(EE_SHORT_STEPS), "--threshold", "0.5", "--class_id", "-1", "--guidance_scale",
         "1.5"], card, 64, lambda r: {"fused_attn_sublayer": n, "fused_mlp_sublayer": n})[1]

    n = EE_SHORT_STEPS * depth
    runs["11e"] = run_ee_cli(
        f"phase 11e: dynamic early exit int8 with the asset's static MLP scales, "
        f"{EE_SHORT_STEPS} steps", [*common, "--num_timesteps", str(EE_SHORT_STEPS),
                                    "--threshold", repr(threshold), "--attn_impl",
                                    "fused_int8", "--int8_scales", INT8_SCALES],
        card, MAIN_BATCH, lambda r: {"fused_attn_sublayer_int8": n, "fused_mlp_sublayer_int8": n,
                                     "fused_mlp_sublayer_int8 static": n})[1]
    print(json.dumps({"phase11_launches": {
        run: {k: v for k, v in counts.items() if v} for run, counts in runs.items()}}), flush=True)
    return runs


EE_TRAIN_STEPS = 200
EE_RESUME_STEPS = 20
EE_FROZEN_STEPS = 20
EE_SAMPLES = 16           # main.py's --n_samples default, sampled once at the last step
EE_EESAMPLE_STEPS = 100
EE_STATIC_SCHEDULE = "999-750:13,749-0:4"
EE_DERIVE_BATCH = 128
EE_CALIB_STEPS_12 = 100
EE_INT8_STEPS = 50
EE_KERNELS = ("fused_attn_sublayer", "fused_mlp_sublayer", "fused_attn_sublayer_bwd",
              "fused_mlp_sublayer_bwd")


def ee_train_argv(work: str, exp: str, n_steps: int, *extra) -> list:
    return train_argv(work, exp, n_steps, "--model", "deediff_uvit", "--attn_impl", "fused",
                      *extra, config=EE_CONFIG, dataset="celeba")


def check_ee_training(device) -> None:
    """Phase 12a, the gates: on configs/deediff_celeba.yaml at batch 8, the
    same weights, batch and draws fused (K1 / K2, K6 / K7) and plain: every
    gradient (backbone, 13 heads, probes) within BWD_REL_FRO, the five loss
    terms within STEP_LOSS_REL, OPT_STEPS AdamW steps as phase 3 holds
    them; then, fused with the backbone frozen, the backbone equal to its
    start to the bit, every head moved, and grad_norm the norm over all
    gradients (the backbone's too)."""
    from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
    from duodiff_tpu_torch.training.train_state import TrainState, make_optimizer, make_train_step
    from duodiff_tpu_torch.utils.model_loading import load_model

    schedule = NoiseSchedule.create(device=device)
    opt = dict(lr=2e-4, weight_decay=0.03, beta1=0.99, beta2=0.999, max_grad_norm=1.0,
               num_warmup_steps=0, num_training_steps=100)

    def build(impl, frozen=False):
        model, cfg = load_model(EE_CONFIG, device=device, seed=0, attn_impl=impl,
                                early_exit=True)
        model.train()
        params = {n: p for n, p in model.named_parameters()
                  if not (frozen and n.startswith("uvit."))}
        step = make_train_step(model, schedule, parametrization="predict_noise", seed=0,
                               model_kind="deediff_uvit")
        return model, cfg, step, TrainState.create(model, make_optimizer(params, **opt))

    models, steps, states = {}, {}, {}
    for impl in ("fused", "plain"):
        models[impl], cfg, steps[impl], states[impl] = build(impl)
    g = torch.Generator().manual_seed(2)
    shape = (CHECK_BATCH, cfg.img_size, cfg.img_size, cfg.in_chans)
    batch = {"image": (torch.rand(shape, generator=g) * 2 - 1).to(device)}
    names = [n for n, _ in models["plain"].named_parameters()]
    draws = steps["plain"].draws(batch, 1)
    out = {impl: steps[impl].backward(batch, *draws) for impl in models}
    terms = {k: abs(out["fused"][0][k].item() / out["plain"][0][k].item() - 1)
             for k in out["plain"][0]}
    rels = {n: rel_fro(a, b) for n, a, b in zip(names, out["fused"][1], out["plain"][1])}
    groups = {part: max(v for n, v in rels.items() if n.startswith(part))
              for part in ("uvit.", "heads.", "probes.")}
    worst = max(rels, key=rels.get)
    ok = rels[worst] <= BWD_REL_FRO and max(terms.values()) <= STEP_LOSS_REL
    print(f"phase 12a: early-exit training gradients B={CHECK_BATCH} fused vs plain, "
          f"{len(names)} parameters: worst rel_fro_err={rels[worst]:.6g} ({worst}), by part "
          f"{ {k: round(v, 6) for k, v in groups.items()} }, median "
          f"{statistics.median(rels.values()):.6g} (bound {BWD_REL_FRO}); loss terms "
          f"{ {k: round(out['fused'][0][k].item(), 6) for k in terms} }, worst rel "
          f"{max(terms.values()):.6g} (bound {STEP_LOSS_REL}) ok={ok}", flush=True)
    if not ok:
        fail("the fused early-exit training gradients or loss terms disagree with the plain ones")
    del out

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
    print(f"phase 12a: {OPT_STEPS} AdamW steps fused vs plain: losses "
          f"{[round(v, 6) for v in losses['fused']]} vs {[round(v, 6) for v in losses['plain']]} "
          f"max rel {loss_rel:.6g} (bound {STEP_LOSS_REL}); parameter updates worst rel_fro_err "
          f"{upd[worst]:.6g} ({worst}), median {statistics.median(upd.values()):.6g} "
          f"(bound {UPDATE_REL_FRO}) ok={ok}", flush=True)
    if not ok:
        fail("fused early-exit training steps disagree with plain ones")
    del models, steps, states
    release_memory()

    model, _, step, state = build("fused", frozen=True)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    norms = []
    for s in range(1, OPT_STEPS + 1):
        metrics, grads = step.backward(batch, *step.draws(batch, s))
        flat = torch.cat([g.double().flatten() for g in grads])
        heads = torch.cat([g.double().flatten() for n, g in zip(names, grads)
                           if not n.startswith("uvit.")])
        logged = step.update(state, grads).item()
        norms.append((logged, torch.linalg.vector_norm(flat).item(),
                      torch.linalg.vector_norm(heads).item()))
    still = all(torch.equal(p.detach(), start[n]) for n, p in model.named_parameters()
                if n.startswith("uvit."))
    moved = all(not torch.equal(p.detach(), start[n]) for n, p in model.named_parameters()
                if not n.startswith("uvit."))
    # the logged norm sums fp32 squares over ~4e7 entries; the references are float64
    norm_ok = all(abs(a / b - 1) <= 1e-4 and abs(a / c - 1) > 1e-2 for a, b, c in norms)
    ok = still and moved and norm_ok
    print(f"phase 12a: {OPT_STEPS} fused steps with the backbone frozen: backbone equal to its "
          f"start {still}, every head and probe moved {moved}; grad_norm logged / over all "
          f"gradients / over the heads' and probes' (float64) "
          f"{[tuple(round(v, 6) for v in n) for n in norms]} (bound 1e-4 from all) ok={ok}",
          flush=True)
    if not ok:
        fail("the frozen backbone moved, a head did not, or grad_norm is not the norm of all")
    del model, state, step
    release_memory()


def run_ee_training(device, card: str) -> dict:
    """Phase 12: DeeDiff early-exit training through the training CLI on
    configs/deediff_celeba.yaml at batch 128, bf16, fused, on a synthetic
    CelebA cache: (a) the gates; (b) EE_TRAIN_STEPS steps with
    --async_checkpoint that sample once, at the last step (EE_SAMPLES images,
    1000 steps, the probe and statistics rows and the grid checked), the
    loss falling, the checkpoint loaded strictly by load_model(early_exit=True)
    with the trainer's forward, a --resume run, eesample's dynamic rule on
    it; (c) --load_backbone of a uvit_celeba.yaml checkpoint written from a
    seed, --freeze_backbone and --profile: the backbone equal to it after the
    steps, the trace written; (d) one early-exit step timed and profiled
    beside the plain U-ViT step on the same backbone, and the frozen step;
    (e) derive_cache_schedule --static_schedule on the trained checkpoint,
    eesample on its table, calibrate_int8 --early_exit --mode percentile,
    eesample in int8 on its scales. Returns the launches of each run."""
    from duodiff_tpu_torch.data.sampler import ResumableSeedableSampler
    from duodiff_tpu_torch.data.synthetic import write_palette_celeba_cache
    from duodiff_tpu_torch.diffusion.cache_schedule import load_cache_schedule
    from duodiff_tpu_torch.diffusion.static_exit import parse_exit_schedule
    from duodiff_tpu_torch.tools import calibrate_int8, derive_cache_schedule
    from duodiff_tpu_torch.training.checkpointer import CHECKPOINT_FILE, Checkpointer
    from duodiff_tpu_torch.training.train_state import TrainState, make_optimizer, make_train_step
    from duodiff_tpu_torch.utils.image import PNG_SIGNATURE
    from duodiff_tpu_torch.utils.model_loading import load_model

    check_ee_training(device)
    depth, runs = 13, {}
    with tempfile.TemporaryDirectory() as work:
        write_palette_celeba_cache(Path(work) / "data", seed=0)
        floor = release_memory()
        fwd, bwd = depth * (EE_TRAIN_STEPS + STEPS), depth * EE_TRAIN_STEPS
        trainer, runs["12b"] = run_train_cli(
            f"phase 12b: train deediff_celeba.yaml, --async_checkpoint, samples at step "
            f"{EE_TRAIN_STEPS}",
            ee_train_argv(work, "ee", EE_TRAIN_STEPS, "--async_checkpoint", "--log_every_n_steps",
                          str(EE_TRAIN_STEPS), "--n_samples", str(EE_SAMPLES),
                          "--sample_height", "64", "--sample_width", "64"), card,
            {"fused_attn_sublayer": fwd, "fused_mlp_sublayer": fwd,
             "fused_attn_sublayer_bwd": bwd, "fused_mlp_sublayer_bwd": bwd})
        peak = torch.cuda.max_memory_allocated()
        first, last = trainer.logs[0], trainer.logs[-1]
        run = trainer.log_path
        probe_rows = np.load(run / f"sample_classifier_outputs_step{EE_TRAIN_STEPS}.npy")
        stat_rows = np.load(run / f"sample_stats_step{EE_TRAIN_STEPS}.npy")
        grid = (run / f"samples_step{EE_TRAIN_STEPS}.png").read_bytes()
        print(f"phase 12b: peak device memory {peak / 2**30:.6g} GiB ({floor:.6g} GiB held before "
              f"the run); loss terms at step {first['step']} "
              f"{ {k: round(v, 6) for k, v in first.items() if k.endswith('loss')} } -> step "
              f"{last['step']} { {k: round(v, 6) for k, v in last.items() if k.endswith('loss')} }"
              f"; in-training samples: probe rows {probe_rows.shape} mean {probe_rows.mean():.6g}, "
              f"stats rows {stat_rows.shape} last {stat_rows[-1].round(6).tolist()}, grid "
              f"{len(grid)} bytes; card {card}", flush=True)
        if not last["train_loss"] < LOSS_DROP * first["train_loss"]:
            fail(f"the early-exit train loss did not fall clearly: {first['train_loss']:.6g} -> "
                 f"{last['train_loss']:.6g}")
        if (probe_rows.shape != (STEPS, depth, EE_SAMPLES) or stat_rows.shape != (STEPS, 2)
                or not np.isfinite(probe_rows).all() or not np.isfinite(stat_rows).all()
                or not grid.startswith(PNG_SIGNATURE)):
            fail("phase 12b: the in-training sampler's rows or grid are wrong")
        # the dynamic runs' threshold, from the trained probes' values along that trajectory
        threshold = pick_threshold(torch.from_numpy(probe_rows.transpose(1, 0, 2).reshape(depth, -1)))

        ckpt = trainer.log_path / "celeba_deediff_uvit_last"
        saved = Checkpointer.restore(ckpt)
        model, cfg = load_model(EE_CONFIG, str(ckpt / CHECKPOINT_FILE), device=device,
                                attn_impl="fused", early_exit=True)
        for m in (model, trainer.model):
            m.eval()
            m.pack_for_kernels()
        g = torch.Generator().manual_seed(3)
        x = torch.randn((CHECK_BATCH, cfg.img_size, cfg.img_size, cfg.in_chans), generator=g)
        t = torch.linspace(0, 999, CHECK_BATCH)
        with torch.inference_mode():
            same = all(torch.equal(a, b) for a, b in zip(model(x.to(device), t.to(device)),
                                                          trainer.model(x.to(device), t.to(device))))
        print(f"phase 12b: checkpoint step {saved['step']} ({len(saved['model_state_dict'])} "
              f"reference names) loaded strictly by load_model(early_exit=True); its forward "
              f"equals the trainer's: {same}", flush=True)
        if not same or saved["step"] != EE_TRAIN_STEPS:
            fail("the early-exit checkpoint does not reproduce the trained model")
        del trainer, model
        release_memory()

        n = depth * EE_RESUME_STEPS
        resumed, runs["12b resume"] = run_train_cli(
            "phase 12b: --resume",
            ee_train_argv(work, "ee", EE_TRAIN_STEPS + EE_RESUME_STEPS, "--resume"), card,
            {k: n for k in EE_KERNELS})
        sampler = ResumableSeedableSampler(len(saved["sampler_state"]["perm"]), seed=0)
        sampler.set_state(saved["sampler_state"])
        sampler.next_indices(TRAIN_BATCH * EE_RESUME_STEPS)
        want, got = sampler.get_state(), resumed.dataloader.get_state()
        ok = (resumed.start_step == EE_TRAIN_STEPS
              and np.array_equal(want["perm"], got["perm"])
              and (want["perm_index"], want["epoch"]) == (got["perm_index"], got["epoch"]))
        print(f"phase 12b: resumed at step {resumed.start_step}, sampler at epoch {got['epoch']} "
              f"index {got['perm_index']}, as the saved state implies: {ok}", flush=True)
        if not ok:
            fail("the early-exit --resume did not continue from the saved step and sampler state")
        ee_step = profile_train_step(resumed, card, "phase 12d (early-exit step)")
        trained = str(resumed.log_path / "celeba_deediff_uvit_last" / CHECKPOINT_FILE)

        # the plain U-ViT step on the same backbone, beside it
        uvit = resumed.model.uvit
        step_fn = make_train_step(uvit, resumed.schedule, parametrization="predict_noise", seed=0)
        state = TrainState.create(uvit, make_optimizer(
            dict(uvit.named_parameters()), lr=2e-4, weight_decay=0.03, beta1=0.99, beta2=0.999,
            max_grad_norm=1.0, num_warmup_steps=0, num_training_steps=100))
        batch = {"image": torch.rand((TRAIN_BATCH, 64, 64, 3), generator=g).to(device) * 2 - 1}
        uvit_step = profile_step_fn(step_fn, state, uvit, batch, step_fn.draws(batch, 1), card,
                                    "phase 12d (its backbone's U-ViT step)")
        del resumed, uvit, step_fn, state
        release_memory()

        n = EE_EESAMPLE_STEPS * depth
        runs["12b eesample"] = run_ee_cli(
            f"phase 12b: eesample dynamic rule on the trained checkpoint, {EE_EESAMPLE_STEPS} "
            f"steps, threshold {threshold:.6g} (from the in-training sampler's probe rows)",
            ["--config_path", EE_CONFIG, "--checkpoint_path", trained, "--num_timesteps",
             str(EE_EESAMPLE_STEPS), "--threshold", repr(threshold)], card, MAIN_BATCH,
            lambda r: {"fused_attn_sublayer": n, "fused_mlp_sublayer": n}, random_init=False)[1]

        # (c) a U-ViT checkpoint written from a seed, loaded as the backbone and frozen
        backbone_path = Path(work) / "uvit_celeba.pth"
        source, _ = load_model(LATE_CONFIG, device="cpu", seed=7)
        torch.save({"model_state_dict": source.state_dict()}, backbone_path)
        floor = release_memory()
        n = depth * EE_FROZEN_STEPS
        frozen, runs["12c"] = run_train_cli(
            "phase 12c: --load_backbone uvit_celeba.yaml checkpoint, --freeze_backbone, --profile",
            ee_train_argv(work, "frozen", EE_FROZEN_STEPS, "--load_backbone", str(backbone_path),
                          "--freeze_backbone", "--profile"), card, {k: n for k in EE_KERNELS})
        frozen_peak = torch.cuda.max_memory_allocated()
        got = frozen.model.uvit.state_dict()
        still = all(torch.equal(v.cpu(), got[k].cpu()) for k, v in source.state_dict().items())
        trace = frozen.log_path / "profile" / "trace.json"
        trace_bytes = trace.stat().st_size if trace.exists() else 0
        print(f"phase 12c: backbone equal to the loaded checkpoint after {EE_FROZEN_STEPS} frozen "
              f"steps: {still}; --profile trace {trace_bytes} bytes; peak device memory "
              f"{frozen_peak / 2**30:.6g} GiB ({floor:.6g} GiB held before the run)", flush=True)
        if not still or not trace_bytes:
            fail("phase 12c: the frozen backbone moved or --profile wrote no trace")
        frozen_step = profile_train_step(frozen, card, "phase 12d (frozen early-exit step)")
        del frozen, source
        release_memory()
        print(f"phase 12d: train step at batch {TRAIN_BATCH}: early exit {ee_step['step']:.6g} ms "
              f"(forward {ee_step['forward']:.6g}, backward {ee_step['backward']:.6g}), frozen "
              f"{frozen_step['step']:.6g} ms, its backbone's U-ViT step {uvit_step['step']:.6g} ms; "
              f"peak {peak / 2**30:.6g} GiB (12b), {frozen_peak / 2**30:.6g} GiB (12c); card {card}",
              flush=True)

        # (e) the tools' early-exit modes on the trained checkpoint
        buckets = parse_exit_schedule(EE_STATIC_SCHEDULE)
        dense = sum((hi - lo + 1) * layer for hi, lo, layer in buckets)
        schedule_path = f"{work}/ee_schedule.json"
        result, runs["12e derive"] = run_tool(
            f"phase 12e: derive_cache_schedule --static_schedule {EE_STATIC_SCHEDULE}, batch "
            f"{EE_DERIVE_BATCH}", derive_cache_schedule.main,
            ["--config", EE_CONFIG, "--checkpoint", trained, "--static_schedule",
             EE_STATIC_SCHEDULE, "--batch", str(EE_DERIVE_BATCH), "--num_anchors",
             str(DERIVE_ANCHORS), "--out", schedule_path, "--device", "cuda"], card,
            {"fused_attn_sublayer": dense, "fused_mlp_sublayer": dense})
        table = load_cache_schedule(schedule_path, num_timesteps=STEPS)
        meta = result["meta"]
        print(f"phase 12e: {int(table.sum())} anchors ({int(table[750:].sum())} in the cached "
              f"bucket), budget {meta['budget']:.6g}, max staleness {meta['max_staleness']:.6g}, "
              f"buckets {[(b['t_hi'], b['t_lo'], b['layer'], b['n_outer']) for b in meta['buckets']]}",
              flush=True)
        if meta["mode"] != "static_exit" or not table[:750].all() or table[750:].sum() > DERIVE_ANCHORS:
            fail("phase 12e: the static-exit schedule is not what the buckets imply")
        n = ee_static_launches(buckets, depth, table)
        runs["12e eesample"] = run_ee_cli(
            f"phase 12e: eesample --static_schedule {EE_STATIC_SCHEDULE} on the derived table",
            ["--config_path", EE_CONFIG, "--checkpoint_path", trained, "--num_timesteps",
             str(STEPS), "--static_schedule", EE_STATIC_SCHEDULE, "--cache_schedule",
             schedule_path], card, MAIN_BATCH,
            lambda r: {"fused_attn_sublayer": n, "fused_mlp_sublayer": n}, random_init=False)[1]

        scales_path = f"{work}/ee_scales.json"
        n = depth * EE_CALIB_STEPS_12
        scales, runs["12e calibrate"] = run_tool(
            f"phase 12e: calibrate_int8 --early_exit --mode percentile, batch {EE_CALIB_BATCH}, "
            f"{EE_CALIB_STEPS_12} steps", calibrate_int8.main,
            ["--config_path", EE_CONFIG, "--checkpoint_path", trained, "--early_exit", "--mode",
             "percentile", "--batch_size", str(EE_CALIB_BATCH), "--num_timesteps",
             str(EE_CALIB_STEPS_12), "--output", scales_path, "--device", "cuda"], card,
            {"fused_attn_sublayer_int8": n})
        names = sorted(scales["scales"])
        print(f"phase 12e: scales of {len(names)} sites {names[:2]}...{names[-2:]}", flush=True)
        n = depth * EE_INT8_STEPS
        runs["12e int8"] = run_ee_cli(
            f"phase 12e: eesample int8 on those scales, {EE_INT8_STEPS} steps",
            ["--config_path", EE_CONFIG, "--checkpoint_path", trained, "--num_timesteps",
             str(EE_INT8_STEPS), "--threshold", repr(threshold), "--attn_impl", "fused_int8",
             "--int8_scales", scales_path], card, MAIN_BATCH,
            lambda r: {"fused_attn_sublayer_int8": n, "fused_mlp_sublayer_int8": n,
                       "fused_mlp_sublayer_int8 static": n}, random_init=False)[1]
    print(json.dumps({"phase12_launches": {
        run: {k: v for k, v in counts.items() if v} for run, counts in runs.items()}}), flush=True)
    return runs


# Phase 13: latent ImageNet-256 (the frozen KL autoencoder, D = 1024)
LATENT_CONFIG = str(REPO / "configs/uvit_imagenet256.yaml")         # depth 21, 16 heads, D 1024
LATENT_EARLY_CONFIG = str(REPO / "configs/uvit_imagenet256_3.yaml")
LATENT_EE_CONFIG = str(REPO / "configs/deediff_imagenet256.yaml")
LATENT_CACHE_SCHEDULE = str(REPO / "assets/cache_schedule_imagenet256.json")  # 70 anchors
LATENT_DEPTH = 21
LATENT_N_OUTER = 4         # the default for depth 21, ceil((21 // 2) / 3), and the asset's
LATENT_BATCH = 16          # 13b (guided: 32 rows a forward), 13d, 13e's sampling
LATENT_INT8_BATCH = 32     # 13c, the README's cached int8 operating point
LATENT_EE_STEPS = 100
LATENT_TRAIN_STEPS = 40
LATENT_SAMPLE_STEPS = 10   # 13e: the sampling CLI on the trained checkpoint
LATENT_CACHE_IMAGES = 256  # 196,608 bytes an image (uint8, as the JAX cache keeps them)
LATENT_GATE_STEPS, LATENT_GATE_SWITCH = 20, 6
LATENT_IMAGE = 256
# 13e's loss, last logged over first
LATENT_LOSS_DROP = 0.75  # measured 0.514 (1.261 -> 0.648), PERF.md
# The autoencoder in bf16 against fp32 on the same weights, relative Frobenius:
# bf16 rounds every convolution's input (2**-9 of each value) through ~30
# convolutions in a row, each followed by a GroupNorm that rescales the error
# with the signal, so the roundings add up like a random walk of ~30 steps of
# 2**-9 (~1 %); held at 5x that.
AE_REL_FRO = 5e-2


def write_latent_files(work: str) -> dict:
    """A random autoencoder ``.pth`` under the reference's names (seed 0, the
    default configuration) and copies of the three ImageNet-256 configs that
    point at it, in ``work``. Returns their paths by role."""
    from duodiff_tpu_torch.config import AutoencoderConfig
    from duodiff_tpu_torch.models.autoencoder import init_autoencoder

    ae = init_autoencoder(AutoencoderConfig(), generator=torch.Generator().manual_seed(0))
    files = {"autoencoder": f"{work}/autoencoder_kl.pth"}
    torch.save(ae.state_dict(), files["autoencoder"])
    for role, src in (("early", LATENT_EARLY_CONFIG), ("late", LATENT_CONFIG),
                      ("ee", LATENT_EE_CONFIG)):
        text = re.sub(r"(autoencoder_checkpoint_path:).*",
                      lambda m: f"{m.group(1)} {files['autoencoder']}", Path(src).read_text())
        files[role] = f"{work}/{Path(src).name}"
        Path(files[role]).write_text(text)
    return files


def check_latent(device, files: dict) -> None:
    """Phase 13a's gates: a guided DuoDiff trajectory at D = 1024 (depth 3
    -> 21, LATENT_GATE_STEPS steps, batch 8 doubled), fused against plain on
    one injected noise table, held as phase 3's guided trajectory; the
    autoencoder's ``decode`` and ``encode_moments`` in bf16 against fp32 on
    the same weights (AE_REL_FRO), each timed."""
    from duodiff_tpu_torch.config import load_autoencoder_config
    from duodiff_tpu_torch.diffusion.sampling import duodiff_sample, make_guided_apply
    from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
    from duodiff_tpu_torch.utils.model_loading import load_autoencoder, load_model

    early, _ = load_model(files["early"], device=device, seed=0, attn_impl="fused")
    late, cfg = load_model(files["late"], device=device, seed=1, attn_impl="fused")
    g = torch.Generator().manual_seed(13)
    shape = (CHECK_BATCH, cfg.img_size, cfg.img_size, cfg.in_chans)
    noise = torch.randn((LATENT_GATE_STEPS,) + shape, generator=g).to(device)
    x0 = torch.randn(shape, generator=g).to(device)
    null = cfg.num_classes - 1
    y = torch.randint(0, null, (CHECK_BATCH,), generator=g).to(device)
    outs = {}
    with torch.inference_mode():
        for impl in ("fused", "plain"):
            for m in (early, late):
                set_attn_impl(m, impl)
                m.eval().pack_for_kernels()
            outs[impl] = duodiff_sample(
                make_guided_apply(early, GUIDANCE_SCALE, null),
                make_guided_apply(late, GUIDANCE_SCALE, null), None,
                schedule=NoiseSchedule.create(steps=LATENT_GATE_STEPS, device=device),
                shape=shape, t_switch=LATENT_GATE_SWITCH, y=y, x_init=x0, noise_table=noise)
    max_abs, limit, rel, ok = scaled_errors(outs["fused"], outs["plain"], MODEL_MAX_FRAC)
    print(f"phase 13a: {LATENT_GATE_STEPS}-step guided DuoDiff trajectory on latents (depth 3 -> "
          f"{cfg.depth}, D={cfg.embed_dim}, {cfg.num_heads} heads, t_switch "
          f"{LATENT_GATE_SWITCH}, w={GUIDANCE_SCALE}) B={CHECK_BATCH} fused vs plain: "
          f"rel_fro_err={rel:.6g} (bound {FWD_REL_FRO}) max_abs_err={max_abs:.6g} (bound "
          f"{limit:.6g} = {MODEL_MAX_FRAC}*max|plain|) ok={ok}", flush=True)
    if not ok:
        fail("the fused guided trajectory at D = 1024 disagrees with the plain one")
    del early, late, outs

    ae_cfg = load_autoencoder_config(files["late"])
    models = {dt: load_autoencoder(files["autoencoder"], ae_cfg, dtype=dt, device=device)
              for dt in (torch.bfloat16, torch.float32)}
    x = (torch.rand((4, LATENT_IMAGE, LATENT_IMAGE, 3), generator=g) * 2 - 1).to(device)
    z = torch.randn((4, cfg.img_size, cfg.img_size, cfg.in_chans), generator=g).to(device)
    with torch.inference_mode():
        for name, inp in (("encode_moments", x), ("decode", z)):
            got, want = (getattr(models[dt], name)(inp).float() for dt in models)
            rel = rel_fro(got, want)
            ms = time_ms({str(dt): lambda dt=dt: getattr(models[dt], name)(inp) for dt in models},
                         reps=5)
            print(f"phase 13a: autoencoder {name} B=4 bf16 vs fp32 (no TF32): rel_fro_err="
                  f"{rel:.6g} (bound {AE_REL_FRO}) max|fp32|={want.abs().max().item():.6g} "
                  f"finite={bool(torch.isfinite(got).all())}; bf16 {ms['torch.bfloat16']:.6g} "
                  f"ms, fp32 {ms['torch.float32']:.6g} ms", flush=True)
            if not rel <= AE_REL_FRO or not torch.isfinite(got).all():
                fail(f"the bf16 autoencoder's {name} disagrees with the fp32 one")


def check_latent_files(batch: int, folder: Path) -> None:
    """``{i}.png`` for every sample, decoded 256 x 256 8-bit RGB."""
    for i in range(batch):
        if png_header(folder / f"{i}.png") != (LATENT_IMAGE, LATENT_IMAGE, 8, 2):
            fail(f"{i}.png is not a decoded {LATENT_IMAGE}x{LATENT_IMAGE} RGB image: "
                 f"{png_header(folder / f'{i}.png')}")


def profile_latent_train_step(trainer, card: str) -> None:
    """13e: one latent train step split into the encode (CUDA events, median
    of 5, then profiled) and the U-ViT step's forward, backward and AdamW
    (:func:`profile_step_fn`)."""
    step_fn = trainer._train_step
    images = trainer._to_device(trainer.dataloader.next_batch())
    trainer.dataloader.close()
    with torch.inference_mode():
        enc = time_ms({"encode": lambda: trainer._encode(images, 1)}, reps=5)["encode"]
        profile_steps("phase 13e encode", lambda: trainer._encode(images, 1), n=2)
    batch = trainer._encode(images, 1)
    draws = (*step_fn.draws(batch, 1), step_fn.drop_mask(batch, 1))
    ms = profile_step_fn(step_fn, trainer.state, trainer.model, batch, draws, card, "phase 13e")
    b = images["image"].shape[0]
    print(f"phase 13e: a latent train step at batch {b}: encode of {b} {LATENT_IMAGE}x"
          f"{LATENT_IMAGE} images {enc:.6g} ms ({enc / b:.6g} ms an image) + U-ViT step "
          f"{ms['step']:.6g} ms (forward {ms['forward']:.6g}, backward {ms['backward']:.6g}, "
          f"AdamW {ms['optimizer']:.6g}) = {enc + ms['step']:.6g} ms; card {card}", flush=True)


def run_latent(device, card: str) -> dict:
    """Phase 13: latent ImageNet-256 at D = 1024 with a random autoencoder
    written under the reference's names: (a) the gates; (b) the sampling
    CLI's guided DuoDiff run (depth 3 for 300 steps, then depth 21), batch 16,
    decoded; (c) the cached int8 operating point on the asset's 70 anchors,
    batch 32, decoded; (d) ``eesample``'s dynamic rule on the DeeDiff model,
    100 steps, batch 16, decoded; (e) the training CLI with the encode, batch
    128, bf16, fused, label dropout, 40 steps on a synthetic 256 x 256
    cache, the loss falling, a step's split and peak memory, then its
    checkpoint in ``load_model`` and 10 sampling steps from it. Returns the
    launches of each run."""
    from duodiff_tpu_torch.data.synthetic import write_palette_imagenet256_cache
    from duodiff_tpu_torch.diffusion.cache_schedule import load_cache_schedule
    from duodiff_tpu_torch.training.checkpointer import CHECKPOINT_FILE
    from duodiff_tpu_torch.utils.model_loading import load_model

    runs, d = {}, LATENT_DEPTH
    with tempfile.TemporaryDirectory() as work:
        files = write_latent_files(work)
        check_latent(device, files)
        release_memory()

        n = T_SWITCH * 3 + (STEPS - T_SWITCH) * d
        runs["13b"] = run_cli(
            f"phase 13b: guided DuoDiff {STEPS} steps on ImageNet-256 latents (depth 3 x "
            f"{T_SWITCH}, depth {d} x {STEPS - T_SWITCH}), w={GUIDANCE_SCALE}, forwards at batch "
            f"{2 * LATENT_BATCH}, decoded to {LATENT_IMAGE}x{LATENT_IMAGE},",
            ["--class_id", "-1", "--guidance_scale", str(GUIDANCE_SCALE)], card,
            {"fused_attn_sublayer": n, "fused_mlp_sublayer": n},
            configs=(files["early"], files["late"]), batch=LATENT_BATCH, image_size=LATENT_IMAGE,
            check_output=lambda folder, _: check_latent_files(LATENT_BATCH, folder))

        table = load_cache_schedule(LATENT_CACHE_SCHEDULE, num_timesteps=STEPS)
        anchors = int(table.sum()) + (not table[STEPS - 1])
        n = anchors * d + (STEPS - anchors) * 2 * LATENT_N_OUTER
        runs["13c"] = run_cli(
            f"phase 13c: depth {d} int8 block-cached on the asset's schedule ({anchors} anchored, "
            f"{STEPS - anchors} cached at n_outer {LATENT_N_OUTER}), dynamic scales, tanh GELU, "
            f"decoded,", ["--attn_impl", "fused_int8", "--cache_schedule", LATENT_CACHE_SCHEDULE,
                          "--gelu_approx", "--class_id", "1"], card,
            {"fused_attn_sublayer_int8": n, "fused_mlp_sublayer_int8": n,
             "fused_mlp_sublayer_int8 dynamic": n},
            configs=(files["late"],), batch=LATENT_INT8_BATCH, t_switch=None,
            image_size=LATENT_IMAGE,
            check_output=lambda folder, _: check_latent_files(LATENT_INT8_BATCH, folder))

        n = LATENT_EE_STEPS * d
        result, runs["13d"], _ = run_ee_cli(
            f"phase 13d: dynamic early exit on the ImageNet-256 DeeDiff model, {LATENT_EE_STEPS} "
            f"steps, threshold 0.5, decoded", ["--config_path", files["ee"], "--seed", "0",
                                               "--num_timesteps", str(LATENT_EE_STEPS),
                                               "--threshold", "0.5", "--class_id", "1"],
            card, LATENT_BATCH, lambda r: {"fused_attn_sublayer": n, "fused_mlp_sublayer": n})
        print(f"phase 13d: decode of {LATENT_BATCH} images {result['decode_seconds']:.6g} s",
              flush=True)
        if result["samples"].shape != (LATENT_BATCH, LATENT_IMAGE, LATENT_IMAGE, 3):
            fail(f"phase 13d: samples of shape {result['samples'].shape}")
        release_memory()

        write_palette_imagenet256_cache(Path(work) / "data", n=LATENT_CACHE_IMAGES, seed=0,
                                        size=LATENT_IMAGE)
        floor = release_memory()
        n = d * LATENT_TRAIN_STEPS
        trainer, runs["13e"] = run_train_cli(
            f"phase 13e: train {Path(LATENT_CONFIG).name} on the synthetic ImageNet-256 cache, "
            f"encoded", train_argv(work, "latent", LATENT_TRAIN_STEPS, "--label_dropout",
                                   str(LABEL_DROPOUT), config=files["late"],
                                   dataset="imagenet256"), card,
            {k: n for k in ("fused_attn_sublayer", "fused_mlp_sublayer",
                            "fused_attn_sublayer_bwd", "fused_mlp_sublayer_bwd")})
        peak = torch.cuda.max_memory_allocated() / 2**30
        first, last = trainer.logs[0]["train_loss"], trainer.logs[-1]["train_loss"]
        print(f"phase 13e: loss {first:.6g} -> {last:.6g} (bound: below {LATENT_LOSS_DROP} of the "
              f"first); peak memory {peak:.6g} GiB ({floor:.6g} GiB held before the run); card "
              f"{card}", flush=True)
        if not last < LATENT_LOSS_DROP * first:
            fail(f"phase 13e: the train loss did not fall clearly: {first:.6g} -> {last:.6g}")

        ckpt = trainer.log_path / "imagenet256_uvit_last" / CHECKPOINT_FILE
        model, cfg = load_model(files["late"], str(ckpt), device=device, attn_impl="fused",
                                dtype=trainer.compute_dtype)
        for m in (model, trainer.model):
            m.pack_for_kernels()
            m.eval()
        g = torch.Generator().manual_seed(3)
        x = torch.randn((CHECK_BATCH, cfg.img_size, cfg.img_size, cfg.in_chans), generator=g)
        t = torch.linspace(0, 999, CHECK_BATCH)
        y = torch.randint(0, cfg.num_classes, (CHECK_BATCH,), generator=g)
        with torch.inference_mode():
            same = torch.equal(model(x.to(device), t.to(device), y.to(device)),
                               trainer.model(x.to(device), t.to(device), y.to(device)))
        print(f"phase 13e: checkpoint loaded strictly by load_model; its forward equals the "
              f"trainer's: {same}", flush=True)
        if not same:
            fail("phase 13e: the checkpoint does not reproduce the trained model")
        del model
        profile_latent_train_step(trainer, card)
        del trainer
        release_memory()
        n = d * LATENT_SAMPLE_STEPS
        runs["13e sample"] = run_cli(
            f"phase 13e: the sampling CLI on the trained checkpoint, {LATENT_SAMPLE_STEPS} steps, "
            f"decoded,", ["--checkpoint_path", str(ckpt), "--class_id", "1"], card,
            {"fused_attn_sublayer": n, "fused_mlp_sublayer": n}, configs=(files["late"],),
            batch=LATENT_BATCH, t_switch=None, image_size=LATENT_IMAGE, steps=LATENT_SAMPLE_STEPS,
            random_init=False,
            check_output=lambda folder, _: check_latent_files(LATENT_BATCH, folder))
    print(json.dumps({"phase13_launches": {
        run: {k: v for k, v in counts.items() if v} for run, counts in runs.items()}}), flush=True)
    return runs


# phase 14: evaluation and the quality tools
EVAL_CONFIG = TRAIN_CONFIG                # configs/uvit_cifar10.yaml: D 512, depth 13, L 257
EVAL_SHALLOW_CONFIG = STUDENT_CONFIG      # configs/uvit_cifar10_3.yaml, random: the sweep's
EVAL_EE_CONFIG = str(REPO / "configs/deediff_celeba.yaml")
EVAL_FEATURE_IMAGES = 8    # 14a's card-vs-CPU gate
EVAL_TIME_IMAGES = 512     # 14a's timing, at EVAL_BATCH
EVAL_BATCH = 128           # feature extraction
EVAL_REF_N = 512           # reference draws (score_quality's --ref_n default)
PROBE_STEPS = 1000         # 14c's training, ~47 ms a step (phase 5)
PROBE_SAMPLE_BATCH = 64
QM_METHODS = ("ddpm", "int8", "cache3", "cache3_int8", "ddim50", "dpm20")
QM_BATCH = 64
# 14c's loss, last logged over first (the probe's lr 2e-3, warm-up 50)
PROBE_LOSS_DROP = 0.05  # measured 0.00896 (1.19401 -> 0.0107036), PERF.md
SWEEP_STEPS, SWEEP_SWITCH, SWEEP_BATCH = 250, 75, 64
# 14d's parity rows and gamma probe: PARITY_STEPS steps, on a drift curve of
# every (STEPS / PARITY_STEPS)-th step of the committed schedule's
PARITY_STEPS, PARITY_BATCH, PARITY_CHUNK = 100, 16, 20
GAMMA_BATCH, GAMMA_GAMMAS = 16, "0,1"
# 14a: the card's fp32 features against the CPU's on the same weights, at
# 1e-4 of the largest feature: seeded random features are ~1e-4 in scale, so
# an absolute 1e-4 would hold for any output
FEATURE_REL = 1e-4
EVAL_KERNELS = ("fused_attn_sublayer", "fused_mlp_sublayer", "fused_attn_sublayer_bwd",
                "fused_mlp_sublayer_bwd", "flash_attention", "fused_attn_sublayer_int8",
                "fused_mlp_sublayer_int8")


def box_blur3(images: np.ndarray) -> np.ndarray:
    """The mean of each pixel's 3 x 3 neighbourhood (wrapping at the edges)."""
    return sum(np.roll(images, (dy, dx), axis=(1, 2))
               for dy in (-1, 0, 1) for dx in (-1, 0, 1)) / 9.0


def blocks_of(every, steps: int, depth: int = 13, n_outer: int = N_OUTER) -> int:
    """Block launches of a block-cached run over ``steps`` steps: an anchor
    (t % every == 0, or ``every[t]`` for a table, and the first step) runs
    ``depth`` blocks, a cached step the 2 * n_outer outer ones."""
    anchored = sum(1 for t in range(steps)
                   if t == steps - 1 or (t % every == 0 if isinstance(every, int) else every[t]))
    return anchored * depth + (steps - anchored) * 2 * n_outer


def check_row_counts(label: str, got: dict, expected: dict) -> None:
    """Every kernel's launches in one row of a tool equal ``expected``
    (unlisted kernels: 0), both ways round."""
    for name in sorted(set(got) | set(expected)):
        if got.get(name, 0) != expected.get(name, 0):
            fail(f"{label}: {name} launched {got.get(name, 0)} times, expected "
                 f"{expected.get(name, 0)}")


def bf16_blocks(n: int) -> dict:
    return {"fused_attn_sublayer": n, "fused_mlp_sublayer": n}


def int8_blocks(n: int) -> dict:
    return {"fused_attn_sublayer_int8": n, "fused_mlp_sublayer_int8": n,
            "fused_mlp_sublayer_int8 dynamic": n}


def run_counted(label: str, fn, argv: list, card: str, expected):
    """A tool's ``main`` on the card, every counter set to 0 just before and
    read just after, the whole run's counts checked against ``expected``
    (None: the caller holds the tool's rows one by one and their sum).
    Returns (its result, the launches)."""
    reset_counts()
    tic = time.perf_counter()
    result = fn(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    launches = read_counts()
    print(f"{label}: wall {wall:.6g} s, launches {launches} (expected {expected}), card {card}",
          flush=True)
    if expected is not None:
        check_counts(launches, expected)
    return result, launches


def check_rows_cover(label: str, launches: dict, parts) -> None:
    """The launches of a tool's rows add up to the whole run's: nothing ran
    outside a row."""
    total = {}
    for part in parts:
        for k, v in part.items():
            total[k] = total.get(k, 0) + v
    check_row_counts(f"{label}, all rows", {k: v for k, v in launches.items() if v}, total)


def check_extractor(device, card: str) -> None:
    """14a: the FD-rand extractor (seed 2026) on the card in fp32, with the
    caller's TF32 switched on, against the same weights on the CPU; a
    control run with the extractor's own TF32 switch taken out; a
    pytorch-fid-named ``.pth`` of those weights (with a classifier head,
    under ``state_dict``) loaded by ``load_inception``, equal to the bit;
    ``extract_features`` timed at batch 128."""
    import contextlib

    from duodiff_tpu_torch.evaluation.fid import extract_features
    from duodiff_tpu_torch.evaluation.metrics import random_inception
    from duodiff_tpu_torch.models import inception
    from duodiff_tpu_torch.tools.score_quality import draw_reference

    imgs = draw_reference("textured", 4, EVAL_FEATURE_IMAGES, 32, seed=14)
    want = extract_features(random_inception(device="cpu"), imgs, EVAL_FEATURE_IMAGES)
    model = random_inception(device=device)
    switches = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    own_switch = inception._ieee_fp32_convs
    try:
        got = extract_features(model, imgs, EVAL_FEATURE_IMAGES)
        inception._ieee_fp32_convs = lambda active: contextlib.nullcontext()
        tf32 = extract_features(model, imgs, EVAL_FEATURE_IMAGES)
    finally:
        inception._ieee_fp32_convs = own_switch
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = switches
    scale = float(np.abs(want).max())
    err, err_tf32 = float(np.abs(got - want).max()), float(np.abs(tf32 - want).max())
    ok = err <= FEATURE_REL * scale and bool(np.isfinite(got).all())
    print(f"phase 14a: seed-2026 InceptionV3 features of {EVAL_FEATURE_IMAGES} textured 32x32 "
          f"images, card (TF32 switched on by the caller) vs CPU fp32: max_abs_err={err:.6g} "
          f"(bound {FEATURE_REL * scale:.6g} = {FEATURE_REL}*max|feature| {scale:.6g}) ok={ok}; "
          f"control without the extractor's own switch, TF32 convolutions: max_abs_err="
          f"{err_tf32:.6g} ({err_tf32 / scale:.6g} of max|feature|)", flush=True)
    if not ok:
        fail("phase 14a: the card's Inception features disagree with the CPU's")
    with tempfile.TemporaryDirectory() as work:
        state = {k: v.cpu() for k, v in model.state_dict().items()}
        state.update({"fc.weight": torch.zeros(1000, 2048), "fc.bias": torch.zeros(1000)})
        torch.save({"state_dict": state}, f"{work}/pt_inception_random.pth")
        loaded = inception.load_inception(f"{work}/pt_inception_random.pth", device)
    same = np.array_equal(extract_features(loaded, imgs, EVAL_FEATURE_IMAGES), got)
    print(f"phase 14a: the weights as a pytorch-fid-named .pth in load_inception: features "
          f"equal to the bit: {same}", flush=True)
    if not same:
        fail("phase 14a: the loaded .pth does not reproduce the extractor's features")
    many = draw_reference("textured", 4, EVAL_TIME_IMAGES, 32, seed=15)
    extract_features(model, many[:EVAL_BATCH], EVAL_BATCH)  # warm-up
    torch.cuda.synchronize()
    tic = time.perf_counter()
    extract_features(model, many, EVAL_BATCH)
    torch.cuda.synchronize()
    s = time.perf_counter() - tic
    print(f"phase 14a: extract_features of {EVAL_TIME_IMAGES} 32x32 images at batch "
          f"{EVAL_BATCH} (resize to 299, fp32, no TF32): {s:.6g} s, "
          f"{EVAL_TIME_IMAGES / s:.6g} images/s; card {card}", flush=True)


def check_fd_rand(device, card: str) -> None:
    """14b: two independent textured draws a and b (n = EVAL_REF_N each):
    the real-vs-real floor is a against b; the damage is a against a 3 x 3
    box blur of b, so that the blur is the only change. FD-rand and the
    spectral distance of the blur must lie above the floor, and a repeated
    ``fd_rand`` call on the floor's sets must give its bits again."""
    from concurrent.futures import ThreadPoolExecutor

    from duodiff_tpu_torch.evaluation.fid import extract_features, fids_from_features
    from duodiff_tpu_torch.evaluation.metrics import (
        fd_rand,
        random_inception,
        spectral_distance,
        standardize_features,
    )
    from duodiff_tpu_torch.tools.score_quality import draw_reference

    tic = time.perf_counter()
    a = draw_reference("textured", 4, EVAL_REF_N, 32, seed=123)
    b = draw_reference("textured", 4, EVAL_REF_N, 32, seed=124)
    blur = box_blur3(b).astype(np.float32)
    model = random_inception(device=device)
    raw = [extract_features(model, s, EVAL_BATCH) for s in (a, b, blur)]
    fa, fb, fblur = standardize_features(raw[0], raw)
    # the repeat runs the whole fd_rand (features on the card, the square root
    # on the host) beside the two distances' worker processes
    with ThreadPoolExecutor(1) as thread:
        repeat = thread.submit(fd_rand, a, b, EVAL_BATCH, model=model)
        floor, blurred = fids_from_features([(fa, fb), (fa, fblur)])
        again = repeat.result()
    spec_floor, spec_blur = spectral_distance(a, b), spectral_distance(a, blur)
    s = time.perf_counter() - tic
    finite = all(np.isfinite(v) for v in (floor, blurred, again, spec_floor, spec_blur))
    ok = finite and blurred > floor and spec_blur > spec_floor and again == floor
    print(f"phase 14b: textured, n={EVAL_REF_N} a set: real-vs-real floor FD-rand {floor!r}, "
          f"spectral {spec_floor!r}; against the second draw 3x3 box-blurred: FD-rand "
          f"{blurred!r}, spectral {spec_blur!r}; "
          f"a repeated fd_rand call {again!r} (equal bits: {again == floor}); {s:.6g} s; "
          f"ok={ok}; card {card}", flush=True)
    if not ok:
        fail("phase 14b: FD-rand / the spectral distance do not separate the blur from the "
             "floor, or fd_rand is not deterministic")


def run_quality_path(device, card: str, work: str) -> tuple:
    """14c: ``convergence_probe`` (palette k = 4) trains ``uvit_cifar10.yaml``
    at batch 128, bf16, fused, then ``quality_matrix`` samples the checkpoint
    with each knob of QM_METHODS at batch 64 (each row's launches held
    exactly), and ``score_quality`` scores them (ref_n 512). Returns (the
    launches of each run, the probe's result)."""
    from duodiff_tpu_torch.diffusion.sampling import ddim_pairs, dpm_solver_tables
    from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
    from duodiff_tpu_torch.tools import convergence_probe, quality_matrix, score_quality

    runs = {}
    n, s = 13 * PROBE_STEPS, 13 * STEPS
    result, runs["14c probe"] = run_counted(
        f"phase 14c: convergence_probe, {Path(EVAL_CONFIG).name} palette k=4, {PROBE_STEPS} steps "
        f"at batch {TRAIN_BATCH} bf16, then {PROBE_SAMPLE_BATCH} samples over {STEPS} steps",
        convergence_probe.main,
        ["--config", EVAL_CONFIG, "--steps", str(PROBE_STEPS), "--batch", str(TRAIN_BATCH),
         "--use_amp", "--palette_k", "4", "--sample_batch", str(PROBE_SAMPLE_BATCH),
         "--workdir", f"{work}/probe", "--device", "cuda"], card,
        {**bf16_blocks(n + s), "fused_attn_sublayer_bwd": n, "fused_mlp_sublayer_bwd": n})
    first, last = result["train_loss_first"], result["train_loss_last"]
    print(f"phase 14c: probe result {json.dumps(result)}", flush=True)
    if not last < PROBE_LOSS_DROP * first:
        fail(f"phase 14c: the train loss did not fall clearly: {first:.6g} -> {last:.6g}")

    transitions = len(dpm_solver_tables(NoiseSchedule.create(steps=STEPS), 20)["phi"])
    expected = {
        "ddpm": bf16_blocks(13 * STEPS), "int8": int8_blocks(13 * STEPS),
        "cache3": bf16_blocks(blocks_of(3, STEPS)),
        "cache3_int8": int8_blocks(blocks_of(3, STEPS)),
        "ddim50": bf16_blocks(13 * len(ddim_pairs(STEPS, 50)[0])),
        "dpm20": bf16_blocks(13 * transitions),
    }
    total = {}
    for row in expected.values():
        for k, v in row.items():
            total[k] = total.get(k, 0) + v
    rows, runs["14c quality_matrix"] = run_counted(
        f"phase 14c: quality_matrix {','.join(QM_METHODS)} at batch {QM_BATCH}",
        quality_matrix.main,
        ["--config", EVAL_CONFIG, "--checkpoint", result["checkpoint"], "--methods",
         ",".join(QM_METHODS), "--batch", str(QM_BATCH), "--palette_k", "4",
         "--out", f"{work}/qm", "--device", "cuda"], card, total)
    for name, want in expected.items():
        if "refused" in rows[name]:
            fail(f"phase 14c: the port refused the {name} row: {rows[name]['refused']}")
        check_row_counts(f"phase 14c: quality_matrix row {name}", rows[name]["launches"], want)
    table, _ = run_counted(
        f"phase 14c: score_quality, palette k=4, ref_n {EVAL_REF_N}", score_quality.main,
        ["--out", f"{work}/qm", "--ref_n", str(EVAL_REF_N), "--palette_k", "4",
         "--batch_size", str(EVAL_BATCH), "--device", "cuda"], card, {})
    merged = json.loads(Path(f"{work}/qm/quality_matrix.json").read_text())
    print("phase 14c: | row | sampling s | within-image std | modes hit | counts | "
          "fd_rand_vs_real | fd_rand_vs_dense | spec_vs_real | spec_vs_dense |", flush=True)
    for name, r in [("real_vs_real", table["rows"]["real_vs_real"])] + [
            (m, merged[m]) for m in QM_METHODS]:
        print(f"phase 14c: | {name} | {r.get('elapsed_s', '')} | {r.get('within_image_std', '')} "
              f"| {r.get('modes_hit', '')} | {r.get('mode_counts', '')} | "
              f"{r['fd_rand_vs_real']} | {r['fd_rand_vs_dense']} | {r['spec_vs_real']} | "
              f"{r['spec_vs_dense']} |", flush=True)
    numbers = [v for r in table["rows"].values() for v in r.values()]
    if not all(np.isfinite(v) for v in numbers):
        fail("phase 14c: a quality score is not finite")
    print(json.dumps({"phase14_quality": table["rows"]}), flush=True)
    return runs, result


def run_eval_tools(device, card: str, work: str, probe: dict) -> dict:
    """14d: the ``fid`` CLI on random-init weights (real statistics of the
    probe's data saved), ``t_switch_sweep`` on the 14c backbone and a random
    depth-3 shallow model, ``probe_cache_gamma`` on a 100-step drift curve
    (every tenth step of the committed DuoDiff schedule's), and
    ``trajectory_parity`` over every row at 100 steps, batch 16, with a
    schedule derived from that curve; every row's launches held exactly."""
    from duodiff_tpu_torch import fid
    from duodiff_tpu_torch.diffusion.cache_schedule import (
        derive_anchor_table,
        load_cache_schedule,
        save_cache_schedule,
        uniform_budget,
    )
    from duodiff_tpu_torch.diffusion.sampling import dpm_solver_tables
    from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
    from duodiff_tpu_torch.tools import probe_cache_gamma, t_switch_sweep, trajectory_parity

    runs = {}
    stats = f"{work}/real_stats.npz"
    value, runs["14d fid"] = run_counted(
        "phase 14d: python -m duodiff_tpu_torch.fid on the ddpm row, random-init weights, "
        "--save_real_stats", fid.main,
        ["--dataset", "cifar10", "--data_path", f"{work}/probe/data", "--samples_path",
         f"{work}/qm/ddpm", "--inception_weights", "random-init", "--save_real_stats", stats,
         "--batch_size", str(EVAL_BATCH), "--device", "cuda"], card, {})
    if not np.isfinite(value):
        fail(f"phase 14d: the fid CLI gave {value}")

    n = 2 * (SWEEP_STEPS * 13 + SWEEP_SWITCH * 3 + (SWEEP_STEPS - SWEEP_SWITCH) * 13)
    sweep, runs["14d sweep"] = run_counted(
        f"phase 14d: t_switch_sweep 0 / {SWEEP_SWITCH} over {SWEEP_STEPS} steps, the trained "
        f"backbone and a random depth-3 model, batch {SWEEP_BATCH}", t_switch_sweep.main,
        ["--config_path", EVAL_SHALLOW_CONFIG, "--config_path_late", EVAL_CONFIG,
         "--checkpoint_path_late", probe["checkpoint"], "--real_stats", stats,
         "--inception_weights", "random-init", "--t_switch", "0", str(SWEEP_SWITCH),
         "--n_samples", str(SWEEP_BATCH), "--batch_size", str(SWEEP_BATCH),
         "--num_timesteps", str(SWEEP_STEPS), "--device", "cuda"], card, bf16_blocks(n))
    print(f"phase 14d: sweep {json.dumps(sweep)}", flush=True)
    if not all(np.isfinite(r["fid"]) for r in sweep["results"]):
        fail("phase 14d: a sweep FID is not finite")

    drift = np.asarray(json.loads(Path(CACHE_SCHEDULE).read_text())["meta"]["drift"])
    drift = drift[::len(drift) // PARITY_STEPS][:PARITY_STEPS]
    drift_json, derived = f"{work}/drift.json", f"{work}/derived.json"
    save_cache_schedule(drift_json, np.zeros(PARITY_STEPS, bool), meta={"drift": drift.tolist()})
    save_cache_schedule(derived, derive_anchor_table(drift, uniform_budget(drift, 3)))
    gamma, runs["14d gamma"] = run_counted(
        f"phase 14d: probe_cache_gamma gammas {GAMMA_GAMMAS} on a {PARITY_STEPS}-step drift, batch "
        f"{GAMMA_BATCH}", probe_cache_gamma.main,
        ["--drift_json", drift_json, "--steps", str(PARITY_STEPS), "--batch", str(GAMMA_BATCH),
         "--gammas", GAMMA_GAMMAS, "--device", "cuda"], card, None)
    check_row_counts("phase 14d: probe_cache_gamma dense", gamma["dense_launches"],
                     bf16_blocks(13 * PARITY_STEPS))
    for name, r in gamma["rows"].items():
        a = r["anchored_steps"]
        check_row_counts(f"phase 14d: probe_cache_gamma {name}", r["launches"],
                         bf16_blocks(a * 13 + (PARITY_STEPS - a) * 2 * N_OUTER))
    check_rows_cover("phase 14d: probe_cache_gamma", runs["14d gamma"],
                     [gamma["dense_launches"]] + [r["launches"] for r in gamma["rows"].values()])
    print(f"phase 14d: probe_cache_gamma {json.dumps(gamma['rows'])}", flush=True)

    table = load_cache_schedule(derived, num_timesteps=PARITY_STEPS)
    transitions = len(dpm_solver_tables(NoiseSchedule.create(steps=PARITY_STEPS), 20)["phi"])
    anchored = len(range(0, transitions, 3))
    t = PARITY_STEPS
    buckets = [(t - 1, int(t * 0.7), 3), (int(t * 0.7) - 1, int(t * 0.3), 8),
               (int(t * 0.3) - 1, 0, 13)]
    dense = 13 * PARITY_STEPS
    expected = {
        "determinism fused (rerun)": bf16_blocks(dense),
        "attn xla vs fused": {}, "attn plain vs fused": {},
        "attn pallas vs fused": {"flash_attention": dense},
        "gelu tanh vs exact (fused)": bf16_blocks(dense),
        "attn fused_int8 vs fused": int8_blocks(dense),
        "block-cache every=3 vs dense": bf16_blocks(blocks_of(3, t)),
        "block-cache every=5 vs dense": bf16_blocks(blocks_of(5, t)),
        "block-cache every=3 + int8 vs dense": int8_blocks(blocks_of(3, t)),
        "block-cache every=5 + int8 vs dense": int8_blocks(blocks_of(5, t)),
        "block-cache derived vs dense": bf16_blocks(blocks_of(table, t)),
        "block-cache derived + int8 vs dense": int8_blocks(blocks_of(table, t)),
        "DPM-20 vs DDPM-1000 (shared x_init)": bf16_blocks(13 * transitions),
        "DPM-20 cached every=3 vs DPM-20 dense": bf16_blocks(
            anchored * 13 + (transitions - anchored) * 2 * N_OUTER),
        "static buckets vs dynamic thr=0.08": bf16_blocks(
            dense + sum(layer * (hi - lo + 1) for hi, lo, layer in buckets)),
    }
    parity, runs["14d parity"] = run_counted(
        f"phase 14d: trajectory_parity, {PARITY_STEPS} steps, batch {PARITY_BATCH}, every row",
        trajectory_parity.main,
        ["--batch", str(PARITY_BATCH), "--steps", str(PARITY_STEPS), "--chunk",
         str(PARITY_CHUNK), "--cache_schedule", derived, "--ee_config", EVAL_EE_CONFIG,
         "--out", f"{work}/parity.json", "--device", "cuda"], card, None)
    if set(parity["rows"]) != set(expected):
        fail(f"phase 14d: trajectory_parity rows {sorted(parity['rows'])}, expected "
             f"{sorted(expected)}")
    check_row_counts("phase 14d: trajectory_parity baseline", parity["baseline_launches"],
                     bf16_blocks(dense))
    for name, want in expected.items():
        check_row_counts(f"phase 14d: trajectory_parity {name}", parity["rows"][name]["launches"],
                         want)
    check_rows_cover("phase 14d: trajectory_parity", runs["14d parity"],
                     [parity["baseline_launches"]]
                     + [r["launches"] for r in parity["rows"].values()])
    print(f"phase 14d: trajectory_parity {json.dumps(parity['rows'])}", flush=True)
    return runs


def run_evaluation(device, card: str) -> dict:
    """Phase 14: evaluation and the quality tools. Returns the launches of
    each run."""
    tic = time.perf_counter()
    check_extractor(device, card)
    check_fd_rand(device, card)
    with tempfile.TemporaryDirectory() as work:
        runs, probe = run_quality_path(device, card, work)
        release_memory()
        runs.update(run_eval_tools(device, card, work, probe))
    release_memory()
    print(f"phase 14: {time.perf_counter() - tic:.6g} s", flush=True)
    print(json.dumps({"phase14_launches": {
        run: {k: v for k, v in counts.items() if v} for run, counts in runs.items()}}),
        flush=True)
    return runs


# --- phase 15: serving ------------------------------------------------------

SERVE_CONFIG = LATE_CONFIG              # configs/uvit_celeba.yaml: D 512, depth 13, L 257
SERVE_KERNEL_BATCHES = (1, 3, 16)       # one image, an odd slot count, a wide slot batch
SERVE_SLOTS = 8
SERVE_CACHE_PATTERN = "1,0,0"           # every 3 steps an anchor; n_outer 2, depth 13's default
SERVE_SEED = 7
SERVE_BUCKET_IMAGES = 2                 # 15b's request
SERVE_CLIENTS = 8                       # 15d: the A/B's load
SERVE_REQUESTS_PER_CLIENT = 4
SERVE_AB_STEPS = 20                     # 15d: DPM-Solver++ 20 steps, a load shape
SERVE_STEPS_PER_POLL = 5                # serve.py's default; it divides 1000 and 20, so a
                                        # wave's last advance runs no step past its end
SERVE_TIMEOUT = 600                     # seconds an HTTP call may take before the check fails


def http_json(url: str, payload=None, timeout: float = SERVE_TIMEOUT) -> tuple:
    """(status, JSON body) of a GET (``payload`` None) or a POST of ``payload``."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def start_server(argv: list) -> tuple:
    """``duodiff_tpu_torch.serve.main(argv)`` in a thread of this process, on
    an ephemeral port; returns (server, service, base URL, thread) once it
    listens. The service's ``sample`` is wrapped to keep what it returned
    (float images in [0, 1]) in ``service.returned``."""
    from duodiff_tpu_torch import serve

    ready, box, failed = threading.Event(), [], []

    def run():
        try:
            serve.main(argv, ready_event=ready, server_box=box)
        except BaseException as e:  # noqa: BLE001 — reported below
            failed.append(e)
            ready.set()

    th = threading.Thread(target=run, daemon=True)
    th.start()
    if not ready.wait(timeout=SERVE_TIMEOUT) or failed:
        fail(f"the server {argv} did not come up: {failed}")
    httpd, service = box[0]
    service.returned = []
    inner = service.sample

    def sample(**kw):
        imgs = inner(**kw)
        service.returned.append(imgs)
        return imgs

    service.sample = sample
    return httpd, service, f"http://127.0.0.1:{httpd.server_address[1]}", th


def stop_server(httpd, th) -> None:
    httpd.shutdown()
    th.join(timeout=120)
    if th.is_alive():
        fail("the server thread did not end")


def check_png_images(label: str, resp: dict, n: int, side: int = 64) -> list:
    """The response's ``n`` PNG images decoded (utils/image.py), each side x
    side x 3; returns their pixels."""
    from duodiff_tpu_torch.utils.image import decode_png

    if len(resp.get("images", [])) != n:
        fail(f"{label}: {len(resp.get('images', []))} images, expected {n}")
    pixels = [decode_png(base64.b64decode(b))["pixels"] for b in resp["images"]]
    for p in pixels:
        if p.shape != (side, side, 3) or p.dtype != np.uint8:
            fail(f"{label}: a PNG decodes to {p.shape} {p.dtype}, expected ({side}, {side}, 3)")
    return pixels


def check_returned(label: str, imgs: list, n: int, side: int = 64) -> None:
    if len(imgs) != n or any(np.asarray(i).shape != (side, side, 3) for i in imgs):
        fail(f"{label}: the service returned {[np.asarray(i).shape for i in imgs]}")
    if not all(np.isfinite(i).all() for i in imgs):
        fail(f"{label}: images are not finite")


def check_serving_kernels(device, results: dict) -> dict:
    """15a: K1 (with and without a qkv bias), K2 (exact and tanh GELU), K11
    (with and without a qkv bias) and K12 (dynamic and static, exact and
    tanh GELU) against their plain versions at the serving batches 1, 3 and
    16 (a request of one image is M = 257 rows), phase 2's elementwise
    bounds, each timed call by call beside its bound at that batch; and
    whether a row's output depends on the batch: the kernel on the first
    element alone against the first row of the whole batch, to the bit."""
    from duodiff_tpu_torch.ops import block
    from duodiff_tpu_torch.ops import block_int8 as q
    from duodiff_tpu_torch.utils.int8_scales import load_int8_scales

    static = load_int8_scales(INT8_SCALES)["mid_block"]
    heads, rows_equal = CELEBA.heads, {}
    for batch in SERVE_KERNEL_BATCHES:
        suffix = f"_b{batch}"
        for name, b in kernel_bounds(CELEBA, batch).items():
            if name in (*KERNELS, *INT8_KERNELS):
                results[name]["bound_ms" + suffix] = b["bound_ms"]
        cases = []
        for variant in (False, True):
            x, attn_ops, mlp_ops = sublayer_operands(batch, variant, device)
            cases += [
                ("fused_attn_sublayer", f"qkv_bias={variant}", x,
                 lambda x, o=attn_ops: block.fused_attn_sublayer(x, *o, num_heads=heads),
                 lambda x, o=attn_ops: block.attn_sublayer_plain(x, *o, num_heads=heads),
                 not variant),
                ("fused_mlp_sublayer", f"gelu={'tanh' if variant else 'erf'}", x,
                 lambda x, o=mlp_ops, v=variant: block.fused_mlp_sublayer(x, *o, gelu_approx=v),
                 lambda x, o=mlp_ops, v=variant: block.mlp_sublayer_plain(x, *o, gelu_approx=v),
                 not variant),
            ]
            xi, norm, qkv, proj, fc1, fc2 = block_modules(batch, variant)
            xi = xi.to(device)
            ops = to_device(q.pack_attn_int8(norm, qkv, proj, num_heads=heads), device)
            cases.append((
                "fused_attn_sublayer_int8", f"qkv_bias={variant}", xi,
                lambda x, o=ops: q.fused_attn_sublayer_int8(x, *o, num_heads=heads),
                lambda x, o=ops: q.attn_sublayer_int8_plain(x, *o, num_heads=heads), not variant))
            if not variant:
                for scales in (None, static):
                    mops = to_device(q.pack_mlp_int8(norm, fc1, fc2, static_scales=scales),
                                     device)
                    for tanh in (False, True):
                        cases.append((
                            "fused_mlp_sublayer_int8",
                            f"scales={'static' if scales else 'dynamic'} "
                            f"gelu={'tanh' if tanh else 'erf'}", xi,
                            lambda x, o=mops, v=tanh: q.fused_mlp_sublayer_int8(x, *o,
                                                                                gelu_approx=v),
                            lambda x, o=mops, v=tanh: q.mlp_sublayer_int8_plain(x, *o,
                                                                                gelu_approx=v),
                            # the served model's static scales, exact GELU
                            scales is not None and not tanh))
        for name, label, x, kernel, plain, timed in cases:
            compare_kernel(results[name], f"{name} D={CELEBA.d} L={CELEBA.l} B={batch} {label}",
                           lambda: kernel(x), lambda: plain(x), suffix if timed else None,
                           phase="phase 15a")
            if batch > 1:
                same = torch.equal(kernel(x)[:1], kernel(x[:1].contiguous()))
                rows_equal[f"{name} {label} B={batch}"] = same
                print(f"phase 15a: {name} {label}: the first element alone equals the first row "
                      f"of batch {batch} to the bit: {same}", flush=True)
    for name in (*KERNELS, *INT8_KERNELS):
        results[name]["rows_equal_across_batches"] = all(
            v for k, v in rows_equal.items() if k.split()[0] == name)
    print(json.dumps({"phase15a_rows_equal_across_batches": rows_equal}), flush=True)
    return rows_equal


def run_bucket_server(card: str) -> dict:
    """15b: the bucket server over HTTP (``--random_init``, ddpm by default,
    fused bf16 by default, ``--bucket 1``): ``POST /sample {"n": 2, "seed":
    7}`` twice, each with the counters set to 0 just before and read just
    after (K1 = K2 = 2 x 1000 x 13), the PNG images decoded, the two
    answers equal to the byte; ``/healthz`` names the card."""
    httpd, svc, base, th = start_server(["--config_path", SERVE_CONFIG, "--random_init",
                                         "--port", "0", "--device", "cuda", "--bucket", "1"])
    try:
        code, info = http_json(base + "/healthz")
        print(f"phase 15b: /healthz {code} {info}", flush=True)
        want_info = {"status": "ok", "card": torch.cuda.get_device_name(0), "mode": "bucket",
                     "method": "ddpm", "steps": STEPS, "attn_impl": "fused", "bucket": 1}
        if code != 200 or any(info.get(k) != v for k, v in want_info.items()):
            fail(f"phase 15b: /healthz gave {info}, expected {want_info}")
        answers, launches = [], {}
        expected = bf16_blocks(SERVE_BUCKET_IMAGES * STEPS * 13)
        for i in range(2):
            reset_counts()
            tic = time.perf_counter()
            code, resp = http_json(base + "/sample", {"n": SERVE_BUCKET_IMAGES, "seed": SERVE_SEED})
            wall = time.perf_counter() - tic
            launches = read_counts()
            print(f"phase 15b: POST /sample n={SERVE_BUCKET_IMAGES} seed={SERVE_SEED} (#{i + 1}): "
                  f"{code}, wall {wall:.6g} s ({SERVE_BUCKET_IMAGES / wall:.6g} images/s, server "
                  f"elapsed_ms {resp.get('elapsed_ms')}), launches "
                  f"{ {k: v for k, v in launches.items() if v} } (expected {expected}), card "
                  f"{card}", flush=True)
            if code != 200:
                fail(f"phase 15b: POST /sample answered {code}: {resp}")
            check_counts(launches, expected)
            check_png_images("phase 15b", resp, SERVE_BUCKET_IMAGES)
            check_returned("phase 15b", svc.returned[-1], SERVE_BUCKET_IMAGES)
            answers.append(resp["images"])
        same = answers[0] == answers[1]
        print(f"phase 15b: the repeated request's PNG bytes equal the first's: {same}", flush=True)
        if not same:
            fail("phase 15b: the same request gave other bytes")
    finally:
        stop_server(httpd, th)
    return launches


def run_continuous_server(card: str) -> dict:
    """15c: the continuous server (``--slots 8``, int8 with the asset's
    static scales, ``--cache_pattern 1,0,0``, no warm-up): one request of 8
    images, admitted on one wave, its launches exact (K11 = K12 =
    blocks_of(3, 1000), every K12 launch static); each image against the
    bucket-1 server's on the same flags and seed (equal bits, or within the
    trajectory gate: FWD_REL_FRO and MODEL_MAX_FRAC of the largest value);
    then a failure injected into the device loop fails both waiting
    requests with 503, and a later request and ``/healthz`` answer 503."""
    from duodiff_tpu_torch import serve
    from duodiff_tpu_torch.diffusion.continuous import periodic_pattern_table

    flags = ["--config_path", SERVE_CONFIG, "--random_init", "--device", "cuda",
             "--attn_impl", "fused_int8", "--int8_scales", INT8_SCALES,
             "--cache_pattern", SERVE_CACHE_PATTERN, "--no-warmup"]
    n = SERVE_SLOTS
    pattern = [int(v) for v in SERVE_CACHE_PATTERN.split(",")]
    blocks = blocks_of(periodic_pattern_table(pattern, STEPS), STEPS)
    expected = {"fused_attn_sublayer_int8": blocks, "fused_mlp_sublayer_int8": blocks,
                "fused_mlp_sublayer_int8 static": blocks}
    httpd, svc, base, th = start_server(flags + ["--port", "0", "--slots", str(n),
                                                 "--steps_per_poll", str(SERVE_STEPS_PER_POLL)])
    try:
        code, info = http_json(base + "/healthz")
        print(f"phase 15c: /healthz {code} {info}", flush=True)
        if code != 200 or info.get("mode") != "continuous" or info.get("slots") != n \
                or info.get("card") != torch.cuda.get_device_name(0):
            fail(f"phase 15c: /healthz gave {info}")
        reset_counts()
        tic = time.perf_counter()
        code, resp = http_json(base + "/sample", {"n": n, "seed": SERVE_SEED})
        wall = time.perf_counter() - tic
        launches = read_counts()
        print(f"phase 15c: POST /sample n={n} seed={SERVE_SEED}: {code}, wall {wall:.6g} s "
              f"({n / wall:.6g} images/s, server elapsed_ms {resp.get('elapsed_ms')}), launches "
              f"{ {k: v for k, v in launches.items() if v} } (expected {expected}), card {card}",
              flush=True)
        if code != 200:
            fail(f"phase 15c: POST /sample answered {code}: {resp}")
        check_counts(launches, expected)
        check_png_images("phase 15c", resp, n)
        got = svc.returned[-1]
        check_returned("phase 15c", got, n)

        # a device-loop failure: both requests in flight get 503, none hangs
        def boom():
            deadline = time.time() + 60
            while len(svc._slot_jobs) + len(svc._queue) < 3 and time.time() < deadline:
                time.sleep(0.01)
            raise RuntimeError("injected device failure")

        svc.batcher.advance = boom
        answers = {}

        def hit(key, payload):
            answers[key] = http_json(base + "/sample", payload, timeout=120)

        waiters = [threading.Thread(target=hit, args=(k, {"n": m, "seed": 1}))
                   for k, m in (("a", 2), ("b", 1))]
        tic = time.perf_counter()
        for w in waiters:
            w.start()
            time.sleep(0.5)
        for w in waiters:
            w.join(timeout=180)
        codes = {k: answers.get(k, (None,))[0] for k in ("a", "b")}
        later = http_json(base + "/sample", {"n": 1, "seed": 2}, timeout=60)
        health = http_json(base + "/healthz", timeout=60)
        print(f"phase 15c: injected device-loop failure: the two waiting requests answered "
              f"{codes} in {time.perf_counter() - tic:.3g} s ({answers.get('a', (0, {}))[1]}); a "
              f"later request {later}; /healthz {health[0]} {health[1].get('status')}",
              flush=True)
        if codes != {"a": 503, "b": 503} or later[0] != 503 or health[0] != 503 \
                or health[1].get("status") != "stopped":
            fail(f"phase 15c: a device-loop failure gave {codes}, then {later[0]} and /healthz "
                 f"{health[0]} {health[1].get('status')}, expected 503 throughout and 'stopped'")
    finally:
        stop_server(httpd, th)

    # the bucket-1 server on the same flags: the same images
    ref = serve.SamplerService(serve.get_args(flags + ["--bucket", "1"]))
    tic = time.perf_counter()
    want = ref.sample(n=n, seed=SERVE_SEED)
    ref_s = time.perf_counter() - tic
    ref.close()
    equal = [bool(np.array_equal(a, b)) for a, b in zip(got, want)]
    worst = {"rel_fro": 0.0, "max_abs": 0.0, "bound": float("inf")}
    for a, b in zip(got, want):
        max_abs, limit, rel, ok = scaled_errors(torch.from_numpy(np.asarray(a)),
                                                torch.from_numpy(np.asarray(b)), MODEL_MAX_FRAC)
        worst = {"rel_fro": max(worst["rel_fro"], rel), "max_abs": max(worst["max_abs"], max_abs),
                 "bound": min(worst["bound"], limit)}
        if not ok:
            fail(f"phase 15c: a continuous image is {rel:.6g} (relative Frobenius) and "
                 f"{max_abs:.6g} (max, bound {limit:.6g}) from the bucket-1 server's")
    print(f"phase 15c: the 8 images against the bucket-1 server's ({ref_s:.6g} s for 8 "
          f"trajectories at batch 1): equal to the bit {equal}; worst relative Frobenius "
          f"{worst['rel_fro']:.6g} (bound {FWD_REL_FRO}), worst max |diff| {worst['max_abs']:.6g} "
          f"(bound {worst['bound']:.6g} = {MODEL_MAX_FRAC} x max)", flush=True)
    release_memory()
    return launches


def run_serving_ab(device, card: str) -> dict:
    """15d: ``tools.bench_serving`` on the card, bucket 1 against 8 slots,
    ``--clients 8 --requests_per_client 4``, DPM-Solver++ 20 steps given
    explicitly (a load shape here, not a quality choice): both JSON lines
    and the ratio line, beside the card. The launches depend on when the
    requests reach the slots, so they are held to what is exact: K1 = K2,
    13 a forward, no other kernel, at least the bucket pass's and at most
    twice it (the slot pass runs at most one forward an image a step, as
    when every image rides alone, so an advance with no job in flight
    fails the check). Then a
    profile of three ``advance()`` calls of an 8-slot batcher at that shape:
    the device's idle share and the host's time a step."""
    from duodiff_tpu_torch.diffusion.continuous import ContinuousDiffusionBatcher
    from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
    from duodiff_tpu_torch.tools import bench_serving
    from duodiff_tpu_torch.utils.model_loading import load_model

    argv = ["--config_path", SERVE_CONFIG, "--random_init", "--method", "dpm",
            "--steps", str(SERVE_AB_STEPS), "--clients", str(SERVE_CLIENTS),
            "--requests_per_client", str(SERVE_REQUESTS_PER_CLIENT), "--slots", str(SERVE_SLOTS),
            "--steps_per_poll", str(SERVE_STEPS_PER_POLL), "--bucket", "1", "--device", "cuda"]
    print(f"phase 15d: card {card}", flush=True)
    result, launches = run_counted("phase 15d: tools.bench_serving", bench_serving.main, argv,
                                   card, None)
    for mode in ("bucket", "continuous", "ratio"):
        if mode not in result:
            fail(f"phase 15d: no {mode} line")
    print(f"phase 15d: {json.dumps(result['bucket'])}; {json.dumps(result['continuous'])}; "
          f"{json.dumps(result['ratio'])}; card {card}", flush=True)
    k1, k2 = launches["fused_attn_sublayer"], launches["fused_mlp_sublayer"]
    # the bucket pass: warm-up, touch pass, measured pass, one trajectory an image
    bucket = (1 + SERVE_CLIENTS + SERVE_CLIENTS * SERVE_REQUESTS_PER_CLIENT) * SERVE_AB_STEPS * 13
    others = {k: v for k, v in launches.items() if v and k not in KERNELS}
    if k1 != k2 or k1 % 13 or not bucket <= k1 <= 2 * bucket or others:
        fail(f"phase 15d: launches {launches}: expected K1 = K2, a multiple of 13, from "
             f"{bucket} to {2 * bucket}, no other kernel")

    model, cfg = load_model(SERVE_CONFIG, device=device, attn_impl="fused")
    model.eval().pack_for_kernels()
    schedule = NoiseSchedule.create(steps=STEPS, device=device)
    with torch.inference_mode():
        batcher = ContinuousDiffusionBatcher(
            model, schedule, img_shape=(cfg.img_size, cfg.img_size, cfg.in_chans),
            slots=SERVE_SLOTS, method="dpm", dpm_steps=SERVE_AB_STEPS,
            steps_per_poll=SERVE_STEPS_PER_POLL)
        batcher.admit_many({s: (torch.Generator(device=device).manual_seed(s), None)
                            for s in range(SERVE_SLOTS)})
        batcher.advance()
        torch.cuda.synchronize()
        tic = time.perf_counter()
        for _ in range(3):
            batcher.advance()
        issued = time.perf_counter() - tic
        torch.cuda.synchronize()
        done = time.perf_counter() - tic
        steps = 3 * SERVE_STEPS_PER_POLL
        print(f"phase 15d: three advance() calls of {SERVE_SLOTS} slots ({steps} steps, "
              f"DPM-Solver++, bf16 fused): the host issued them in {issued * 1e3:.6g} ms "
              f"({issued * 1e3 / steps:.6g} ms a step), the device finished after "
              f"{done * 1e3:.6g} ms ({done * 1e3 / steps:.6g} ms a step); card {card}", flush=True)
        profile_steps("phase 15d, three advance() calls of 8 slots", batcher.advance)
    del model, batcher
    release_memory()
    return launches


def run_serving(device, card: str, results: dict) -> dict:
    """Phase 15: serving. Returns the launches of each counted run."""
    tic = time.perf_counter()
    check_serving_kernels(device, results)
    release_memory()
    runs = {"15b": run_bucket_server(card)}
    release_memory()
    runs["15c"] = run_continuous_server(card)
    runs["15d"] = run_serving_ab(device, card)
    print(f"phase 15: {time.perf_counter() - tic:.6g} s", flush=True)
    print(json.dumps({"phase15_launches": {
        run: {k: v for k, v in counts.items() if v} for run, counts in runs.items()}}),
        flush=True)
    return runs


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
    clock = {"phase": "1", "at": time.perf_counter()}

    def lap(phase: str) -> None:
        """Print the wall time of the phase that just ended (if it ran) and
        start the clock of ``phase``."""
        now = time.perf_counter()
        if clock["phase"] == "1" or clock["phase"] in run:
            print(f"wall time: phase {clock['phase']} {now - clock['at']:.6g} s", flush=True)
        clock.update(phase=phase, at=now)

    card = setup()
    kernels = {**KERNELS, **INT8_KERNELS, **BWD_KERNELS, **ATTENTION_KERNELS, **BLOCK_KERNELS,
               **PROBE_KERNELS}
    results = new_results(kernels)
    launches = {}
    lap("2")
    if "2" in run:
        report_gemm()
        bf16_gemm = check_gemm(device)
        report_gemm_int8()
        check_gemm_int8(device, bf16_gemm)
        check_ln_quant(device)
        report_gemm_t()
        check_gemm_t(device)
        check_kernels(device, results)
        check_int8_kernels(device, results)
        check_bwd_kernels(device, results)
        check_attention_kernels(device, results)
        report_attention_cores()
        check_ragged_attention(device, results)
        check_kernels(device, results, IMAGENET, variants=(False,), suffix="_d768")
        check_bwd_kernels(device, results, IMAGENET, variants=(False,), suffix="_d768")
        check_int8_kernels(device, results, IMAGENET, batches=(CHECK_BATCH,), suffix="_d768_b8")
        check_block_kernels(device, results, IMAGENET, suffix="")
        check_split_kernel(device, results, IMAGENET, variants=(False,), suffix="")
        check_block_kernels(device, results, CELEBA, suffix="_d512")
        check_split_kernel(device, results, CELEBA, variants=(False, True), suffix="_d512")
        check_latent_width_kernels(device, results)
        check_probe_kernels(device, results)
        report_int8_chain()
        check_ragged_int8_chain(device, results)
    lap("3")
    if "3" in run:
        check_model(device)
        check_int8_model(device)
        check_training(device)
        check_imagenet_model(device)
        launches.update(check_block_stack(device))
        check_split_training(device)
    lap("4")
    if "4" in run:
        launches.update({name: n for name, n in run_main_path(card).items() if name in KERNELS})
        profile_sampling_steps(device, card, int8=False)
    lap("4b")
    if "4b" in run:
        launches.update({name: n for name, n in run_int8_main_path(card).items()
                         if name in INT8_KERNELS})
        profile_sampling_steps(device, card, int8=True)
    lap("5")
    if "5" in run:
        launches.update({name: n for name, n in run_train_path(device, card).items()
                         if name in BWD_KERNELS})
    lap("5b")
    if "5b" in run:
        run_distill_path(card)
    lap("6")
    if "6" in run:
        launches["flash_attention"] = run_imagenet_sampling(device, card)["flash_attention"]
    fused_peak = None
    lap("7")
    if "7" in run:
        imagenet_launches, fused_peak = run_imagenet_training(card)
        launches["flash_attention_bwd"] = imagenet_launches["flash_attention_bwd"]
    lap("8")
    if "8" in run:
        split_launches = run_split_training(card, fused_peak)
        launches["fused_mlp_sublayer_bwd_split"] = split_launches["fused_mlp_sublayer_bwd_split"]
    lap("9")
    if "9" in run:
        launches.update(run_probe_tools(card))
    lap("10")
    if "10" in run:
        # phase 4 / 4b's counts stay the record where those paths ran
        for counts in run_other_samplers(device, card).values():
            for name in (*KERNELS, *INT8_KERNELS):
                if counts.get(name):
                    launches.setdefault(name, counts[name])
    lap("11")
    if "11" in run:
        # early exit's launches are added to the record of K1, K2, K11 and K12
        for counts in run_early_exit(device, card).values():
            for name in (*KERNELS, *INT8_KERNELS):
                if counts.get(name):
                    launches[name] = launches.get(name, 0) + counts[name]
    lap("12")
    if "12" in run:
        # early-exit training's launches are added to K1, K2, K6, K7, K11 and K12
        for counts in run_ee_training(device, card).values():
            for name in (*KERNELS, *INT8_KERNELS, *BWD_KERNELS):
                if counts.get(name):
                    launches[name] = launches.get(name, 0) + counts[name]
    lap("13")
    if "13" in run:
        # latent ImageNet-256's launches are added to K1, K2, K6, K7, K11 and K12
        for counts in run_latent(device, card).values():
            for name in (*KERNELS, *INT8_KERNELS, *BWD_KERNELS):
                if counts.get(name):
                    launches[name] = launches.get(name, 0) + counts[name]
    lap("14")
    if "14" in run:
        # evaluation's launches are added to K1, K2, K6, K7, K9, K11 and K12
        for counts in run_evaluation(device, card).values():
            for name in EVAL_KERNELS:
                if counts.get(name):
                    launches[name] = launches.get(name, 0) + counts[name]
    lap("15")
    if "15" in run:
        # serving's launches are added to K1, K2, K11 and K12, and kept apart
        for counts in run_serving(device, card, results).values():
            for name in (*KERNELS, *INT8_KERNELS):
                if counts.get(name):
                    launches[name] = launches.get(name, 0) + counts[name]
                    results[name]["launches_15"] = (results[name].get("launches_15", 0)
                                                    + counts[name])
    lap("end")
    print(f"wall time: the whole run {time.perf_counter() - STARTED:.6g} s since the process "
          "started", flush=True)
    if run == set(PHASES):
        idle = sorted(name for name in kernels if not launches.get(name))
        if idle:
            fail(f"kernels never launched on their paths: {idle}")
    # the bounds at the width of each kernel's main path: CelebA's for the
    # sublayers, their int8 and backward forms and the probes' kernels,
    # ImageNet-64's for K1-v1, K5 and K8
    bounds = {**kernel_bounds(), **{k: v for k, v in kernel_bounds(IMAGENET).items()
                                    if k in BLOCK_KERNELS}}
    # and at D = 1024 beside the times phase 2 keeps there
    for name, b in kernel_bounds(IMAGENET256).items():
        if "ms_d1024" in results.get(name, {}):
            bounds[name] = {**bounds[name], "bound_ms_d1024": b["bound_ms"]}
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
