"""What the probe tools share: the card's line and the two ways they time.

On the card times come from CUDA events around the timed calls (an event
pair on the stream times the device's work itself, so no trick with trip
counts is needed to take the dispatch out); on the CPU, where the wrappers
take their plain versions, from the host clock, and they say nothing about
the card.
"""

from __future__ import annotations

import subprocess
import time

import torch


def device_from_arg(name: str) -> torch.device:
    """``--device``'s value as a device; a CUDA device that is not there is
    refused, never replaced by the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available")
    return device


def card_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if device.type != "cuda":
        return f"{device} (no card: times below are not device times)"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def elapsed_ms(run, device: torch.device) -> float:
    """Time of one ``run()``: CUDA events on the card, the host clock on the CPU."""
    if device.type != "cuda":
        tic = time.perf_counter()
        run()
        return (time.perf_counter() - tic) * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def time_ms(fn, device: torch.device, reps: int, warmup: int = 1) -> float:
    """Mean time per call over ``reps`` calls of ``fn()`` after ``warmup`` calls."""
    for _ in range(warmup):
        fn()

    def run():
        for _ in range(reps):
            fn()

    return elapsed_ms(run, device) / reps


def chain_ms(step, x: torch.Tensor, iters: int) -> float:
    """Mean time per call of a chain ``x <- step(x)`` of ``iters`` calls, each
    fed by the one before so that no call sees the same data twice, after one
    warm-up chain from the same start."""
    def run():
        y = x
        for _ in range(iters):
            y = step(y)

    run()
    return elapsed_ms(run, x.device) / iters


def _counted_wrappers() -> dict:
    """Every kernel wrapper's launch counter by name: (wrapper, attribute)."""
    from duodiff_tpu_torch.ops import block, block_int8, flash_attention, sdpa_int8

    k11, k12 = block_int8.fused_attn_sublayer_int8, block_int8.fused_mlp_sublayer_int8
    return {
        "flash_attention": (flash_attention.flash_attention, "launches"),
        "flash_attention_bwd": (flash_attention.flash_attention_bwd, "launches"),
        "fused_attn_sublayer": (block.fused_attn_sublayer, "launches"),
        "fused_mlp_sublayer": (block.fused_mlp_sublayer, "launches"),
        "fused_attn_sublayer_bwd": (block.fused_attn_sublayer_bwd, "launches"),
        "fused_mlp_sublayer_bwd": (block.fused_mlp_sublayer_bwd, "launches"),
        "fused_attn_sublayer_shard": (block.fused_attn_sublayer, "launches_shard"),
        "fused_mlp_sublayer_shard": (block.fused_mlp_sublayer, "launches_shard"),
        "fused_attn_sublayer_bwd_shard": (block.fused_attn_sublayer_bwd, "launches_shard"),
        "fused_mlp_sublayer_bwd_shard": (block.fused_mlp_sublayer_bwd, "launches_shard"),
        "fused_attn_sublayer_v1": (block.fused_attn_sublayer, "launches_v1"),
        "fused_block": (block.fused_block, "launches"),
        "fused_mlp_sublayer_bwd_split": (block.fused_mlp_sublayer_bwd_split, "launches"),
        "fused_attn_sublayer_int8": (k11, "launches"),
        "fused_attn_sublayer_int8 static": (k11, "launches_static"),
        "fused_mlp_sublayer_int8": (k12, "launches"),
        "fused_mlp_sublayer_int8 dynamic": (k12, "launches_dynamic"),
        "fused_mlp_sublayer_int8 static": (k12, "launches_static"),
        "sdpa_chain_bf16": (sdpa_int8.sdpa_chain_bf16, "launches"),
        "sdpa_chain_int8": (sdpa_int8.sdpa_chain_int8, "launches"),
    }


def launch_counts() -> dict:
    """Every wrapper's launch counter by name. The counters are the
    wrappers' own: one a launch of a kernel on the card, none for a plain
    version on the CPU. Nothing here resets them, so a caller that counts a
    whole run around a tool still sees every launch."""
    return {name: getattr(w, attr) for name, (w, attr) in _counted_wrappers().items()}


def launches_since(before: dict) -> dict:
    """The launches since ``before`` (a :func:`launch_counts`), by name;
    kernels not launched are left out."""
    now = launch_counts()
    return {name: now[name] - before[name] for name in now if now[name] != before[name]}


def reset_launch_counts() -> None:
    """Every wrapper's launch counter to 0 (for a caller that counts whole runs)."""
    for wrapper, attr in _counted_wrappers().values():
        setattr(wrapper, attr, 0)
