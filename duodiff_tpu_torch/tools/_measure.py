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


def _elapsed_ms(run, device: torch.device) -> float:
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


def time_ms(fn, device: torch.device, reps: int) -> float:
    """Mean time per call over ``reps`` calls of ``fn()`` after one warm-up."""
    fn()

    def run():
        for _ in range(reps):
            fn()

    return _elapsed_ms(run, device) / reps


def chain_ms(step, x: torch.Tensor, iters: int) -> float:
    """Mean time per call of a chain ``x <- step(x)`` of ``iters`` calls, each
    fed by the one before so that no call sees the same data twice, after one
    warm-up chain from the same start."""
    def run():
        y = x
        for _ in range(iters):
            y = step(y)

    run()
    return _elapsed_ms(run, x.device) / iters
