"""Profiling and tracing (counterpart of ``duodiff_tpu/utils/profiling.py``).

:func:`trace` records a ``torch.profiler`` trace (host, and the card's
kernels where there is one) and writes it as a Chrome trace, the file the
trainer's ``--profile`` writes and ``tools/trace_step.py`` reads;
:class:`StepTimer` a rolling steps/s; :func:`flops_per_uvit_forward` the
analytic FLOPs of one U-ViT forward, for effective TFLOP/s.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir, device=None):
    """Profile the block and write ``logdir/trace.json`` (open it in Perfetto
    or chrome://tracing). The card's kernels are recorded when ``device`` is
    a CUDA device, or, with no ``device``, whenever CUDA is available; the
    device is synchronised before the trace stops, so that it holds every
    kernel the block launched."""
    from torch.profiler import ProfilerActivity, profile

    cuda = (device.type == "cuda") if device is not None else torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / TRACE_FILE))


class StepTimer:
    """Rolling steps/s tracker for training loops."""

    def __init__(self, window: int = 50):
        self.window = window
        self._t0 = None
        self._count = 0

    def tick(self) -> dict:
        now = time.time()
        self._count += 1
        if self._t0 is None:
            self._t0 = now
            return {}
        if self._count % self.window == 0:
            dt = now - self._t0
            self._t0 = now
            return {"steps_per_sec": self.window / dt}
        return {}


def flops_per_uvit_forward(cfg, batch: int) -> float:
    """Analytic FLOPs for one U-ViT forward (2*MACs), for utilization
    estimates: depth blocks of (qkv + attn + proj + mlp) plus embed/decode."""
    L = cfg.extras + cfg.num_patches
    D = cfg.embed_dim
    per_block = 2 * L * D * 3 * D + 4 * L * L * D + 2 * L * D * D + \
        2 * 2 * L * D * int(cfg.mlp_ratio * D)
    skip_linears = (cfg.depth // 2) * 2 * L * 2 * D * D
    embed = 2 * L * cfg.patch_dim * D
    decode = 2 * L * D * cfg.patch_dim
    return batch * (cfg.depth * per_block + skip_linears + embed + decode)
