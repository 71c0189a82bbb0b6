"""Block-cache anchor schedules (counterpart of the table and JSON half of
``duodiff_tpu/diffusion/cache_schedule.py``).

A schedule is a boolean table indexed by t: ``table[t]`` anchors step t
(the full model runs and refreshes the cached residual). It serializes as
JSON ``{"num_timesteps": T, "anchors": [t, ...], "meta": {...}}``, as
``tools/derive_cache_schedule.py`` writes it. numpy and JSON only.
"""

from __future__ import annotations

import json

import numpy as np


def anchors_to_table(anchors, steps: int) -> np.ndarray:
    """(sorted or not) anchor timesteps -> boolean table indexed by t."""
    table = np.zeros((steps,), dtype=bool)
    a = np.asarray(list(anchors), dtype=np.int64)
    if a.size and (a.min() < 0 or a.max() >= steps):
        raise ValueError(
            f"anchor timesteps must lie in [0, {steps}), got [{a.min()}, {a.max()}]"
        )
    table[a] = True
    return table


def table_to_anchors(table) -> list[int]:
    return [int(t) for t in np.flatnonzero(np.asarray(table, dtype=bool))]


def uniform_table(every: int, steps: int) -> np.ndarray:
    """The table form of the ``t % every == 0`` rule (the forced first-step
    anchor is applied by ``make_block_cached_apply``, not baked in)."""
    if every < 1:
        raise ValueError(f"every must be >= 1, got {every}")
    return (np.arange(steps) % every) == 0


def load_cache_schedule(path, *, num_timesteps: int | None = None,
                        with_meta: bool = False):
    """Schedule JSON -> boolean table, checking its step count against the
    sampler's when given; ``with_meta=True`` also returns the derivation
    metadata (empty if the file has none)."""
    with open(path) as f:
        payload = json.load(f)
    steps = int(payload["num_timesteps"])
    if num_timesteps is not None and steps != num_timesteps:
        raise ValueError(
            f"cache schedule {path} was derived for num_timesteps={steps}, "
            f"sampler runs {num_timesteps}"
        )
    table = anchors_to_table(payload["anchors"], steps)
    if with_meta:
        return table, payload.get("meta", {})
    return table
