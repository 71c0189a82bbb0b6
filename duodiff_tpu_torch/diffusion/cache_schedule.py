"""Block-cache anchor schedules (counterpart of
``duodiff_tpu/diffusion/cache_schedule.py``).

A schedule is a boolean table indexed by t: ``table[t]`` anchors step t
(the full model runs and refreshes the cached residual). It serializes as
JSON ``{"num_timesteps": T, "anchors": [t, ...], "meta": {...}}``, as
``duodiff_tpu_torch.tools.derive_cache_schedule`` writes it. numpy and JSON
only.

Derivation: the per-step drift of the cached residual, ``d(t) = ||delta_t -
delta_{t+1}||_F``, measured along a run that anchors every step, places
anchors greedily (:func:`derive_anchor_table`): walking t from high to low,
anchor where the drift accumulated since the last anchor would exceed a
budget. The accumulated drift bounds ``||delta_t - delta_anchor||`` by the
triangle inequality, so every cached step's staleness stays within the
budget. The budget is a uniform schedule's worst staleness
(:func:`uniform_budget`) or the smallest that a count of anchors allows
(:func:`budget_for_count`, bisected).
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


def segment_staleness(drift: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Accumulated drift since each step's governing anchor: ``stale[t]`` is
    the sum of ``drift`` over (t, anchor], walking down from the anchor; 0 at
    anchors and at t = steps - 1 (the first step always anchors, so
    ``drift[steps - 1]`` is never read)."""
    drift = np.asarray(drift, dtype=np.float64)
    table = np.asarray(table, dtype=bool)
    steps = table.shape[0]
    if drift.shape[0] != steps:
        raise ValueError(f"drift length {drift.shape[0]} != steps {steps}")
    stale = np.zeros((steps,), dtype=np.float64)
    acc = 0.0
    for t in range(steps - 2, -1, -1):
        acc += drift[t]
        if table[t]:
            acc = 0.0
        stale[t] = acc
    return stale


def uniform_budget(drift: np.ndarray, every: int) -> float:
    """The worst staleness of a cached step under the uniform ``t % every ==
    0`` schedule."""
    steps = np.asarray(drift).shape[0]
    return float(segment_staleness(drift, uniform_table(every, steps)).max())


def derive_anchor_table(drift: np.ndarray, budget: float, *,
                        anchor_zero: bool = True) -> np.ndarray:
    """Greedy placement: walking t = steps - 2 .. 0, anchor where the drift
    accumulated since the last anchor exceeds ``budget``. A step whose own
    drift exceeds it anchors at once. t = steps - 1 anchors at run time (the
    segment's first step); ``anchor_zero`` forces t = 0, as the uniform rule
    does."""
    drift = np.asarray(drift, dtype=np.float64)
    steps = drift.shape[0]
    table = np.zeros((steps,), dtype=bool)
    acc = 0.0
    for t in range(steps - 2, -1, -1):
        acc += drift[t]
        if acc > budget:
            table[t] = True
            acc = 0.0
    if anchor_zero:
        table[0] = True
    return table


def budget_for_count(drift: np.ndarray, num_anchors: int, *, iters: int = 60) -> float:
    """The bisected least budget whose greedy table has at most
    ``num_anchors`` anchors (the count does not rise as the budget does)."""
    drift = np.asarray(drift, dtype=np.float64)
    lo, hi = 0.0, float(drift.sum()) + 1.0
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if int(derive_anchor_table(drift, mid).sum()) > num_anchors:
            lo = mid
        else:
            hi = mid
    return hi


def save_cache_schedule(path, table, meta: dict | None = None) -> None:
    """Write the table as the schedule JSON that :func:`load_cache_schedule`
    and the JAX package's reader take."""
    payload = {"num_timesteps": int(np.asarray(table).shape[0]),
               "anchors": table_to_anchors(table)}
    if meta:
        payload["meta"] = meta
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
        f.write("\n")


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
