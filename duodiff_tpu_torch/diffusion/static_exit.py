"""Static-exit (bucketed) and adaptive early-exit sampling (counterpart of
``duodiff_tpu/diffusion/static_exit.py``).

The dynamic rule (:func:`duodiff_tpu_torch.diffusion.sampling.early_exit_sample`)
runs every block and every head at every step and only selects. Since the
chosen layer is almost a function of the timestep, a dynamic run's
``indices_by_timestep`` can be cut into a few contiguous timestep buckets
(:func:`derive_exit_schedule`), and each bucket sampled with a backbone
truncated at its exit layer: blocks 0..exit_layer-1 and head ``exit_layer``
(:func:`truncated_ee_apply`), optionally block-cached inside the truncation
(:func:`truncated_ee_apply_cached`). :func:`make_adaptive_exit_sampler`
picks the bucket chunk by chunk on the host from the truncated forward's
own probe (:func:`truncated_ee_apply_probed`).

The models are :class:`duodiff_tpu_torch.models.early_exit.EarlyExitUViT`
modules; the JAX package's per-bucket re-built models and their chunked
scans are one model and a step loop here (``ddpm_loop``).
"""

from __future__ import annotations

import re
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from duodiff_tpu_torch.diffusion.calibration import apply_probe_calibration
from duodiff_tpu_torch.diffusion.graphs import step_graphs
from duodiff_tpu_torch.diffusion.sampling import (
    StepKinds,
    _initial_noise,
    ddpm_loop,
    make_block_cached_apply,
    make_guided_apply,
)
from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
from duodiff_tpu_torch.models.early_exit import PER_LAYER_PROBES

Bucket = Tuple[int, int, int]  # (t_hi, t_lo, exit_layer), t range inclusive


def truncated_ee_apply(model, exit_layer: int) -> Callable:
    """``apply(x, t, y)`` of the backbone truncated at ``exit_layer``
    (``EarlyExitUViT.forward_truncated``)."""
    model.check_exit(exit_layer)
    return lambda x, t, y: model.forward_truncated(x, t, y, exit_layer=exit_layer)


def truncated_ee_apply_cached(model, exit_layer: int, n_outer: int) -> tuple:
    """``(apply_anchor(x, t, y) -> (out, delta), apply_cached(x, t, y, delta)
    -> out)`` of the truncated backbone with the centered region
    (in_blocks[n_outer:], mid, out_blocks[:k - n_outer]) cached. The region
    lies inside the truncation only where ``exit_layer > 2k - n_outer``;
    anything else raises ValueError (pick ``n_outer`` with
    :func:`cache_outer_for`)."""
    model.cache_prefix(exit_layer, n_outer)
    kw = dict(exit_layer=exit_layer, n_outer=n_outer)
    return (lambda x, t, y: model.forward_truncated_anchor(x, t, y, **kw),
            lambda x, t, y, delta: model.forward_truncated_cached(x, t, y, delta=delta, **kw))


def cache_outer_for(depth: int, exit_layer: int, cache_outer: Optional[int] = None
                    ) -> Optional[int]:
    """The n_outer for caching a backbone truncated at ``exit_layer``, or
    None when there is none (an exit at or before the mid block: nothing to
    cache). ``cache_outer=None`` takes the sampling CLI's default
    ``max(1, ceil(k/3))``; either is raised to the least the truncation
    allows, ``2k - exit_layer + 1``."""
    k = depth // 2
    min_p = 2 * k - int(exit_layer) + 1  # the region must end before the exit
    p = cache_outer if cache_outer is not None else max(1, -(-k // 3))
    p = max(int(p), min_p, 1)
    if p > k:
        return None
    return p


def parse_exit_schedule(spec: str) -> List[Bucket]:
    """``"999-700:3,699-300:8,299-0:13"`` -> bucket tuples, t descending; the
    buckets must be contiguous."""
    buckets = []
    for part in spec.split(","):
        m = re.match(r"^\s*(\d+)-(\d+):(\d+)\s*$", part)
        if not m:
            raise ValueError(f"bad exit-schedule entry {part!r}; expected 't_hi-t_lo:layer'")
        t_hi, t_lo, layer = map(int, m.groups())
        if t_lo > t_hi:
            t_hi, t_lo = t_lo, t_hi
        buckets.append((t_hi, t_lo, layer))
    buckets.sort(key=lambda b: -b[0])
    for (hi1, lo1, _), (hi2, lo2, _) in zip(buckets, buckets[1:]):
        if lo1 != hi2 + 1:
            raise ValueError(f"exit schedule not contiguous: [{hi1},{lo1}] then [{hi2},{lo2}]")
    return buckets


def derive_exit_schedule(indices_by_timestep: np.ndarray, n_buckets: int = 4,
                         quantile: float = 0.5) -> List[Bucket]:
    """A logged (T, B) exit-index table -> ``n_buckets`` contiguous timestep
    buckets, each exiting at the ceil of the ``quantile`` of its per-(t,
    sample) exits (the median by default: the JAX package measured a
    mean-derived schedule collapsing modes on a trained model); adjacent
    buckets with the same layer are merged."""
    idx = np.asarray(indices_by_timestep)
    steps = idx.shape[0]
    if not 1 <= n_buckets <= steps:
        raise ValueError(f"n_buckets must be in [1, {steps}] (the table covers {steps} "
                         f"timesteps), got {n_buckets}")
    edges = np.linspace(0, steps, n_buckets + 1).astype(int)
    buckets = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        layer = int(np.ceil(np.quantile(idx[lo:hi], quantile)))
        buckets.append((int(hi) - 1, int(lo), layer))
    buckets.sort(key=lambda b: -b[0])
    merged: List[Bucket] = []
    for b in buckets:
        if merged and merged[-1][2] == b[2]:
            merged[-1] = (merged[-1][0], b[1], b[2])
        else:
            merged.append(b)
    return merged


def make_static_exit_sampler(model, *, schedule: NoiseSchedule, buckets: Sequence[Bucket],
                             guidance: Optional[tuple] = None, cache_every=None,
                             cache_outer: Optional[int] = None, graphs=True) -> Callable:
    """``sample(generator, shape, y=None, x_init=None, noise_table=None) ->
    x``: one truncated backbone per bucket, each run by ``ddpm_loop`` over
    its t range (predict_noise). Buckets must cover [0, steps-1].

    ``guidance=(scale, null_label)`` guides each bucket's single output.
    ``cache_every`` (an int period, or a 1-D boolean anchor table indexed by
    t) block-caches every bucket whose exit lies past the mid block, inside
    its truncation: anchors on its rule and on the bucket's first step (the
    residual does not carry across buckets); not with guidance. ``graphs``
    is :func:`ddpm_loop`'s: by default a call's buckets replay step graphs
    of one run; a :class:`StepGraphs` keeps them across calls."""
    buckets = sorted(buckets, key=lambda b: -b[0])
    if buckets[0][0] != schedule.steps - 1 or buckets[-1][1] != 0:
        raise ValueError(f"buckets must cover the timesteps {schedule.steps - 1}..0, got "
                         f"{buckets}")
    if isinstance(cache_every, (int, np.integer)) and cache_every < 1:
        raise ValueError(f"cache_every must be >= 1, got {cache_every}")
    if cache_every is not None and guidance is not None:
        raise ValueError("cache_every does not compose with guidance (the guided wrapper "
                         "doubles the batch around a stateless apply)")
    cfg = model.config
    tokens = cfg.extras + cfg.num_patches

    def init_state(x):
        return torch.zeros((x.shape[0], tokens, cfg.embed_dim), dtype=model.dtype,
                           device=x.device)

    segments = []
    for t_hi, t_lo, layer in buckets:
        n_outer = (None if cache_every is None
                   else cache_outer_for(cfg.depth, layer, cache_outer))
        if n_outer is None:
            apply = truncated_ee_apply(model, layer)
            if guidance is not None:
                apply = make_guided_apply(apply, *guidance)
            segments.append((t_hi, t_lo, apply, False))
        else:
            anchor, cached = truncated_ee_apply_cached(model, layer, n_outer)
            segments.append((t_hi, t_lo, make_block_cached_apply(anchor, cached, cache_every,
                                                                 t_hi), True))

    def sample(generator, shape=None, y=None, x_init=None, noise_table=None):
        x = _initial_noise(x_init, shape, generator)
        run = step_graphs(graphs, x.device)
        for t_hi, t_lo, apply, stateful in segments:
            ts = range(t_hi, t_lo - 1, -1)
            if stateful:
                x, _ = ddpm_loop(apply, schedule, "predict_noise", x, generator, ts, y,
                                 noise_table=noise_table, state=init_state(x), graphs=run)
            else:
                x = ddpm_loop(apply, schedule, "predict_noise", x, generator, ts, y,
                              noise_table=noise_table, graphs=run)
        return x

    return sample


def static_exit_sample(model, generator, *, schedule: NoiseSchedule, shape=None,
                       buckets: Sequence[Bucket], y=None, guidance: Optional[tuple] = None,
                       cache_every=None, cache_outer: Optional[int] = None, x_init=None,
                       noise_table=None, graphs=True):
    """One-shot :func:`make_static_exit_sampler`."""
    sampler = make_static_exit_sampler(model, schedule=schedule, buckets=buckets,
                                       guidance=guidance, cache_every=cache_every,
                                       cache_outer=cache_outer, graphs=graphs)
    return sampler(generator, shape, y, x_init=x_init, noise_table=noise_table)


def truncated_ee_apply_probed(model, exit_layer: int,
                              probe_slots: Optional[Sequence[int]] = None) -> tuple:
    """The truncated backbone of :func:`truncated_ee_apply` that also adds
    the batch mean of each probe in ``probe_slots`` (each at most the
    layer's own slot ``min(exit_layer, depth-1)``; by default that one
    alone) to its state. Returns the stateful apply of ``ddpm_loop``,
    ``apply(state, x, t_batch, y, t) -> (eps, state + means)``, a
    :class:`StepKinds` of the one kind "probed" (so it replays as a step
    graph), and ``init_state(x)``: fp32 zeros, a scalar for the default
    slot, else one entry a slot. Per-layer probe families only: the
    per-timestep tables gate on t, which the static buckets already
    encode."""
    depth = model.config.depth
    exit_layer = model.check_exit(exit_layer)
    own = min(exit_layer, depth - 1)
    slots = [own] if probe_slots is None else [int(s) for s in probe_slots]
    bad = [s for s in slots if not 0 <= s <= own]
    if bad:
        raise ValueError(f"probe_slots {bad} out of range for exit_layer {exit_layer} (valid: "
                         f"0..{own} — a probe past the truncation point is never computed)")
    if model.config.classifier_type not in PER_LAYER_PROBES:
        raise ValueError(
            "adaptive bucket selection needs a per-layer probe family (got classifier_type="
            f"{model.config.classifier_type!r}); the per-timestep tables gate on t, which the "
            "static buckets already encode")
    scalar = probe_slots is None

    def probed(state, x, t_batch, y):
        eps, u = model.forward_probed(x, t_batch, y, exit_layer=exit_layer, slots=slots)
        means = u.float().mean(1)
        return eps, state + (means[0] if scalar else means)

    def init_state(x):
        return torch.zeros(() if scalar else (len(slots),), dtype=torch.float32,
                           device=x.device)

    return StepKinds({"probed": probed}, lambda t: "probed"), init_state


def make_adaptive_exit_sampler(model, *, schedule: NoiseSchedule, layers: Sequence[int],
                               chunk: int = 50, threshold: float = 0.08, margin: float = 0.7,
                               monotone: bool = True, calibration: Optional[dict] = None,
                               graphs=True) -> Callable:
    """Probe-driven bucket selection, chunk by chunk: each ``chunk``-step
    segment runs one truncated backbone that also sums its probe's batch
    mean; between chunks the host moves one candidate deeper when that mean
    (over the chunk's steps) is above ``threshold``, or, with
    ``monotone=False``, one shallower when the own value is within the
    threshold and the next shallower candidate's probe, read on the way,
    is within ``threshold * margin``. Monotone walks start at the
    shallowest candidate, bidirectional ones at the deepest.

    ``calibration`` (:mod:`duodiff_tpu_torch.diffusion.calibration`) maps
    each probe onto realized-error units first; the log rows then carry
    ``calibrated`` / ``below_calibrated`` beside ``mean_probe`` /
    ``below_probe``. Returns ``sample(generator, shape, y=None, x_init=None,
    noise_table=None) -> (x, log)``, one log row a chunk. With one candidate
    it samples what the static sampler with one bucket samples.

    ``graphs`` is :func:`ddpm_loop`'s: each (candidate, below) apply is a
    kind of step of one run, replayed as a CUDA graph on the card by
    default. A chunk's probe sum starts from zeros, copied into its loop's
    static state, and is read once after its last step, the chunk's only
    read on the host (the JAX sampler's one read a chunk); a shorter last
    chunk replays the same graphs. The chunks pass x on in the run's x
    buffer, which ``sample`` returns, as every sampler given a run's
    :class:`StepGraphs` does."""
    depth = model.config.depth
    layers = sorted({int(v) for v in layers})
    if not layers:
        raise ValueError("layers must be non-empty")
    bad = [v for v in layers if not 0 <= v <= depth]
    if bad:
        raise ValueError(f"adaptive exit layers {bad} out of range for depth {depth} (valid: "
                         f"0..{depth}); pass --adaptive_layers matching this model")
    if calibration is not None and len(calibration["a"]) != depth:
        raise ValueError(f"probe calibration has {len(calibration['a'])} slots but the model "
                         f"has depth {depth} — it was fitted on a different model")

    def slot_of(layer):
        return min(layer, depth - 1)

    applies: dict = {}

    def get(li):
        """The probed apply of candidate ``li``: its own slot alone when
        monotone, else also the next shallower candidate's slot."""
        below = None if (monotone or li == 0) else layers[li - 1]
        if (li, below) not in applies:
            slots = None if monotone else (
                [slot_of(layers[li])] + ([slot_of(below)] if below is not None else []))
            applies[(li, below)] = truncated_ee_apply_probed(model, layers[li], slots)
        return applies[(li, below)]

    def calibrated(slot, value, row, field):
        if calibration is None:
            return value
        out = apply_probe_calibration(calibration, slot, value)
        row[field] = round(out, 6)
        return out

    def sample(generator, shape=None, y=None, x_init=None, noise_table=None):
        li = 0 if monotone else len(layers) - 1
        x = _initial_noise(x_init, shape, generator)
        run = step_graphs(graphs, x.device)
        t = schedule.steps - 1
        log = []
        while t >= 0:
            lo = max(t - chunk + 1, 0)
            apply, init_state = get(li)
            x, st = ddpm_loop(apply, schedule, "predict_noise", x, generator,
                              range(t, lo - 1, -1), y, noise_table=noise_table,
                              state=init_state(x), graphs=run)
            st = st.double().cpu().numpy().reshape(-1) / (t - lo + 1)  # the chunk's one read
            mean_u = float(st[0])
            row = {"t_hi": int(t), "t_lo": int(lo), "layer": int(layers[li]),
                   "mean_probe": round(mean_u, 6)}
            value = calibrated(slot_of(layers[li]), mean_u, row, "calibrated")
            below_value = None
            if st.size > 1:
                row["below_probe"] = round(float(st[1]), 6)
                below_value = calibrated(slot_of(layers[li - 1]), float(st[1]), row,
                                         "below_calibrated")
            log.append(row)
            if value > threshold and li < len(layers) - 1:
                li += 1
            elif (value <= threshold and below_value is not None
                  and below_value <= threshold * margin):
                li -= 1
            t = lo - 1
        return x, log

    return sample
