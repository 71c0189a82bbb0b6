"""Derive a drift-adaptive block-cache anchor schedule from a measured run
(counterpart of the repository's ``tools/derive_cache_schedule.py``).

    python -m duodiff_tpu_torch.tools.derive_cache_schedule --out schedule.json \\
        [--config configs/uvit_celeba.yaml] [--checkpoint ckpt.pth] \\
        [--budget_from_every 3 | --num_anchors 240] [--gelu_approx]

One reverse DDPM trajectory runs the anchor forward (``forward_anchor``, the
full model) on every step and records the drift of the cached residual,
``d(t) = ||delta_t - delta_{t+1}||_F`` in fp32, as per-step aux rows that
stay on the device until the run ends. Anchors are then placed greedily so
that the drift accumulated between anchors stays within a budget
(``diffusion/cache_schedule.py``): the worst staleness of the uniform
``--budget_from_every N`` schedule, or the least budget that
``--num_anchors K`` anchors allow, bisected.

DuoDiff mode (``--t_switch N --shallow_config YAML [--shallow_checkpoint
C]``): the shallow model runs its N steps dense (it is never cached), then
the full model's drift is measured from the handoff down, and anchors are
derived over that late segment only; the early rows are written as anchors,
since that segment is dense. With random weights the shallow model takes
``--seed`` and the full one ``--full_seed`` (the sampling CLI pairs seed s
with s + 1: ``--full_seed 1`` derives for its seed-0 pair). The noise comes
from a generator seeded with ``--seed`` on the device, drawn as the sampling
CLI draws it, so an unconditional run follows that CLI's trajectory.

Static-exit mode (``--static_schedule '999-700:3,699-0:13' --config
<deediff yaml> [--checkpoint C]``): the early-exit model runs the buckets in
turn, each on its backbone truncated at its exit layer. A bucket whose
truncation can hold the cached region measures its own drift through the
truncated anchor forward (``diffusion/static_exit.py``), from a zero delta
at its entry, where the composed sampler anchors again; the others run
dense. Anchors are derived bucket by bucket under one budget (the worst
bucket-local uniform staleness, or bisected for ``--num_anchors``); the
rows of dense buckets are written as anchors.

It runs on the card unless ``--device cpu``. The JSON it writes holds the
anchors and a ``meta`` block as the JAX tool writes it, with the card's name
and power limit in place of the JAX backend. Every scan replays step graphs
on the card, one run's (``diffusion/graphs.py``), as the JAX tool's scans
are compiled loops; ``main(argv, graphs=False)`` runs the step bodies
eagerly.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

from duodiff_tpu_torch.diffusion.cache_schedule import (
    budget_for_count,
    derive_anchor_table,
    save_cache_schedule,
    segment_staleness,
    uniform_budget,
    uniform_table,
)
from duodiff_tpu_torch.diffusion.graphs import step_graphs
from duodiff_tpu_torch.diffusion.sampling import StepKinds, ddpm_loop
from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
from duodiff_tpu_torch.diffusion.static_exit import (
    cache_outer_for,
    parse_exit_schedule,
    truncated_ee_apply,
    truncated_ee_apply_cached,
)
from duodiff_tpu_torch.tools._measure import card_line, device_from_arg
from duodiff_tpu_torch.utils.model_loading import load_model

ATTN_IMPLS = ("fused", "plain", "pallas", "xla")
FLAGSHIP_CONFIG = Path(__file__).resolve().parents[2] / "configs" / "uvit_celeba.yaml"


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", type=str, default=None,
                   help="model config (default: the CelebA-64 flagship, the "
                        "repository's configs/uvit_celeba.yaml)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="checkpoint (.pth) of the full model (default: random "
                        "weights from --seed, or --full_seed)")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cache_outer", type=int, default=None)
    p.add_argument("--budget_from_every", type=int, default=3)
    p.add_argument("--num_anchors", type=int, default=None,
                   help="in place of --budget_from_every: bisect the budget to at "
                        "most K anchors")
    p.add_argument("--attn_impl", type=str, default=None, choices=ATTN_IMPLS,
                   help="block route (default: fused on CUDA, plain on the CPU)")
    p.add_argument("--gelu_approx", action="store_true")
    p.add_argument("--t_switch", type=int, default=None,
                   help="DuoDiff mode: the shallow model (--shallow_config) runs "
                        "t >= steps - t_switch dense; drift is measured on the full "
                        "model's late segment only")
    p.add_argument("--shallow_config", type=str, default=None)
    p.add_argument("--shallow_checkpoint", type=str, default=None)
    p.add_argument("--full_seed", type=int, default=None,
                   help="random-weight DuoDiff mode: the full model's seed in place "
                        "of --seed")
    p.add_argument("--label_max", type=int, default=None,
                   help="class-conditional models: labels in [0, label_max)")
    p.add_argument("--static_schedule", type=str, default=None,
                   help="static-exit mode: the bucket schedule ('999-700:3,699-0:13') of "
                        "the early-exit model of --config / --checkpoint; drift per bucket")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def check_args(args) -> None:
    """The JAX tool's refusals (those that need no model)."""
    if (args.t_switch is None) != (args.shallow_config is None):
        raise SystemExit("--t_switch and --shallow_config go together")
    if args.t_switch is not None and args.static_schedule is not None:
        raise SystemExit("--t_switch and --static_schedule are mutually exclusive")
    if args.static_schedule is not None and args.config is None:
        raise SystemExit("--static_schedule needs --config (the DeeDiff YAML of the "
                         "EarlyExitUViT checkpoint)")
    if args.full_seed is not None and (args.checkpoint is not None or args.t_switch is None):
        raise SystemExit("--full_seed is for the random-init DuoDiff mode only (no "
                         "--checkpoint, with --t_switch)")
    if args.t_switch is not None and not 1 <= args.t_switch <= args.steps - 1:
        raise SystemExit(f"--t_switch must be in [1, {args.steps - 1}]")
    if args.num_anchors is None and args.budget_from_every < 1:
        raise SystemExit("--budget_from_every must be >= 1")


def drift_apply(anchor_apply) -> StepKinds:
    """A stateful apply (``diffusion/sampling.py``) around an anchor forward
    ``(x, t, y) -> (out, delta)``: the state is the previous step's delta,
    the output ``(out, (drift_sq, norm_sq))`` for the aux rows, fp32 0-d
    tensors on the device; one kind of step, "anchor"."""
    def anchor(prev_delta, x, t_batch, y):
        out, delta = anchor_apply(x, t_batch, y)
        d32 = delta.float()
        drift_sq = torch.sum((d32 - prev_delta.float()) ** 2)
        return (out, (drift_sq, torch.sum(d32 ** 2))), delta

    return StepKinds({"anchor": anchor}, lambda t: "anchor")


def segment_drift(anchor_apply, schedule, x, generator, t_hi: int, t_lo: int, y, delta0,
                  noise_table=None, graphs=True):
    """An anchor forward ``(x, t, y) -> (out, delta)`` over t = t_hi .. t_lo
    from x, the delta starting at ``delta0``, its noise from ``generator`` or
    ``noise_table``. Returns (x after t_lo, drift, norm), each of the last
    two (t_hi - t_lo + 1,) float64 indexed by t - t_lo: ||delta_t -
    delta_{t+1}||_F (row t_hi against ``delta0``, never read) and
    ||delta_t||_F. The rows are read once, after the segment. ``graphs``
    is :func:`ddpm_loop`'s."""
    x, _, (drift_sq, norm_sq) = ddpm_loop(
        drift_apply(anchor_apply), schedule, "predict_noise", x, generator,
        range(t_hi, t_lo - 1, -1), y, noise_table=noise_table, state=delta0,
        aux_fn=lambda out: out, graphs=graphs,
    )
    rows = torch.stack([drift_sq, norm_sq]).double().cpu().numpy()
    return x, np.sqrt(rows[0])[::-1], np.sqrt(rows[1])[::-1]


def measure_drift(model, schedule, x, generator, t_hi: int, n_outer: int, y, tokens: int,
                  noise_table=None, graphs=True):
    """The full model's anchor forward over t = t_hi .. 0 from x
    (:func:`segment_drift` from a zero delta); returns (drift, norm), each
    (t_hi + 1,) indexed by t. ``graphs`` is :func:`ddpm_loop`'s."""
    delta0 = torch.zeros((x.shape[0], tokens, model.config.embed_dim), dtype=model.dtype,
                         device=x.device)
    _, drift, norm = segment_drift(
        lambda xx, tt, yy: model.forward_anchor(xx, tt, yy, n_outer=n_outer), schedule, x,
        generator, t_hi, 0, y, delta0, noise_table, graphs=graphs)
    return drift, norm


def static_exit_drift(model, cfg, schedule, x, generator, buckets, cache_outer, y, tokens,
                      drift, norm, noise_table=None, graphs=True):
    """The static-exit mode's run: bucket after bucket, the cacheable ones
    through their truncated anchor forward (:func:`segment_drift` from a
    zero delta, rows written into ``drift`` and ``norm`` at their t), the
    others dense, all on one
    run of step graphs (``graphs``, :func:`ddpm_loop`'s). Returns (the
    cacheable segments (t_hi, t_lo), the buckets' meta rows)."""
    segments, bucket_meta = [], []
    delta0 = torch.zeros((x.shape[0], tokens, cfg.embed_dim), dtype=model.dtype,
                         device=x.device)
    run = step_graphs(graphs, x.device)
    for t_hi, t_lo, layer in buckets:
        p_outer = cache_outer_for(cfg.depth, layer, cache_outer)
        if p_outer is not None:
            anchor, _ = truncated_ee_apply_cached(model, layer, p_outer)
            x, drift[t_lo:t_hi + 1], norm[t_lo:t_hi + 1] = segment_drift(
                anchor, schedule, x, generator, t_hi, t_lo, y, delta0, noise_table, graphs=run)
            segments.append((t_hi, t_lo))
        else:
            x = ddpm_loop(truncated_ee_apply(model, layer), schedule, "predict_noise", x,
                          generator, range(t_hi, t_lo - 1, -1), y, noise_table=noise_table,
                          graphs=run)
        bucket_meta.append({"t_hi": t_hi, "t_lo": t_lo, "layer": layer, "n_outer": p_outer,
                            "cacheable": p_outer is not None})
    return segments, bucket_meta


def derive_segmented(drift: np.ndarray, segments, budget: float) -> np.ndarray:
    """The table under one budget: anchors derived in each cacheable segment
    (t = 0 forced in the segment that reaches it), every other row an
    anchor, since those steps run dense."""
    table = np.ones(drift.shape, dtype=bool)
    for hi, lo in segments:
        table[lo:hi + 1] = derive_anchor_table(drift[lo:hi + 1], budget, anchor_zero=lo == 0)
    return table


def segmented_staleness(drift: np.ndarray, segments, table) -> tuple[float, float]:
    """The worst and the mean staleness over the cacheable segments."""
    st = np.concatenate([segment_staleness(drift[lo:hi + 1], table[lo:hi + 1])
                         for hi, lo in segments])
    return float(st.max()), float(st.mean())


def segmented_budget_for_count(drift: np.ndarray, segments, num_anchors: int) -> float:
    """The bisected least budget whose segmented table has at most
    ``num_anchors`` anchors over the cacheable rows."""
    in_seg = segment_mask(drift.shape[0], segments)
    lo_b, hi_b = 0.0, float(drift.sum()) or 1.0
    for _ in range(60):
        mid = 0.5 * (lo_b + hi_b)
        if int(derive_segmented(drift, segments, mid)[in_seg].sum()) <= num_anchors:
            hi_b = mid
        else:
            lo_b = mid
    return hi_b


def segment_mask(steps: int, segments) -> np.ndarray:
    in_seg = np.zeros((steps,), dtype=bool)
    for hi, lo in segments:
        in_seg[lo:hi + 1] = True
    return in_seg


def main(argv=None, graphs=True) -> dict:
    """Run the tool; returns {"table": bool (steps,), "budget", "budget_mode",
    "drift" (steps,), "norm" (steps,), "meta", "card"}. ``graphs`` is
    :func:`~duodiff_tpu_torch.diffusion.graphs.step_graphs`'s (a bool, or a
    run's StepGraphs): the scans' one run."""
    args = get_args(argv)
    check_args(args)
    device = device_from_arg(args.device)
    card = card_line(device)
    print(card)
    attn = args.attn_impl or ("fused" if device.type == "cuda" else "plain")
    full_seed = args.seed if args.full_seed is None else args.full_seed
    buckets = None
    if args.static_schedule is not None:
        buckets = parse_exit_schedule(args.static_schedule)
        if buckets[0][0] != args.steps - 1 or buckets[-1][1] != 0:
            raise SystemExit(f"--static_schedule must cover t={args.steps - 1}..0")
    model, cfg = load_model(args.config or FLAGSHIP_CONFIG, args.checkpoint, device=device,
                            seed=full_seed, attn_impl=attn, gelu_approx=args.gelu_approx,
                            early_exit=buckets is not None)
    model.eval().pack_for_kernels()
    k_half = cfg.depth // 2
    n_outer = args.cache_outer if args.cache_outer is not None else max(1, -(-k_half // 3))
    if not 1 <= n_outer <= k_half:
        raise SystemExit(f"--cache_outer must be in [1, {k_half}]")
    y = None
    if cfg.num_classes > 0:
        hi = cfg.num_classes
        if args.label_max is not None:
            if not 1 <= args.label_max <= cfg.num_classes:
                raise SystemExit(f"--label_max must be in [1, {cfg.num_classes}]")
            hi = args.label_max
        y = torch.randint(0, hi, (args.batch,), generator=torch.Generator().manual_seed(7))
        y = y.to(device)

    steps = args.steps
    schedule = NoiseSchedule.create(steps=steps, device=device)
    shape = (args.batch, cfg.img_size, cfg.img_size, cfg.in_chans)
    tokens = cfg.extras + cfg.num_patches
    generator = torch.Generator(device=device).manual_seed(args.seed)
    # drift[t] = ||delta_t - delta_{t+1}||; each cacheable segment's top row is
    # against a zero delta and never read; rows outside the segments stay 0
    drift = np.zeros((steps,), np.float64)
    norm = np.zeros((steps,), np.float64)
    run = step_graphs(graphs, device)
    with torch.inference_mode():
        x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        if args.t_switch is not None:
            early, ecfg = load_model(args.shallow_config, args.shallow_checkpoint, device=device,
                                     seed=args.seed, attn_impl=attn, gelu_approx=args.gelu_approx)
            early.eval().pack_for_kernels()
            if (ecfg.img_size, ecfg.in_chans) != (cfg.img_size, cfg.in_chans):
                raise SystemExit("shallow/full image shapes differ")
            handoff = steps - args.t_switch
            print(f"measuring DuoDiff late-segment drift: shallow dense t={steps - 1}..{handoff}, "
                  f"full anchors t={handoff - 1}..0, batch {args.batch}, attn={attn}, "
                  f"n_outer={n_outer} ...", file=sys.stderr)
            x = ddpm_loop(early, schedule, "predict_noise", x, generator,
                          range(steps - 1, handoff - 1, -1), y, graphs=run)
            drift[:handoff], norm[:handoff] = measure_drift(model, schedule, x, generator,
                                                            handoff - 1, n_outer, y, tokens,
                                                            graphs=run)
            segments = [(handoff - 1, 0)]
            mode_meta = {"mode": "duodiff", "t_switch": args.t_switch,
                         "shallow_config": args.shallow_config,
                         "shallow_checkpoint": args.shallow_checkpoint, "full_seed": full_seed}
        elif buckets is not None:
            print(f"measuring per-bucket drift: {args.static_schedule}, batch {args.batch}, "
                  f"attn={attn} ...", file=sys.stderr)
            segments, bucket_meta = static_exit_drift(model, cfg, schedule, x, generator,
                                                      buckets, args.cache_outer, y, tokens,
                                                      drift, norm, graphs=run)
            if not segments:
                raise SystemExit("no bucket is cacheable (every exit is at/inside the mid "
                                 "block) — nothing to derive")
            mode_meta = {"mode": "static_exit", "static_schedule": args.static_schedule,
                         "buckets": bucket_meta}
        else:
            print(f"measuring drift: {steps} steps, batch {args.batch}, attn={attn}, "
                  f"n_outer={n_outer} ...", file=sys.stderr)
            drift[:], norm[:] = measure_drift(model, schedule, x, generator, steps - 1, n_outer,
                                              y, tokens, graphs=run)
            segments = [(steps - 1, 0)]
            mode_meta = {"mode": "dense"}

    in_seg = segment_mask(steps, segments)
    n_seg = int(in_seg.sum())

    def seg_anchors(tab):
        return int(tab[in_seg].sum())

    if args.num_anchors is not None:
        if mode_meta["mode"] == "dense":
            budget = budget_for_count(drift, args.num_anchors)
        else:
            budget = segmented_budget_for_count(drift, segments, args.num_anchors)
        budget_mode = f"num_anchors<={args.num_anchors}"
    else:
        budget = max(uniform_budget(drift[lo:hi + 1], args.budget_from_every)
                     for hi, lo in segments)
        budget_mode = f"budget_from_every={args.budget_from_every}"
    table = derive_segmented(drift, segments, budget)

    report = {"derived": table}
    for every in sorted({args.budget_from_every, 3, 5}):
        report[f"uniform_{every}"] = uniform_table(every, steps)
    print(f"\nbudget: {budget:.4f} ({budget_mode}); mean |delta| over cacheable t: "
          f"{norm[in_seg].mean():.3f}")
    print("| schedule | anchors (cacheable t) | anchor frac | max staleness | mean staleness |")
    print("|---|---|---|---|---|")
    for name, tab in report.items():
        st_max, st_mean = segmented_staleness(drift, segments, tab)
        print(f"| {name} | {seg_anchors(tab)} | {seg_anchors(tab) / n_seg:.3f} "
              f"| {st_max:.4f} | {st_mean:.4f} |")

    stale_max, stale_mean = segmented_staleness(drift, segments, table)
    meta = {
        "config": args.config or "flagship (uvit_celeba)",
        "checkpoint": args.checkpoint,
        "seed": args.seed,
        "batch": args.batch,
        "attn_impl": attn,
        "gelu_approx": args.gelu_approx,
        "n_outer": n_outer,
        "budget": budget,
        "budget_mode": budget_mode,
        "card": card,
        "max_staleness": stale_max,
        "mean_staleness": stale_mean,
        "drift": [round(float(v), 5) for v in drift],
        "delta_norm_mean": float(norm[in_seg].mean()),
        **mode_meta,
    }
    save_cache_schedule(args.out, table, meta)
    print(f"\nwrote {args.out}: {int(table.sum())} anchors total, {seg_anchors(table)} over "
          f"cacheable steps ({seg_anchors(table) / n_seg:.1%})",
          file=sys.stderr)
    return {"table": table, "budget": budget, "budget_mode": budget_mode, "drift": drift,
            "norm": norm, "meta": meta, "card": card}


if __name__ == "__main__":
    main()
