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

The static-exit mode (``--static_schedule``, a derivation over an
early-exit model's buckets) is not ported yet: it comes with early-exit
training (ROADMAP item 7, its second half); it is refused.

It runs on the card unless ``--device cpu``. The JSON it writes holds the
anchors and a ``meta`` block as the JAX tool writes it, with the card's name
and power limit in place of the JAX backend.
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
from duodiff_tpu_torch.diffusion.sampling import ddpm_loop
from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
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
                   help="static-exit mode (not ported yet; refused)")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def check_args(args) -> None:
    """The JAX tool's refusals, and the static-exit mode's."""
    if (args.t_switch is None) != (args.shallow_config is None):
        raise SystemExit("--t_switch and --shallow_config go together")
    if args.t_switch is not None and args.static_schedule is not None:
        raise SystemExit("--t_switch and --static_schedule are mutually exclusive")
    if args.static_schedule is not None:
        raise SystemExit("--static_schedule (derivation over static-exit buckets) is not "
                         "ported yet: it comes with early-exit training (ROADMAP item 7, its "
                         "second half)")
    if args.full_seed is not None and (args.checkpoint is not None or args.t_switch is None):
        raise SystemExit("--full_seed is for the random-init DuoDiff mode only (no "
                         "--checkpoint, with --t_switch)")
    if args.t_switch is not None and not 1 <= args.t_switch <= args.steps - 1:
        raise SystemExit(f"--t_switch must be in [1, {args.steps - 1}]")
    if args.num_anchors is None and args.budget_from_every < 1:
        raise SystemExit("--budget_from_every must be >= 1")


def drift_apply(anchor_apply):
    """A stateful apply (``diffusion/sampling.py``) around an anchor forward
    ``(x, t, y) -> (out, delta)``: the state is the previous step's delta,
    the output ``(out, (drift_sq, norm_sq))`` for the aux rows, fp32 0-d
    tensors on the device."""
    def apply(prev_delta, x, t_batch, y, t):
        out, delta = anchor_apply(x, t_batch, y)
        d32 = delta.float()
        drift_sq = torch.sum((d32 - prev_delta.float()) ** 2)
        return (out, (drift_sq, torch.sum(d32 ** 2))), delta

    return apply


def measure_drift(model, schedule, x, generator, t_hi: int, n_outer: int, y, tokens: int,
                  noise_table=None):
    """The full model's anchor forward over t = t_hi .. 0 from x, its noise
    from ``generator`` or ``noise_table``; returns (drift, norm), each (t_hi +
    1,) float64 indexed by t: ||delta_t - delta_{t+1}||_F (row t_hi against
    the zero start, never read) and ||delta_t||_F."""
    state = torch.zeros((x.shape[0], tokens, model.config.embed_dim), dtype=model.dtype,
                        device=x.device)
    apply = drift_apply(lambda xx, tt, yy: model.forward_anchor(xx, tt, yy, n_outer=n_outer))
    _, _, (drift_sq, norm_sq) = ddpm_loop(
        apply, schedule, "predict_noise", x, generator, range(t_hi, -1, -1), y,
        noise_table=noise_table, state=state, aux_fn=lambda out: out,
    )
    rows = torch.stack([drift_sq, norm_sq]).double().cpu().numpy()  # one read, after the run
    return np.sqrt(rows[0])[::-1], np.sqrt(rows[1])[::-1]


def main(argv=None) -> dict:
    """Run the tool; returns {"table": bool (steps,), "budget", "budget_mode",
    "drift" (steps,), "meta", "card"}."""
    args = get_args(argv)
    check_args(args)
    device = device_from_arg(args.device)
    card = card_line(device)
    print(card)
    attn = args.attn_impl or ("fused" if device.type == "cuda" else "plain")
    full_seed = args.seed if args.full_seed is None else args.full_seed
    model, cfg = load_model(args.config or FLAGSHIP_CONFIG, args.checkpoint, device=device,
                            seed=full_seed, attn_impl=attn, gelu_approx=args.gelu_approx)
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
    drift = np.zeros((steps,), np.float64)
    norm = np.zeros((steps,), np.float64)
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
                          range(steps - 1, handoff - 1, -1), y)
            drift[:handoff], norm[:handoff] = measure_drift(model, schedule, x, generator,
                                                            handoff - 1, n_outer, y, tokens)
            n_seg = handoff
            mode_meta = {"mode": "duodiff", "t_switch": args.t_switch,
                         "shallow_config": args.shallow_config,
                         "shallow_checkpoint": args.shallow_checkpoint, "full_seed": full_seed}
        else:
            print(f"measuring drift: {steps} steps, batch {args.batch}, attn={attn}, "
                  f"n_outer={n_outer} ...", file=sys.stderr)
            drift[:], norm[:] = measure_drift(model, schedule, x, generator, steps - 1, n_outer,
                                              y, tokens)
            n_seg = steps
            mode_meta = {"mode": "dense"}

    # the cached segment is t = n_seg - 1 .. 0; the rows above it run dense,
    # so "anchor" is their true value
    seg_drift = drift[:n_seg]

    def staleness(tab):
        st = segment_staleness(seg_drift, tab[:n_seg])
        return float(st.max()), float(st.mean())

    def seg_anchors(tab):
        return int(tab[:n_seg].sum())

    if args.num_anchors is not None:
        budget = budget_for_count(seg_drift, args.num_anchors)
        budget_mode = f"num_anchors<={args.num_anchors}"
    else:
        budget = uniform_budget(seg_drift, args.budget_from_every)
        budget_mode = f"budget_from_every={args.budget_from_every}"
    table = np.ones((steps,), dtype=bool)
    table[:n_seg] = derive_anchor_table(seg_drift, budget)

    report = {"derived": table}
    for every in sorted({args.budget_from_every, 3, 5}):
        report[f"uniform_{every}"] = uniform_table(every, steps)
    print(f"\nbudget: {budget:.4f} ({budget_mode}); mean |delta| over cacheable t: "
          f"{norm[:n_seg].mean():.3f}")
    print("| schedule | anchors (cacheable t) | anchor frac | max staleness | mean staleness |")
    print("|---|---|---|---|---|")
    for name, tab in report.items():
        st_max, st_mean = staleness(tab)
        print(f"| {name} | {seg_anchors(tab)} | {seg_anchors(tab) / n_seg:.3f} "
              f"| {st_max:.4f} | {st_mean:.4f} |")

    stale_max, stale_mean = staleness(table)
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
        "delta_norm_mean": float(norm[:n_seg].mean()),
        **mode_meta,
    }
    save_cache_schedule(args.out, table, meta)
    print(f"\nwrote {args.out}: {int(table.sum())} anchors total, {seg_anchors(table)} over "
          f"cacheable steps ({seg_anchors(table) / n_seg:.1%})",
          file=sys.stderr)
    return {"table": table, "budget": budget, "budget_mode": budget_mode, "drift": drift,
            "meta": meta, "card": card}


if __name__ == "__main__":
    main()
