"""Pick the cache schedule's drift weighting by measurement (counterpart of
the repository's ``tools/probe_cache_gamma.py``).

The derivation's greedy places anchors on a per-step signal ``s(t) =
drift(t) * w(t)^gamma``, where ``w(t) = beta_t / (sqrt(1 - abar_t)
sqrt(alpha_t) sqrt(abar_{t-1}))`` is the first-order amplification of an
eps error injected at step t into the terminal sample. gamma = 0 trusts the
raw drift, gamma = 1 the linear model; neither is exact, so this probe
samples each candidate schedule (the gammas and the uniform 3 / 5 / ``--
budget_from_every`` tables) block-cached and measures its terminal
deviation from the dense trajectory (every step an anchor), on one noise
stream (a generator of seed 0 for every run).

    python -m duodiff_tpu_torch.tools.probe_cache_gamma --drift_json sched.json \\
        [--gammas 0,0.25,0.5,1] [--budget_from_every 3] [--batch 128]

``--drift_json`` is a ``derive_cache_schedule`` output (its ``meta.drift``
is the measured curve). Prints a markdown table (anchors, max gap, terminal
max error, PSNR a candidate); ``--out`` writes the candidate with the
fewest anchors among those at least as close as uniform-``--ref_every``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def get_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--drift_json", type=str, required=True,
                    help="a derive_cache_schedule output (its meta.drift is the drift curve)")
    ap.add_argument("--config", type=str, default=None,
                    help="model YAML (default: the CelebA-64 U-ViT; use the drift's model)")
    ap.add_argument("--checkpoint", type=str, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gammas", type=str, default="0,0.25,0.5,0.75,1")
    ap.add_argument("--budget_from_every", type=int, default=3)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--cache_outer", type=int, default=None)
    ap.add_argument("--ref_every", type=int, default=3,
                    help="the uniform schedule whose PSNR gates --out")
    ap.add_argument("--out", type=str, default=None,
                    help="write the best schedule JSON here (fewest anchors among the gammas "
                         "with PSNR >= uniform-<ref_every>'s)")
    ap.add_argument("--device", type=str, default="cuda")
    return ap.parse_args(argv)


def amplification(betas: np.ndarray) -> np.ndarray:
    """w(t): the first-order terminal amplification of an eps error at t."""
    betas = np.asarray(betas, np.float64)
    alphas = 1.0 - betas
    abar = np.cumprod(alphas)
    abar_prev = abar / alphas
    return betas / np.sqrt(1 - abar) / np.sqrt(alphas) / np.sqrt(abar_prev)


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a - b) ** 2))
    peak = float(b.max() - b.min()) or 2.0
    return 10.0 * np.log10(peak * peak / mse) if mse else float("inf")


@torch.inference_mode()
def main(argv=None) -> dict:
    args = get_args(argv)
    from duodiff_tpu_torch.config import flagship_config
    from duodiff_tpu_torch.diffusion.cache_schedule import (
        derive_anchor_table,
        save_cache_schedule,
        uniform_budget,
        uniform_table,
    )
    from duodiff_tpu_torch.diffusion.sampling import DDPMSampler, make_block_cached_apply
    from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
    from duodiff_tpu_torch.models.uvit import init_uvit
    from duodiff_tpu_torch.tools._measure import (
        card_line,
        device_from_arg,
        launch_counts,
        launches_since,
    )
    from duodiff_tpu_torch.utils.model_loading import load_model

    device = device_from_arg(args.device)
    meta = json.loads(open(args.drift_json).read())["meta"]
    drift = np.asarray(meta["drift"], np.float64)
    steps = args.steps
    if drift.shape[0] != steps:
        raise SystemExit(f"--drift_json holds {drift.shape[0]} steps of drift, --steps is {steps}")
    schedule = NoiseSchedule.create(steps=steps, device=device)
    w = amplification(schedule.betas.double().cpu().numpy())

    candidates = {f"uniform_{every}": uniform_table(every, steps)
                  for every in sorted({args.budget_from_every, args.ref_every, 5})}
    for g in (float(v) for v in args.gammas.split(",")):
        signal = drift * np.power(w, g)
        candidates[f"gamma_{g:g}"] = derive_anchor_table(
            signal, uniform_budget(signal, args.budget_from_every))

    attn = "fused" if device.type == "cuda" else "plain"
    if args.config:
        model, cfg = load_model(args.config, args.checkpoint, device=device, seed=args.seed,
                                attn_impl=attn)
    else:
        cfg = flagship_config()
        model = init_uvit(cfg, device=device, generator=torch.Generator().manual_seed(args.seed),
                          attn_impl=attn)
    model.eval().pack_for_kernels()
    n_outer = (args.cache_outer if args.cache_outer is not None
               else max(1, -(-(cfg.depth // 2) // 3)))
    tokens = cfg.extras + cfg.num_patches
    shape = (args.batch, cfg.img_size, cfg.img_size, cfg.in_chans)
    y = None
    if cfg.num_classes > 0:  # one fixed label draw, as derive_cache_schedule's
        y = torch.randint(0, cfg.num_classes, (args.batch,),
                          generator=torch.Generator().manual_seed(7)).to(device)

    def run(table) -> np.ndarray:
        apply = make_block_cached_apply(
            lambda x, t, yy: model.forward_anchor(x, t, yy, n_outer=n_outer),
            lambda x, t, yy, d: model.forward_cached(x, t, yy, n_outer=n_outer, delta=d),
            np.asarray(table, bool), steps - 1)
        sampler = DDPMSampler(apply, schedule, init_state_fn=lambda x: torch.zeros(
            (x.shape[0], tokens, cfg.embed_dim), dtype=model.dtype, device=x.device))
        g = torch.Generator(device=device).manual_seed(0)
        x = sampler.init(g, shape)
        x, _ = sampler.run(x, g, steps - 1, 0, y, state=sampler.init_state_fn(x))
        return x.double().cpu().numpy()

    print(f"dense reference (every step an anchor), card {card_line(device)} ...")
    before = launch_counts()
    dense = run(np.ones((steps,), bool))
    dense_launches = launches_since(before)
    rows = {}
    print("| schedule | anchors | max gap | terminal max-err | PSNR (dB) |")
    print("|---|---|---|---|---|")
    for name, table in candidates.items():
        before = launch_counts()
        x = run(table)
        gaps = np.diff(np.sort(np.append(np.flatnonzero(table), steps - 1)))
        rows[name] = {"anchors": int(table.sum()), "max_gap": int(gaps.max()),
                      "max_err": float(np.max(np.abs(x - dense))), "psnr": psnr(x, dense),
                      "anchored_steps": int(table.sum() + (not table[steps - 1])),
                      "launches": launches_since(before), "table": table}
        r = rows[name]
        print(f"| {name} | {r['anchors']} | {r['max_gap']} | {r['max_err']:.3e} "
              f"| {r['psnr']:.1f} |", flush=True)

    best = None
    if args.out:
        ref = rows[f"uniform_{args.ref_every}"]["psnr"]
        ok = {n: r for n, r in rows.items() if n.startswith("gamma_") and r["psnr"] >= ref}
        if not ok:
            print(f"no gamma candidate reaches uniform-{args.ref_every}'s {ref:.1f} dB; not "
                  "writing --out")
        else:
            best = min(ok, key=lambda n: ok[n]["anchors"])
            save_cache_schedule(args.out, ok[best]["table"], meta={
                **{k: meta[k] for k in ("config", "seed", "attn_impl", "gelu_approx", "n_outer")
                   if k in meta},
                "probe": best, "psnr_vs_dense": ok[best]["psnr"], "uniform_ref_psnr": ref,
                "batch": args.batch,
            })
            print(f"wrote {args.out}: {best} ({ok[best]['anchors']} anchors, "
                  f"{ok[best]['psnr']:.1f} dB)")
    return {"rows": {n: {k: v for k, v in r.items() if k != "table"} for n, r in rows.items()},
            "best": best, "dense_launches": dense_launches, "card": card_line(device)}


if __name__ == "__main__":
    main()
