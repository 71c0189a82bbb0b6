"""Trajectory parity of every sampling speed knob (counterpart of the
repository's ``tools/trajectory_parity.py``).

For each knob it runs the whole reverse trajectory and measures how far the
knob moves it from the dense baseline (``fused``, exact GELU, bf16): the
max-abs error at every ``--chunk``-step boundary, and the terminal max-abs
error, relative error and PSNR (with the reference's own peak-to-peak
range). Knobs: ``attn_impl`` xla / plain / pallas (the unfused block
around the attention kernel K9) against fused; tanh GELU against erf; int8
W8A8 against bf16; block caching every 3 and every 5, with and without
int8, and on a derived anchor schedule (``--cache_schedule``); DPM-Solver++
20 steps against the DDPM baseline on its x_T; DPM-Solver++ cached against
dense; static exit buckets against the dynamic threshold rule; and a rerun
of the baseline (determinism). Every trajectory draws its noise from a
``torch.Generator`` of seed 0, so two runs of one knob see the same noise.
The JAX tool's two RNG rows (rbg against threefry) have no counterpart:
torch has one generator family. On the CPU every kernel wrapper takes its
plain version, so the kernel rows read 0 there; the card runs the kernels.

    python -m duodiff_tpu_torch.tools.trajectory_parity --batch 128 --steps 1000 \\
        --out trajectory_parity_torch.json

Weights are seed-0 random (``--config``, default the CelebA-64 U-ViT;
``--ee_config`` for the exit rows). Writes the rows to ``--out`` (merged
with what is there under ``--only``) and prints a markdown table.
"""

from __future__ import annotations

import argparse
import json
import math
import time
from pathlib import Path

import numpy as np
import torch


def psnr(a, b) -> float:
    """PSNR with the peak-to-peak range of the reference side ``b``: random
    weights leave the reverse process unbounded, so [-1, 1] would misstate
    agreement."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    mse = float(np.mean((a - b) ** 2))
    if mse == 0:
        return float("inf")
    peak = float(b.max() - b.min()) or 2.0
    return 10.0 * np.log10(peak * peak / mse)


def max_err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def rel_err(a, b) -> float:
    denom = float(np.max(np.abs(np.asarray(b, np.float64)))) or 1.0
    return max_err(a, b) / denom


def row(a, b, kind, traj=None) -> dict:
    return {
        "traj_max_err": traj,
        "terminal_max_err": max_err(a, b),
        "terminal_rel_err": rel_err(a, b),
        "terminal_psnr": psnr(a, b),
        "ref_abs_max": float(np.max(np.abs(np.asarray(b, np.float64)))),
        "kind": kind,
    }


def get_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--chunk", type=int, default=100)
    p.add_argument("--threshold", type=float, default=0.08)
    p.add_argument("--only", type=str, default=None,
                   help="substring filter: run only matching rows and merge them into --out")
    p.add_argument("--cache_schedule", type=str, default=None,
                   help="derived anchor-table JSON: adds the 'block-cache derived' rows")
    p.add_argument("--config", type=str, default=None,
                   help="model YAML (default: the CelebA-64 U-ViT)")
    p.add_argument("--ee_config", type=str, default="configs/deediff_celeba.yaml",
                   help="early-exit model YAML of the static-exit row")
    p.add_argument("--out", type=str, default="trajectory_parity_torch.json")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


CACHE_ROWS = ("block-cache every=3 vs dense", "block-cache every=5 vs dense",
              "block-cache every=3 + int8 vs dense", "block-cache every=5 + int8 vs dense",
              "block-cache derived vs dense", "block-cache derived + int8 vs dense")


@torch.inference_mode()
def main(argv=None) -> dict:
    args = get_args(argv)
    from duodiff_tpu_torch.config import flagship_config, load_model_config
    from duodiff_tpu_torch.diffusion.cache_schedule import load_cache_schedule
    from duodiff_tpu_torch.diffusion.sampling import (
        DDPMSampler,
        dpm_solver_sample,
        early_exit_sample,
        make_block_cached_apply,
    )
    from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
    from duodiff_tpu_torch.diffusion.static_exit import static_exit_sample
    from duodiff_tpu_torch.models.early_exit import init_early_exit_uvit
    from duodiff_tpu_torch.models.uvit import init_uvit
    from duodiff_tpu_torch.tools._measure import (
        card_line,
        device_from_arg,
        launch_counts,
        launches_since,
    )

    def selected(name: str) -> bool:
        return args.only is None or args.only.lower() in name.lower()

    device = device_from_arg(args.device)
    cfg = load_model_config(args.config) if args.config else flagship_config()
    schedule = NoiseSchedule.create(steps=args.steps, device=device)
    shape = (args.batch, cfg.img_size, cfg.img_size, cfg.in_chans)
    base_attn = "fused"
    results = {}
    t_wall = time.time()

    def gen():
        return torch.Generator(device=device).manual_seed(0)

    def model_of(attn, gelu_approx):
        model = init_uvit(cfg, device=device, dtype=torch.bfloat16,
                          generator=torch.Generator().manual_seed(0), attn_impl=attn,
                          gelu_approx=gelu_approx)
        model.eval().pack_for_kernels()
        return model

    def chunks():
        t_hi = args.steps - 1
        while t_hi >= 0:
            t_lo = max(0, t_hi - args.chunk + 1)
            yield t_hi, t_lo
            t_hi = t_lo - 1

    def dense_trajectory(attn, gelu_approx):
        sampler = DDPMSampler(model_of(attn, gelu_approx), schedule)
        g = gen()
        x, snaps = sampler.init(g, shape), []
        for t_hi, t_lo in chunks():
            x = sampler.run(x, g, t_hi, t_lo)
            snaps.append(x.cpu().numpy())
        return snaps

    def cache_parts(model):
        n_outer = max(1, -(-(cfg.depth // 2) // 3))
        tokens = cfg.extras + cfg.num_patches
        return (lambda x, t, y: model.forward_anchor(x, t, y, n_outer=n_outer),
                lambda x, t, y, d: model.forward_cached(x, t, y, n_outer=n_outer, delta=d),
                lambda x: torch.zeros((x.shape[0], tokens, cfg.embed_dim), dtype=model.dtype,
                                      device=x.device))

    def cache_trajectory(every, attn, gelu_approx):
        # the baseline's generator and noise draws: the deviation is the
        # stale-residual approximation (and the kernels of attn) alone
        anchor, cached, init_state = cache_parts(model_of(attn, gelu_approx))
        sampler = DDPMSampler(make_block_cached_apply(anchor, cached, every, args.steps - 1),
                              schedule, init_state_fn=init_state)
        g = gen()
        x, snaps = sampler.init(g, shape), []
        state = init_state(x)
        for t_hi, t_lo in chunks():
            x, state = sampler.run(x, g, t_hi, t_lo, state=state)
            snaps.append(x.cpu().numpy())
        return snaps

    def traj(snaps, ref):
        return [max_err(a, b) for a, b in zip(snaps, ref)]

    launches = {}

    def counted(key, run):
        """``run()``, its kernel launches kept under ``key``."""
        before = launch_counts()
        out = run()
        launches[key] = launches_since(before)
        return out

    variant_rows = [r for r in (
        ("attn xla vs fused", "xla", False, "numerics"),
        ("attn plain vs fused", "plain", False, "numerics"),
        ("attn pallas vs fused", "pallas", False, "numerics"),
        ("gelu tanh vs exact (fused)", base_attn, True, "numerics"),
        ("attn fused_int8 vs fused", "fused_int8", False, "quantization"),
    ) if selected(r[0])]
    det_name = f"determinism {base_attn} (rerun)"
    table = None
    if args.cache_schedule:
        table = load_cache_schedule(args.cache_schedule, num_timesteps=args.steps)
    cache_rows = [(name, every, attn, gelu, kind) for name, every, attn, gelu, kind in (
        (CACHE_ROWS[0], 3, base_attn, False, "algorithmic"),
        (CACHE_ROWS[1], 5, base_attn, False, "algorithmic"),
        # int8 with tanh GELU, as the headline composition serves it
        (CACHE_ROWS[2], 3, "fused_int8", True, "quantization+algorithmic"),
        (CACHE_ROWS[3], 5, "fused_int8", True, "quantization+algorithmic"),
        (CACHE_ROWS[4], table, base_attn, False, "algorithmic"),
        (CACHE_ROWS[5], table, "fused_int8", True, "quantization+algorithmic"),
    ) if selected(name) and every is not None]

    dpm_name, dpm_cached_name = ("DPM-20 vs DDPM-1000 (shared x_init)",
                                 "DPM-20 cached every=3 vs DPM-20 dense")
    base = None
    if variant_rows or cache_rows or selected(det_name) or selected(dpm_name):
        base = counted("baseline", lambda: dense_trajectory(base_attn, False))
    if selected(det_name):
        again = counted(det_name, lambda: dense_trajectory(base_attn, False))
        results[det_name] = row(again[-1], base[-1], "numerics", traj=traj(base, again))
    for name, attn, gelu, kind in variant_rows:
        snaps = counted(name, lambda: dense_trajectory(attn, gelu))
        results[name] = row(snaps[-1], base[-1], kind, traj=traj(snaps, base))
    for name, every, attn, gelu, kind in cache_rows:
        snaps = counted(name, lambda: cache_trajectory(every, attn, gelu))
        results[name] = row(snaps[-1], base[-1], kind, traj=traj(snaps, base))

    if selected(dpm_name) or selected(dpm_cached_name):
        model = model_of(base_attn, False)
        x_init = DDPMSampler(model, schedule).init(gen(), shape)  # the baseline's x_T

        def dpm(cache=None):
            return dpm_solver_sample(model, gen(), schedule=schedule, shape=shape, dpm_steps=20,
                                     order=2, x_init=x_init, cache=cache).cpu().numpy()

        dense_dpm = counted(dpm_name, dpm)
        if selected(dpm_name):
            results[dpm_name] = row(dense_dpm, base[-1], "solver+stochasticity")
        if selected(dpm_cached_name):
            anchor, cached, init_state = cache_parts(model)
            results[dpm_cached_name] = row(
                counted(dpm_cached_name, lambda: dpm((anchor, cached, 3, init_state))),
                dense_dpm, "algorithmic")

    if selected("static buckets"):
        ee_cfg = load_model_config(args.ee_config)
        ee_model = init_early_exit_uvit(ee_cfg, device=device, dtype=torch.bfloat16,
                                        generator=torch.Generator().manual_seed(0),
                                        attn_impl=base_attn, gelu_approx=True)
        ee_model.eval().pack_for_kernels()
        ee_shape = (args.batch, ee_cfg.img_size, ee_cfg.img_size, ee_cfg.in_chans)
        static_name = f"static buckets vs dynamic thr={args.threshold}"
        t = args.steps
        buckets = [(t - 1, int(t * 0.7), 3), (int(t * 0.7) - 1, int(t * 0.3), 8),
                   (int(t * 0.3) - 1, 0, ee_cfg.depth)]

        def both():
            dynamic = early_exit_sample(ee_model, gen(), schedule=schedule, shape=ee_shape,
                                        threshold=args.threshold)
            return dynamic, static_exit_sample(ee_model, gen(), schedule=schedule,
                                               shape=ee_shape, buckets=buckets)

        (dyn_x, _, dyn_idx), static_x = counted(static_name, both)
        results[static_name] = {
            **row(static_x.cpu().numpy(), dyn_x.cpu().numpy(), "algorithmic"),
            "dynamic_mean_exit": float(dyn_idx.float().mean()),
        }

    for name, r in results.items():
        r["launches"] = launches.get(name, {})
    wall = time.time() - t_wall
    out_path = Path(args.out)
    rows_out = results
    if args.only is not None and out_path.exists():
        rows_out = {**json.loads(out_path.read_text()).get("rows", {}), **results}

    # JSON has no Infinity (a bit-equal rerun's PSNR): non-finite floats as strings
    def finite(o):
        if isinstance(o, dict):
            return {k: finite(v) for k, v in o.items()}
        if isinstance(o, list):
            return [finite(v) for v in o]
        if isinstance(o, float) and not math.isfinite(o):
            return repr(o)
        return o

    out = {"batch": args.batch, "steps": args.steps, "card": card_line(device),
           "wall_s": round(wall, 1), "baseline_launches": launches.get("baseline"),
           "rows": rows_out}
    out_path.write_text(json.dumps(finite(out), indent=2, allow_nan=False))
    print(f"wrote {out_path} ({wall:.0f}s)")
    print("| knob | kind | terminal max-abs-err | rel err | PSNR (dB) |")
    print("|---|---|---|---|---|")
    for name, r in rows_out.items():
        p = r["terminal_psnr"]
        ps = f"{p:.1f}" if isinstance(p, float) and math.isfinite(p) else str(p)
        print(f"| {name} | {r['kind']} | {r['terminal_max_err']:.3e} "
              f"| {r['terminal_rel_err']:.3e} | {ps} |")
    return out


if __name__ == "__main__":
    main()
