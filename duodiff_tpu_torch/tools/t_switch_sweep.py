"""DuoDiff t_switch sweep (counterpart of the repository's
``tools/t_switch_sweep.py``, its flags plus ``--device``): the FID-vs-time
frontier of the handoff point.

For each candidate t_switch it samples ``--n_samples`` images with the
shallow -> full pair, times the batches (a warm-up run first, outside the
timing), computes FID against the statistics of ``--real_stats`` (``python
-m duodiff_tpu_torch.fid --save_real_stats``) with ``--inception_weights``
(``random-init`` runs the plumbing on seed-0 random weights), and
recommends the largest t_switch whose FID stays within ``--fid_slack`` of
the full model's (t_switch 0, always swept).

    python -m duodiff_tpu_torch.tools.t_switch_sweep \\
        --config_path configs/uvit_celeba_3.yaml --checkpoint_path <shallow.pth> \\
        --config_path_late configs/uvit_celeba.yaml --checkpoint_path_late <full.pth> \\
        --real_stats celeba_stats.npz --inception_weights <pt_inception.pth> \\
        --n_samples 1024 --t_switch 0 100 200 300 400 500
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch


def get_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config_path", required=True, help="shallow (early) model")
    p.add_argument("--checkpoint_path", default=None)
    p.add_argument("--config_path_late", required=True, help="full model")
    p.add_argument("--checkpoint_path_late", default=None)
    p.add_argument("--real_stats", required=True,
                   help=".npz with real-set mu/sigma (fid --save_real_stats)")
    p.add_argument("--inception_weights", required=True)
    p.add_argument("--t_switch", type=int, nargs="+", default=[0, 100, 200, 300, 400, 500])
    p.add_argument("--n_samples", type=int, default=1024)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_timesteps", type=int, default=1000)
    p.add_argument("--fid_slack", type=float, default=0.5,
                   help="max FID degradation vs t_switch=0 (the full model)")
    p.add_argument("--random_init", action="store_true")
    p.add_argument("--output", default=None, help="JSON results path")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    if 0 not in args.t_switch:
        args.t_switch = [0] + list(args.t_switch)
    return args


def make_switch_sampler(early_sampler, late_sampler, schedule, shape):
    """DuoDiff with ``duodiff_sample``'s convention: the shallow model for
    the first t_switch (high-noise) steps t = T-1 .. T-t_switch, the full
    model for the other T - t_switch. The samplers are
    :class:`~duodiff_tpu_torch.diffusion.sampling.DDPMSampler` s; the
    returned ``sample(generator, t_switch)`` draws x_T from ``generator``
    and advances it through both segments."""

    def sample_with_switch(generator, t_switch):
        handoff = schedule.steps - int(t_switch)
        x = early_sampler.init(generator, shape)
        if t_switch > 0:
            x = early_sampler.run(x, generator, schedule.steps - 1, handoff, None)
            return late_sampler.run(x, generator, handoff - 1, 0, None)
        return late_sampler.run(x, generator, schedule.steps - 1, 0, None)

    return sample_with_switch


def main(argv=None) -> dict:
    args = get_args(argv)
    from duodiff_tpu_torch.diffusion.sampling import DDPMSampler
    from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
    from duodiff_tpu_torch.evaluation.fid import (
        compute_statistics,
        extract_features,
        frechet_distances,
    )
    from duodiff_tpu_torch.models.inception import load_inception
    from duodiff_tpu_torch.tools._measure import device_from_arg
    from duodiff_tpu_torch.utils.model_loading import load_model

    device = device_from_arg(args.device)
    attn_impl = "fused" if device.type == "cuda" else "plain"

    def load(config_path, checkpoint_path, seed):
        model, cfg = load_model(config_path, None if args.random_init else checkpoint_path,
                                device=device, seed=seed, attn_impl=attn_impl)
        model.eval().pack_for_kernels()
        return model, cfg

    early, cfg = load(args.config_path, args.checkpoint_path, args.seed)
    late, _ = load(args.config_path_late, args.checkpoint_path_late, args.seed + 1)
    schedule = NoiseSchedule.create(steps=args.num_timesteps, device=device)
    shape = (args.batch_size, cfg.img_size, cfg.img_size, cfg.in_chans)
    sample_with_switch = make_switch_sampler(DDPMSampler(early, schedule),
                                             DDPMSampler(late, schedule), schedule, shape)

    stats = np.load(args.real_stats)
    mu_r, s_r = stats["mu"], stats["sigma"]
    inception = load_inception(args.inception_weights, device)

    def generator(seed):
        return torch.Generator(device=device).manual_seed(seed)

    def synchronize():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    n_batches = (args.n_samples + args.batch_size - 1) // args.batch_size
    timed = []
    with torch.inference_mode():
        for t_switch in args.t_switch:
            sample_with_switch(generator(args.seed), t_switch)  # warm-up, outside the timing
            synchronize()
            imgs = []
            tic = time.perf_counter()
            for i in range(n_batches):
                x = sample_with_switch(generator(args.seed + 1 + i), t_switch)
                imgs.append(((x + 1.0) / 2.0).clamp(0, 1))
            synchronize()
            elapsed = time.perf_counter() - tic
            gen = torch.cat(imgs).cpu().numpy()[:args.n_samples]
            mu_s = compute_statistics(extract_features(inception, gen, args.batch_size))
            timed.append((t_switch, elapsed / (n_batches * args.batch_size), mu_s))
    # the Frechet distances of every t_switch at once, spread over processes
    fids = frechet_distances([(mu_r, s_r, *mu_s) for _, _, mu_s in timed])
    results = []
    for (t_switch, per_image, _), fid in zip(timed, fids):
        results.append({"t_switch": t_switch, "fid": round(fid, 4),
                        "s_per_image": round(per_image, 5)})
        print(f"t_switch={t_switch:>4}: FID {fid:7.3f}  {per_image * 1e3:7.2f} ms/image")

    base_fid = results[0]["fid"]
    best = max((r for r in results if r["fid"] <= base_fid + args.fid_slack),
               key=lambda r: r["t_switch"])
    print(f"\nrecommended t_switch={best['t_switch']} (FID {best['fid']} vs full-model "
          f"{base_fid}, {best['s_per_image'] * 1e3:.2f} ms/image)")
    payload = {"results": results, "recommended": best}
    if args.output:
        Path(args.output).write_text(json.dumps(payload, indent=2))
    return payload


if __name__ == "__main__":
    main()
