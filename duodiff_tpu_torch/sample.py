"""Dense / DuoDiff DDPM sampling CLI (counterpart of the repository's
``sampler.py``, a subset of its flags).

    python -m duodiff_tpu_torch.sample \\
        --config_path configs/uvit_celeba_3.yaml \\
        --config_path_late configs/uvit_celeba.yaml --t_switch 300 \\
        --random_init --batch_size 16 --parametrization predict_noise \\
        --output_folder out --device cuda

With a late model and ``--t_switch N`` the first model runs the N high-noise
steps t = T-1 .. T-N and the late model the rest; without, the first model
runs all T steps. The samples are written as one ``samples.npy``, uint8
NHWC. ``--attn_impl`` picks the block sublayers: ``fused`` (the CUDA
kernels; default on a CUDA device) or ``plain`` (default on the CPU).
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from duodiff_tpu_torch.diffusion.sampling import DDPMSampler
from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
from duodiff_tpu_torch.utils.model_loading import load_model


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--checkpoint_path", type=str, default=None,
                        help="Checkpoint (.pth) of the (early, for DuoDiff) model")
    parser.add_argument("--checkpoint_path_late", type=str, default=None,
                        help="Checkpoint (.pth) of the model used for the latest steps")
    parser.add_argument("--batch_size", type=int, required=True)
    parser.add_argument("--parametrization", type=str, required=True,
                        choices=["predict_noise", "predict_original", "predict_previous"])
    parser.add_argument("--output_folder", type=str, required=True)
    parser.add_argument("--config_path", type=str, required=True)
    parser.add_argument("--config_path_late", type=str, default=None)
    parser.add_argument("--t_switch", type=int, default=None,
                        help="Number of high-noise steps the first model runs "
                             "before the late model takes over")
    parser.add_argument("--random_init", action="store_true",
                        help="Skip checkpoint loading (random weights from --seed)")
    parser.add_argument("--num_timesteps", type=int, default=1000)
    parser.add_argument("--gelu_approx", action="store_true",
                        help="tanh-approximate GELU in the MLP sublayers")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--attn_impl", type=str, default=None, choices=["fused", "plain"],
                        help="Block sublayers: fused kernels or plain PyTorch "
                             "(default: fused on CUDA, plain on the CPU)")
    return parser.parse_args(argv)


def to_uint8(img01: np.ndarray) -> np.ndarray:
    img01 = np.nan_to_num(img01, nan=0.0, posinf=1.0, neginf=0.0)
    return (np.clip(img01, 0.0, 1.0) * 255.0).round().astype(np.uint8)


def main(argv=None) -> dict:
    """Run the CLI; returns {"samples": float (B, H, W, C) in about [0, 1],
    "seconds": sampling wall time}."""
    args = get_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available")
    if not args.random_init and args.checkpoint_path is None:
        raise SystemExit("--checkpoint_path is required (or pass --random_init)")
    has_late = args.config_path_late is not None or args.checkpoint_path_late is not None
    if has_late != (args.t_switch is not None):
        raise SystemExit("DuoDiff needs both --t_switch and the late model "
                         "(--config_path_late / --checkpoint_path_late)")
    steps = args.num_timesteps
    if args.t_switch is not None and not 0 <= args.t_switch <= steps:
        raise SystemExit(f"--t_switch must be in [0, {steps}], got {args.t_switch}")
    attn_impl = args.attn_impl or ("fused" if device.type == "cuda" else "plain")
    output_folder = Path(args.output_folder)
    output_folder.mkdir(parents=True, exist_ok=True)

    def load(config_path, checkpoint_path, seed):
        model, cfg = load_model(
            config_path, None if args.random_init else checkpoint_path,
            device=device, seed=seed, attn_impl=attn_impl,
            gelu_approx=args.gelu_approx,
        )
        if cfg.num_classes > 0:
            raise SystemExit("class-conditional sampling is not ported yet")
        model.pack_for_kernels()
        return model.eval(), cfg

    model, cfg = load(args.config_path, args.checkpoint_path, args.seed)
    schedule = NoiseSchedule.create(steps=steps, device=device)
    segments = [(model, steps - 1, 0)]
    if has_late:
        late, _ = load(args.config_path_late or args.config_path,
                       args.checkpoint_path_late, args.seed + 1)
        handoff = steps - args.t_switch
        segments = [(model, steps - 1, handoff), (late, handoff - 1, 0)]
    shape = (args.batch_size, cfg.img_size, cfg.img_size, cfg.in_chans)
    generator = torch.Generator(device=device).manual_seed(args.seed)

    print(f"Sampling {args.batch_size} images on {device} (attn_impl={attn_impl})...")
    with torch.inference_mode():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        tic = time.perf_counter()
        x = DDPMSampler(model, schedule).init(generator, shape)
        for seg_model, t_hi, t_lo in segments:
            if t_hi >= t_lo:
                sampler = DDPMSampler(seg_model, schedule,
                                      parametrization=args.parametrization)
                x = sampler.run(x, generator, t_hi, t_lo)
        samples = ((x + 1.0) / 2.0).cpu().numpy()  # waits for the device
        elapsed = time.perf_counter() - tic

    np.save(output_folder / "samples.npy", to_uint8(samples))
    with open(output_folder / "statistics.txt", "w") as f:
        f.write(f"Elapsed time: {elapsed} s\n")
    print(f"Elapsed time: {elapsed:.2f} s -> {output_folder}")
    return {"samples": samples, "seconds": elapsed}


if __name__ == "__main__":
    main()
