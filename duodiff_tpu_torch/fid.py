"""FID evaluation CLI (counterpart of the repository's ``fid.py``, its flags
plus ``--device``).

    python -m duodiff_tpu_torch.fid --dataset cifar10 --data_path data \\
        --samples_path out --inception_weights pt_inception-2015-12-05-6726825d.pth

Reads every sample PNG under ``--samples_path`` (grid images skipped),
extracts InceptionV3 pool3 features on ``--device`` (default ``cuda``),
and prints the Frechet distance to as many real images of ``--dataset``
(in [0, 1], the seeded loader order), or to the statistics of
``--real_stats`` (an ``.npz`` of ``mu`` and ``sigma``, which
``--save_real_stats`` writes). ``--inception_weights random-init`` runs on
seed-0 random weights: the plumbing works, the number means nothing.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="FID evaluation parameters")
    parser.add_argument("--dataset", type=str, required=True,
                        choices=["cifar10", "celeba", "imagenet64", "imagenet256"])
    parser.add_argument("--seed", type=int, default=0,
                        help="Seed for sampling images from the dataset")
    parser.add_argument("--data_path", type=str, default="data")
    parser.add_argument("--samples_path", type=str, required=True,
                        help="Directory with generated sample PNGs")
    parser.add_argument("--inception_weights", type=str,
                        default="checkpoints/pt_inception-2015-12-05-6726825d.pth",
                        help="pytorch-fid or torchvision Inception .pth, or random-init")
    parser.add_argument("--batch_size", type=int, default=64,
                        help="Feature-extraction batch size")
    parser.add_argument("--real_stats", type=str, default=None,
                        help=".npz with precomputed real-set mu/sigma; skips the dataset "
                             "pass when given")
    parser.add_argument("--save_real_stats", type=str, default=None,
                        help="Write the real-set mu/sigma to this .npz")
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def main(argv=None) -> float:
    args = get_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available")

    from duodiff_tpu_torch.evaluation.fid import (
        compute_statistics,
        extract_features,
        frechet_distance,
        get_dataset_samples,
        read_samples,
    )
    from duodiff_tpu_torch.models.inception import load_inception

    generated = read_samples(args.samples_path)
    n_samples = len(generated)
    print(f"Using {n_samples}")

    model = load_inception(args.inception_weights, device)
    mu_f, s_f = compute_statistics(extract_features(model, generated, args.batch_size))

    if args.real_stats:
        stats = np.load(args.real_stats)
        mu_r, s_r = stats["mu"], stats["sigma"]
        print(f"Loaded real-set statistics from {args.real_stats}")
    else:
        real = get_dataset_samples(args.dataset, args.data_path, args.seed, n_samples)
        mu_r, s_r = compute_statistics(extract_features(model, real, args.batch_size))
        if args.save_real_stats:
            np.savez(args.save_real_stats, mu=mu_r, sigma=s_r)
            print(f"Saved real-set statistics to {args.save_real_stats}")

    print("Evaluating FID")
    fid = frechet_distance(mu_r, s_r, mu_f, s_f)
    print(f"FID: {fid}")
    return fid


if __name__ == "__main__":
    main()
