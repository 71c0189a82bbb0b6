"""End-to-end distributional convergence probe (counterpart of the
repository's ``tools/convergence_probe.py``).

It writes a known image distribution, trains a U-ViT on it through the
port's training CLI (``duodiff_tpu_torch.train``), samples the checkpoint
through the port's sampling CLI (``duodiff_tpu_torch.sample``) and measures
whether the samples match the training distribution: within-image pixel
std, the distance of each sample's mean colour to the nearest mode, and
mode coverage.

    python -m duodiff_tpu_torch.tools.convergence_probe \\
        --config configs/uvit_cifar10.yaml --steps 3000 --batch 128 --use_amp

Two distributions: ``palette`` (solid colours plus sigma-6 pixel noise, 1,
4 or 8 modes) and ``textured`` (Gaussian random fields with class-distinct
power-law spectra and base colours). The same seed writes the same files,
byte for byte, as the JAX tool. ``--dataset imagenet64`` writes the
class-conditional 64 x 64 images as the decoded-image cache the port
reads (``data/cache.py``) in place of the JAX tool's PNG folders, which
need Pillow; the cache holds the same pixels in the same order, and
sampling is per class (``--fixed_class``). Prints one JSON line with the
metrics.
"""

from __future__ import annotations

import argparse
import json
import pickle
import tempfile
import time
from pathlib import Path

import numpy as np

from duodiff_tpu_torch.data.synthetic import write_palette_cifar

TINY_YAML = """model_params:
  img_size: 32
  patch_size: 4
  in_chans: 3
  embed_dim: 32
  depth: 3
  num_heads: 4
  mlp_ratio: 4
  qkv_bias: False
  mlp_time_embed: False
  num_classes: -1
  normalize_timesteps: True
"""

# saturated, well-separated modes, away from 0/255 so the pixel noise does
# not clip; one mode is the easiest target
PALETTES = {
    1: np.array([[128, 128, 128]], np.float32),
    4: np.array([[230, 40, 40], [40, 230, 40], [40, 40, 230],
                 [230, 230, 40]], np.float32),
    8: np.array([[230, 40, 40], [40, 230, 40], [40, 40, 230],
                 [230, 230, 40], [230, 40, 230], [40, 230, 230],
                 [240, 240, 240], [20, 20, 20]], np.float32),
}

# Gaussian random fields with power spectra P(f) ~ f^-alpha, rough (1.0) to
# smooth blobs (3.4): (alpha, base RGB, contrast, per-channel field gains)
TEXTURE_CLASSES = [
    (1.0, (190, 70, 70), 30.0, (1.0, 0.55, 0.55)),
    (1.8, (70, 190, 70), 30.0, (0.55, 1.0, 0.55)),
    (2.6, (70, 70, 190), 30.0, (0.55, 0.55, 1.0)),
    (3.4, (165, 165, 70), 30.0, (1.0, 1.0, 0.45)),
]
# the modes measure() assigns textured samples to: the base colours
TEXTURE_PALETTE = np.array([c for _, c, _, _ in TEXTURE_CLASSES], np.float32)


def _gaussian_random_field(rng: np.random.RandomState, size: int, alpha: float) -> np.ndarray:
    """(size, size) real field, mean 0 std 1, power spectrum ~ f^-alpha."""
    f = np.fft.fftfreq(size) * size
    fx, fy = np.meshgrid(f, f, indexing="ij")
    r = np.sqrt(fx**2 + fy**2)
    r[0, 0] = 1.0  # the DC amplitude is zeroed below
    amp = r ** (-alpha / 2.0)
    amp[0, 0] = 0.0
    noise = rng.randn(size, size) + 1j * rng.randn(size, size)
    field = np.fft.ifft2(noise * amp).real
    return (field - field.mean()) / (field.std() + 1e-12)


def make_textured_images(rng: np.random.RandomState, ks: np.ndarray, size: int = 32) -> np.ndarray:
    """(N, size, size, 3) uint8 textured images of the class indices ``ks``."""
    out = np.empty((len(ks), size, size, 3), np.uint8)
    for i, k in enumerate(ks):
        alpha, base, contrast, gains = TEXTURE_CLASSES[int(k)]
        field = _gaussian_random_field(rng, size, alpha)
        img = (np.asarray(base, np.float32)[None, None]
               + contrast * field[:, :, None] * np.asarray(gains, np.float32)[None, None])
        out[i] = np.clip(img, 0, 255).astype(np.uint8)
    return out


def make_palette_images(rng: np.random.RandomState, ks: np.ndarray, palette: np.ndarray,
                        size: int = 32) -> np.ndarray:
    """(N, size, size, 3) uint8 palette images: solid colour plus sigma-6
    pixel noise, drawn channel-major (``write_palette_cifar``'s stream)."""
    n = len(ks)
    imgs = palette[ks][:, :, None] + rng.randn(n, 3, size * size).astype(np.float32) * 6.0
    imgs = np.clip(imgs, 0, 255).astype(np.uint8)
    return imgs.reshape(n, 3, size, size).transpose(0, 2, 3, 1)


def write_textured_cifar(data_dir, seed: int = 0, per_batch: int = 512) -> None:
    """Textured images in the CIFAR-10 file layout: ``data_batch_{1..5}``
    pickles of (per_batch, 3072) channel-major uint8 rows and their class
    labels."""
    root = Path(data_dir) / "cifar10" / "cifar-10-batches-py"
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i in range(1, 6):
        ks = rng.randint(0, len(TEXTURE_CLASSES), per_batch)
        rows = make_textured_images(rng, ks).transpose(0, 3, 1, 2).reshape(per_batch, 3072)
        with open(root / f"data_batch_{i}", "wb") as f:
            pickle.dump({b"data": rows, b"labels": ks.tolist()}, f)


def _write_class_cache(data_dir, images_of_class, n_classes: int) -> Path:
    """The ImageNet-64 decoded-image cache of ``n_classes`` classes, class
    by class (the order of the JAX tool's sorted ``c0``, ``c1``, ... folders),
    labels the class index, pixels float32 in 0..255."""
    from duodiff_tpu_torch.data.cache import CACHE_DIR, IMAGENET64_KEY

    images = np.concatenate([images_of_class(k) for k in range(n_classes)])
    labels = np.repeat(np.arange(n_classes, dtype=np.int32), len(images) // n_classes)
    final = Path(data_dir) / CACHE_DIR / IMAGENET64_KEY
    final.mkdir(parents=True, exist_ok=True)
    np.save(final / "images.npy", images.astype(np.float32))
    np.save(final / "labels.npy", labels)
    (final / "meta.json").write_text(json.dumps({"shape": list(images.shape)}))
    return final


def write_palette_imagenet64(data_dir, palette: np.ndarray, seed: int = 0, per_class: int = 320,
                             size: int = 64) -> Path:
    """The JAX tool's ``write_palette_imagefolder`` images (the same RNG
    stream, one image at a time) as a decoded-image cache."""
    rng = np.random.RandomState(seed)

    def images_of_class(k):
        return np.stack([
            np.clip(palette[k][None, None] + rng.randn(size, size, 3) * 6.0, 0, 255
                    ).astype(np.uint8) for _ in range(per_class)])

    return _write_class_cache(data_dir, images_of_class, len(palette))


def write_textured_imagenet64(data_dir, seed: int = 0, per_class: int = 320,
                              size: int = 64) -> Path:
    """The JAX tool's ``write_textured_imagefolder`` images as a
    decoded-image cache."""
    rng = np.random.RandomState(seed)
    return _write_class_cache(
        data_dir, lambda k: make_textured_images(rng, np.full(per_class, k, np.int64), size),
        len(TEXTURE_CLASSES))


def final_sample_pngs(samples_dir) -> list:
    """The ``{i}.png`` finals of a sample folder (no grid, no ``{i}_{s}``
    intermediates), sorted by name."""
    return [p for p in sorted(Path(samples_dir).glob("*.png")) if p.stem.isdigit()]


def measure(samples_dir, palette: np.ndarray) -> dict:
    """Mode statistics of the sample PNGs in ``samples_dir`` (grid images
    skipped): within-image std, mean distance to the nearest mode, modes
    hit and each mode's count."""
    from duodiff_tpu_torch.utils.image import read_png

    imgs = np.stack([read_png(p).astype(np.float32) / 255.0
                     for p in sorted(Path(samples_dir).glob("*.png"))
                     if not p.name.startswith("grid")])
    means = imgs.mean(axis=(1, 2))
    d = np.linalg.norm(means[:, None] - palette[None] / 255.0, axis=-1)
    counts = np.bincount(d.argmin(1), minlength=len(palette))
    return {
        "n_samples": int(len(imgs)),
        "within_image_std": float(imgs.std(axis=(1, 2)).mean()),
        "mean_mode_dist": float(d.min(1).mean()),
        "modes_hit": int((counts > 0).sum()),
        "mode_counts": counts.tolist(),
    }


def get_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=str, default=None,
                    help="model YAML (default: a built-in tiny 32x32 model)")
    ap.add_argument("--steps", type=int, default=2500)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--warmup", type=int, default=50)
    # keep the 1000-step schedule: at T = 100 alpha_bar_T is ~0.37, and
    # sampling from pure noise cannot match what training saw
    ap.add_argument("--num_timesteps", type=int, default=1000)
    ap.add_argument("--palette_k", type=int, default=4, choices=[1, 4, 8])
    ap.add_argument("--distribution", type=str, default="palette",
                    choices=["palette", "textured"])
    ap.add_argument("--sample_batch", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save_every", type=int, default=None,
                    help="checkpoint cadence (default: only at --steps)")
    ap.add_argument("--workdir", type=str, default=None)
    ap.add_argument("--gelu", type=str, default=None)
    ap.add_argument("--attn_impl", type=str, default=None)
    ap.add_argument("--use_amp", action="store_true", help="bf16 training")
    ap.add_argument("--dataset", type=str, default="cifar10", choices=["cifar10", "imagenet64"],
                    help="imagenet64: class-conditional 64x64 images (labels = mode index) "
                         "as a decoded-image cache, sampled class by class")
    ap.add_argument("--device", type=str, default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = get_args(argv)
    from duodiff_tpu_torch import sample, train
    from duodiff_tpu_torch.config import read_model_params
    from duodiff_tpu_torch.training.checkpointer import CHECKPOINT_FILE
    from duodiff_tpu_torch.tools._measure import device_from_arg

    device_from_arg(args.device)
    work = Path(args.workdir or tempfile.mkdtemp(prefix="duodiff_conv_"))
    work.mkdir(parents=True, exist_ok=True)
    data = work / "data"
    if args.distribution == "textured":
        palette = TEXTURE_PALETTE
        if args.dataset == "imagenet64":
            write_textured_imagenet64(data, seed=args.seed)
        else:
            write_textured_cifar(data, seed=args.seed)
    else:
        palette = PALETTES[args.palette_k]
        if args.dataset == "imagenet64":
            write_palette_imagenet64(data, palette, seed=args.seed)
        else:
            write_palette_cifar(data, palette, seed=args.seed)

    if args.config is None:
        if args.dataset == "imagenet64":
            raise SystemExit("--dataset imagenet64 needs an explicit --config with img_size: 64 "
                             "and num_classes > number of palette colors (e.g. "
                             "configs/uvit_imagenet64.yaml); the built-in tiny config is 32x32 "
                             "unconditional")
        cfg_path = work / "tiny.yaml"
        cfg_path.write_text(TINY_YAML)
    else:
        cfg_path = Path(args.config)
    if args.dataset == "imagenet64":
        mp = read_model_params(cfg_path)
        if mp.get("img_size") != 64 or mp.get("num_classes", -1) <= len(palette):
            raise SystemExit(
                f"--dataset imagenet64 needs img_size: 64 and num_classes > {len(palette)} "
                f"(got img_size={mp.get('img_size')}, num_classes={mp.get('num_classes', -1)}): "
                "the sampling stage runs --fixed_class per palette index and training needs a "
                "null-token slot above the real classes")

    train_argv = [
        "--config_path", str(cfg_path), "--n_steps", str(args.steps),
        "--batch_size", str(args.batch), "--num_timesteps", str(args.num_timesteps),
        "--lr", str(args.lr), "--num_warmup_steps", str(args.warmup),
        "--dataset", args.dataset, "--data_path", str(data),
        "--log_path", str(work / "logs"), "--exp_name", "conv",
        "--save_every_n_steps", str(args.save_every or args.steps),
        # rerunning with a larger --steps and the same --workdir continues the run
        "--resume", "--seed", str(args.seed), "--device", args.device,
    ]
    if args.gelu:
        train_argv += ["--gelu", args.gelu]
    if args.attn_impl:
        train_argv += ["--attn_impl", args.attn_impl]
    if args.use_amp:
        train_argv += ["--use_amp"]
    tic = time.time()
    logs = train.main(train_argv).logs
    train_s = time.time() - tic
    # no logs: --resume found the run already at --steps
    loss0 = logs[0]["train_loss"] if logs else float("nan")
    loss1 = logs[-1]["train_loss"] if logs else float("nan")
    print(f"train: {args.steps} steps in {train_s:.1f}s, loss {loss0:.4f} -> {loss1:.4f}")

    ckpt = work / "logs" / "conv" / f"{args.dataset}_uvit_last" / CHECKPOINT_FILE

    def sample_cmd(out, extra):
        argv = [
            "--config_path", str(cfg_path), "--checkpoint_path", str(ckpt),
            "--batch_size", str(args.sample_batch), "--parametrization", "predict_noise",
            "--output_folder", str(out), "--num_timesteps", str(args.num_timesteps),
            "--seed", str(args.seed + 1), "--device", args.device,
        ] + extra
        if args.gelu == "tanh":
            argv += ["--gelu_approx"]
        if args.attn_impl:
            argv += ["--attn_impl", args.attn_impl]
        sample.main(argv)

    tic = time.time()
    if args.dataset == "imagenet64":
        per_class = {}
        for k in range(len(palette)):
            sample_cmd(work / f"samples_c{k}", ["--fixed_class", str(k)])
            per_class[k] = measure(work / f"samples_c{k}", palette)
        sample_s = time.time() - tic

        def hit(k, r):
            return r["mode_counts"][k] / max(sum(r["mode_counts"]), 1)

        result = {
            "per_class": {str(k): {"within_image_std": r["within_image_std"],
                                   "mean_mode_dist": r["mean_mode_dist"],
                                   "dominant_mode": int(np.argmax(r["mode_counts"])),
                                   "requested_hit_frac": hit(k, r)}
                          for k, r in per_class.items()},
            "within_image_std": float(np.mean([r["within_image_std"]
                                               for r in per_class.values()])),
            "class_adherence": float(np.mean([hit(k, r) for k, r in per_class.items()])),
        }
    else:
        sample_cmd(work / "samples", [])
        sample_s = time.time() - tic
        result = measure(work / "samples", palette)
    result.update({
        "steps": args.steps, "train_loss_first": float(loss0), "train_loss_last": float(loss1),
        "train_s": round(train_s, 1), "sample_s": round(sample_s, 1), "workdir": str(work),
        "checkpoint": str(ckpt), "config": str(cfg_path),
    })
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
