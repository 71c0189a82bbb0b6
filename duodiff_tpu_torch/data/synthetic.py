"""A synthetic image distribution for training runs where no dataset is at
hand: solid palette colors plus sigma-6 pixel noise. A model that learns it
samples solid colors near the palette modes.

:func:`write_palette_cifar` writes it in the CIFAR-10 file layout, the
distribution of ``tools/convergence_probe.py``'s ``write_palette_cifar``
(the same files, byte for byte, from the same seed);
:func:`write_palette_imagenet64_cache`, :func:`write_palette_celeba_cache`
and :func:`write_palette_imagenet256_cache` as the decoded-image caches that
``--dataset imagenet64``, ``celeba`` and ``imagenet256`` read
(``data/cache.py``).
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path

import numpy as np

# four saturated, well-separated modes, away from 0/255 so the noise does
# not clip
PALETTE4 = np.array([[230, 40, 40], [40, 230, 40], [40, 40, 230], [230, 230, 40]], np.float32)


def write_palette_cifar(data_dir, palette: np.ndarray = PALETTE4, seed: int = 0,
                        per_batch: int = 256) -> None:
    """``data_dir/cifar10/cifar-10-batches-py/data_batch_{1..5}``: pickles of
    (per_batch, 3072) uint8 rows (channel-major 32x32x3) and their labels,
    the palette index of each image."""
    root = Path(data_dir) / "cifar10" / "cifar-10-batches-py"
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i in range(1, 6):
        ks = rng.randint(0, len(palette), per_batch)
        imgs = palette[ks][:, :, None] + rng.randn(per_batch, 3, 32 * 32).astype(np.float32) * 6.0
        rows = np.clip(imgs, 0, 255).astype(np.uint8).reshape(per_batch, 3072)
        with open(root / f"data_batch_{i}", "wb") as f:
            pickle.dump({b"data": rows, b"labels": ks.tolist()}, f)


def _write_cache(final: Path, images: np.ndarray, labels: np.ndarray) -> Path:
    final.mkdir(parents=True, exist_ok=True)
    np.save(final / "images.npy", images)
    np.save(final / "labels.npy", labels)
    (final / "meta.json").write_text(json.dumps({"shape": list(images.shape)}))
    return final


def _palette_images(rng, colors: np.ndarray, palette: np.ndarray, size: int = 64) -> np.ndarray:
    """Each image its palette color (index modulo the palette) plus noise,
    float32 size x size x 3 in 0..255."""
    n = len(colors)
    images = palette[colors % len(palette)][:, None, None, :] + (
        rng.randn(n, size, size, 3).astype(np.float32) * 6.0)
    return np.clip(images, 0, 255).astype(np.float32)


def write_palette_imagenet64_cache(data_dir, n: int = 1024, palette: np.ndarray = PALETTE4,
                                   seed: int = 0, num_classes: int = 999) -> Path:
    """``data_dir/_duodiff_cache/imagenet64aa_norm1/``: ``n`` float32 64x64x3
    images in 0..255 as the JAX package caches resized ImageNet-64, labels
    uniform in [0, num_classes) (999: the config's slot 999 stays free for
    the null label), each image its label's palette color (label modulo the
    palette) plus noise. Returns the cache directory."""
    from duodiff_tpu_torch.data.cache import CACHE_DIR, IMAGENET64_KEY

    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, n).astype(np.int32)
    return _write_cache(Path(data_dir) / CACHE_DIR / IMAGENET64_KEY,
                        _palette_images(rng, labels, palette), labels)


def write_palette_celeba_cache(data_dir, n: int = 1024, palette: np.ndarray = PALETTE4,
                               seed: int = 0) -> Path:
    """``data_dir/_duodiff_cache/celeba64aa_norm1/``: ``n`` float32 64x64x3
    images in 0..255 as the JAX package caches cropped and resized CelebA,
    every label 0 (CelebA's loader yields none), each image a random palette
    color plus noise. Returns the cache directory."""
    from duodiff_tpu_torch.data.cache import CACHE_DIR, CELEBA_KEY

    rng = np.random.RandomState(seed)
    images = _palette_images(rng, rng.randint(0, len(palette), n), palette)
    return _write_cache(Path(data_dir) / CACHE_DIR / CELEBA_KEY, images,
                        np.zeros(n, np.int32))


def write_palette_imagenet256_cache(data_dir, n: int = 256, palette: np.ndarray = PALETTE4,
                                    seed: int = 0, num_classes: int = 1000,
                                    size: int = 256) -> Path:
    """``data_dir/_duodiff_cache/imagenet256_norm1/``: ``n`` uint8 size x size
    x 3 images, as the JAX package caches ImageNet-256 (unresized images are
    kept as decoded, uint8: 196,608 bytes an image at 256), labels uniform in
    [0, num_classes) (1000: ``uvit_imagenet256.yaml``'s slot 1000 stays free
    for the null label), each image its label's palette color plus noise,
    rounded. ``size`` is 256 for the configs; smaller sizes suit tiny
    autoencoders. Returns the cache directory."""
    from duodiff_tpu_torch.data.cache import CACHE_DIR, IMAGENET256_KEY

    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, n).astype(np.int32)
    images = np.empty((n, size, size, 3), np.uint8)
    for lo in range(0, n, 64):  # in chunks: the float32 noise of 256 images is 200 MB
        hi = min(n, lo + 64)
        images[lo:hi] = np.rint(_palette_images(rng, labels[lo:hi], palette, size))
    return _write_cache(Path(data_dir) / CACHE_DIR / IMAGENET256_KEY, images, labels)
