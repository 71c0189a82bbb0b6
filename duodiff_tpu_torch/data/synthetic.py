"""A synthetic image distribution for training runs where no dataset is at
hand: solid palette colors plus sigma-6 pixel noise. A model that learns it
samples solid colors near the palette modes.

:func:`write_palette_cifar` writes it in the CIFAR-10 file layout, the
distribution of ``tools/convergence_probe.py``'s ``write_palette_cifar``
(the same files, byte for byte, from the same seed);
:func:`write_palette_imagenet64_cache` as the decoded-image cache that
``--dataset imagenet64`` reads (``data/cache.py``).
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


def write_palette_imagenet64_cache(data_dir, n: int = 1024, palette: np.ndarray = PALETTE4,
                                   seed: int = 0, num_classes: int = 999) -> Path:
    """``data_dir/_duodiff_cache/imagenet64aa_norm1/``: ``n`` float32 64x64x3
    images in 0..255 as the JAX package caches resized ImageNet-64, labels
    uniform in [0, num_classes) (999: the config's slot 999 stays free for
    the null label), each image its label's palette color (label modulo the
    palette) plus noise. Returns the cache directory."""
    from duodiff_tpu_torch.data.cache import CACHE_DIR, IMAGENET64_KEY

    final = Path(data_dir) / CACHE_DIR / IMAGENET64_KEY
    final.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, n).astype(np.int32)
    images = palette[labels % len(palette)][:, None, None, :] + (
        rng.randn(n, 64, 64, 3).astype(np.float32) * 6.0)
    images = np.clip(images, 0, 255).astype(np.float32)
    np.save(final / "images.npy", images)
    np.save(final / "labels.npy", labels)
    (final / "meta.json").write_text(json.dumps({"shape": list(images.shape)}))
    return final
