"""A synthetic image distribution in the CIFAR-10 file layout, for training
runs where no dataset is at hand: solid palette colors plus sigma-6 pixel
noise, the distribution of ``tools/convergence_probe.py``'s
``write_palette_cifar`` (the same files, byte for byte, from the same
seed). A model that learns it samples solid colors near the palette modes.
"""

from __future__ import annotations

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
