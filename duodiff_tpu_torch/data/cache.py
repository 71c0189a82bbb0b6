"""Reader of the decoded-image cache (the reading side of
``duodiff_tpu/data/cache.py``).

The JAX package caches a dataset's decoded and resized images once as
``<data_dir>/_duodiff_cache/<key>/``: ``images.npy`` (N, H, W, 3), read as a
memmap, ``labels.npy`` (N,) int32 and ``meta.json`` with the images' shape.
The port cannot decode images, so a cache is its only CelebA and ImageNet
(64 and 256) source: one the JAX package built with ``--cache_data``, or a
synthetic one (``data/synthetic.py``). The cache does not record the float
transform; the key's ``norm1`` names it, and the caller passes the matching
``scale`` and ``offset``.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

CACHE_DIR = "_duodiff_cache"
IMAGENET64_KEY = "imagenet64aa_norm1"  # antialiased 64x64 resize, Normalize(0.5, 0.5)
CELEBA_KEY = "celeba64aa_norm1"        # crop 178, antialiased 64x64 resize, Normalize(0.5, 0.5)
IMAGENET256_KEY = "imagenet256_norm1"  # the 256x256 images as decoded (uint8), Normalize(0.5, 0.5)


class MemmapCachedDataset:
    """Integer indexing -> (HWC array, label), plus the loader's ``scale`` and
    ``offset``. ``num_real_classes`` is one past the largest label stored."""

    def __init__(self, cache_dir, *, scale: float, offset: float):
        final = Path(cache_dir)
        if not (final / "meta.json").exists():
            raise FileNotFoundError(f"no dataset cache at {final}")
        meta = json.loads((final / "meta.json").read_text())
        self.images = np.load(final / "images.npy", mmap_mode="r")
        if list(self.images.shape) != meta["shape"]:
            raise ValueError(f"corrupt cache at {final}: {self.images.shape} vs {meta['shape']}")
        self.labels = np.load(final / "labels.npy")
        if len(self.labels) != len(self.images):
            raise ValueError(f"corrupt cache at {final}: {len(self.labels)} labels for "
                             f"{len(self.images)} images")
        self.scale, self.offset = scale, offset
        self.num_real_classes = int(self.labels.max()) + 1

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        return self.images[i], int(self.labels[i])
