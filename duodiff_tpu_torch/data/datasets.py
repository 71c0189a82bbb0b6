"""Dataset readers (counterpart of ``duodiff_tpu/data/datasets.py``).

CIFAR-10 reads the train split's python pickle batches with numpy alone:
items are NHWC uint8, and the loader's fused scale and offset give
x / 255 followed by Normalize(0.5, 0.5), i.e. values in [-1, 1]. CelebA
and ImageNet need image decoding, which the port does not have yet;
ImageNet-64 is read from its decoded-image cache (``data/cache.py``) when
one is there.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from duodiff_tpu_torch.data.cache import CACHE_DIR, IMAGENET64_KEY, MemmapCachedDataset
from duodiff_tpu_torch.data.loader import DataLoader
from duodiff_tpu_torch.data.sampler import ResumableSeedableSampler


# uint8 -> float: x / 255, then Normalize(0.5, 0.5), as one multiply-add
NORMALIZE_SCALE, NORMALIZE_OFFSET = 2.0 / 255.0, -1.0


class Cifar10Dataset:
    """CIFAR-10 train split from ``cifar-10-batches-py/data_batch_{1..5}``
    under ``data_dir/cifar10`` or ``data_dir``."""

    scale, offset = NORMALIZE_SCALE, NORMALIZE_OFFSET

    def __init__(self, data_dir):
        root = Path(data_dir) / "cifar10" / "cifar-10-batches-py"
        if not root.exists():
            root = Path(data_dir) / "cifar-10-batches-py"
            if not root.exists():
                raise FileNotFoundError(f"CIFAR-10 not found under {data_dir}")
        datas, labels = [], []
        for f in (root / f"data_batch_{i}" for i in range(1, 6)):
            with open(f, "rb") as fh:
                d = pickle.load(fh, encoding="bytes")
            datas.append(d[b"data"])
            labels.extend(d[b"labels"])
        raw = np.concatenate(datas, axis=0)  # (N, 3072) uint8, CHW order
        self.images = np.ascontiguousarray(raw.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        self.labels = np.asarray(labels, dtype=np.int32)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return self.images[i], int(self.labels[i])


def get_dataloader(dataset: str, batch_size: int, seed: int, data_dir) -> DataLoader:
    """The loader of a dataset by name."""
    if dataset == "cifar10":
        ds = Cifar10Dataset(data_dir)
        return DataLoader(ds, batch_size, ResumableSeedableSampler(len(ds), seed=seed))
    if dataset == "imagenet64":
        cache = Path(data_dir) / CACHE_DIR / IMAGENET64_KEY
        if not (cache / "meta.json").exists():
            raise NotImplementedError(
                f"dataset 'imagenet64' needs image decoding, which is not ported yet, unless "
                f"its decoded cache is at {cache} (the JAX package builds it with "
                "--cache_data; duodiff_tpu_torch.data.synthetic writes a synthetic one)")
        ds = MemmapCachedDataset(cache, scale=NORMALIZE_SCALE, offset=NORMALIZE_OFFSET)
        return DataLoader(ds, batch_size, ResumableSeedableSampler(len(ds), seed=seed))
    if dataset in ("celeba", "imagenet256"):
        raise NotImplementedError(f"dataset {dataset!r} needs image decoding, not ported yet")
    raise ValueError(f"Dataset {dataset} not implemented.")
