"""Frechet Inception Distance (counterpart of ``duodiff_tpu/evaluation/fid.py``).

Feature extraction (InceptionV3 pool3, ``models/inception.py``) runs
batched on the extractor's device; the Gaussian statistics are float64
numpy on the host and the matrix square root is scipy's, the split
torchmetrics and the JAX package use. scipy's square root of a 2048 x 2048
matrix takes tens of seconds on one core and holds the GIL, so
:func:`fids_from_features` spreads many distances over processes.
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import torch

from duodiff_tpu_torch.models.inception import preprocess
from duodiff_tpu_torch.utils.image import read_png


def model_device(model: torch.nn.Module) -> torch.device:
    return next(model.buffers()).device


@torch.inference_mode()
def extract_features(model, images01: np.ndarray, batch_size: int = 64) -> np.ndarray:
    """images01: (N, H, W, C) float in [0, 1] -> (N, 2048) float32 features,
    computed on the model's device ``batch_size`` images at a time. The last
    batch is not padded: frozen BatchNorm keeps every image independent."""
    device = model_device(model)
    feats = []
    for i in range(0, images01.shape[0], batch_size):
        chunk = torch.as_tensor(np.asarray(images01[i:i + batch_size], np.float32))
        feats.append(model(preprocess(chunk.to(device))).cpu().numpy())
    return np.concatenate(feats, axis=0)


def compute_statistics(features: np.ndarray):
    """(N, D) -> (mu (D,), sigma (D, D)) in float64."""
    f = np.asarray(features, np.float64)
    return f.mean(axis=0), np.cov(f, rowvar=False)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """|mu1 - mu2|^2 + tr(s1 + s2 - 2 sqrtm(s1 s2)), with the eps-jitter
    fallback where the product is near-singular, and the real part of a
    complex square root."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * np.trace(covmean))


def fid_from_features(real_feats: np.ndarray, fake_feats: np.ndarray) -> float:
    mu_r, s_r = compute_statistics(real_feats)
    mu_f, s_f = compute_statistics(fake_feats)
    return frechet_distance(mu_r, s_r, mu_f, s_f)


def _fid_of_pair(pair) -> float:
    return fid_from_features(*pair)


def _frechet_of(stats) -> float:
    return frechet_distance(*stats)


# BLAS threads of each worker: the workers share the cores between them
_WORKER_ENV = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def _in_processes(fn, items: list, workers) -> list:
    """``[fn(item) for item in items]``, in up to ``workers`` fresh processes
    (default: one a CPU core), each with one BLAS thread; one worker, or one
    item, in this process."""
    workers = min(len(items), workers or os.cpu_count() or 1)
    if workers <= 1:
        return [fn(item) for item in items]
    saved = {k: os.environ.get(k) for k in _WORKER_ENV}
    os.environ.update(_WORKER_ENV)  # what the spawned workers inherit
    try:
        with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
            return list(pool.map(fn, items))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def fids_from_features(pairs, workers=None) -> list:
    """:func:`fid_from_features` of each (a, b) pair of feature sets, in
    order, spread over processes: the same function on the same arrays, so
    the same values."""
    return _in_processes(_fid_of_pair, list(pairs), workers)


def frechet_distances(stats, workers=None) -> list:
    """:func:`frechet_distance` of each (mu1, sigma1, mu2, sigma2), in order,
    spread over processes."""
    return _in_processes(_frechet_of, list(stats), workers)


def read_samples(path) -> np.ndarray:
    """Every PNG under ``path`` (recursively, sorted), grid images skipped,
    as (N, H, W, 3) float32 in [0, 1]."""
    imgs = [read_png(p).astype(np.float32) / 255.0
            for p in sorted(Path(path).rglob("*.png")) if "grid" not in p.name]
    if not imgs:
        raise FileNotFoundError(f"no sample PNGs under {path}")
    print(f"Read {len(imgs)} images")
    return np.stack(imgs)


def get_dataset_samples(dataset_name: str, data_path, seed: int, n_samples: int) -> np.ndarray:
    """The first ``n_samples`` images of the dataset's seeded order, in [0, 1]."""
    from duodiff_tpu_torch.data.datasets import get_dataloader

    loader = get_dataloader(dataset_name, n_samples, seed, data_path, normalize=False)
    try:
        return loader.next_batch()["image"]
    finally:
        loader.close()
