"""Weight-free sample-quality metrics: FD-rand and the spectral distance
(counterpart of ``duodiff_tpu/evaluation/metrics.py``).

- **FD-rand**: the Frechet distance of InceptionV3 pool3 features under a
  fixed seeded random initialisation, each set standardised by the
  reference set's per-dimension statistics.
- **Spectral distance**: the RMS distance between mean radial log power
  spectra, which sees the texture and high-frequency damage that mode
  statistics miss.

Both are relative: report them against a reference set (fresh draws of the
data distribution, or the dense-DDPM samples when isolating a speed knob).
The port's seed-2026 extractor is drawn by ``torch.Generator``, not by
JAX's PRNG, so its FD-rand values compare with the port's own only, not
with the JAX package's tables.
"""

from __future__ import annotations

import numpy as np
import torch

from duodiff_tpu_torch.evaluation.fid import extract_features, fid_from_features
from duodiff_tpu_torch.models.inception import init_inception

# every FD-rand number of the port uses this seed
FEATURE_SEED = 2026


def random_inception(seed: int = FEATURE_SEED, device="cuda"):
    """The FD-rand extractor: the InceptionV3 graph with seeded random
    weights (``init_inception`` from ``torch.Generator().manual_seed(seed)``)
    on ``device``."""
    return init_inception(torch.Generator().manual_seed(seed)).to(device)


def standardize_features(ref_feats: np.ndarray, feats_list):
    """Z-score every feature set by the reference set's per-dimension mean
    and std, float64; the std floor (1 % of the mean std) keeps near-dead
    dimensions from amplifying float noise. Random-init activations are
    ~1e-4 in scale, which would put the raw distance at ~1e-6."""
    ref = np.asarray(ref_feats, np.float64)
    mu = ref.mean(axis=0)
    sd = ref.std(axis=0)
    sd = np.maximum(sd, 0.01 * sd.mean() + 1e-12)
    return [(np.asarray(f, np.float64) - mu) / sd for f in feats_list]


def fd_rand(images_a: np.ndarray, images_b: np.ndarray, batch_size: int = 32,
            seed: int = FEATURE_SEED, model=None, device="cuda") -> float:
    """Frechet distance between two image sets ((N, H, W, 3) float in [0, 1])
    under seeded random pool3 features, standardised by set a's statistics.
    Pass ``model`` (:func:`random_inception`) to reuse one extractor; without,
    the extractor of ``seed`` is built on ``device``."""
    model = model if model is not None else random_inception(seed, device)
    fa = extract_features(model, images_a, batch_size)
    fb = extract_features(model, images_b, batch_size)
    fa, fb = standardize_features(fa, [fa, fb])
    return fid_from_features(fa, fb)


def radial_power_spectrum(images: np.ndarray) -> np.ndarray:
    """Mean radial log10 power spectrum of an image set ((N, H, W, C) or (N,
    H, W) in [0, 1], H == W): channel mean, per-image mean removed, |FFT2|^2
    averaged over the set, binned by integer radius. Entry k covers radii
    [k + 1, k + 2); the DC-only band is dropped. (H // 2 - 1,) float64."""
    imgs = np.asarray(images, np.float64)
    if imgs.ndim == 4:
        imgs = imgs.mean(axis=-1)
    _, h, w = imgs.shape
    if h != w:
        raise ValueError(f"radial spectrum needs square images, got {h}x{w}")
    imgs = imgs - imgs.mean(axis=(1, 2), keepdims=True)
    power = (np.abs(np.fft.fft2(imgs)) ** 2).mean(axis=0)
    f = np.fft.fftfreq(h) * h
    fx, fy = np.meshgrid(f, f, indexing="ij")
    r = np.sqrt(fx**2 + fy**2)
    nbins = h // 2
    bins = np.clip(r.astype(np.int64), 0, nbins).ravel()
    keep = (bins < nbins) & (r.ravel() > 0)
    sums = np.bincount(bins[keep], weights=power.ravel()[keep], minlength=nbins)
    counts = np.bincount(bins[keep], minlength=nbins)
    return np.log10(sums / np.maximum(counts, 1) + 1e-12)[1:]


def spectral_distance(images_a: np.ndarray, images_b: np.ndarray) -> float:
    """RMS distance between the two sets' mean radial log power spectra, in
    log10-power units (0.3: a ~2x power mismatch in an average band)."""
    sa, sb = radial_power_spectrum(images_a), radial_power_spectrum(images_b)
    return float(np.sqrt(np.mean((sa - sb) ** 2)))
