"""The port's FID statistics and weight-free quality metrics
(``duodiff_tpu_torch/evaluation``) against the JAX package's
(``duodiff_tpu/evaluation``), and the unnormalised data path FID reads.

Tolerances, each with its reason:
- ``compute_statistics``, ``frechet_distance`` (with ``tests/test_fid.py``'s
  goldens), ``fid_from_features``, ``standardize_features``,
  ``radial_power_spectrum`` and ``spectral_distance`` on equal inputs:
  rtol 1e-9 (float64 numpy and scipy on both sides);
- ``fd_rand`` on the JAX extractor's weights crossed over: the port's
  features within 1e-4 of the largest JAX feature (seeded random features
  are ~1e-4 in scale), and the distance computed by the port's code on
  JAX's features within rtol 1e-9 of JAX's ``fd_rand``. The distances are
  compared on equal features: with N < 2048 the covariances are singular,
  and the square root's jitter fallback and real part would magnify a
  1e-6 difference of the features;
- the real images and the sample PNGs FID reads: equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from duodiff_tpu.evaluation import fid as jax_fid
from duodiff_tpu.evaluation import metrics as jax_metrics
from duodiff_tpu.models.inception import InceptionV3Features as JaxInception
from duodiff_tpu_torch.data.datasets import get_dataloader
from duodiff_tpu_torch.data.synthetic import write_palette_cifar, write_palette_imagenet64_cache
from duodiff_tpu_torch.evaluation import fid, metrics
from duodiff_tpu_torch.models.inception import InceptionV3Features
from duodiff_tpu_torch.utils.convert import export_inception

torch.set_num_threads(1)
RTOL = 1e-9


def _features(n, d, seed, shift=0.0):
    return np.random.RandomState(seed).randn(n, d) + shift


def test_statistics_match_jax():
    f = _features(300, 16, 0)
    for got, want in zip(fid.compute_statistics(f), jax_fid.compute_statistics(f)):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("case", ["identical", "mean_shift", "covariance_1d", "separated",
                                  "singular"])
def test_frechet_distance_matches_jax(case):
    if case == "identical":
        mu, s = fid.compute_statistics(_features(500, 8, 0))
        args = (mu, s, mu, s)
        assert abs(fid.frechet_distance(*args)) < 1e-6
    elif case == "mean_shift":  # equal covariances: |mu1 - mu2|^2
        args = (np.zeros(4), np.eye(4), np.full(4, 2.0), np.eye(4))
        np.testing.assert_allclose(fid.frechet_distance(*args), 16.0, rtol=RTOL)
    elif case == "covariance_1d":  # (m1 - m2)^2 + (sqrt(v1) - sqrt(v2))^2
        args = (np.array([1.0]), np.array([[4.0]]), np.array([0.0]), np.array([[9.0]]))
        np.testing.assert_allclose(fid.frechet_distance(*args), 2.0, rtol=RTOL)
    elif case == "separated":
        args = (*fid.compute_statistics(_features(400, 16, 1)),
                *fid.compute_statistics(_features(400, 16, 2, 3.0)))
    else:  # N < D: singular covariances, the square root's real part decides
        args = (*fid.compute_statistics(_features(20, 48, 3)),
                *fid.compute_statistics(_features(20, 48, 4, 0.5)))
    np.testing.assert_allclose(fid.frechet_distance(*args), jax_fid.frechet_distance(*args),
                               rtol=RTOL, atol=1e-12)


def test_fid_from_features_and_standardize_match_jax():
    ref, a, b = _features(64, 24, 5), _features(40, 24, 6, 0.3), _features(40, 24, 7)
    ref[:, 3] = 0.0  # a dead dimension: the std floor
    got = metrics.standardize_features(ref, [ref, a, b])
    want = jax_metrics.standardize_features(ref, [ref, a, b])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=0)
    np.testing.assert_allclose(fid.fid_from_features(got[1], got[2]),
                               jax_fid.fid_from_features(want[1], want[2]), rtol=RTOL)
    near, far = fid.fid_from_features(a, b), fid.fid_from_features(a, a + 3.0)
    assert near < far


def test_spectra_match_jax():
    rng = np.random.RandomState(9)
    a, b = rng.rand(6, 32, 32, 3), rng.rand(5, 32, 32, 3) ** 2
    np.testing.assert_allclose(metrics.radial_power_spectrum(a),
                               jax_metrics.radial_power_spectrum(a), rtol=RTOL)
    np.testing.assert_allclose(metrics.spectral_distance(a, b),
                               jax_metrics.spectral_distance(a, b), rtol=RTOL)
    with pytest.raises(ValueError, match="square"):
        metrics.radial_power_spectrum(rng.rand(2, 16, 8))


def test_pool_of_processes_gives_the_same_distances():
    pairs = [(_features(30, 6, i), _features(30, 6, i + 10, 0.2)) for i in range(3)]
    np.testing.assert_array_equal(fid.fids_from_features(pairs, workers=2),
                                  [fid.fid_from_features(a, b) for a, b in pairs])


def test_real_stats_npz_roundtrip(tmp_path):
    real, fake = _features(300, 16, 0), _features(300, 16, 1, 1.0)
    mu_r, s_r = fid.compute_statistics(real)
    np.savez(tmp_path / "stats.npz", mu=mu_r, sigma=s_r)
    loaded = np.load(tmp_path / "stats.npz")
    got = fid.frechet_distance(loaded["mu"], loaded["sigma"], *fid.compute_statistics(fake))
    np.testing.assert_allclose(got, fid.fid_from_features(real, fake), rtol=1e-12)


@pytest.fixture(scope="module")
def crossed_over():
    """The JAX extractor at PRNGKey(2026) (the seed of FD-rand), its
    jitted apply, and the port's extractor on the same weights."""
    model = JaxInception()
    params = jax.jit(lambda k: model.init(k, jnp.zeros((1, 299, 299, 3)))["params"])(
        jax.random.PRNGKey(metrics.FEATURE_SEED))
    port = InceptionV3Features().eval()
    port.load_state_dict({k: torch.tensor(v) for k, v in export_inception(params).items()})
    return model, params, port


def _two_sets():
    rng = np.random.RandomState(11)
    a = (0.5 + 0.2 * rng.randn(8, 32, 32, 3)).clip(0, 1).astype(np.float32)
    b = rng.rand(8, 32, 32, 3).astype(np.float32)
    return a, b


def test_fd_rand_matches_jax_on_crossed_over_weights(crossed_over):
    model, params, port = crossed_over
    a, b = _two_sets()
    jax_a = jax_fid.extract_features(model, params, a, batch_size=8)
    jax_b = jax_fid.extract_features(model, params, b, batch_size=8)
    got_a, got_b = fid.extract_features(port, a, 8), fid.extract_features(port, b, 8)
    scale = max(np.abs(jax_a).max(), np.abs(jax_b).max())
    assert max(np.abs(got_a - jax_a).max(), np.abs(got_b - jax_b).max()) <= 1e-4 * scale
    want = jax_metrics.fd_rand(a, b, batch_size=8, model_params=(model, params))
    fa, fb = metrics.standardize_features(jax_a, [jax_a, jax_b])
    np.testing.assert_allclose(fid.fid_from_features(fa, fb), want, rtol=RTOL)


def test_fd_rand_composes_extraction_standardisation_and_distance(crossed_over, monkeypatch):
    _, _, port = crossed_over
    a, b = _two_sets()
    seen = []
    monkeypatch.setattr(metrics, "fid_from_features", lambda x, y: seen.append((x, y)) or 1.5)
    assert metrics.fd_rand(a, b, batch_size=8, model=port) == 1.5
    fa = fid.extract_features(port, a, 8)
    want = metrics.standardize_features(fa, [fa, fid.extract_features(port, b, 8)])
    np.testing.assert_array_equal(seen[0][0], want[0])
    np.testing.assert_array_equal(seen[0][1], want[1])


def test_random_inception_is_the_seeded_initialiser():
    m1, m2 = metrics.random_inception(device="cpu"), metrics.random_inception(device="cpu")
    m3 = metrics.random_inception(seed=1, device="cpu")
    key = "Mixed_6b.branch7x7_2.conv.weight"
    assert torch.equal(m1.state_dict()[key], m2.state_dict()[key])
    assert not torch.equal(m1.state_dict()[key], m3.state_dict()[key])


def test_dataset_samples_match_jax(tmp_path):
    write_palette_cifar(tmp_path, seed=0, per_batch=32)
    got = fid.get_dataset_samples("cifar10", tmp_path, seed=3, n_samples=16)
    want = jax_fid.get_dataset_samples("cifar10", tmp_path, seed=3, n_samples=16)
    assert got.shape == (16, 32, 32, 3) and 0.0 <= got.min() and got.max() <= 1.0
    np.testing.assert_array_equal(got, want)


def test_caches_read_unnormalised(tmp_path):
    """A cache (here under the ``norm1`` key the synthetic writer uses) read
    with ``normalize=False`` gives the same images in [0, 1]."""
    cache = write_palette_imagenet64_cache(tmp_path, n=8, seed=0)
    batches = {}
    for normalize in (True, False):
        loader = get_dataloader("imagenet64", 8, 0, tmp_path, normalize=normalize)
        batches[normalize] = loader.next_batch()
        loader.close()
    raw, norm = batches[False]["image"], batches[True]["image"]
    np.testing.assert_array_equal(batches[False]["label"], batches[True]["label"])
    assert 0.0 <= raw.min() and raw.max() <= 1.0
    np.testing.assert_allclose(raw * 2 - 1, norm, rtol=0, atol=1e-6)
    images = np.load(cache / "images.npy").reshape(8, -1) / 255.0
    np.testing.assert_allclose(np.sort(raw.reshape(8, -1).sum(1)), np.sort(images.sum(1)),
                               rtol=1e-6)


def test_read_samples_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    for name in ["0.png", "1.png", "grid_image.png", "sub/2.png"]:
        (tmp_path / name).parent.mkdir(exist_ok=True)
        Image.fromarray(rng.randint(0, 256, (8, 8, 3), dtype=np.uint8)).save(tmp_path / name)
    Image.fromarray(rng.randint(0, 256, (8, 8), dtype=np.uint8)).save(tmp_path / "3.png")
    got = fid.read_samples(tmp_path)
    assert got.shape == (4, 8, 8, 3)
    np.testing.assert_array_equal(got, jax_fid.read_samples(tmp_path))
