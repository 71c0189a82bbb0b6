"""The port's data pipeline (duodiff_tpu_torch.data) against the JAX
package's: the sampler's permutations bit for bit, CIFAR-10 reading, the
synthetic palette files against tools/convergence_probe.py's, and the
loader's checkpoint-exact state across a resume."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from duodiff_tpu.data.sampler import ResumableSeedableSampler as JaxSampler
from duodiff_tpu_torch.data.datasets import Cifar10Dataset, get_dataloader
from duodiff_tpu_torch.data.loader import DataLoader
from duodiff_tpu_torch.data.sampler import ResumableSeedableSampler
from duodiff_tpu_torch.data.synthetic import PALETTE4, write_palette_cifar

REPO = Path(__file__).resolve().parents[1]


def _convergence_probe():
    spec = importlib.util.spec_from_file_location("convergence_probe",
                                                  REPO / "tools" / "convergence_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed, n, draws", [(0, 50, [7, 30, 64, 1]), (123, 13, [13, 13, 40])])
def test_sampler_matches_jax_bit_for_bit(seed, n, draws):
    ours, theirs = ResumableSeedableSampler(n, seed=seed), JaxSampler(n, seed=seed)
    for k in draws:
        np.testing.assert_array_equal(ours.next_indices(k), theirs.next_indices(k))
        a, b = ours.get_state(), theirs.get_state()
        np.testing.assert_array_equal(a["perm"], b["perm"])
        assert (a["perm_index"], a["epoch"], a["seed"]) == (b["perm_index"], b["epoch"], b["seed"])


def test_sampler_resume_continues_the_stream():
    a = ResumableSeedableSampler(20, seed=3)
    a.next_indices(27)
    b = ResumableSeedableSampler(20, seed=99)
    b.set_state(a.get_state())
    np.testing.assert_array_equal(a.next_indices(31), b.next_indices(31))


@pytest.fixture(scope="module")
def palette_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("palette")
    write_palette_cifar(d, seed=0, per_batch=32)
    return d


def test_palette_files_match_the_convergence_probe(palette_dir, tmp_path):
    _convergence_probe().write_palette_cifar(tmp_path, PALETTE4, seed=0, per_batch=32)
    ours, theirs = Cifar10Dataset(palette_dir), Cifar10Dataset(tmp_path)
    np.testing.assert_array_equal(ours.images, theirs.images)
    np.testing.assert_array_equal(ours.labels, theirs.labels)
    assert len(ours) == 160 and ours.images.shape == (160, 32, 32, 3)


def test_cifar10_reader_matches_jax(palette_dir):
    from duodiff_tpu.data.datasets import Cifar10Dataset as JaxCifar

    ours, theirs = Cifar10Dataset(palette_dir), JaxCifar(palette_dir)
    np.testing.assert_array_equal(ours.images, theirs.images)
    assert (ours.scale, ours.offset) == (theirs.scale, theirs.offset)


def test_loader_batches_are_normalized_and_resume_exactly(palette_dir):
    loader = get_dataloader("cifar10", 8, 5, palette_dir)
    it = loader.prefetching_iterator()
    try:
        first = [next(it) for _ in range(3)]
        state = loader.get_state()
        rest = [next(it) for _ in range(4)]
    finally:
        it.close()
        loader.close()
    b = first[0]
    assert b["image"].shape == (8, 32, 32, 3) and b["image"].dtype == np.float32
    assert b["label"].dtype == np.int32
    assert -1.0 <= b["image"].min() and b["image"].max() <= 1.0
    ds = loader.dataset
    idx = ResumableSeedableSampler(len(ds), seed=5).next_indices(8)
    np.testing.assert_allclose(b["image"], ds.images[idx] * (2.0 / 255.0) - 1.0, atol=1e-6)
    resumed = DataLoader(ds, 8, ResumableSeedableSampler(len(ds), seed=5))
    resumed.set_state(state)
    for want in rest:
        got = resumed.next_batch()
        np.testing.assert_array_equal(got["image"], want["image"])
        np.testing.assert_array_equal(got["label"], want["label"])
    resumed.close()


@pytest.mark.parametrize("name", ["celeba", "imagenet64", "imagenet256"])
def test_image_decoding_datasets_are_refused(name, tmp_path):
    with pytest.raises(NotImplementedError, match="image decoding"):
        get_dataloader(name, 8, 0, tmp_path)
