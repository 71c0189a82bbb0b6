"""The port's native batch assembler (``duodiff_tpu_torch/data/_native``) and
its loader's multiply-add against the JAX package's.

The JAX package's loader assembles uint8 items with its native assembler
whenever g++ builds it, and g++ (-O3 -march=native) contracts ``src *
scale + offset`` into one fused multiply-add on a host with FMA: one
rounding. The port's assembler writes ``std::fma``, and its numpy path
computes the exact float64 value and rounds it once, so every comparison
here is to the bit (tolerance 0). Where the JAX package's assembler cannot
be built its loader takes a numpy path with two roundings, and the
comparisons with it are skipped with that reason.
"""

from pathlib import Path

import numpy as np
import pytest

from duodiff_tpu.data._native import get_assembler as jax_get_assembler
from duodiff_tpu.data.cache import MemmapCachedDataset as JaxCachedDataset
from duodiff_tpu.data.datasets import get_cifar10_dataloader as jax_cifar10_loader
from duodiff_tpu.data.loader import DataLoader as JaxDataLoader
from duodiff_tpu.data.sampler import ResumableSeedableSampler as JaxSampler
from duodiff_tpu_torch.data import _native, loader
from duodiff_tpu_torch.data.cache import CACHE_DIR, IMAGENET64_KEY
from duodiff_tpu_torch.data.datasets import get_dataloader, scale_offset
from duodiff_tpu_torch.data.loader import assemble_numpy
from duodiff_tpu_torch.data.synthetic import write_palette_cifar, write_palette_imagenet64_cache

PAIRS = [(2.0 / 255.0, -1.0), (1.0 / 255.0, 0.0)]  # normalize True, False


def _jax_assembler():
    assembler = jax_get_assembler()
    if assembler is None:
        pytest.skip("the JAX package's native assembler cannot be built here (no g++), so its "
                    "loader takes its numpy path, two roundings")
    return assembler


def _port_assembler():
    assembler = _native.get_assembler()
    if assembler is None:
        pytest.skip("g++ cannot build the port's native assembler here")
    return assembler


def _images(n, shape, seed):
    rng = np.random.RandomState(seed)
    return [np.ascontiguousarray(rng.randint(0, 256, shape, np.uint8)) for _ in range(n)]


# --- the assembler -------------------------------------------------------------


@pytest.mark.parametrize("n_threads", [1, 3])
@pytest.mark.parametrize("n, shape", [(1, (1, 1, 1)), (2, (3, 5, 3)), (7, (16, 16, 3)),
                                      (5, (13, 11, 3))])
@pytest.mark.parametrize("pair", PAIRS, ids=["normalize", "unit"])
def test_native_assembler_equals_numpy_and_jax(n, shape, pair, n_threads):
    """Ragged sizes (element counts 1, 45, 768, 429: none a multiple of the
    JAX kernel's 8-wide unroll but 768), 1 and 3 threads: equal bits."""
    assembler, jax_assembler = _port_assembler(), _jax_assembler()
    images = _images(n, shape, seed=n)
    got = np.full((n, *shape), np.nan, np.float32)
    assembler(images, *pair, got, n_threads=n_threads)
    np.testing.assert_array_equal(got, assemble_numpy(images, *pair))
    want = np.full((n, *shape), np.nan, np.float32)
    jax_assembler(images, *pair, want, n_threads=n_threads)
    np.testing.assert_array_equal(got, want)


def test_one_rounding_differs_from_two():
    """On training's pair the two-rounding float32 multiply-then-add (the
    port's loader before the repair) differs from the one-rounding value in
    most entries, by one ulp at most; the numpy path is the one-rounding one."""
    images = _images(8, (64, 64, 3), seed=0)
    scale, offset = PAIRS[0]
    one = assemble_numpy(images, scale, offset)
    two = np.stack(images).astype(np.float32) * np.float32(scale) + np.float32(offset)
    exact = np.stack(images).astype(np.float64) * np.float32(scale) + np.float32(offset)
    assert np.array_equal(one, exact.astype(np.float32))
    differ = one != two
    assert 0.4 < differ.mean() < 0.8
    assert np.abs(one - two).max() <= np.spacing(np.float32(1.0))


def test_native_assembler_counts_and_refuses():
    assembler = _port_assembler()
    images = _images(3, (4, 4, 3), seed=1)
    out = np.empty((3, 4, 4, 3), np.float32)
    before = _native.assemble_batch.assemblies
    assembler(images, *PAIRS[0], out)
    assembler(images, *PAIRS[1], out, n_threads=1)
    assert _native.assemble_batch.assemblies == before + 2
    with pytest.raises(ValueError, match="uint8"):
        assembler([img.astype(np.float32) for img in images], *PAIRS[0], out)
    with pytest.raises(ValueError, match="C-contiguous uint8"):
        assembler([img[:, ::2] for img in images], *PAIRS[0], np.empty((3, 4, 2, 3), np.float32))
    with pytest.raises(ValueError, match="float32"):
        assembler(images, *PAIRS[0], np.empty((3, 4, 4, 3), np.float64))
    with pytest.raises(ValueError, match="3 rows"):
        assembler(images, *PAIRS[0], np.empty((2, 4, 4, 3), np.float32))
    assert _native.assemble_batch.assemblies == before + 2


def test_native_source_and_build_are_the_ports_own():
    """The library is built from the port's copy of the source into the port's
    build directory; the copy rounds once by construction."""
    repo = Path(__file__).resolve().parents[1]
    assert _native.SRC == repo / "duodiff_tpu_torch" / "data" / "_native" / "batch_assembler.cpp"
    assert _native.BUILD_DIR == repo / "duodiff_tpu_torch" / "build"
    assert "std::fma(" in _native.SRC.read_text()
    _port_assembler()
    assert list(_native.BUILD_DIR.glob("batch_assembler_*.so"))


# --- the loader ----------------------------------------------------------------


class _Base:
    """A stand-in for the JAX package's folder datasets as its cache writer
    reads them: HWC items, labels, and the loader's scale and offset."""

    def __init__(self, images, labels, normalize):
        self.images, self.labels = images, labels
        self.scale, self.offset = scale_offset(normalize)

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        return self.images[i], int(self.labels[i])


def _loaders(kind, normalize, data, batch, seed):
    """(port loader, JAX loader) on the same data."""
    if kind == "cifar10":
        write_palette_cifar(data, seed=0, per_batch=32)
        return (get_dataloader("cifar10", batch, seed, data, normalize=normalize),
                jax_cifar10_loader(batch, seed, data, normalize=normalize, num_workers=2))
    if kind == "imagenet64_float":  # the synthetic cache: float32 items, as JAX caches them
        cache = write_palette_imagenet64_cache(data, n=24, seed=0)
        images, labels = np.load(cache / "images.npy"), np.load(cache / "labels.npy")
    else:  # uint8 items at ImageNet-64's shape, written by the JAX package's cache writer
        rng = np.random.RandomState(5)
        images = rng.randint(0, 256, (24, 64, 64, 3)).astype(np.uint8)
        labels = rng.randint(0, 999, 24).astype(np.int32)
    written = JaxCachedDataset(_Base(images, labels, normalize), data / CACHE_DIR,
                               IMAGENET64_KEY if kind == "imagenet64_float" or normalize
                               else IMAGENET64_KEY[:-1] + "0",
                               num_workers=2, verbose=False)
    return (get_dataloader("imagenet64", batch, seed, data, normalize=normalize),
            JaxDataLoader(written, batch, JaxSampler(len(written), seed=seed), num_workers=2))


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("kind", ["cifar10", "imagenet64_float", "imagenet64_uint8"])
def test_loader_batches_equal_jax(kind, normalize, tmp_path):
    """The port's batches are the JAX package's to the bit, across an epoch
    boundary (CIFAR-10 with normalize=True differed in 26,355 of 49,152
    entries before the repair)."""
    if kind != "imagenet64_float":
        _jax_assembler()
    got, want = _loaders(kind, normalize, tmp_path, batch=16, seed=3)
    try:
        for _ in range(12):  # 160 of 192 CIFAR images, 8 epochs of the caches
            a, b = got.next_batch(), want.next_batch()
            np.testing.assert_array_equal(a["label"], b["label"])
            assert a["image"].dtype == np.float32 and a["image"].shape == b["image"].shape
            np.testing.assert_array_equal(a["image"], b["image"])
    finally:
        got.close()


def test_loader_assembles_natively(tmp_path):
    """uint8 items go through the native assembler, one call a batch; float32
    items do not."""
    _port_assembler()
    write_palette_cifar(tmp_path, seed=0, per_batch=32)
    dl = get_dataloader("cifar10", 8, 0, tmp_path)
    before = _native.assemble_batch.assemblies
    try:
        dl.next_batch()
        dl.next_batch()
    finally:
        dl.close()
    assert _native.assemble_batch.assemblies == before + 2
    write_palette_imagenet64_cache(tmp_path, n=8, seed=0)
    dl = get_dataloader("imagenet64", 4, 0, tmp_path)
    try:
        dl.next_batch()
    finally:
        dl.close()
    assert _native.assemble_batch.assemblies == before + 2


@pytest.mark.parametrize("normalize", [True, False])
def test_loader_without_compiler_gives_the_same_bits(normalize, tmp_path, monkeypatch):
    """Where g++ is missing the loader's numpy path gives the native bits."""
    _port_assembler()
    write_palette_cifar(tmp_path, seed=0, per_batch=32)
    native = get_dataloader("cifar10", 16, 2, tmp_path, normalize=normalize)
    monkeypatch.setattr(loader, "get_assembler", lambda: None)
    numpy_path = get_dataloader("cifar10", 16, 2, tmp_path, normalize=normalize)
    before = _native.assemble_batch.assemblies
    try:
        b = numpy_path.next_batch()
        assert _native.assemble_batch.assemblies == before
        monkeypatch.undo()
        a = native.next_batch()
    finally:
        native.close()
        numpy_path.close()
    np.testing.assert_array_equal(a["image"], b["image"])
    np.testing.assert_array_equal(a["label"], b["label"])


def test_loader_refuses_other_item_types(tmp_path):
    ds = _Base([np.zeros((2, 2, 3), np.float64)] * 4, np.zeros(4, np.int32), True)
    dl = loader.DataLoader(ds, 2, loader.ResumableSeedableSampler(4, seed=0))
    try:
        with pytest.raises(ValueError, match="uint8 or float32"):
            dl.next_batch()
    finally:
        dl.close()
