"""The port's FID InceptionV3 (``duodiff_tpu_torch/models/inception.py``)
against the JAX package's ``InceptionV3Features``, and its loader.

The JAX weights are those ``init_inception`` draws (``model.init`` at
PRNGKey(0), jitted once for the file), crossed over through
``utils/convert.py:export_inception``. Tolerances, each with its reason:
- features on JAX's weights: max |port - JAX| <= 1e-4 * max |JAX feature|.
  Seeded random features are ~1e-3 to 1e-4 in scale after 94 layers, so the
  bound is relative; the same fp32 convolutions in another summation order
  differ far below it;
- ``preprocess`` (bilinear resize to 299, then to [-1, 1]) at 32, 64, 256
  and 299: 1e-5; larger images are refused (at 320 torch's antialiased
  resize is 2.4e-5 off JAX's);
- a ``.pth`` of ``tests/torch_inception_ref.py``'s graph (random BatchNorm
  statistics, features ~10-100): against that graph 1e-5 of its largest
  feature (BatchNorm's fused form there, the explicit one here), against
  JAX's ``convert_inception_weights`` path 1e-4 absolute, the bound of
  ``tests/test_fid.py``;
- the initialiser's std a layer within 5 % of flax's lecun-normal on the
  layers with at least 100,000 weights.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duodiff_tpu.models.inception import InceptionV3Features as JaxInception
from duodiff_tpu.models.inception import convert_inception_weights
from duodiff_tpu.models.inception import preprocess as jax_preprocess
from duodiff_tpu_torch.models.inception import (
    InceptionV3Features,
    init_inception,
    load_inception,
    preprocess,
)
from duodiff_tpu_torch.utils.convert import export_inception

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_inception_ref import random_initialized  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_inception():
    """(params as numpy, jitted apply) of the JAX extractor at PRNGKey(0)."""
    model = JaxInception()
    params = jax.jit(lambda k: model.init(k, jnp.zeros((1, 299, 299, 3)))["params"])(
        jax.random.PRNGKey(0))
    apply = jax.jit(lambda p, x: model.apply({"params": p}, x))
    return jax.tree_util.tree_map(np.asarray, params), apply


def _inputs(n: int = 2, seed: int = 42):
    return np.random.RandomState(seed).uniform(-1.0, 1.0, (n, 299, 299, 3)).astype(np.float32)


def _port_on(state: dict) -> InceptionV3Features:
    model = InceptionV3Features().eval()
    model.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in state.items()},
                          strict=True)
    return model


def test_features_match_jax_on_its_weights(jax_inception):
    params, apply = jax_inception
    x = _inputs()
    want = np.asarray(apply(params, x))
    with torch.no_grad():
        got = _port_on(export_inception(params))(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 2048)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-4 * scale, (np.abs(got - want).max(), scale)


@pytest.mark.parametrize("size", [32, 64, 256, 299])
def test_preprocess_matches_jax(size):
    img = np.random.RandomState(size).uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    want = np.asarray(jax_preprocess(jnp.asarray(img)))
    got = preprocess(torch.from_numpy(img)).numpy()
    assert got.shape == want.shape == (2, 299, 299, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [(320, 320), (64, 300)])
def test_preprocess_refuses_what_it_would_shrink(shape):
    """JAX antialiases a shrinking resize; torch's antialiased bilinear is
    2.4e-5 off it at 320 -> 299, past the bound above, so the port refuses."""
    with pytest.raises(ValueError, match="at most 299"):
        preprocess(torch.zeros((1, *shape, 3)))


def test_export_is_the_inverse_of_the_jax_converter(jax_inception, tmp_path):
    params, _ = jax_inception
    path = tmp_path / "w.pth"
    torch.save({k: torch.from_numpy(v) for k, v in export_inception(params).items()}, path)
    back = convert_inception_weights(str(path), jax.tree_util.tree_map(jnp.asarray, params))
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.fixture(scope="module")
def reference_pth(tmp_path_factory):
    ref = random_initialized(seed=0)
    path = tmp_path_factory.mktemp("inception") / "fid_inception_random.pth"
    torch.save(ref.state_dict(), path)
    return ref, path


def test_a_pytorch_fid_pth_loads_by_name(reference_pth, jax_inception):
    ref, path = reference_pth
    _, apply = jax_inception
    x = _inputs()
    with torch.no_grad():
        got = load_inception(str(path), "cpu")(torch.from_numpy(x)).numpy()
        want = ref(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    template = jax.eval_shape(lambda k: JaxInception().init(k, jnp.zeros((1, 299, 299, 3))),
                              jax.random.PRNGKey(0))["params"]
    template = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), template)
    jax_feats = np.asarray(apply(convert_inception_weights(str(path), template), x))
    assert np.abs(got - jax_feats).max() < 1e-4


def test_head_aux_and_state_dict_wrapping_are_accepted(reference_pth, tmp_path):
    ref, path = reference_pth
    state = dict(torch.load(path, weights_only=True))
    state.update({"fc.weight": torch.zeros(1000, 2048), "fc.bias": torch.zeros(1000),
                  "AuxLogits.fc.weight": torch.zeros(1000, 768)})
    wrapped = tmp_path / "wrapped.pth"
    torch.save({"state_dict": state}, wrapped)
    x = torch.from_numpy(_inputs(1))
    with torch.no_grad():
        assert torch.equal(load_inception(str(wrapped), "cpu")(x),
                           load_inception(str(path), "cpu")(x))


@pytest.mark.parametrize("case", ["missing_key", "wrong_shape", "missing_file"])
def test_refusals(case, reference_pth, tmp_path):
    _, path = reference_pth
    state = dict(torch.load(path, weights_only=True))
    bad = tmp_path / "bad.pth"
    if case == "missing_key":
        del state["Mixed_6c.branch7x7_2.conv.weight"]
        err, match = KeyError, "Mixed_6c.branch7x7_2.conv.weight"
    elif case == "wrong_shape":
        state["Mixed_7b.branch_pool.bn.running_var"] = torch.ones(7)
        err, match = ValueError, "Mixed_7b.branch_pool.bn.running_var"
    else:
        bad = tmp_path / "absent.pth"
        err, match = FileNotFoundError, "--inception_weights"
    if case != "missing_file":
        torch.save(state, bad)
    with pytest.raises(err, match=match):
        load_inception(str(bad), "cpu")


def test_initialiser_std_matches_flax_and_is_seeded(jax_inception):
    params, _ = jax_inception
    jax_state = export_inception(params)
    ours = init_inception(torch.Generator().manual_seed(0)).state_dict()
    large = [k for k, v in jax_state.items() if k.endswith("conv.weight") and v.size >= 100_000]
    assert len(large) > 40
    for k in large:
        mine, theirs = float(ours[k].std()), float(jax_state[k].std())
        assert abs(mine - theirs) <= 0.05 * theirs, (k, mine, theirs)
    for k, v in ours.items():
        if k.endswith(("bn.weight", "bn.running_var")):
            assert torch.equal(v, torch.ones_like(v))
        elif k.endswith(("bn.bias", "bn.running_mean")):
            assert torch.equal(v, torch.zeros_like(v))
    again = init_inception(torch.Generator().manual_seed(0)).state_dict()
    other = init_inception(torch.Generator().manual_seed(1)).state_dict()
    assert all(torch.equal(ours[k], again[k]) for k in ours)
    assert not torch.equal(ours[large[0]], other[large[0]])
