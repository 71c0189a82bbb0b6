"""The port's early-exit U-ViT (``duodiff_tpu_torch/models/early_exit.py``)
against the JAX package's, on the same weights crossed over through the
export: the forward triple (backbone, probes, heads) for the four probe
families, the int8 forward, the truncated, truncated-cached and probed
forwards of the static-exit and adaptive samplers, the export itself bit
by bit, and the strict load of a JAX-written checkpoint.

Tolerances: fp32 forwards 1e-4 (rtol and atol, the sampler bound of
``tests/test_torch_sampling.py``); the int8 forward as
``tests/test_torch_int8.py`` holds the int8 UViT against JAX's
``fused_int8`` (2e-2 elementwise and in relative Frobenius error: an int8
code that fp32 summation order moves across a rounding boundary is carried
on by the blocks after it)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duodiff_tpu.config import UViTConfig as JaxConfig
from duodiff_tpu.diffusion.static_exit import truncated_ee_apply_probed as jax_probed
from duodiff_tpu.models.early_exit import EarlyExitUViT as JaxEarlyExitUViT
from duodiff_tpu.utils.torch_export import export_early_exit_uvit as jax_export_ee
from duodiff_tpu.utils.torch_export import export_torch_checkpoint
from duodiff_tpu_torch.config import UViTConfig
from duodiff_tpu_torch.models.early_exit import CLASSIFIER_TYPES, EarlyExitUViT
from duodiff_tpu_torch.utils import convert
from duodiff_tpu_torch.utils.model_loading import load_model

torch.set_num_threads(1)

TINY = dict(img_size=16, patch_size=2, in_chans=3, embed_dim=32, depth=5, num_heads=4,
            mlp_ratio=4, num_classes=-1, normalize_timesteps=True)
TOL = 1e-4
INT8_TOL = 2e-2
EXITS = (0, 2, 3, 5)


def _random_params(jmodel, cfg, seed):
    """Parameters of JAX's tree (its shapes traced, nothing compiled) drawn
    from ``numpy.random.RandomState(seed)``: 0.05 N(0, 1), LayerNorm scales
    about 1. No parameter is zero, so a wrong layout cannot hide behind the
    initialiser's zero queries and biases."""
    x = jnp.zeros((1, cfg["img_size"], cfg["img_size"], cfg["in_chans"]), jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), x, jnp.zeros((1,)))
                            )["params"]
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        value = 0.05 * rng.randn(*leaf.shape).astype(np.float32)
        return value + 1.0 if path[-1].key == "scale" else value

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _pair(kind, seed=0, **model_kw):
    """(JAX model, its params, the port's model on the same weights)."""
    cfg = dict(TINY, classifier_type=kind)
    jmodel = JaxEarlyExitUViT(config=JaxConfig(**cfg), **model_kw)
    params = _random_params(jmodel, cfg, seed)
    impl = model_kw.get("attn_impl")
    model = EarlyExitUViT(UViTConfig(**cfg), dtype=torch.float32,
                          attn_impl="plain_int8" if impl == "fused_int8" else "plain",
                          gelu_approx=model_kw.get("gelu_approx", False))
    model.load_state_dict(convert.early_exit_state_dict_from_jax(params, model.config),
                          strict=True)
    model.pack_for_kernels()
    return jmodel, params, model.eval()


@pytest.fixture(scope="module")
def pairs():
    return {kind: _pair(kind, seed) for seed, kind in enumerate(CLASSIFIER_TYPES)}


def _inputs(seed=0, batch=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, 16, 16, 3).astype(np.float32)
    # fractional and out-of-table timesteps: the tables' index truncates and clips
    t = np.array([3.0, 500.7, 1200.0], np.float32)[:batch]
    return x, t


def _forward_both(pair, x, t):
    jmodel, params, model = pair
    want = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t))
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("kind", CLASSIFIER_TYPES)
def test_forward_triple_matches_jax(pairs, kind):
    got, want = _forward_both(pairs[kind], *_inputs())
    for name, g, w in zip(("backbone", "u", "g"), got, want):
        assert g.shape == w.shape and g.dtype == np.float32, name
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=name)
    assert got[1].shape == (TINY["depth"], 3) and got[2].shape == (TINY["depth"], 3, 16, 16, 3)


def test_int8_forward_matches_jax_fused_int8():
    """The port's plain int8 blocks against JAX's fused_int8 (Pallas int8
    kernels in interpret mode) under the same heads and probes."""
    pair = _pair("mlp_probe_per_layer", 7, attn_impl="fused_int8")
    got, want = _forward_both(pair, *_inputs(1, batch=2))
    for name, g, w in zip(("backbone", "u", "g"), got, want):
        np.testing.assert_allclose(g, w, rtol=INT8_TOL, atol=INT8_TOL, err_msg=name)
        assert np.linalg.norm(g - w) / np.linalg.norm(w) < INT8_TOL, name


@pytest.mark.parametrize("kind", CLASSIFIER_TYPES)
def test_export_equals_the_jax_packages(pairs, kind):
    """The port's copy of export_early_exit_uvit against JAX's, key by key
    and bit by bit."""
    params = pairs[kind][1]
    want = jax_export_ee(params)
    got = convert.export_early_exit_uvit(params)
    assert list(got) == list(want)
    for key, value in want.items():
        assert got[key].dtype == np.float32 and np.array_equal(got[key], np.asarray(value)), key


@pytest.mark.parametrize("kind", CLASSIFIER_TYPES)
def test_jax_written_checkpoint_loads_strictly(pairs, kind, tmp_path):
    """A ``.pth`` the JAX package exports loads through ``load_model(
    early_exit=True)`` strictly, per-timestep modules gathered into tables,
    and gives JAX's forward."""
    jmodel, params, _ = pairs[kind]
    path = tmp_path / "ee.pth"
    export_torch_checkpoint(params, path)
    config = tmp_path / "ee.yaml"
    config.write_text("model_params:\n" + "".join(
        f"  {k}: {v!r}\n" if isinstance(v, str) else f"  {k}: {v}\n"
        for k, v in dict(TINY, classifier_type=kind).items()))
    model, cfg = load_model(config, str(path), device="cpu", dtype=torch.float32,
                            early_exit=True)
    assert isinstance(model, EarlyExitUViT) and cfg.classifier_type == kind
    model.eval().pack_for_kernels()
    x, t = _inputs(2)
    want = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("fault", ["missing", "unexpected"])
def test_the_load_is_strict(pairs, fault):
    _, params, model = pairs["mlp_probe_per_timestep"]
    sd = {k: torch.from_numpy(np.array(v)) for k, v in convert.export_early_exit_uvit(
        params).items()}
    if fault == "missing":
        del sd["matrix.999.classifier.0.bias"]
        with pytest.raises(KeyError, match="matrix.999.classifier.0.bias"):
            convert.early_exit_state_dict_from_reference(sd, model.config)
    else:
        sd["matrix.1000.classifier.0.bias"] = torch.zeros(1)
        with pytest.raises(RuntimeError, match="matrix.1000"):
            model.load_state_dict(convert.early_exit_state_dict_from_reference(
                sd, model.config), strict=True)


def test_unknown_classifier_type_is_refused():
    with pytest.raises(ValueError, match="Unknown classifier type"):
        EarlyExitUViT(UViTConfig(**TINY, classifier_type="lstm"))


@pytest.mark.parametrize("exit_layer", EXITS)
def test_truncated_forward_is_that_head(pairs, exit_layer):
    """Blocks 0..exit_layer-1 and head exit_layer give g[exit_layer] of the
    dense forward (the backbone at depth), which matches JAX's."""
    pair = pairs["mlp_probe_per_layer"]
    x, t = _inputs(3)
    (bb, _, g), _ = _forward_both(pair, x, t)
    with torch.no_grad():
        got = pair[2].forward_truncated(torch.from_numpy(x), torch.from_numpy(t),
                                        exit_layer=exit_layer).numpy()
    want = bb if exit_layer == TINY["depth"] else g[exit_layer]
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("exit_layer", EXITS)
def test_truncated_cached_forward_matches_jax(pairs, exit_layer):
    """The anchor forward equals the truncated forward and returns JAX's
    residual; a cached forward on that residual equals JAX's; an exit inside
    the cached region is refused, as JAX refuses it."""
    from duodiff_tpu.diffusion.static_exit import truncated_ee_apply_cached as jax_cached

    from duodiff_tpu_torch.diffusion.static_exit import (
        cache_outer_for,
        truncated_ee_apply_cached,
    )

    jmodel, params, model = pairs["mlp_probe_per_layer"]
    n_outer = cache_outer_for(TINY["depth"], exit_layer)
    if n_outer is None:
        with pytest.raises(ValueError, match="exits inside the cached region"):
            truncated_ee_apply_cached(model, exit_layer, 2)
        return
    x, t = _inputs(4)
    x2 = x + 0.1 * np.random.RandomState(5).randn(*x.shape).astype(np.float32)
    j_anchor, j_cached, p0 = jax_cached(JaxConfig(**TINY, classifier_type="mlp_probe_per_layer"),
                                        params, exit_layer, n_outer, dtype=jnp.float32)
    want_out, want_delta = j_anchor(p0, jnp.asarray(x), jnp.asarray(t), None)
    want_cached = j_cached(p0, jnp.asarray(x2), jnp.asarray(t), None, want_delta)
    anchor, cached = truncated_ee_apply_cached(model, exit_layer, n_outer)
    with torch.no_grad():
        out, delta = anchor(torch.from_numpy(x), torch.from_numpy(t), None)
        full = model.forward_truncated(torch.from_numpy(x), torch.from_numpy(t),
                                       exit_layer=exit_layer)
        got_cached = cached(torch.from_numpy(x2), torch.from_numpy(t), None, delta)
    assert torch.equal(out, full)
    for g, w in ((out, want_out), (delta, want_delta), (got_cached, want_cached)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind", ["attention_probe", "mlp_probe_per_layer"])
@pytest.mark.parametrize("exit_layer,slots", [(0, None), (3, None), (5, None), (5, [4, 1]),
                                              (3, [3, 0])])
def test_probed_forward_matches_jax(pairs, kind, exit_layer, slots):
    """The adaptive sampler's probed apply: the prediction and the state it
    adds to (the batch mean of each probe slot) against JAX's."""
    from duodiff_tpu_torch.diffusion.static_exit import truncated_ee_apply_probed

    jmodel, params, model = pairs[kind]
    x, t = _inputs(6)
    apply, p0, j_init = jax_probed(JaxConfig(**TINY, classifier_type=kind), params, exit_layer,
                                   dtype=jnp.float32, probe_slots=slots)
    want_eps, want_state = apply(p0, j_init(None), jnp.asarray(x), jnp.asarray(t), None)
    probed, init_state = truncated_ee_apply_probed(model, exit_layer, slots)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        eps, state = probed(init_state(xt), xt, torch.from_numpy(t), None, 0)
    assert state.shape == np.shape(want_state) and state.dtype == torch.float32
    np.testing.assert_allclose(eps.numpy(), np.asarray(want_eps), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_state), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ["per_timestep", "slot_past_exit"])
def test_probed_forward_refusals(pairs, case):
    from duodiff_tpu_torch.diffusion.static_exit import truncated_ee_apply_probed

    if case == "per_timestep":
        with pytest.raises(ValueError, match="per-layer probe family"):
            truncated_ee_apply_probed(pairs["mlp_probe_per_timestep"][2], 3)
    else:
        with pytest.raises(ValueError, match="out of range for exit_layer 2"):
            truncated_ee_apply_probed(pairs["mlp_probe_per_layer"][2], 2, [3])


def test_random_init_is_seeded_and_finite():
    """``load_model(early_exit=True)`` without a checkpoint: the same seed
    gives the same weights; the forward is finite with every probe family."""
    from duodiff_tpu_torch.models.early_exit import init_early_exit_uvit

    cfg = UViTConfig(**TINY, classifier_type="attention_probe")
    a, b = (init_early_exit_uvit(cfg, device="cpu", dtype=torch.float32,
                                 generator=torch.Generator().manual_seed(3)) for _ in range(2))
    assert all(torch.equal(p, q) for p, q in zip(a.state_dict().values(),
                                                  b.state_dict().values()))
    for kind in CLASSIFIER_TYPES:
        model = init_early_exit_uvit(dataclasses.replace(cfg, classifier_type=kind),
                                     device="cpu", dtype=torch.float32,
                                     generator=torch.Generator().manual_seed(0))
        model.eval().pack_for_kernels()
        with torch.no_grad():
            out = model(*map(torch.from_numpy, _inputs()))
        assert all(torch.isfinite(o).all() for o in out), kind


def test_use_ema_loads_the_shadow(pairs, tmp_path):
    """``use_ema`` takes the checkpoint's ``ema_state_dict`` (reference names,
    gathered like the live ones); without it the live weights load."""
    _, params, _ = pairs["attention_probe"]
    live = {k: torch.from_numpy(np.array(v)) for k, v in
            convert.export_early_exit_uvit(params).items()}
    shadow = {k: v + 1.0 for k, v in live.items()}
    torch.save({"model_state_dict": live, "ema_state_dict": shadow}, tmp_path / "ee.pth")
    config = tmp_path / "ee.yaml"
    config.write_text("model_params:\n" + "".join(
        f"  {k}: {v!r}\n" if isinstance(v, str) else f"  {k}: {v}\n"
        for k, v in dict(TINY, classifier_type="attention_probe").items()))
    for use_ema, want in ((True, shadow), (False, live)):
        model, _ = load_model(config, str(tmp_path / "ee.pth"), device="cpu", early_exit=True,
                              use_ema=use_ema)
        assert torch.equal(model.probes.q[2], want["matrix.2.q"].reshape(-1))
        assert torch.equal(model.heads.conv_bias[4], want["out_blocks_heads.1.final_layer.bias"])
        assert torch.equal(model.uvit.pos_embed, want["uvit.pos_embed"])
