"""The port's int8 calibration against the JAX package's: the calibration
MLP sublayer (``mlp_sublayer_int8_calib``), the model's calibration forward
against ``UViT(int8_calibrate=True)`` applied with
``mutable=["int8_calib"]``, one calibration trajectory against a loop over
that JAX model on the same noise, ``scales_from_stats`` and
``_union_percentile`` on one set of statistics, the one-call
``calibrate_int8_mlp_scales`` against JAX's statistics reduced to scales, a
scales file read by both readers, and the calibration tool end to end on
the CPU with its refusal.

Tolerances: fp32 throughout. The amaxes, the row amaxes and their
quantile curves are held at rtol 1e-4 plus 1e-5 absolute (they agree to
~1e-7 in one sublayer). The sublayer and model outputs are held at atol =
rtol = 2e-2, the bound ``tests/test_torch_int8.py`` holds the int8
sublayers to: behind the GELU an fp32 difference at the last bit (torch's
erf against XLA's) moves a hidden activation across an int8 rounding
boundary now and then, and the flipped code moves an output entry by a
quantization step (ROADMAP: not a fault). The scales from one set of
statistics are equal."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from duodiff_tpu.config import UViTConfig as JaxConfig
from duodiff_tpu.diffusion.schedule import NoiseSchedule as JaxSchedule
from duodiff_tpu.models.uvit import init_uvit as jax_init_uvit
from duodiff_tpu.ops import pallas_block_int8 as jq8
from duodiff_tpu.utils import int8_calib as jcal
from duodiff_tpu_torch.config import UViTConfig
from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
from duodiff_tpu_torch.models.uvit import UViT
from duodiff_tpu_torch.ops import block_int8 as q8
from duodiff_tpu_torch.tools import calibrate_int8 as tool
from duodiff_tpu_torch.utils import int8_calib as tcal
from duodiff_tpu_torch.utils.convert import uvit_state_dict_from_jax
from duodiff_tpu_torch.utils.int8_scales import load_int8_scales

torch.set_num_threads(1)

SMALL = dict(img_size=16, patch_size=4, in_chans=3, embed_dim=64, num_heads=4, mlp_ratio=4)
SHAPE = (2, 16, 16, 3)
RTOL, ATOL = 1e-4, 1e-5
OUT_TOL = 2e-2


def _mlp_modules(rng, d, hidden):
    norm, fc1, fc2 = nn.LayerNorm(d), nn.Linear(d, hidden), nn.Linear(hidden, d)
    with torch.no_grad():
        for p in (*norm.parameters(), *fc1.parameters(), *fc2.parameters()):
            p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * 0.1))
        norm.weight.add_(1.0)
    return norm, fc1, fc2


@pytest.mark.parametrize("gelu_approx", [False, True])
@pytest.mark.parametrize("rows", [33, 129])
def test_calib_mlp_matches_jax(gelu_approx, rows):
    rng = np.random.RandomState(rows)
    d, hidden = 64, 256
    norm, fc1, fc2 = _mlp_modules(rng, d, hidden)
    x = rng.randn(1, rows, d).astype(np.float32)
    want = jq8.mlp_sublayer_int8_calib(
        jnp.asarray(x), jnp.asarray(norm.weight.detach().numpy()),
        jnp.asarray(norm.bias.detach().numpy()), jnp.asarray(fc1.weight.detach().numpy().T),
        jnp.asarray(fc1.bias.detach().numpy()), jnp.asarray(fc2.weight.detach().numpy().T),
        jnp.asarray(fc2.bias.detach().numpy()), gelu_approx=gelu_approx, with_rows=True)
    ops = q8.pack_mlp_int8(norm, fc1, fc2)
    assert ops[-1] is None
    got = q8.mlp_sublayer_int8_calib(torch.from_numpy(x), *ops[:-1], gelu_approx=gelu_approx,
                                     with_rows=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=OUT_TOL, atol=OUT_TOL)
    for g, w in zip((*got[1:3], *got[3]), (*want[1:3], *want[3])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
    # its output is the dynamic int8 sublayer's
    plain = q8.mlp_sublayer_int8_plain(torch.from_numpy(x), *ops, gelu_approx=gelu_approx)
    assert torch.equal(got[0], plain)
    assert got[3][0].shape == got[3][1].shape == (1, rows)


@pytest.fixture(scope="module")
def calib_pair():
    """(JAX calibration model, params, the port's int8 model), same weights, fp32."""
    cfg = dict(SMALL, depth=3)
    jmodel, params = jax_init_uvit(JaxConfig(**cfg), jax.random.PRNGKey(3), dtype=jnp.float32,
                                   attn_impl="fused_int8", int8_calibrate=True)
    rng = np.random.RandomState(3)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rng.randn(*a.shape).astype(np.float32), params)
    model = UViT(UViTConfig(**cfg), dtype=torch.float32, attn_impl="fused_int8")
    model.load_state_dict(uvit_state_dict_from_jax(params), strict=True)
    model.eval().pack_for_kernels()
    return jmodel, params, model


def _jax_calib_apply(jmodel, params, x, t):
    out, col = jmodel.apply({"params": params}, x, t, None, mutable=["int8_calib"])
    amax = {k.split("/")[-1]: v for k, v in jcal._collect_leaves(col["int8_calib"],
                                                                 "mlp_amax").items()}
    rows = {k.split("/")[-1]: v for k, v in jcal._collect_leaves(col["int8_calib"],
                                                                 "mlp_rowamax").items()}
    return out, amax, rows


def test_calibration_forward_matches_jax(calib_pair):
    jmodel, params, model = calib_pair
    rng = np.random.RandomState(0)
    x = rng.randn(*SHAPE).astype(np.float32)
    t = np.array([500.0, 3.0], np.float32)
    want_out, want_amax, want_rows = _jax_calib_apply(jmodel, params, jnp.asarray(x),
                                                      jnp.asarray(t))
    with torch.no_grad():
        out, stats = model.forward_calib(torch.from_numpy(x), torch.from_numpy(t))
        deployed = model(torch.from_numpy(x), torch.from_numpy(t))
    assert list(stats) == model.block_names() and sorted(stats) == sorted(want_amax)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=OUT_TOL, atol=OUT_TOL)
    assert torch.equal(out, deployed)  # the dynamic-int8 forward, unchanged
    for name, (amax, rows) in stats.items():
        assert amax.shape == (2,) and rows.shape == (2, 2 * 17)
        np.testing.assert_allclose(amax.numpy(), np.asarray(want_amax[name]), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
        np.testing.assert_allclose(rows.numpy(), np.asarray(want_rows[name]), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_calibration_forward_refuses_static_and_bf16_blocks(calib_pair):
    model = UViT(UViTConfig(**dict(SMALL, depth=3)), dtype=torch.float32, attn_impl="plain")
    model.eval().pack_for_kernels()
    with pytest.raises(ValueError, match="dynamic scales"):
        model.forward_calib(torch.zeros(SHAPE), torch.zeros(2))
    static = UViT(UViTConfig(**dict(SMALL, depth=3)), dtype=torch.float32,
                  attn_impl="plain_int8", int8_mlp_scales=((4.0, 1.0),) * 3)
    static.eval().pack_for_kernels()
    with pytest.raises(ValueError, match="dynamic scales"):
        static.forward_calib(torch.zeros(SHAPE), torch.zeros(2))


@pytest.fixture(scope="module")
def noise():
    """One 10-step trajectory's start and noise table."""
    rng = np.random.RandomState(5)
    return rng.randn(*SHAPE).astype(np.float32), rng.randn(10, *SHAPE).astype(np.float32)


@pytest.fixture(scope="module")
def stats(calib_pair, noise):
    """Both sides' statistics of one 10-step trajectory on one noise table."""
    jmodel, params, model = calib_pair
    steps = 10
    x0, table = noise
    js = JaxSchedule.create(steps=steps)
    fracs = jnp.asarray(jcal.CALIB_FRACTIONS, jnp.float32)
    x, amax, curves = jnp.asarray(x0), {}, {}
    for t in range(steps - 1, -1, -1):
        out, a, rows = _jax_calib_apply(jmodel, params, x, jnp.full((2,), t, jnp.float32))
        for k in a:
            amax[k] = np.maximum(amax.get(k, 0.0), np.asarray(a[k]))
            curves.setdefault(k, []).append(np.asarray(jnp.quantile(rows[k], fracs, axis=-1).T))
        x = js.step("predict_noise", out, x, t, jnp.asarray(table[t]) if t else 0.0 * x)
    want = (amax, {k: np.stack(v) for k, v in curves.items()})
    with torch.inference_mode():
        got = tcal.calibrate_int8_stats(model, NoiseSchedule.create(steps=steps), None, SHAPE,
                                        x_init=torch.from_numpy(x0),
                                        noise_table=torch.from_numpy(table))
    return got, want


def test_calibration_statistics_match_a_jax_trajectory(stats):
    (g_amax, g_quants), (w_amax, w_quants) = stats
    assert sorted(g_amax) == sorted(w_amax)
    for k in w_amax:
        assert g_amax[k].dtype == np.float32 and g_quants[k].shape == w_quants[k].shape
        assert g_quants[k].shape == (10, 2, len(tcal.CALIB_FRACTIONS))
        np.testing.assert_allclose(g_amax[k], w_amax[k], rtol=RTOL, atol=ATOL, err_msg=k)
        np.testing.assert_allclose(g_quants[k], w_quants[k], rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("mode,percentile,margin", [
    ("amax", 99.9, 1.0), ("amax", 99.9, 1.1), ("percentile", 99.9, 1.0),
    ("percentile", 99.5, 1.0), ("percentile", 50.0, 1.3), ("percentile", 100.0, 1.0)])
def test_scales_from_stats_equal_jax(stats, mode, percentile, margin):
    (g_amax, g_quants), (w_amax, w_quants) = stats
    for amax, quants in ((g_amax, g_quants), (w_amax, w_quants)):
        got = tcal.scales_from_stats(amax, quants, mode=mode, percentile=percentile,
                                     margin=margin)
        want = jcal.scales_from_stats(amax, quants, mode=mode, percentile=percentile,
                                      margin=margin)
        assert got == want


@pytest.mark.parametrize("mode,percentile,margin", [
    ("amax", 99.9, 1.1), ("percentile", 99.5, 1.0)])
def test_one_call_calibration_matches_jax_stats(calib_pair, noise, stats, mode, percentile,
                                                margin):
    _, (w_amax, w_quants) = stats
    x0, table = noise
    want = jcal.scales_from_stats(w_amax, w_quants, mode=mode, percentile=percentile,
                                  margin=margin)
    with torch.inference_mode():
        got = tcal.calibrate_int8_mlp_scales(
            calib_pair[2], NoiseSchedule.create(steps=10), None, SHAPE, margin=margin,
            mode=mode, percentile=percentile, x_init=torch.from_numpy(x0),
            noise_table=torch.from_numpy(table))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)


def test_union_percentile_and_fractions_equal_jax():
    assert tcal.CALIB_FRACTIONS == jcal.CALIB_FRACTIONS
    rng = np.random.RandomState(1)
    curves = np.sort(rng.rand(30, len(tcal.CALIB_FRACTIONS)) * 5, axis=1)
    for p in (0.0, 12.5, 50.0, 99.0, 99.9, 100.0):
        assert (tcal._union_percentile(curves, tcal.CALIB_FRACTIONS, p)
                == jcal._union_percentile(curves, jcal.CALIB_FRACTIONS, p))


def test_row_quantiles_in_sized_calls_equal_one_call(monkeypatch):
    rows = torch.rand(7, 300)
    fracs = torch.tensor(tcal.CALIB_FRACTIONS)
    whole = torch.quantile(rows, fracs, dim=-1).t()
    monkeypatch.setattr(tcal, "_QUANTILE_MAX_ELEMENTS", 650)  # two rows a call
    assert torch.equal(tcal._row_quantiles(rows, fracs), whole)
    monkeypatch.setattr(tcal, "_QUANTILE_MAX_ELEMENTS", 299)
    with pytest.raises(ValueError, match="smaller batch"):
        tcal._row_quantiles(rows, fracs)


def test_saved_scales_are_read_by_both_readers(tmp_path):
    scales = {"in_blocks_0": (4.25, 1.5), "mid_block": (3.0, 0.75), "out_blocks_0": (2.0, 9.5)}
    meta = {"mode": "search", "seed": 1}
    tcal.save_int8_scales(tmp_path / "port.json", scales, meta)
    jcal.save_int8_scales(tmp_path / "jax.json", scales, meta)
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    assert load_int8_scales(tmp_path / "port.json") == scales
    assert jcal.load_int8_scales(tmp_path / "port.json") == scales


@pytest.fixture(scope="module")
def config(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "tiny5.yaml"
    path.write_text("model_params:\n" + "".join(
        f"  {k}: {v}\n" for k, v in dict(SMALL, depth=5).items()))
    return str(path)


@pytest.mark.parametrize("mode", ["amax", "percentile", "search"])
def test_tool_writes_scales_the_sampler_takes(config, tmp_path, mode):
    from duodiff_tpu_torch import sample

    out = tmp_path / "scales.json"
    result = tool.main(["--device", "cpu", "--config_path", config, "--random_init",
                        "--seed", "1", "--num_timesteps", "8", "--batch_size", "2",
                        "--mode", mode, "--search_grid", "99.5,99.9", "--gelu_approx",
                        "--output", str(out)])
    data = json.loads(out.read_text())
    assert sorted(data["blocks"]) == sorted(UViT(UViTConfig(**dict(SMALL, depth=5))).block_names())
    assert data["meta"]["mode"] == mode and data["meta"]["card"].startswith("cpu")
    if mode == "search":
        assert [r["candidate"] for r in data["meta"]["search"]] == ["amax", "p99.5", "p99.9"]
        assert data["meta"]["search_winner"] in data["meta"]["search"]
    assert load_int8_scales(out) == {k: tuple(v) for k, v in result["scales"].items()}
    samples = sample.main(["--device", "cpu", "--random_init", "--config_path", config,
                           "--num_timesteps", "8", "--batch_size", "2", "--parametrization",
                           "predict_noise", "--output_folder", str(tmp_path / "s"),
                           "--attn_impl", "fused_int8", "--int8_scales", str(out),
                           "--gelu_approx"])["samples"]
    assert np.isfinite(samples).all()


@pytest.mark.parametrize("extra,message", [
    (["--random_init", "--early_exit"], "ROADMAP item 7"),
    ([], "--checkpoint_path is required"),
], ids=["early_exit", "no_checkpoint"])
def test_tool_refusals(config, tmp_path, extra, message):
    with pytest.raises(SystemExit, match=message):
        tool.main(["--device", "cpu", "--config_path", config, "--output",
                   str(tmp_path / "s.json"), *extra])
    assert not (tmp_path / "s.json").exists()
