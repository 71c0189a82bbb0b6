"""The asset tools' early-exit modes against the JAX package's:

- ``tools/derive_cache_schedule.py --static_schedule``: the per-bucket drift
  the port measures against a loop over JAX's ``truncated_ee_apply_cached``
  and ``truncated_ee_apply`` on one injected trajectory (rtol 1e-4, the
  trajectory bound); the segmented derivation, its staleness and its
  ``--num_anchors`` bisection against the JAX tool's own ``main`` on the same
  drift arrays (tables and meta equal, floats within 1e-12), each tool's
  measurement replaced by the arrays; the port's tool end to end on a tiny
  early-exit model with ``eesample`` on its table; its refusals.
- ``tools/calibrate_int8.py --early_exit``: the calibration statistics of an
  early-exit model against a loop over JAX's ``EarlyExitUViT(int8_calibrate=
  True)`` on one noise table (names equal; the first step's row-amax curves
  within rtol 1e-4 plus 1e-5, ``tests/test_torch_int8_calib.py``'s bound for
  statistics of one input; the whole trajectory's within 2e-2, the bound of
  the int8 outputs that carry it from step to step, since an fp32 difference
  at the last bit flips an int8 code now and then and the flipped output
  moves the next step's input), the scales from one set of statistics equal,
  and the tool end to end with ``eesample`` on its scales.
"""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duodiff_tpu.config import UViTConfig as JaxConfig
from duodiff_tpu.diffusion import static_exit as jse
from duodiff_tpu.diffusion.cache_schedule import load_cache_schedule as jax_load_schedule
from duodiff_tpu.diffusion.sampling import ddpm_scan
from duodiff_tpu.diffusion.schedule import NoiseSchedule as JaxSchedule
from duodiff_tpu.models.early_exit import EarlyExitUViT as JaxEarlyExitUViT
from duodiff_tpu.utils import int8_calib as jcal
from duodiff_tpu_torch import eesample
from duodiff_tpu_torch.config import UViTConfig
from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
from duodiff_tpu_torch.diffusion.static_exit import parse_exit_schedule
from duodiff_tpu_torch.models.early_exit import EarlyExitUViT
from duodiff_tpu_torch.tools import calibrate_int8 as calib_tool
from duodiff_tpu_torch.tools import derive_cache_schedule as tool
from duodiff_tpu_torch.utils import int8_calib as tcal
from duodiff_tpu_torch.utils.convert import early_exit_state_dict_from_jax
from duodiff_tpu_torch.utils.int8_scales import load_int8_scales

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
TINY = dict(img_size=16, patch_size=4, in_chans=3, embed_dim=32, depth=5, num_heads=4,
            mlp_ratio=4, num_classes=-1, normalize_timesteps=True,
            classifier_type="mlp_probe_per_layer")
SHAPE = (2, 16, 16, 3)
TOKENS = 17
STEPS = 12
# depth 5 (k = 2): exits 4 and 5 hold a cached region (n_outer 1), exit 2 does not
BUCKETS = "11-8:5,7-4:2,3-0:4"
RTOL, ATOL = 1e-4, 1e-5
INT8_TOL = 2e-2


def _random_params(jmodel, seed):
    x = jnp.zeros((1, *SHAPE[1:]), jnp.float32)
    tree = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), x, jnp.zeros((1,))))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        value = 0.05 * rng.randn(*leaf.shape).astype(np.float32)
        return value + 1.0 if path[-1].key == "scale" else value

    return jax.tree_util.tree_map_with_path(draw, tree["params"])


def _port_model(params, config, attn_impl="plain"):
    model = EarlyExitUViT(config, dtype=torch.float32, attn_impl=attn_impl)
    model.load_state_dict(early_exit_state_dict_from_jax(params, config), strict=True)
    model.eval().pack_for_kernels()
    return model


@pytest.fixture(scope="module")
def config_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("ee_tools") / "ee.yaml"
    path.write_text("model_params:\n" + "".join(
        f"  {k}: {v!r}\n" if isinstance(v, str) else f"  {k}: {v}\n" for k, v in TINY.items()))
    return str(path)


# --- the static-exit drift -------------------------------------------------------------


def test_per_bucket_drift_matches_jax_truncated_applies():
    """static_exit_drift against the JAX tool's static-mode loop written out
    over JAX's truncated applies, fp32, on one noise table: a zero delta at
    each cacheable bucket's entry, dense buckets run through."""
    cfg = JaxConfig(**TINY)
    params = _random_params(JaxEarlyExitUViT(config=cfg), seed=1)
    rng = np.random.RandomState(2)
    x0 = rng.randn(*SHAPE).astype(np.float32)
    table = rng.randn(STEPS, *SHAPE).astype(np.float32)
    js = JaxSchedule.create(steps=STEPS)
    buckets = parse_exit_schedule(BUCKETS)

    want_drift, want_norm = np.zeros(STEPS), np.zeros(STEPS)
    x = jnp.asarray(x0)
    for t_hi, t_lo, layer in buckets:
        ts = jnp.arange(t_hi, t_lo - 1, -1)
        p_outer = jse.cache_outer_for(cfg.depth, layer, None)
        if p_outer is None:
            fn, p0 = jse.truncated_ee_apply(cfg, params, layer, dtype=jnp.float32)
            x, _ = ddpm_scan(lambda xx, tt, yy: fn(p0, xx, tt, yy), js, "predict_noise", x,
                             jax.random.PRNGKey(0), ts, noise_table=jnp.asarray(table))
            continue
        anchor, _, p0 = jse.truncated_ee_apply_cached(cfg, params, layer, p_outer,
                                                      dtype=jnp.float32)

        def drift_apply(prev, xx, tt, yy, anchor=anchor, p0=p0):
            out, delta = anchor(p0, xx, tt, yy)
            rows = (jnp.sum((delta - prev) ** 2), jnp.sum(delta ** 2))
            return (out, rows), delta

        x, _, _, (d_sq, n_sq) = ddpm_scan(
            drift_apply, js, "predict_noise", x, jax.random.PRNGKey(0), ts,
            aux_fn=lambda mo: mo, noise_table=jnp.asarray(table),
            state=jnp.zeros((2, TOKENS, cfg.embed_dim), jnp.float32))
        want_drift[t_lo:t_hi + 1] = np.sqrt(np.asarray(d_sq, np.float64))[::-1]
        want_norm[t_lo:t_hi + 1] = np.sqrt(np.asarray(n_sq, np.float64))[::-1]

    config = UViTConfig(**TINY)
    model = _port_model(params, config)
    drift, norm = np.zeros(STEPS), np.zeros(STEPS)
    with torch.inference_mode():
        segments, meta = tool.static_exit_drift(
            model, config, NoiseSchedule.create(steps=STEPS), torch.from_numpy(x0), None,
            buckets, None, None, TOKENS, drift, norm, noise_table=torch.from_numpy(table))
    assert segments == [(11, 8), (3, 0)]
    assert [(m["layer"], m["n_outer"], m["cacheable"]) for m in meta] == [
        (5, 1, True), (2, None, False), (4, 1, True)]
    assert not drift[4:8].any() and not norm[4:8].any()
    np.testing.assert_allclose(drift, want_drift, rtol=RTOL)
    np.testing.assert_allclose(norm, want_norm, rtol=RTOL)


# --- the segmented derivation against the JAX tool's main ------------------------------


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_derive_cache_schedule", REPO / "tools" / "derive_cache_schedule.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _drift_arrays(seed):
    rng = np.random.RandomState(seed)
    drift = np.exp(np.linspace(2, -3, STEPS)) * rng.uniform(0.5, 1.5, STEPS)
    drift[rng.choice(STEPS, 2, replace=False)] *= 10
    return drift, rng.uniform(1, 2, STEPS)


def _run_jax_tool(monkeypatch, argv, drift, norm):
    """The JAX tool's main on the drift arrays: its model loading, truncated
    applies and sampler replaced by stand-ins that hand back the rows of
    ``drift`` and ``norm`` (scan order, t descending) for each cacheable
    bucket."""
    from duodiff_tpu import diffusion
    from duodiff_tpu.utils import model_loading

    class Sampler:
        def __init__(self, apply_fn, schedule, init_state_fn=None, **kw):
            self.stateful = init_state_fn is not None

        def init(self, key, shape):
            return jnp.zeros(shape), key

        def run(self, x, key, t_hi, t_lo, y=None, state=None):
            if not self.stateful:
                return x, key
            rows = (drift[t_lo:t_hi + 1][::-1] ** 2, norm[t_lo:t_hi + 1][::-1] ** 2)
            return x, key, state, rows

    class Model:
        dtype = jnp.float32

    monkeypatch.setattr(diffusion, "ChunkedDDPMSampler", Sampler)
    monkeypatch.setattr(model_loading, "load_model_from_config",
                        lambda *a, **k: (Model(), {}, JaxConfig(**TINY), None))
    monkeypatch.setattr(jse, "truncated_ee_apply_cached", lambda *a, **k: (None, None, {}))
    monkeypatch.setattr(jse, "truncated_ee_apply", lambda *a, **k: (None, {}))
    _jax_tool().main(argv)


def _run_port_tool(monkeypatch, argv, drift, norm):
    """The port's tool's main on the same arrays: the model and the
    measurement replaced, the bucket logic its own."""
    class Model:
        dtype = torch.float32

        def eval(self):
            return self

        def pack_for_kernels(self):
            pass

    def segment_drift(anchor, schedule, x, generator, t_hi, t_lo, y, delta0, noise_table=None,
                      graphs=True):
        return x, drift[t_lo:t_hi + 1], norm[t_lo:t_hi + 1]

    monkeypatch.setattr(tool, "load_model", lambda *a, **k: (Model(), UViTConfig(**TINY)))
    monkeypatch.setattr(tool, "segment_drift", segment_drift)
    monkeypatch.setattr(tool, "truncated_ee_apply_cached", lambda *a, **k: (None, None))
    monkeypatch.setattr(tool, "truncated_ee_apply", lambda *a, **k: None)
    monkeypatch.setattr(tool, "ddpm_loop", lambda fn, schedule, p, x, *a, **k: x)
    return tool.main(argv)


@pytest.mark.parametrize("budget", [("--budget_from_every", "3"), ("--num_anchors", "3"),
                                    ("--num_anchors", "1")])
@pytest.mark.parametrize("schedule", [BUCKETS, "11-6:4,5-0:2", "11-0:5"])
def test_segmented_derivation_matches_the_jax_tool(monkeypatch, tmp_path, schedule, budget):
    drift, norm = _drift_arrays(len(schedule) + int(budget[1]))
    common = ["--config", "ee.yaml", "--static_schedule", schedule, "--steps", str(STEPS),
              "--batch", "2", *budget]
    _run_jax_tool(monkeypatch, [*common, "--out", str(tmp_path / "jax.json")], drift, norm)
    result = _run_port_tool(monkeypatch, [*common, "--device", "cpu", "--out",
                                          str(tmp_path / "port.json")], drift, norm)
    want_table, want = jax_load_schedule(tmp_path / "jax.json", num_timesteps=STEPS,
                                         with_meta=True)
    got_table, got = jax_load_schedule(tmp_path / "port.json", num_timesteps=STEPS,
                                       with_meta=True)
    assert np.array_equal(got_table, want_table) and np.array_equal(result["table"], want_table)
    for key in ("budget", "max_staleness", "mean_staleness", "delta_norm_mean"):
        assert abs(got[key] - want[key]) <= 1e-12 * max(1.0, abs(want[key])), key
    for key in ("budget_mode", "mode", "static_schedule", "buckets", "drift", "n_outer",
                "batch", "seed"):
        assert got[key] == want[key], key
    if budget[0] == "--num_anchors":
        cacheable = tool.segment_mask(STEPS, [(b["t_hi"], b["t_lo"]) for b in got["buckets"]
                                              if b["cacheable"]])
        assert int(got_table[cacheable].sum()) <= int(budget[1])


def test_static_mode_end_to_end_and_eesample_on_its_table(config_file, tmp_path):
    out = tmp_path / "schedule.json"
    result = tool.main(["--device", "cpu", "--config", config_file, "--static_schedule", BUCKETS,
                        "--steps", str(STEPS), "--batch", "2", "--num_anchors", "3",
                        "--out", str(out)])
    table, meta = jax_load_schedule(out, num_timesteps=STEPS, with_meta=True)
    assert np.array_equal(table, result["table"]) and meta["mode"] == "static_exit"
    assert table[4:8].all() and table[0]  # the dense bucket; t = 0
    assert int(table[8:12].sum() + table[0:4].sum()) <= 3
    assert meta["card"].startswith("cpu") and meta["max_staleness"] <= meta["budget"] + 1e-9
    samples = eesample.main(["--device", "cpu", "--random_init", "--config_path", config_file,
                             "--num_timesteps", str(STEPS), "--batch_size", "2",
                             "--static_schedule", BUCKETS, "--cache_schedule", str(out),
                             "--output_folder", str(tmp_path / "s")])["samples"]
    assert samples.shape == (2, 16, 16, 3) and np.isfinite(samples).all()


@pytest.mark.parametrize("schedule,message", [
    ("10-0:5", "--static_schedule must cover t=11..0"),
    ("11-0:2", "no bucket is cacheable"),
], ids=["not_covering", "none_cacheable"])
def test_static_mode_refusals(config_file, tmp_path, schedule, message):
    with pytest.raises(SystemExit, match=message):
        tool.main(["--device", "cpu", "--config", config_file, "--static_schedule", schedule,
                   "--steps", str(STEPS), "--batch", "2", "--out", str(tmp_path / "s.json")])
    assert not (tmp_path / "s.json").exists()


# --- the early-exit int8 calibration -----------------------------------------------------


def test_early_exit_calibration_statistics_match_jax():
    """One 8-step calibration trajectory of an early-exit model, stepping
    on its backbone, against a loop over JAX's calibration model on the same
    noise; the sites are the backbone blocks' short names."""
    cfg = dict(TINY, depth=3)
    jmodel = JaxEarlyExitUViT(config=JaxConfig(**cfg), attn_impl="fused_int8",
                              int8_calibrate=True)
    params = _random_params(jmodel, seed=3)
    model = _port_model(params, UViTConfig(**cfg), attn_impl="fused_int8")
    steps = 8
    rng = np.random.RandomState(5)
    x0 = rng.randn(*SHAPE).astype(np.float32)
    table = rng.randn(steps, *SHAPE).astype(np.float32)
    js = JaxSchedule.create(steps=steps)
    fracs = jnp.asarray(jcal.CALIB_FRACTIONS, jnp.float32)
    x, amax, curves = jnp.asarray(x0), {}, {}
    for t in range(steps - 1, -1, -1):
        out, col = jmodel.apply({"params": params}, x, jnp.full((2,), t, jnp.float32), None,
                                mutable=["int8_calib"])
        a = jcal._collect_leaves(col["int8_calib"], "mlp_amax")
        rows = jcal._collect_leaves(col["int8_calib"], "mlp_rowamax")
        for k in a:
            short = k.split("/")[-1]
            amax[short] = np.maximum(amax.get(short, 0.0), np.asarray(a[k]))
            curves.setdefault(short, []).append(
                np.asarray(jnp.quantile(rows[k], fracs, axis=-1).T))
        x = js.step("predict_noise", out[0], x, t, jnp.asarray(table[t]) if t else 0.0 * x)
    quants = {k: np.stack(v) for k, v in curves.items()}
    with torch.inference_mode():
        g_amax, g_quants = tcal.calibrate_int8_stats(
            model, NoiseSchedule.create(steps=steps), None, SHAPE, x_init=torch.from_numpy(x0),
            noise_table=torch.from_numpy(table))
    assert sorted(g_amax) == sorted(amax) == sorted(model.uvit.block_names())
    for k in amax:
        assert g_quants[k].shape == quants[k].shape == (steps, 2, len(tcal.CALIB_FRACTIONS))
        np.testing.assert_allclose(g_quants[k][0], quants[k][0], rtol=RTOL, atol=ATOL, err_msg=k)
        np.testing.assert_allclose(g_quants[k], quants[k], rtol=INT8_TOL, atol=INT8_TOL,
                                   err_msg=k)
        np.testing.assert_allclose(g_amax[k], amax[k], rtol=INT8_TOL, atol=INT8_TOL, err_msg=k)
    for mode in ("amax", "percentile"):
        assert (tcal.scales_from_stats(amax, quants, mode=mode, margin=1.1)
                == jcal.scales_from_stats(amax, quants, mode=mode, margin=1.1))


@pytest.mark.parametrize("mode", ["amax", "percentile"])
def test_early_exit_tool_writes_scales_eesample_takes(config_file, tmp_path, mode):
    out = tmp_path / "scales.json"
    result = calib_tool.main(["--device", "cpu", "--config_path", config_file, "--random_init",
                              "--early_exit", "--seed", "1", "--num_timesteps", "6",
                              "--batch_size", "2", "--mode", mode, "--output", str(out)])
    data = json.loads(out.read_text())
    names = EarlyExitUViT(UViTConfig(**TINY)).uvit.block_names()
    assert sorted(data["blocks"]) == sorted(names) and data["meta"]["early_exit"] is True
    assert load_int8_scales(out) == {k: tuple(v) for k, v in result["scales"].items()}
    samples = eesample.main(["--device", "cpu", "--random_init", "--config_path", config_file,
                             "--threshold", "0.5", "--num_timesteps", "6", "--batch_size", "2",
                             "--attn_impl", "fused_int8", "--int8_scales", str(out),
                             "--output_folder", str(tmp_path / "s")])["samples"]
    assert np.isfinite(samples).all()
