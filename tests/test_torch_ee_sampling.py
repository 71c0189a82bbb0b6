"""The port's early-exit samplers against the JAX package's, on the same
weights (crossed over through the export) and one injected noise table:

- the dynamic threshold rule (``ee_loop`` / ``early_exit_sample`` against
  ``ee_scan(noise_table=)``) at a threshold between probe values, one below
  0 (nothing qualifies: the shallowest head) and one above all of them
  (the shallowest head too, by the first qualifying probe); guided, the
  wrapper and a trajectory;
- ``early_exit_select``, the exit-schedule parser, derivation and
  ``cache_outer_for`` on random tables;
- static-bucket trajectories, plain, block-cached (period and table) and
  guided, against JAX's truncated applies chained through
  ``ddpm_scan(noise_table=)`` bucket by bucket;
- the adaptive walk's chunk ranges and layers at thresholds that force
  every move, against JAX's walk; one candidate equal to the static sampler;
- the probe calibration: ``collect_probe_stats`` against a JAX loop on the
  same noise, the fit, the map, and the file both ways.

Tolerances: x to 1e-4 (rtol and atol), exit indices equal, the probes'
batch means to 1e-5."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duodiff_tpu.config import UViTConfig as JaxConfig
from duodiff_tpu.diffusion import calibration as jcal
from duodiff_tpu.diffusion import sampling as jsampling
from duodiff_tpu.diffusion import static_exit as jstatic
from duodiff_tpu.diffusion.schedule import NoiseSchedule as JaxSchedule
from duodiff_tpu.models.early_exit import EarlyExitUViT as JaxEarlyExitUViT
from duodiff_tpu_torch.config import UViTConfig
from duodiff_tpu_torch.diffusion import calibration, sampling, static_exit
from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
from duodiff_tpu_torch.models.early_exit import EarlyExitUViT
from duodiff_tpu_torch.utils.convert import early_exit_state_dict_from_jax

torch.set_num_threads(1)

TINY = dict(img_size=16, patch_size=2, in_chans=3, embed_dim=32, depth=5, num_heads=4,
            mlp_ratio=4, normalize_timesteps=True, classifier_type="mlp_probe_per_layer")
STEPS, BATCH = 12, 2
SHAPE = (BATCH, 16, 16, 3)
TOL = 1e-4
NULL, SCALE = 9, 1.5


def _random_params(jmodel, cfg, seed):
    """Parameters of JAX's tree (its shapes traced, nothing compiled) drawn
    from ``numpy.random.RandomState(seed)``: 0.05 N(0, 1), LayerNorm scales
    about 1."""
    x = jnp.zeros((1, cfg["img_size"], cfg["img_size"], cfg["in_chans"]), jnp.float32)
    y = jnp.zeros((1,), jnp.int32) if cfg["num_classes"] > 0 else None
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), x, jnp.zeros((1,)), y)
                            )["params"]
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        value = 0.05 * rng.randn(*leaf.shape).astype(np.float32)
        return value + 1.0 if path[-1].key == "scale" else value

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _pair(seed, **cfg_kw):
    cfg = {**TINY, "num_classes": -1, **cfg_kw}
    jmodel = JaxEarlyExitUViT(config=JaxConfig(**cfg))
    params = _random_params(jmodel, cfg, seed)
    model = EarlyExitUViT(UViTConfig(**cfg), dtype=torch.float32)
    model.load_state_dict(early_exit_state_dict_from_jax(params, model.config), strict=True)
    model.pack_for_kernels()
    japply = jax.jit(lambda x, t, y, m=jmodel, p=params: m.apply({"params": p}, x, t, y))
    return {"japply": japply, "params": params, "jcfg": JaxConfig(**cfg), "model": model.eval()}


@pytest.fixture(scope="module")
def uncond():
    return _pair(0)


@pytest.fixture(scope="module")
def cond():
    return _pair(1, num_classes=10, classifier_type="attention_probe")


def _noise(seed=3):
    rng = np.random.RandomState(seed)
    table = rng.randn(STEPS, *SHAPE).astype(np.float32)
    table[0] = 0.0
    return rng.randn(*SHAPE).astype(np.float32), table


def _labels():
    return np.array([2, 7], np.int32)


def _threshold(pair, x0, y=None):
    """A threshold between the probes' first-step values, away from each by
    at least 1e-4, that spreads the samples' exits over the most layers."""
    t = torch.full((BATCH,), float(STEPS - 1))
    with torch.no_grad():
        u = pair["model"](torch.from_numpy(x0), t, y)[1].numpy()
    values = np.sort(u.ravel())
    mids = [(a + b) / 2 for a, b in zip(values, values[1:]) if b - a > 2e-4]
    spread = [len(set(np.argmax(u <= m, axis=0))) for m in mids]
    return float(mids[int(np.argmax(spread))])


def _jax_ee(apply_fn, threshold, x0, table, y=None):
    x, _, err, idx = jsampling.ee_scan(
        apply_fn, JaxSchedule.create(steps=STEPS), threshold, jnp.asarray(x0),
        jax.random.PRNGKey(0), jnp.arange(STEPS - 1, -1, -1),
        None if y is None else jnp.asarray(y), noise_table=jnp.asarray(table))
    return np.asarray(x), np.asarray(err)[::-1], np.asarray(idx)[::-1]


def _check_ee(got, want):
    (x, err, idx), (wx, werr, widx) = got, want
    assert idx.dtype == torch.int32 and np.array_equal(idx.numpy(), widx)
    np.testing.assert_allclose(err.numpy(), werr, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(x.numpy(), wx, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("where", ["between", "below_zero", "above_all"])
def test_dynamic_trajectory_matches_ee_scan(uncond, where):
    x0, table = _noise()
    threshold = {"between": _threshold(uncond, x0), "below_zero": -0.5, "above_all": 2.0}[where]
    want = _jax_ee(uncond["japply"], threshold, x0, table)
    with torch.no_grad():
        got = sampling.early_exit_sample(
            uncond["model"], None, schedule=NoiseSchedule.create(steps=STEPS), shape=SHAPE,
            threshold=threshold, x_init=torch.from_numpy(x0),
            noise_table=torch.from_numpy(table))
    _check_ee(got, want)
    idx = got[2].numpy()
    assert idx.shape == (STEPS, BATCH) and got[1].shape == (STEPS, TINY["depth"])
    if where == "between":  # the rule really chose among several exits
        assert len(np.unique(idx)) > 1
    else:  # nothing qualifies, or the first probe does: the shallowest head
        assert (idx == 0).all()


def test_guided_wrapper_matches_jax(cond):
    x0, _ = _noise(4)
    y = _labels()
    t = np.full((BATCH,), 7.0, np.float32)
    want = jsampling.make_guided_apply_ee(cond["japply"], SCALE, NULL)(
        jnp.asarray(x0), jnp.asarray(t), jnp.asarray(y))
    with torch.no_grad():
        got = sampling.make_guided_apply_ee(cond["model"], SCALE, NULL)(
            torch.from_numpy(x0), torch.from_numpy(t), torch.from_numpy(y).long())
    for g, w in zip(got, want):
        assert g.shape == np.shape(w)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="guidance needs class labels"):
        sampling.make_guided_apply_ee(cond["model"], SCALE, NULL)(
            torch.from_numpy(x0), torch.from_numpy(t), None)


def test_guided_trajectory_matches_ee_scan(cond):
    x0, table = _noise(5)
    y = _labels()
    yt = torch.from_numpy(y).long()
    threshold = _threshold(cond, x0, yt)
    want = _jax_ee(jsampling.make_guided_apply_ee(cond["japply"], SCALE, NULL), threshold, x0,
                   table, y)
    with torch.no_grad():
        got = sampling.early_exit_sample(
            sampling.make_guided_apply_ee(cond["model"], SCALE, NULL), None,
            schedule=NoiseSchedule.create(steps=STEPS), shape=SHAPE, threshold=threshold,
            y=yt, x_init=torch.from_numpy(x0), noise_table=torch.from_numpy(table))
    _check_ee(got, want)


@pytest.mark.parametrize("layout", ["stacked", "legacy"])
@pytest.mark.parametrize("lam,earliest", [(0.3, 0), (0.5, 2), (0.9, 1), (-1.0, 3)])
def test_early_exit_select_matches_jax(layout, lam, earliest):
    rng = np.random.RandomState(abs(int(10 * lam)) + earliest)
    depth, b = 5, 6
    eps = rng.randn(b, 4, 4, 3).astype(np.float32)
    g = rng.randn(depth, b, 4, 4, 3).astype(np.float32)
    u = rng.rand(depth, b).astype(np.float32)
    if layout == "legacy":  # (B, depth, ...) with values to average
        u = np.repeat(u.T[:, :, None], 3, axis=2) + rng.randn(b, depth, 3).astype(np.float32) * 1e-3
    w_sel, w_layers = jsampling.early_exit_select(lam, (jnp.asarray(eps), jnp.asarray(u),
                                                        jnp.asarray(g)), earliest)
    sel, layers = sampling.early_exit_select(lam, tuple(map(torch.from_numpy, (eps, u, g))),
                                             earliest)
    assert layers.dtype == torch.int32 and np.array_equal(layers.numpy(), np.asarray(w_layers))
    np.testing.assert_array_equal(sel.numpy(), np.asarray(w_sel))


def test_exit_schedule_parser_matches_jax():
    for spec in ("999-700:3,699-300:8,299-0:13", " 0-4:1 , 9-5:2", "11-0:5"):
        assert static_exit.parse_exit_schedule(spec) == jstatic.parse_exit_schedule(spec)
    for bad, message in (("999-700:3,600-0:8", "not contiguous"), ("9-0", "bad exit-schedule"),
                         ("a-0:1", "bad exit-schedule")):
        with pytest.raises(ValueError, match=message):
            static_exit.parse_exit_schedule(bad)
        with pytest.raises(ValueError, match=message):
            jstatic.parse_exit_schedule(bad)


@pytest.mark.parametrize("seed", range(4))
def test_exit_schedule_derivation_matches_jax(seed):
    rng = np.random.RandomState(seed)
    steps = rng.randint(5, 200)
    table = np.clip(np.round(np.linspace(1, 12, steps)[:, None] + rng.randn(steps, 8) * 2), 0,
                    13).astype(np.int32)
    for n in (1, 3, 4, steps):
        for q in (0.5, 0.9):
            assert (static_exit.derive_exit_schedule(table, n, q)
                    == jstatic.derive_exit_schedule(table, n, q))
    with pytest.raises(ValueError, match="n_buckets must be in"):
        static_exit.derive_exit_schedule(table, steps + 1)


def test_cache_outer_for_matches_jax():
    for depth in (5, 13, 17):
        for exit_layer in range(depth + 1):
            for outer in (None, 1, 2, 3, 8):
                assert (static_exit.cache_outer_for(depth, exit_layer, outer)
                        == jstatic.cache_outer_for(depth, exit_layer, outer))


def _jax_static(pair, buckets, x0, table, cache_every=None, guidance=None, y=None):
    """JAX's truncated applies chained through ddpm_scan bucket by bucket."""
    js = JaxSchedule.create(steps=STEPS)
    x, key = jnp.asarray(x0), jax.random.PRNGKey(0)
    yy = None if y is None else jnp.asarray(y)
    cfg, params = pair["jcfg"], pair["params"]
    for t_hi, t_lo, layer in buckets:
        ts = jnp.arange(t_hi, t_lo - 1, -1)
        n_outer = (jstatic.cache_outer_for(cfg.depth, layer) if cache_every is not None
                   else None)
        if n_outer is None:
            apply, p0 = jstatic.truncated_ee_apply(cfg, params, layer, dtype=jnp.float32)
            fn = lambda xx, tt, y2, a=apply, p=p0: a(p, xx, tt, y2)  # noqa: E731
            if guidance is not None:
                fn = jsampling.make_guided_apply(fn, *guidance)
            x, key = jsampling.ddpm_scan(fn, js, "predict_noise", x, key, ts, yy,
                                         noise_table=jnp.asarray(table))
        else:
            anchor, cached, p0 = jstatic.truncated_ee_apply_cached(cfg, params, layer, n_outer,
                                                                   dtype=jnp.float32)
            rule = cache_every if isinstance(cache_every, int) else jnp.asarray(cache_every)
            fn = jsampling.make_block_cached_apply(
                lambda xx, tt, y2, a=anchor, p=p0: a(p, xx, tt, y2),
                lambda xx, tt, y2, d, c=cached, p=p0: c(p, xx, tt, y2, d), rule, t_hi)
            state = jnp.zeros((BATCH, cfg.extras + cfg.num_patches, cfg.embed_dim))
            x, key, _ = jsampling.ddpm_scan(fn, js, "predict_noise", x, key, ts, yy,
                                            noise_table=jnp.asarray(table), state=state)
    return np.asarray(x)


BUCKETS = [(11, 8, 2), (7, 4, 5), (3, 0, 4)]
ANCHORS = np.zeros(STEPS, bool)
ANCHORS[[10, 5, 1]] = True


@pytest.mark.parametrize("mode", ["plain", "cached_every_2", "cached_table", "guided"])
def test_static_buckets_match_jax(uncond, cond, mode):
    pair = cond if mode == "guided" else uncond
    guidance = (SCALE, NULL) if mode == "guided" else None
    y = _labels() if mode == "guided" else None
    cache = {"cached_every_2": 2, "cached_table": ANCHORS}.get(mode)
    x0, table = _noise(6)
    want = _jax_static(pair, BUCKETS, x0, table, cache, guidance, y)
    with torch.no_grad():
        got = static_exit.static_exit_sample(
            pair["model"], None, schedule=NoiseSchedule.create(steps=STEPS), buckets=BUCKETS,
            y=None if y is None else torch.from_numpy(y).long(), guidance=guidance,
            cache_every=cache, x_init=torch.from_numpy(x0), noise_table=torch.from_numpy(table))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case,message", [
    ("gap", "must cover"), ("guided_cache", "does not compose with guidance"),
    ("period", "cache_every must be >= 1"), ("layer", "exit_layer must be in")])
def test_static_sampler_refusals(uncond, case, message):
    kw = {"gap": dict(buckets=[(11, 1, 3)]),
          "guided_cache": dict(buckets=BUCKETS, guidance=(1.0, 1), cache_every=2),
          "period": dict(buckets=BUCKETS, cache_every=0),
          "layer": dict(buckets=[(11, 0, 6)])}[case]
    with pytest.raises(ValueError, match=message):
        static_exit.make_static_exit_sampler(uncond["model"],
                                             schedule=NoiseSchedule.create(steps=STEPS), **kw)


def _calibration(depth=5):
    rng = np.random.RandomState(0)
    return jcal.fit_probe_calibration(rng.rand(40, depth), rng.rand(40, depth) * 0.1)


# (layers, threshold, margin, monotone, calibrated, chunk): each forces one
# kind of move. Chunks of 5 end on a short chunk (t 1..0); chunks of 4 divide
# the 12 steps, which spares JAX a second compiled chunk length.
WALKS = {
    "monotone_deepens": ([1, 3, 5], -10.0, 0.7, True, False, 5),
    "monotone_stays": ([1, 3, 5], 10.0, 0.7, True, False, 5),
    "bidirectional_shallows": ([0, 2, 5], 10.0, 1.0, False, True, 4),
    "bidirectional_stays_deep": ([0, 2, 5], -10.0, 1.0, False, True, 4),
}


@pytest.mark.parametrize("walk", sorted(WALKS))
def test_adaptive_walk_matches_jax(uncond, walk):
    layers, threshold, margin, monotone, calibrated, chunk = WALKS[walk]
    calib = _calibration() if calibrated else None
    kw = dict(layers=layers, chunk=chunk, threshold=threshold, margin=margin,
              monotone=monotone, calibration=calib)
    sampler = jstatic.make_adaptive_exit_sampler(
        uncond["jcfg"], uncond["params"], schedule=JaxSchedule.create(steps=STEPS),
        dtype=jnp.float32, **kw)
    _, want = sampler(jax.random.PRNGKey(0), SHAPE)
    x0, table = _noise(7)
    with torch.no_grad():
        x, got = static_exit.make_adaptive_exit_sampler(
            uncond["model"], schedule=NoiseSchedule.create(steps=STEPS), **kw)(
                None, x_init=torch.from_numpy(x0), noise_table=torch.from_numpy(table))
    assert torch.isfinite(x).all()
    assert [(r["t_hi"], r["t_lo"], r["layer"]) for r in got] == [
        (r["t_hi"], r["t_lo"], r["layer"]) for r in want]
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    moves = [r["layer"] for r in got]
    assert moves == {"monotone_deepens": [1, 3, 5], "monotone_stays": [1, 1, 1],
                     "bidirectional_shallows": [5, 2, 0],
                     "bidirectional_stays_deep": [5, 5, 5]}[walk]


def test_one_candidate_walk_is_the_static_sampler(uncond):
    """The probe sums never touch x or the noise stream: with one candidate
    the walk samples what one static bucket samples, to the bit, from a
    generator and from a noise table."""
    schedule = NoiseSchedule.create(steps=STEPS)
    walk = static_exit.make_adaptive_exit_sampler(uncond["model"], schedule=schedule,
                                                  layers=[3], chunk=5, threshold=0.5)
    static = static_exit.make_static_exit_sampler(uncond["model"], schedule=schedule,
                                                  buckets=[(STEPS - 1, 0, 3)])
    x0, table = map(torch.from_numpy, _noise(8))
    with torch.no_grad():
        for kw in (dict(x_init=x0, noise_table=table), dict(shape=SHAPE)):
            a, log = walk(torch.Generator().manual_seed(1), **kw)
            b = static(torch.Generator().manual_seed(1), **kw)
            assert torch.equal(a, b) and [r["layer"] for r in log] == [3, 3, 3]


@pytest.mark.parametrize("case,message", [
    ("empty", "must be non-empty"), ("range", "out of range for depth"),
    ("calibration", "fitted on a different model")])
def test_adaptive_sampler_refusals(uncond, case, message):
    kw = {"empty": dict(layers=[]), "range": dict(layers=[1, 6]),
          "calibration": dict(layers=[1], calibration=_calibration(4))}[case]
    with pytest.raises(ValueError, match=message):
        static_exit.make_adaptive_exit_sampler(uncond["model"],
                                               schedule=NoiseSchedule.create(steps=STEPS), **kw)


def test_collect_probe_stats_matches_a_jax_loop(uncond):
    """``collect_probe_stats`` against JAX's loop body (backbone-driven
    trajectory, batch means of u and of (g - backbone)^2) on one noise table."""
    x0, table = _noise(9)
    js = JaxSchedule.create(steps=STEPS)
    x, u_rows, e_rows = jnp.asarray(x0), [], []
    for t in range(STEPS - 1, -1, -1):
        bb, u, g = uncond["japply"](x, jnp.full((BATCH,), t, jnp.float32), None)
        u_rows.append(np.asarray(u).mean(1))
        e_rows.append(np.asarray(jnp.mean((g - bb[None]) ** 2, axis=(1, 2, 3, 4))))
        x = js.step_predict_noise(bb, x, t, jnp.asarray(table[t]) * (t > 0))
    with torch.no_grad():
        got_u, got_e = calibration.collect_probe_stats(
            uncond["model"], NoiseSchedule.create(steps=STEPS), None,
            x_init=torch.from_numpy(x0), noise_table=torch.from_numpy(table))
    assert got_u.shape == got_e.shape == (STEPS, TINY["depth"]) and got_u.dtype == np.float32
    np.testing.assert_allclose(got_u, np.array(u_rows[::-1]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_e, np.array(e_rows[::-1]), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("seed", range(3))
def test_calibration_fit_and_map_match_jax(seed):
    rng = np.random.RandomState(seed)
    u = rng.rand(30, 5)
    e = 0.3 * u + 0.01 * rng.randn(30, 5)
    u[:, 1] = 0.5  # a dead probe: the constant fallback
    e[:, 2] = -e[:, 2]  # a negative slope: clamped to 0
    got, want = calibration.fit_probe_calibration(u, e), jcal.fit_probe_calibration(u, e)
    assert got == want
    for slot in range(5):
        for value in (-1.0, 0.0, 0.3, 0.5, 0.99, 3.0):
            assert (calibration.apply_probe_calibration(got, slot, value)
                    == jcal.apply_probe_calibration(want, slot, value))
    with pytest.raises(ValueError, match="shape mismatch"):
        calibration.fit_probe_calibration(u, e[:, :4])


def test_calibration_file_reads_both_ways(tmp_path):
    calib = _calibration()
    calibration.save_probe_calibration(tmp_path / "port.json", calib, meta={"card": "x"})
    jcal.save_probe_calibration(tmp_path / "jax.json", calib, meta={"backend": "cpu"})
    assert jcal.load_probe_calibration(tmp_path / "port.json") == json.loads(
        (tmp_path / "port.json").read_text())
    assert calibration.load_probe_calibration(tmp_path / "jax.json") == jcal.load_probe_calibration(
        tmp_path / "jax.json")
    assert (tmp_path / "port.json").read_text().replace('"card": "x"', '"backend": "cpu"') == (
        tmp_path / "jax.json").read_text()
    for bad, message in (({"a": [1]}, "not a probe calibration file"),
                         ({"a": [1], "b": [1, 2]}, "len\\(a\\) != len\\(b\\)"),
                         ({"a": [1], "b": [1]}, "missing 'mean_error'"),
                         ({"a": [1], "b": [1], "mean_error": []}, "len\\(mean_error\\)")):
        (tmp_path / "bad.json").write_text(json.dumps(bad))
        with pytest.raises(ValueError, match=message):
            calibration.load_probe_calibration(tmp_path / "bad.json")
