"""The last one-card eager loops as step graphs, on the CPU: the adaptive
early-exit walk (``diffusion/static_exit.py:make_adaptive_exit_sampler``),
the probe calibration (``diffusion/calibration.py:collect_probe_stats``),
the int8 calibration scan (``utils/int8_calib.py:calibrate_int8_stats``),
the drift scans of ``tools/derive_cache_schedule.py`` (dense, DuoDiff and
static-exit modes) and the train steps that ``tools/trace_step.py`` and
``tools/microbench.py`` time.

The capture is emulated (tests/torch_graph_emulator.py): a replay reruns
the aten ops the capture recorded, on the same tensors, with the capture's
host values, and a host read inside a body fails. Held: (1) every such run
graphed equals its eager run (``graphs=False``) to the bit, its generator
ends in the same state, and its graphs were captured and replayed; (2) the
walk's x and log rows, and the probe statistics, graphed, against the JAX
functions on crossed-over weights and JAX's own draws (as a noise table),
within 1e-4; (3) ``_row_quantiles`` is ``torch.quantile`` to the bit;
(4) a traced window of ``trace_step`` holds replays only, no capture. Tiny
sizes: depth 3, D 64, a 20-step schedule, batch 2.
"""

import contextlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duodiff_tpu.config import UViTConfig as JaxConfig
from duodiff_tpu.diffusion import calibration as jcal
from duodiff_tpu.diffusion import static_exit as jstatic
from duodiff_tpu.diffusion.schedule import NoiseSchedule as JaxSchedule
from duodiff_tpu.models.early_exit import EarlyExitUViT as JaxEarlyExitUViT
from duodiff_tpu_torch import eesample
from duodiff_tpu_torch.config import UViTConfig
from duodiff_tpu_torch.diffusion import calibration, graphs, static_exit
from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
from duodiff_tpu_torch.models.early_exit import EarlyExitUViT
from duodiff_tpu_torch.models.uvit import init_uvit
from duodiff_tpu_torch.tools import derive_cache_schedule, microbench, trace_step
from duodiff_tpu_torch.utils import int8_calib, profiling
from duodiff_tpu_torch.utils.convert import early_exit_state_dict_from_jax
from torch_graph_emulator import EmulatedStepGraphs, emulate, emulated  # noqa: F401

torch.set_num_threads(1)

STEPS, BATCH = 20, 2
SHAPE = (BATCH, 16, 16, 3)
TINY = dict(img_size=16, patch_size=4, in_chans=3, embed_dim=64, depth=3, num_heads=4,
            mlp_ratio=4, num_classes=-1)
EE = dict(TINY, normalize_timesteps=True, classifier_type="mlp_probe_per_layer")
JAX_TOL = 1e-4
LAYERS = [1, 2, 3]
# (threshold, margin, monotone, calibrated): each forces one kind of move
WALKS = {
    "monotone_deepens": (-10.0, 0.7, True, False),
    "monotone_stays": (10.0, 0.7, True, False),
    "bidirectional_shallows": (10.0, 1.0, False, True),
    "bidirectional_stays_deep": (-10.0, 1.0, False, True),
}


def _random_params(jmodel, seed):
    """JAX's parameter tree (shapes traced, nothing compiled) drawn from
    ``numpy.random.RandomState(seed)``: 0.05 N(0, 1), LayerNorm scales
    about 1."""
    x = jnp.zeros((1, 16, 16, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), x, jnp.zeros((1,))))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        value = 0.05 * rng.randn(*leaf.shape).astype(np.float32)
        return value + 1.0 if path[-1].key == "scale" else value

    return jax.tree_util.tree_map_with_path(draw, shapes["params"])


@pytest.fixture(scope="module")
def pair():
    """A depth-3 early-exit model on both sides, on one set of weights."""
    jcfg = JaxConfig(**EE)
    jmodel = JaxEarlyExitUViT(config=jcfg)
    params = _random_params(jmodel, 0)
    model = EarlyExitUViT(UViTConfig(**EE), dtype=torch.float32)
    model.load_state_dict(early_exit_state_dict_from_jax(params, model.config), strict=True)
    model.eval().pack_for_kernels()
    japply = jax.jit(lambda x, t, y: jmodel.apply({"params": params}, x, t, y))
    return {"jcfg": jcfg, "params": params, "japply": japply, "model": model}


def _jax_draws(seed):
    """The start and the per-step noise a JAX sampler draws from
    ``PRNGKey(seed)`` (``ChunkedDDPMSampler.init``, then ``ddpm_scan``'s
    split a step, t = T-1 .. 0), as x_T and a noise table."""
    key, init_key = jax.random.split(jax.random.PRNGKey(seed))
    x0 = np.asarray(jax.random.normal(init_key, SHAPE, jnp.float32))
    table = np.zeros((STEPS, *SHAPE), np.float32)
    for t in range(STEPS - 1, -1, -1):
        key, zkey = jax.random.split(key)
        if t > 0:
            table[t] = np.asarray(jax.random.normal(zkey, SHAPE, jnp.float32))
    return x0, table


def _calibration():
    rng = np.random.RandomState(0)
    return jcal.fit_probe_calibration(rng.rand(40, 3), rng.rand(40, 3) * 0.1)


def _walk(model, name, chunk, graphs_arg):
    threshold, margin, monotone, calibrated = WALKS[name]
    return static_exit.make_adaptive_exit_sampler(
        model, schedule=NoiseSchedule.create(steps=STEPS), layers=LAYERS, chunk=chunk,
        threshold=threshold, margin=margin, monotone=monotone,
        calibration=_calibration() if calibrated else None, graphs=graphs_arg)


def _assert_replayed(run, n_kinds=None):
    """Every graph of ``run`` was captured and replayed at least once after
    its capture's own step."""
    assert run.graphs and (n_kinds is None or len(run.graphs) == n_kinds)
    for key, g in run.graphs.items():
        assert g.graph is not None and g.graph.replays >= 2, (key, g.calls)


# --- (1) graphed against eager, to the bit --------------------------------------------


@pytest.mark.parametrize("walk", sorted(WALKS))
def test_the_walk_graphed_equals_the_walk_eager(pair, emulated, walk):
    """Chunks of 6 over 20 steps, the last one of 2 steps; from a generator:
    x, every log row and the generator's state equal to the bit."""
    runs, out = [], []
    for graphed in (False, True):
        run = emulated() if graphed else False
        gen = torch.Generator().manual_seed(5)
        with torch.no_grad():
            x, log = _walk(pair["model"], walk, 6, run)(gen, SHAPE)
        out.append((x.clone(), log, gen.get_state()))
        runs.append(run)
    (x0, log0, g0), (x1, log1, g1) = out
    assert torch.equal(x0, x1) and log0 == log1 and torch.equal(g0, g1)
    assert [(r["t_hi"], r["t_lo"]) for r in log1] == [(19, 14), (13, 8), (7, 2), (1, 0)]
    run = runs[1]
    _assert_replayed(run, len({row["layer"] for row in log1}))  # a kind a candidate walked


def test_the_probe_statistics_graphed_equal_eager(pair, emulated):
    got = []
    for graphed in (False, True):
        run = emulated() if graphed else False
        gen = torch.Generator().manual_seed(6)
        with torch.no_grad():
            u, e = calibration.collect_probe_stats(pair["model"], NoiseSchedule.create(
                steps=STEPS), gen, SHAPE, graphs=run)
        got.append((u, e, gen.get_state()))
        if graphed:
            _assert_replayed(run, 1)
    (u0, e0, g0), (u1, e1, g1) = got
    assert u1.shape == e1.shape == (STEPS, 3) and u1.dtype == np.float32
    assert np.array_equal(u0, u1) and np.array_equal(e0, e1) and torch.equal(g0, g1)


def _int8_model():
    model = init_uvit(UViTConfig(**TINY), device="cpu", dtype=torch.float32,
                      generator=torch.Generator().manual_seed(3), attn_impl="plain_int8")
    model.eval().pack_for_kernels()
    return model


def test_the_int8_calibration_scan_graphed_equals_eager(emulated):
    """The statistics of a 20-step trajectory and the scales JSON of every
    mode from them, graphed and eager, equal to the bit."""
    model = _int8_model()
    got = []
    for graphed in (False, True):
        run = emulated() if graphed else False
        gen = torch.Generator().manual_seed(7)
        with torch.inference_mode():
            amax, quants = int8_calib.calibrate_int8_stats(
                model, NoiseSchedule.create(steps=STEPS), gen, SHAPE, graphs=run)
        scales = [json.dumps(int8_calib.scales_from_stats(amax, quants, mode=mode,
                                                          percentile=99.0, margin=1.1),
                             sort_keys=True) for mode in ("amax", "percentile")]
        got.append((amax, quants, scales))
        if graphed:
            _assert_replayed(run, 1)
    (a0, q0, s0), (a1, q1, s1) = got
    assert sorted(a0) == sorted(a1) == sorted(model.block_names()) and s0 == s1
    for k in a0:
        assert np.array_equal(a0[k], a1[k]) and np.array_equal(q0[k], q1[k])
        assert q1[k].shape == (STEPS, 2, len(int8_calib.CALIB_FRACTIONS))


def _write_yaml(path, params: dict) -> str:
    path.write_text("model_params:\n" + "".join(f"  {k}: {v}\n" for k, v in params.items()))
    return str(path)


DERIVE_MODES = {
    "dense": lambda d: ["--config", d["uvit"]],
    "duodiff": lambda d: ["--config", d["uvit"], "--shallow_config", d["uvit"], "--t_switch",
                          "6", "--full_seed", "1"],
    "static_exit": lambda d: ["--config", d["ee"], "--static_schedule", "19-10:3,9-0:1"],
}


@pytest.mark.parametrize("mode", sorted(DERIVE_MODES))
def test_the_derivation_scans_graphed_equal_eager(emulated, tmp_path, mode):
    """``derive_cache_schedule.main`` on one run of emulated graphs against
    ``graphs=False``: the drift and norm rows, the table and the JSON file
    equal to the bit."""
    files = {"uvit": _write_yaml(tmp_path / "uvit.yaml", TINY),
             "ee": _write_yaml(tmp_path / "ee.yaml", EE)}
    results, texts, run = [], [], emulated()
    for graphed in (False, True):
        out = tmp_path / f"schedule_{graphed}.json"
        results.append(derive_cache_schedule.main(
            [*DERIVE_MODES[mode](files), "--device", "cpu", "--steps", str(STEPS), "--batch",
             "2", "--num_anchors", "5", "--out", str(out)], graphs=run if graphed else False))
        texts.append(out.read_text())
    (r0, r1), (t0, t1) = results, texts
    for key in ("drift", "norm", "table"):
        assert np.array_equal(r0[key], r1[key]), key
    assert t0 == t1 and r1["meta"]["mode"] == json.loads(t1)["meta"]["mode"]
    assert (r1["drift"][:STEPS - 1] > 0).any()
    _assert_replayed(run, {"dense": 1, "duodiff": 2, "static_exit": 2}[mode])


@pytest.fixture
def run_class(monkeypatch):
    """Runs that code builds from ``graphs.StepGraphs`` graphed and
    emulated on the CPU; returns the list of the runs made."""
    emulate(monkeypatch)
    made = []

    class Recorded(EmulatedStepGraphs):
        def __init__(self, device, graphed=True):
            super().__init__(device, graphed)
            made.append(self)

    monkeypatch.setattr(graphs, "StepGraphs", Recorded)
    return made


@pytest.fixture(scope="module")
def tiny_config(tmp_path_factory):
    return _write_yaml(tmp_path_factory.mktemp("cfg") / "tiny.yaml", TINY)


def test_microbench_train_rows_graphed_equal_eager(run_class, tiny_config, monkeypatch):
    """Each train row's last loss, graphed and eager, equal to the bit; each
    graphed row's step captured in the warm-up and replayed in the reps."""
    monkeypatch.setenv("MB_CONFIG", tiny_config)
    losses = {}
    for graphed in (False, True):
        losses[graphed] = microbench.bench_train(device=torch.device("cpu"), batch=2, reps=2,
                                                 warmup=1, graphs=graphed)["train_loss"]
    assert list(losses[True]) == [f"{a}+mlp:{m}" for a, m in microbench.TRAIN_VARIANTS]
    assert losses[True] == losses[False]
    graphed_runs = [run for run in run_class if run.graphed]
    assert len(graphed_runs) == len(microbench.TRAIN_VARIANTS)
    for run in graphed_runs:
        _assert_replayed(run, 1)
        assert run.graphs[("train", "update")].graph.replays == 3  # 2 reps after the capture


@pytest.mark.parametrize("mode", ["sample", "train"])
def test_a_traced_window_of_trace_step_holds_replays_only(run_class, tiny_config, tmp_path,
                                                          monkeypatch, mode):
    """``trace_step.main`` graphed (emulated) and eager: the captures all
    happen before the trace opens, the window replays, and the train
    mode's loss equals the eager one's to the bit."""
    traced, captures, replays = [], [], []
    record, real_trace = graphs._capture, profiling.trace

    def noted(graph, pool):
        captures.append("traced" if traced else "untraced")
        return record(graph, pool)

    @contextlib.contextmanager
    def watched(*args, **kwargs):
        with real_trace(*args, **kwargs):
            traced.append(True)
            yield
            traced.clear()
            replays.extend(g.graph.replays for run in run_class if run.graphed
                           for g in run.graphs.values())

    monkeypatch.setattr(graphs, "_capture", noted)
    monkeypatch.setattr(profiling, "trace", watched)
    results = {}
    for graphed in (False, True):
        results[graphed] = trace_step.main(
            ["--device", "cpu", "--config", tiny_config, "--batch", "2", "--steps", "2",
             "--mode", mode, "--out", str(tmp_path / f"tr{graphed}")], graphs=graphed)
    runs = [run for run in run_class if run.graphed]
    assert len(runs) == 1 and len(runs[0].graphs) == 1 and captures == ["untraced"]
    # the untraced steps: an eager warm-up, the capture (and its step), then for
    # sample the untraced loop's two replays, for train one; the window: two
    assert replays == [{"sample": 3, "train": 2}[mode] + 2]
    if mode == "train":
        assert results[True]["capture"]["loss"] == results[False]["capture"]["loss"]
    assert results[True]["summary"]["span_ms"] > 0


def test_the_adaptive_cli_graphed_equals_eager(run_class, monkeypatch, tmp_path):
    """``eesample --adaptive_layers`` with its run's graphs emulated against
    ``main(graphs=False)``: the samples, the walk's log and the tables equal
    to the bit."""
    config = _write_yaml(tmp_path / "ee.yaml", EE)
    monkeypatch.setattr(eesample, "StepGraphs", graphs.StepGraphs)
    monkeypatch.setattr(eesample, "graph_route",
                        lambda device, model_parallel=1, graphs=True: (graphs, "emulated"))
    got = {}
    for graphed in (False, True):
        got[graphed] = eesample.main(
            ["--config_path", config, "--random_init", "--device", "cpu", "--num_timesteps",
             str(STEPS), "--batch_size", "2", "--threshold", "-1", "--adaptive_layers",
             "1,2,3", "--adaptive_chunk", "6", "--output_folder", str(tmp_path / str(graphed))],
            graphs=graphed)
    assert np.array_equal(got[True]["samples"], got[False]["samples"])
    assert got[True]["log"] == got[False]["log"]
    assert [r["layer"] for r in got[True]["log"]] == [1, 2, 3, 3]
    assert np.array_equal(got[True]["err_by_t"], got[False]["err_by_t"], equal_nan=True)
    _assert_replayed(next(run for run in run_class if run.graphed), 3)


# --- (2) against JAX ---------------------------------------------------------------------


@pytest.mark.parametrize("walk", sorted(WALKS))
def test_the_graphed_walk_matches_jax(pair, emulated, walk):
    """JAX's walk (chunks of 5) from PRNGKey(2) against the graphed port on
    JAX's draws: the moves, x and every probe field within 1e-4."""
    threshold, margin, monotone, calibrated = WALKS[walk]
    sampler = jstatic.make_adaptive_exit_sampler(
        pair["jcfg"], pair["params"], schedule=JaxSchedule.create(steps=STEPS), layers=LAYERS,
        chunk=5, threshold=threshold, margin=margin, monotone=monotone,
        calibration=_calibration() if calibrated else None, dtype=jnp.float32)
    want_x, want = sampler(jax.random.PRNGKey(2), SHAPE)
    x0, table = _jax_draws(2)
    run = emulated()
    with torch.no_grad():
        x, got = _walk(pair["model"], walk, 5, run)(None, x_init=torch.from_numpy(x0),
                                                    noise_table=torch.from_numpy(table))
    _assert_replayed(run)
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    for g, w in zip(got, want):
        assert (g["t_hi"], g["t_lo"], g["layer"]) == (w["t_hi"], w["t_lo"], w["layer"])
        for field in set(g) - {"t_hi", "t_lo", "layer"}:
            np.testing.assert_allclose(g[field], w[field], rtol=JAX_TOL, atol=JAX_TOL)
    np.testing.assert_allclose(x.numpy(), np.asarray(want_x), rtol=JAX_TOL, atol=JAX_TOL)


def test_the_graphed_probe_statistics_match_jax(pair, emulated):
    """JAX's ``collect_probe_stats`` from PRNGKey(4) (one ``lax.scan``)
    against the graphed port on JAX's draws."""
    want_u, want_e = jcal.collect_probe_stats(pair["japply"], JaxSchedule.create(steps=STEPS),
                                              jax.random.PRNGKey(4), SHAPE)
    x0, table = _jax_draws(4)
    run = emulated()
    with torch.no_grad():
        got_u, got_e = calibration.collect_probe_stats(
            pair["model"], NoiseSchedule.create(steps=STEPS), None,
            x_init=torch.from_numpy(x0), noise_table=torch.from_numpy(table), graphs=run)
    _assert_replayed(run, 1)
    assert got_u.shape == np.shape(want_u) == (STEPS, 3)
    np.testing.assert_allclose(got_u, want_u, rtol=JAX_TOL, atol=JAX_TOL)
    np.testing.assert_allclose(got_e, want_e, rtol=JAX_TOL, atol=JAX_TOL)


# --- (3) the quantiles ----------------------------------------------------------------------


@pytest.mark.parametrize("rows", [(7, 300), (26, 2 * 17), (3, 1), (5, 2), (4, 1000)])
@pytest.mark.parametrize("kind", ["random", "ties", "nan"])
def test_row_quantiles_are_torch_quantile_to_the_bit(rows, kind):
    values = torch.from_numpy(np.random.RandomState(rows[1]).rand(*rows).astype(np.float32)) * 5
    if kind == "ties":
        values = values.round()
    elif kind == "nan":
        values[1, 0] = float("nan")
    fractions = torch.tensor(int8_calib.CALIB_FRACTIONS)
    got = int8_calib._row_quantiles(values, fractions)
    want = torch.quantile(values, fractions, dim=-1).t()
    assert got.shape == want.shape and torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(-1.0), want.nan_to_num(-1.0))
