"""The port's cache-schedule derivation against the JAX package's: every
derivation function on random drift curves (tables equal, floats within
1e-12), the written JSON read by both readers, the drift curve the port's
tool measures against a loop over the JAX model's ``forward_anchor`` on the
same noise (rtol 1e-4, the trajectory bound), and the tool end to end on a
tiny DuoDiff pair on the CPU with its refusals."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duodiff_tpu.config import UViTConfig as JaxConfig
from duodiff_tpu.diffusion import cache_schedule as jcs
from duodiff_tpu.diffusion.schedule import NoiseSchedule as JaxSchedule
from duodiff_tpu.models.uvit import init_uvit as jax_init_uvit
from duodiff_tpu_torch.config import UViTConfig
from duodiff_tpu_torch.diffusion import cache_schedule as tcs
from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
from duodiff_tpu_torch.models.uvit import UViT
from duodiff_tpu_torch.tools import derive_cache_schedule as tool
from duodiff_tpu_torch.utils.convert import uvit_state_dict_from_jax

torch.set_num_threads(1)

SMALL = dict(img_size=16, patch_size=4, in_chans=3, embed_dim=64, num_heads=4, mlp_ratio=4)
FLOAT_TOL = 1e-12


def _drift(seed: int, steps: int) -> np.ndarray:
    """A drift curve with the shape a run gives: large at high noise, a tail
    of small steps, and a few spikes."""
    rng = np.random.RandomState(seed)
    base = np.exp(np.linspace(-3, 2, steps)) * rng.uniform(0.5, 1.5, steps)
    base[rng.choice(steps, 3, replace=False)] *= 20
    return base


CURVES = [(seed, steps) for seed in range(4) for steps in (7, 60, 1000)]


@pytest.mark.parametrize("seed,steps", CURVES)
@pytest.mark.parametrize("every", [1, 3, 5])
def test_staleness_and_uniform_budget_match_jax(seed, steps, every):
    drift = _drift(seed, steps)
    want_table = jcs.uniform_table(every, steps)
    got_table = tcs.uniform_table(every, steps)
    assert np.array_equal(got_table, want_table)
    np.testing.assert_allclose(tcs.segment_staleness(drift, got_table),
                               jcs.segment_staleness(drift, want_table), rtol=0, atol=FLOAT_TOL)
    assert abs(tcs.uniform_budget(drift, every) - jcs.uniform_budget(drift, every)) <= FLOAT_TOL


@pytest.mark.parametrize("seed,steps", CURVES)
@pytest.mark.parametrize("anchor_zero", [True, False])
def test_derived_tables_equal_jax(seed, steps, anchor_zero):
    drift = _drift(seed, steps)
    for budget in (0.0, float(np.median(drift)), float(drift.sum() / 10), float(drift.sum())):
        got = tcs.derive_anchor_table(drift, budget, anchor_zero=anchor_zero)
        want = jcs.derive_anchor_table(drift, budget, anchor_zero=anchor_zero)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert tcs.table_to_anchors(got) == jcs.table_to_anchors(want)
        assert np.array_equal(tcs.anchors_to_table(tcs.table_to_anchors(got), steps), got)


@pytest.mark.parametrize("seed,steps", CURVES)
def test_budget_for_count_matches_jax(seed, steps):
    drift = _drift(seed, steps)
    for count in sorted({1, 3, steps // 4, steps // 2}):
        got, want = tcs.budget_for_count(drift, count), jcs.budget_for_count(drift, count)
        assert abs(got - want) <= FLOAT_TOL * max(1.0, abs(want))
        assert np.array_equal(tcs.derive_anchor_table(drift, got),
                              jcs.derive_anchor_table(drift, want))


def test_saved_schedule_is_read_by_both_readers(tmp_path):
    table = tcs.derive_anchor_table(_drift(9, 100), 5.0)
    meta = {"mode": "duodiff", "budget": 5.0}
    tcs.save_cache_schedule(tmp_path / "port.json", table, meta)
    jcs.save_cache_schedule(tmp_path / "jax.json", table, meta)
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    got, got_meta = jcs.load_cache_schedule(tmp_path / "port.json", num_timesteps=100,
                                            with_meta=True)
    assert np.array_equal(got, table) and got_meta == meta
    assert np.array_equal(tcs.load_cache_schedule(tmp_path / "port.json"), table)


def test_drift_curve_matches_a_jax_forward_anchor_loop():
    """The tool's measurement (a stateful apply with aux rows through
    ddpm_loop) against a loop the test builds from the JAX model's
    forward_anchor and schedule, on the same noise."""
    steps, shape, n_outer = 12, (2, 16, 16, 3), 1
    cfg = dict(SMALL, depth=5)
    jmodel, params = jax_init_uvit(JaxConfig(**cfg), jax.random.PRNGKey(4), dtype=jnp.float32,
                                   attn_impl="fused")
    rng = np.random.RandomState(4)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rng.randn(*a.shape).astype(np.float32), params)
    model = UViT(UViTConfig(**cfg), dtype=torch.float32, attn_impl="fused")
    model.load_state_dict(uvit_state_dict_from_jax(params), strict=True)
    model.eval().pack_for_kernels()
    x0 = rng.randn(*shape).astype(np.float32)
    table = rng.randn(steps, *shape).astype(np.float32)

    js = JaxSchedule.create(steps=steps)
    x, prev = jnp.asarray(x0), jnp.zeros((2, 17, 64), jnp.float32)
    want_drift, want_norm = np.zeros(steps), np.zeros(steps)
    for t in range(steps - 1, -1, -1):
        eps, delta = jmodel.apply({"params": params}, x, jnp.full((2,), t, jnp.float32), None,
                                  n_outer=n_outer, method=jmodel.forward_anchor)
        want_drift[t] = np.sqrt(float(jnp.sum((delta - prev) ** 2)))
        want_norm[t] = np.sqrt(float(jnp.sum(delta ** 2)))
        z = jnp.asarray(table[t]) if t > 0 else jnp.zeros(shape)
        x, prev = js.step("predict_noise", eps, x, t, z, "beta_tilde"), delta
    with torch.inference_mode():
        drift, norm = tool.measure_drift(model, NoiseSchedule.create(steps=steps),
                                         torch.from_numpy(x0), None, steps - 1, n_outer, None,
                                         17, noise_table=torch.from_numpy(table))
    assert drift.shape == norm.shape == (steps,)
    np.testing.assert_allclose(drift, want_drift, rtol=1e-4)
    np.testing.assert_allclose(norm, want_norm, rtol=1e-4)


def _write_config(path, depth):
    path.write_text("model_params:\n" + "".join(
        f"  {k}: {v}\n" for k, v in dict(SMALL, depth=depth).items()))
    return str(path)


@pytest.fixture(scope="module")
def configs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cfg")
    return _write_config(d / "tiny3.yaml", 3), _write_config(d / "tiny5.yaml", 5)


@pytest.mark.parametrize("budget", [("--num_anchors", "4"), ("--budget_from_every", "3")])
def test_tool_duodiff_mode_writes_a_schedule_the_samplers_read(configs, tmp_path, budget):
    out = tmp_path / "schedule.json"
    steps, t_switch = 20, 6
    result = tool.main(["--device", "cpu", "--config", configs[1], "--shallow_config",
                        configs[0], "--t_switch", str(t_switch), "--full_seed", "1",
                        "--steps", str(steps), "--batch", "2", "--out", str(out), *budget])
    table, meta = jcs.load_cache_schedule(out, num_timesteps=steps, with_meta=True)
    handoff = steps - t_switch
    assert np.array_equal(table, result["table"])
    assert table[handoff:].all()  # the dense shallow segment
    late = int(table[:handoff].sum())
    if budget[0] == "--num_anchors":
        assert late <= 4
    assert table[0] and meta["mode"] == "duodiff" and meta["full_seed"] == 1
    assert meta["card"].startswith("cpu") and "backend" not in meta
    assert len(meta["drift"]) == steps and meta["max_staleness"] <= meta["budget"] + 1e-9
    assert tcs.load_cache_schedule(out).sum() == table.sum()


def test_tool_plain_mode_runs(configs, tmp_path):
    out = tmp_path / "dense.json"
    tool.main(["--device", "cpu", "--config", configs[0], "--steps", "10", "--batch", "2",
               "--out", str(out)])
    assert json.loads(out.read_text())["meta"]["mode"] == "dense"


TOOL_REFUSALS = {
    "static_schedule": (["--static_schedule", "9-0:3"], "--static_schedule needs --config"),
    "t_switch_alone": (["--t_switch", "3"], "--t_switch and --shallow_config go together"),
    "shallow_alone": (["--shallow_config", "x.yaml"], "--t_switch and --shallow_config"),
    "full_seed_dense": (["--full_seed", "1"], "--full_seed is for"),
    "t_switch_range": (["--t_switch", "10", "--shallow_config", "x.yaml"], "--t_switch must be"),
    "both_modes": (["--t_switch", "3", "--shallow_config", "x.yaml", "--static_schedule",
                    "9-0:3"], "mutually exclusive"),
}


@pytest.mark.parametrize("name", sorted(TOOL_REFUSALS))
def test_tool_refusals(tmp_path, name):
    extra, message = TOOL_REFUSALS[name]
    with pytest.raises(SystemExit, match=message):
        tool.main(["--device", "cpu", "--steps", "10", "--out", str(tmp_path / "s.json"), *extra])
    assert not (tmp_path / "s.json").exists()
