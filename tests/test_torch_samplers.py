"""The port's other samplers against the JAX package's: ``ddim_step``, the
DDIM grid and sampler (with the DuoDiff handoff and snapshots), the
DPM-Solver++ tables and sampler (orders 1 and 2, with and without block
caching), heavy-light interleaving, ``aux_fn`` rows and ``ddpm_sample``'s
snapshots, on JAX-initialised weights carried across; and the sampling
CLI's new flags, runs and refusals on a tiny config.

Tolerances: the step arithmetic on shared tables is held at 1e-6 (fp32);
the DPM tables at 1e-5 relative (torch's and XLA's fp32 cumprod differ by
an ulp); whole trajectories at rtol/atol 1e-4, the sampler bound of
``tests/test_torch_sampling.py``."""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duodiff_tpu.config import UViTConfig as JaxConfig
from duodiff_tpu.diffusion import sampling as jsampling
from duodiff_tpu.diffusion.schedule import NoiseSchedule as JaxSchedule
from duodiff_tpu.models.uvit import init_uvit as jax_init_uvit
from duodiff_tpu_torch import sample
from duodiff_tpu_torch.config import UViTConfig
from duodiff_tpu_torch.diffusion import sampling
from duodiff_tpu_torch.diffusion.cache_schedule import save_cache_schedule
from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
from duodiff_tpu_torch.models.uvit import UViT
from duodiff_tpu_torch.utils.convert import uvit_state_dict_from_jax

torch.set_num_threads(1)

STEPS, T_SWITCH, BATCH, DDIM_STEPS = 20, 6, 2, 8
SMALL = dict(img_size=16, patch_size=4, in_chans=3, embed_dim=64, num_heads=4, mlp_ratio=4)
SHAPE = (BATCH, 16, 16, 3)
TOL = 1e-4
N_OUTER = 1


def _models(depth, seed):
    """(JAX model, its params, the port's model with the same weights)."""
    kw = dict(SMALL, depth=depth)
    jmodel, params = jax_init_uvit(JaxConfig(**kw), jax.random.PRNGKey(seed),
                                   dtype=jnp.float32, attn_impl="fused")
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rng.randn(*a.shape).astype(np.float32), params)
    model = UViT(UViTConfig(**kw), dtype=torch.float32, attn_impl="fused")
    model.load_state_dict(uvit_state_dict_from_jax(params), strict=True)
    model.pack_for_kernels()
    return jmodel, params, model


@pytest.fixture(scope="module")
def pair():
    """(early, late): each (JAX apply (x, t, y), JAX model, params, port model)."""
    out = []
    for depth, seed in ((3, 0), (5, 1)):
        jmodel, params, model = _models(depth, seed)
        out.append(((lambda x, t, y, m=jmodel, p=params: m.apply({"params": p}, x, t, y)),
                    jmodel, params, model))
    return out


def _noise(seed=3):
    rng = np.random.RandomState(seed)
    table = rng.randn(STEPS, *SHAPE).astype(np.float32)
    table[0] = 0.0
    return rng.randn(*SHAPE).astype(np.float32), table


def _port_schedule_from(js: JaxSchedule) -> NoiseSchedule:
    """The port's schedule on the JAX schedule's own tables."""
    return NoiseSchedule(*(torch.from_numpy(np.array(getattr(js, f.name)))
                           for f in dataclasses.fields(NoiseSchedule)))


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_step_matches_jax(eta):
    js = JaxSchedule.create(steps=STEPS)
    ts = _port_schedule_from(js)
    rng = np.random.RandomState(0)
    x, eps, z = (rng.randn(*SHAPE).astype(np.float32) for _ in range(3))
    for t, s in ((19, 16), (13, 10), (5, 2), (2, 0)):
        want = js.ddim_step(jnp.asarray(eps), jnp.asarray(x), t, s, jnp.asarray(z), eta=eta)
        got = ts.ddim_step(torch.from_numpy(eps), torch.from_numpy(x), t, s,
                           torch.from_numpy(z), eta=eta)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_ddim_step_on_the_ports_own_tables_matches_jax():
    js, ts = JaxSchedule.create(steps=STEPS), NoiseSchedule.create(steps=STEPS)
    rng = np.random.RandomState(1)
    x, eps, z = (rng.randn(*SHAPE).astype(np.float32) for _ in range(3))
    want = js.ddim_step(jnp.asarray(eps), jnp.asarray(x), 13, 10, jnp.asarray(z), eta=0.5)
    got = ts.ddim_step(torch.from_numpy(eps), torch.from_numpy(x), 13, 10,
                       torch.from_numpy(z), eta=0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("steps,n", [(1000, 50), (1000, 20), (20, 8), (20, 25), (7, 7), (100, 3)])
def test_ddim_grid_equals_jax(steps, n):
    got = sampling.ddim_timestep_grid(steps, n)
    want = jsampling.ddim_timestep_grid(steps, n)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_ddim_pairs_follow_the_reference_switch():
    early, late = sampling.ddim_pairs(1000, 50, 300)
    assert (len(early), len(late)) == (16, 33)
    assert early[-1][0] < 700 <= early[-2][0] and late[-1][1] == 0
    assert sampling.ddim_pairs(STEPS, DDIM_STEPS)[1] == []


@pytest.mark.parametrize("save", [(), (4, 12, 3, 18)])
def test_ddim_duodiff_trajectory_matches_jax(pair, save):
    (j_early, *_, t_early), (j_late, *_, t_late) = pair
    x0, _ = _noise()
    want, want_inter = jsampling.ddim_sample(
        j_early, jax.random.PRNGKey(0), schedule=JaxSchedule.create(steps=STEPS), shape=SHAPE,
        ddim_steps=DDIM_STEPS, eta=0.0, timesteps_save=save, x_init=jnp.asarray(x0),
        late_apply_fn=j_late, t_switch=T_SWITCH,
    )
    with torch.no_grad():
        got, got_inter = sampling.ddim_sample(
            t_early, None, schedule=NoiseSchedule.create(steps=STEPS), shape=SHAPE,
            ddim_steps=DDIM_STEPS, eta=0.0, timesteps_save=save,
            x_init=torch.from_numpy(x0), late_apply_fn=t_late, t_switch=T_SWITCH,
        )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    assert len(got_inter) == len(want_inter) == len([s for s in save if s != 3])
    for g, w in zip(got_inter, want_inter):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)


def test_ddim_noise_table_matches_a_jax_loop_at_eta_half(pair):
    """DDIM with eta > 0 draws noise: the port's noise_table (row s for the
    pair (t, s)) against a loop over JAX's model and ddim_step on that table."""
    j_apply, *_, model = pair[0]
    x0, table = _noise(5)
    js = JaxSchedule.create(steps=STEPS)
    x = jnp.asarray(x0)
    for t, s in sampling.ddim_pairs(STEPS, DDIM_STEPS)[0]:
        eps = j_apply(x, jnp.full((BATCH,), t, jnp.float32), None)
        x = js.ddim_step(eps, x, t, s, jnp.asarray(table[s]) * (s > 0), eta=0.5)
    with torch.no_grad():
        got, _ = sampling.ddim_sample(
            model, None, schedule=NoiseSchedule.create(steps=STEPS), shape=SHAPE,
            ddim_steps=DDIM_STEPS, eta=0.5, x_init=torch.from_numpy(x0),
            noise_table=torch.from_numpy(table))
    np.testing.assert_allclose(got.numpy(), np.asarray(x), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dpm_steps", [20, 8, 2])
def test_dpm_solver_tables_match_jax(dpm_steps):
    """On the 1000-step schedule the CLIs run. alphas_bar lies within 1e-4
    of 1 at small t, where an ulp of it moves 1 - alphas_bar by up to 1e-3
    relative; with grid points close together there (a 20-step schedule, or
    50 and more points) the ratios carry that past 1e-5, so the next test
    holds those grids on shared tables, to the bit."""
    want = jsampling.dpm_solver_tables(JaxSchedule.create(steps=1000), dpm_steps)
    got = sampling.dpm_solver_tables(NoiseSchedule.create(steps=1000), dpm_steps)
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].dtype == torch.float32 and got[k].shape == v.shape, k
        np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-5, atol=0, err_msg=k)
    assert got["t_prev_host"] == [int(t) for t in np.asarray(want["t_prev"])]


@pytest.mark.parametrize("steps,dpm_steps", [(STEPS, 8), (STEPS, 30), (1000, 50), (1000, 1500)])
def test_dpm_solver_tables_on_jax_tables_are_equal_to_the_bit(steps, dpm_steps):
    js = JaxSchedule.create(steps=steps)
    want = jsampling.dpm_solver_tables(js, dpm_steps)
    got = sampling.dpm_solver_tables(_port_schedule_from(js), dpm_steps)
    for k, v in want.items():
        assert np.array_equal(got[k].numpy(), np.asarray(v)), k


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("parametrization", ["predict_noise", "predict_original"])
def test_dpm_solver_trajectory_matches_jax(pair, order, cached, parametrization):
    j_apply, jmodel, params, model = pair[1]
    x0, _ = _noise(7)
    cache_j = cache_t = None
    if cached:
        cache_j = (
            lambda x, t, y: jmodel.apply({"params": params}, x, t, y, n_outer=N_OUTER,
                                         method=jmodel.forward_anchor),
            lambda x, t, y, d: jmodel.apply({"params": params}, x, t, y, n_outer=N_OUTER,
                                            delta=d, method=jmodel.forward_cached),
            2, lambda x: jnp.zeros((x.shape[0], 17, 64), jnp.float32),
        )
        cache_t = (
            lambda x, t, y: model.forward_anchor(x, t, y, n_outer=N_OUTER),
            lambda x, t, y, d: model.forward_cached(x, t, y, n_outer=N_OUTER, delta=d),
            2, lambda x: torch.zeros((x.shape[0], 17, 64)),
        )
    want = jsampling.dpm_solver_sample(
        j_apply, jax.random.PRNGKey(0), schedule=JaxSchedule.create(steps=STEPS), shape=SHAPE,
        dpm_steps=10, order=order, parametrization=parametrization, x_init=jnp.asarray(x0),
        cache=cache_j)
    with torch.no_grad():
        got = sampling.dpm_solver_sample(
            model, None, schedule=NoiseSchedule.create(steps=STEPS), shape=SHAPE, dpm_steps=10,
            order=order, parametrization=parametrization, x_init=torch.from_numpy(x0),
            cache=cache_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_dpm_cache_anchors_by_transition_index():
    """Transition i anchors where i % every == 0; the others take the cached call."""
    calls = []

    def anchor(x, t, y):
        calls.append(("anchor", int(t[0])))
        return 0.1 * x, torch.zeros(1)

    def cached(x, t, y, d):
        calls.append(("cached", int(t[0])))
        return 0.1 * x

    sampling.dpm_solver_sample(
        None, None, schedule=NoiseSchedule.create(steps=STEPS), shape=SHAPE, dpm_steps=8,
        x_init=torch.zeros(SHAPE), cache=(anchor, cached, 3, lambda x: torch.zeros(1)))
    grid = sampling.ddim_timestep_grid(STEPS, 8)
    assert calls == [("anchor" if i % 3 == 0 else "cached", int(t))
                     for i, t in enumerate(grid[:-1])]


def test_dpm_order_one_equals_ddim_at_eta_zero(pair):
    *_, model = pair[0]
    x0, _ = _noise(9)
    sched = NoiseSchedule.create(steps=STEPS)
    with torch.no_grad():
        a = sampling.dpm_solver_sample(model, None, schedule=sched, shape=SHAPE, dpm_steps=12,
                                       order=1, x_init=torch.from_numpy(x0))
        b, _ = sampling.ddim_sample(model, None, schedule=sched, shape=SHAPE, ddim_steps=12,
                                    eta=0.0, x_init=torch.from_numpy(x0))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("every", [1, 3, 4])
def test_interleaved_trajectory_and_aux_rows_match_jax(pair, every):
    """make_interleaved_apply on the JAX package's params pair through
    ddpm_scan with aux_fn, against the port's host-branch form through
    ddpm_loop with aux_fn, on one noise table."""
    (_, je, pe, te), (_, jl, pl, tl) = pair
    x0, table = _noise(11)
    japply = jsampling.make_interleaved_apply(
        lambda p, x, t, y: jl.apply({"params": p}, x, t, y),
        lambda p, x, t, y: je.apply({"params": p}, x, t, y), every)
    want, _, (w_mean, w_std) = jsampling.ddpm_scan(
        lambda x, t, y: japply({"full": pl, "shallow": pe}, x, t, y),
        JaxSchedule.create(steps=STEPS), "predict_noise", jnp.asarray(x0),
        jax.random.PRNGKey(0), jnp.arange(STEPS - 1, -1, -1),
        aux_fn=lambda mo: (mo, (jnp.mean(mo), jnp.std(mo))), noise_table=jnp.asarray(table))
    with torch.no_grad():
        got, state, (g_mean, g_std) = sampling.ddpm_loop(
            sampling.make_interleaved_apply(tl, te, every), NoiseSchedule.create(steps=STEPS),
            "predict_noise", torch.from_numpy(x0), None, range(STEPS - 1, -1, -1),
            noise_table=torch.from_numpy(table), state=(),
            aux_fn=lambda mo: (mo, (mo.mean(), mo.std(unbiased=False))))
    assert state == ()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    assert g_mean.shape == (STEPS,) and g_std.shape == (STEPS,)
    np.testing.assert_allclose(g_mean.numpy(), np.asarray(w_mean), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(g_std.numpy(), np.asarray(w_std), rtol=TOL, atol=TOL)


def test_interleaving_picks_the_model_on_the_host():
    seen = []
    apply = sampling.make_interleaved_apply(lambda x, t, y: seen.append("full") or x,
                                            lambda x, t, y: seen.append("shallow") or x, 4)
    for t in (9, 8, 4, 1, 0):
        out, st = apply("state", torch.zeros(1), torch.full((1,), float(t)), None, t)
        assert st == "state"
    assert seen == ["shallow", "full", "full", "shallow", "full"]
    with pytest.raises(ValueError):
        sampling.make_interleaved_apply(None, None, 0)


def test_aux_rows_stay_on_the_loop_device_and_in_step_order():
    sched = NoiseSchedule.create(steps=5)
    x, rows = sampling.ddpm_loop(lambda x, t, y: torch.zeros_like(x), sched, "predict_noise",
                                 torch.ones(1, 2), None, range(4, -1, -1),
                                 noise_table=torch.zeros(5, 1, 2),
                                 aux_fn=lambda mo: (mo, mo.sum() + 7))
    assert torch.equal(rows, torch.full((5,), 7.0))


@pytest.mark.parametrize("save", [(5,), (20, 1, 12, 25, 0)])
def test_ddpm_sample_snapshots_match_jax_scans(pair, save):
    j_apply, *_, model = pair[0]
    x0, table = _noise(13)
    js = JaxSchedule.create(steps=STEPS)
    with torch.no_grad():
        got, inter = sampling.ddpm_sample(
            model, None, schedule=NoiseSchedule.create(steps=STEPS), shape=SHAPE,
            timesteps_save=save, x_init=torch.from_numpy(x0),
            noise_table=torch.from_numpy(table))
    valid = [s for s in save if 1 <= s <= STEPS]
    assert len(inter) == len(valid)
    for s, g in zip(valid + [STEPS], inter + [got]):
        want, _ = jsampling.ddpm_scan(
            j_apply, js, "predict_noise", jnp.asarray(x0), jax.random.PRNGKey(0),
            jnp.arange(STEPS - 1, STEPS - s - 1, -1), noise_table=jnp.asarray(table))
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


# ----------------------------------------------------------------- the CLI

def _write_config(path, depth):
    path.write_text("model_params:\n" + "".join(
        f"  {k}: {v}\n" for k, v in dict(SMALL, depth=depth).items()))
    return str(path)


@pytest.fixture(scope="module")
def configs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cfg")
    return _write_config(d / "tiny3.yaml", 3), _write_config(d / "tiny5.yaml", 5)


def _argv(configs, out, *extra, late=True):
    argv = ["--device", "cpu", "--random_init", "--config_path", configs[0],
            "--num_timesteps", str(STEPS), "--batch_size", str(BATCH),
            "--parametrization", "predict_noise", "--output_folder", str(out)]
    if late:
        argv += ["--config_path_late", configs[1]]
    return argv + list(extra)


REFUSALS = {
    "interleave_without_pair": ((False, "--interleave_every", "2"), "--interleave_every needs"),
    "interleave_with_t_switch": ((True, "--interleave_every", "2", "--t_switch", "6"),
                                 "--interleave_every supports"),
    "interleave_with_ddim": ((True, "--interleave_every", "2", "--use_ddim"),
                             "--interleave_every supports"),
    "interleave_with_dpm": ((True, "--interleave_every", "2", "--use_dpm_solver"),
                            "--interleave_every supports"),
    "interleave_with_saves": ((True, "--interleave_every", "2", "--timesteps_save", "5"),
                              "--interleave_every supports"),
    "interleave_zero": ((True, "--interleave_every", "0"), "--interleave_every must be"),
    "cache_with_ddim": ((False, "--use_ddim", "--cache_every", "2"), "--cache_every/"),
    "cache_with_interleave": ((True, "--interleave_every", "2", "--cache_every", "2"),
                              "--cache_every/"),
    "cache_with_guidance": ((False, "--cache_every", "2", "--class_id", "1",
                             "--guidance_scale", "2"), "--guidance_scale"),
    "dpm_with_cache_schedule": ((False, "--use_dpm_solver", "--cache_schedule", "{schedule}"),
                                "--cache_schedule is t-indexed"),
    "dpm_cached_with_pair": ((True, "--use_dpm_solver", "--cache_every", "2", "--t_switch", "6"),
                             "single-model solver"),
    "dpm_predict_previous": ((False, "--use_dpm_solver", "--parametrization",
                              "predict_previous"), "predict_noise/predict_original"),
    # the port's own: the JAX CLI samples the shallow model alone here
    "dpm_with_late_model": ((True, "--use_dpm_solver", "--t_switch", "6"), "samples one model"),
    "dpm_with_late_model_no_switch": ((True, "--use_dpm_solver"), "DuoDiff needs both"),
    "dpm_with_saves": ((False, "--use_dpm_solver", "--timesteps_save", "5"),
                       "--use_dpm_solver keeps no"),
    "dpm_one_step": ((False, "--use_dpm_solver", "--dpm_steps", "1"), "--dpm_steps must be"),
    # the port's own: the JAX CLI shifts every later label here
    "ddim_unreachable_save": ((True, "--use_ddim", "--t_switch", "6", "--ddim_steps", "8",
                               "--timesteps_save", "4", "3"), "--use_ddim keeps the state"),
    "ddim_half_pair": ((True, "--use_ddim"), "DuoDiff needs both"),
    "cache_outer_alone": ((False, "--cache_outer", "1"), "--cache_outer requires"),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_cli_refusals(configs, tmp_path, name):
    (late, *extra), message = REFUSALS[name]
    schedule = tmp_path / "schedule.json"
    save_cache_schedule(schedule, np.arange(STEPS) % 4 == 0)
    extra = [str(schedule) if a == "{schedule}" else a for a in extra]
    argv = _argv(configs, tmp_path / "out", *extra, late=late)
    if "--parametrization" in extra:
        i = argv.index("--parametrization")
        del argv[i:i + 2]
    with pytest.raises(SystemExit, match=re.escape(message)):
        sample.main(argv)
    assert not (tmp_path / "out" / "samples.npy").exists()


def test_cli_ddim_pair_keeps_the_grid_states(configs, tmp_path):
    out = sample.main(_argv(configs, tmp_path, "--use_ddim", "--ddim_steps", str(DDIM_STEPS),
                            "--t_switch", str(T_SWITCH), "--timesteps_save", "4", "18"))
    assert sorted(out["intermediates"]) == [4, 18]
    assert out["samples"].shape == (BATCH, 16, 16, 3) and np.isfinite(out["samples"]).all()
    assert (tmp_path / "0_4.png").exists() and (tmp_path / "1_18.png").exists()


def test_cli_ddim_equals_the_library_run(configs, tmp_path):
    """The CLI's DDIM run is ddim_sample on its two models and its generator."""
    from duodiff_tpu_torch.utils.model_loading import load_model

    out = sample.main(_argv(configs, tmp_path, "--use_ddim", "--ddim_steps", str(DDIM_STEPS),
                            "--t_switch", str(T_SWITCH), "--ddim_eta", "0.3", "--seed", "4"))
    early = load_model(configs[0], device="cpu", seed=4)[0].eval()
    late = load_model(configs[1], device="cpu", seed=5)[0].eval()
    early.pack_for_kernels()
    late.pack_for_kernels()
    g = torch.Generator().manual_seed(4)
    with torch.inference_mode():
        x = torch.randn(SHAPE, generator=g)
        want, _ = sampling.ddim_sample(
            early, g, schedule=NoiseSchedule.create(steps=STEPS), shape=SHAPE,
            ddim_steps=DDIM_STEPS, eta=0.3, x_init=x, late_apply_fn=late, t_switch=T_SWITCH)
    np.testing.assert_array_equal(out["samples"], ((want + 1) / 2).numpy())


@pytest.mark.parametrize("extra", [
    ("--interleave_every", "3"),
    ("--use_dpm_solver", "--dpm_order", "1"),
    ("--use_dpm_solver", "--cache_every", "2", "--attn_impl", "fused_int8", "--gelu_approx"),
], ids=["interleave", "dpm1", "dpm2_cached_int8"])
def test_cli_other_samplers_run(configs, tmp_path, extra):
    late = extra[0] == "--interleave_every"
    out = sample.main(_argv(configs, tmp_path, *extra, late=late))
    assert out["samples"].shape == (BATCH, 16, 16, 3) and np.isfinite(out["samples"]).all()
    assert np.load(tmp_path / "samples.npy").dtype == np.uint8


def test_cli_guided_ddim_runs(tmp_path):
    config = tmp_path / "cond.yaml"
    config.write_text("model_params:\n" + "".join(
        f"  {k}: {v}\n" for k, v in dict(SMALL, depth=3, num_classes=5).items()))
    out = sample.main(["--device", "cpu", "--random_init", "--config_path", str(config),
                       "--num_timesteps", str(STEPS), "--batch_size", str(BATCH),
                       "--parametrization", "predict_noise", "--output_folder",
                       str(tmp_path / "out"), "--use_ddim", "--ddim_steps", "5",
                       "--class_id", "-1", "--guidance_scale", "1.5"])
    assert np.isfinite(out["samples"]).all()
