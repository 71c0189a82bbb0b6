"""The port's continuous batcher (``duodiff_tpu_torch/diffusion/continuous.py``)
against the JAX package's, case by case as ``tests/test_continuous.py``
holds the JAX one, and against the port's own sequential samplers.

Against JAX, both batchers run the same jobs with staggered admissions;
the port's jobs carry :class:`TableNoise` built from JAX's own threefry
sequence (the request key split into the carry and x_T's key, then one
split a step), so the port consumes exactly what the JAX batcher drew.
Tolerance 1e-4 (rtol and atol) in fp32, the sampler bound of
``tests/test_torch_sampling.py``. Against the port's bucket-1 sequential
samplers on the same ``torch.Generator`` (x_T, then a draw for each DDPM t
> 0 / DDIM s > 0): equal to the bit. Over a grid's data ranks the slots
must divide them; the batcher on two ranks is held through the server by
``tests/test_torch_serve_grid.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duodiff_tpu.config import UViTConfig as JaxConfig
from duodiff_tpu.diffusion import continuous as jcontinuous
from duodiff_tpu.diffusion import sampling as jsampling
from duodiff_tpu.diffusion.schedule import NoiseSchedule as JaxSchedule
from duodiff_tpu.models.uvit import init_uvit as jax_init_uvit
from duodiff_tpu_torch.config import UViTConfig
from duodiff_tpu_torch.diffusion import continuous, sampling
from duodiff_tpu_torch.diffusion.continuous import ContinuousDiffusionBatcher, TableNoise
from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
from duodiff_tpu_torch.models.uvit import UViT
from duodiff_tpu_torch.parallel.mesh import Grid
from duodiff_tpu_torch.utils.convert import uvit_state_dict_from_jax

torch.set_num_threads(1)

IMG = (8, 8, 3)
TOL = 1e-4
SCALE = 0.1


def stub_apply(x, t, y):
    """Batch-row-independent stub with label sensitivity (tests/test_continuous.py's)."""
    out = SCALE * x + 0.01 * t[:, None, None, None]
    if y is not None:
        out = out + 0.001 * y[:, None, None, None].to(torch.float32)
    return out


def jax_stub(params, x, t, y):
    out = params["scale"] * x + 0.01 * t[:, None, None, None]
    if y is not None:
        out = out + 0.001 * y[:, None, None, None].astype(jnp.float32)
    return out


JPARAMS = {"scale": jnp.float32(SCALE)}


def stub_anchor(x, t, y):
    """Anchor / cached pair whose delta depends on x, so a stale delta shows."""
    out = stub_apply(x, t, y)
    delta = x.mean(dim=(1, 2, 3))[:, None] * torch.ones((1, 4))
    return out + 0.05 * delta.mean(1)[:, None, None, None], delta


def stub_cached(x, t, y, d):
    return stub_apply(x, t, y) + 0.05 * d.mean(1)[:, None, None, None]


def jax_anchor(params, x, t, y):
    out = jax_stub(params, x, t, y)
    delta = jnp.mean(x, axis=(1, 2, 3))[:, None] * jnp.ones((1, 4))
    return out + 0.05 * jnp.mean(delta, axis=1)[:, None, None, None], delta


def jax_cached(params, x, t, y, d):
    return jax_stub(params, x, t, y) + 0.05 * jnp.mean(d, axis=1)[:, None, None, None]


def cache_tuple(every):
    return (stub_anchor, stub_cached, every, lambda x: torch.zeros((x.shape[0], 4)))


def jax_cache_tuple(every):
    return (jax_anchor, jax_cached, every, lambda x: jnp.zeros((x.shape[0], 4)))


def port_schedule(js: JaxSchedule) -> NoiseSchedule:
    """The port's schedule on the JAX schedule's own tables (torch's and
    XLA's fp32 cumprod differ by an ulp)."""
    return NoiseSchedule(*(torch.from_numpy(np.array(getattr(js, f.name)))
                           for f in dataclasses.fields(NoiseSchedule)))


def draw_rows(method, steps, n_steps):
    """The noise row of each transition: t (ddpm), s (ddim), none (dpm)."""
    if method == "ddpm":
        return list(range(steps - 1, -1, -1))
    if method == "ddim":
        return [int(s) for s in sampling.ddim_timestep_grid(steps, n_steps)[1:]]
    return None


def jax_job_noise(key, method, steps, n_steps=6, shape=IMG) -> TableNoise:
    """The JAX batcher's draws for one job as a TableNoise: x_T from the
    request key's second half; then, from the first half, one split a
    transition, its draw placed at the transition's noise row (zeroed
    where the row is 0, as the JAX batcher zeroes it)."""
    carry, init_key = jax.random.split(key)
    x_init = np.array(jax.random.normal(init_key, shape, jnp.float32))
    rows = draw_rows(method, steps, n_steps)
    if rows is None:
        return TableNoise(torch.from_numpy(x_init))
    table = np.zeros((steps,) + tuple(shape), np.float32)
    for row in rows:
        carry, zkey = jax.random.split(carry)
        if row > 0:
            table[row] = np.asarray(jax.random.normal(zkey, shape, jnp.float32))
    return TableNoise(torch.from_numpy(x_init), torch.from_numpy(table))


def seq_reference(method, generator, *, sched, apply=stub_apply, y=None, steps=6,
                  shape=(1,) + IMG):
    """The port's dedicated bucket-1 sequential run from ``generator``."""
    if method == "ddpm":
        sampler = sampling.DDPMSampler(apply, sched)
        x = sampler.init(generator, shape)
        return sampler.run(x, generator, sched.steps - 1, 0, y)[0].numpy()
    if method == "ddim":
        return sampling.ddim_sample(apply, generator, schedule=sched, shape=shape,
                                    ddim_steps=steps, y=y)[0][0].numpy()
    return sampling.dpm_solver_sample(apply, generator, schedule=sched, shape=shape,
                                      dpm_steps=steps, y=y)[0].numpy()


def gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("method", ["ddpm", "ddim", "dpm"])
def test_staggered_jobs_match_jax(method):
    """5 jobs through 2 slots (staggered admissions) on JAX's draws: the
    port's batcher against the JAX batcher."""
    js = JaxSchedule.create(steps=12)
    keys = [jax.random.PRNGKey(100 + j) for j in range(5)]
    want = jcontinuous.ContinuousDiffusionBatcher(
        jax_stub, js, img_shape=IMG, slots=2, params=JPARAMS, method=method, ddim_steps=6,
        dpm_steps=6, steps_per_poll=3,
    ).run_jobs([(k, None) for k in keys])
    got = ContinuousDiffusionBatcher(
        stub_apply, port_schedule(js), img_shape=IMG, slots=2, method=method, ddim_steps=6,
        dpm_steps=6, steps_per_poll=3,
    ).run_jobs([(jax_job_noise(k, method, 12), None) for k in keys])
    for j in range(5):
        np.testing.assert_allclose(got[j], np.asarray(want[j]), rtol=TOL, atol=TOL,
                                   err_msg=f"{method} job {j}")


@pytest.mark.parametrize("method", ["ddpm", "ddim", "dpm"])
def test_staggered_jobs_equal_bucket1_to_the_bit(method):
    """5 jobs through 2 slots == 5 dedicated bucket-1 sequential runs from
    the same generators, bit for bit."""
    sched = NoiseSchedule.create(steps=12)
    got = ContinuousDiffusionBatcher(
        stub_apply, sched, img_shape=IMG, slots=2, method=method, ddim_steps=6, dpm_steps=6,
        steps_per_poll=3,
    ).run_jobs([(gen(100 + j), None) for j in range(5)])
    for j in range(5):
        np.testing.assert_array_equal(got[j], seq_reference(method, gen(100 + j), sched=sched),
                                      err_msg=f"{method} job {j} diverged")


def test_table_noise_equals_the_sequential_noise_table():
    """A TableNoise job equals ddpm_loop driven by the same x_T and noise_table."""
    sched = NoiseSchedule.create(steps=12)
    rng = np.random.RandomState(0)
    x0 = torch.from_numpy(rng.randn(*IMG).astype(np.float32))
    table = torch.from_numpy(rng.randn(12, *IMG).astype(np.float32))
    got = ContinuousDiffusionBatcher(stub_apply, sched, img_shape=IMG, slots=3,
                                     steps_per_poll=4).run_jobs([(TableNoise(x0, table), None)])
    want = sampling.ddpm_loop(stub_apply, sched, "predict_noise", x0[None], None,
                              range(11, -1, -1), noise_table=table[:, None])
    np.testing.assert_array_equal(got[0], want[0].numpy())


def test_admission_mid_flight_is_isolated():
    """A job admitted while another is mid-trajectory gets the result it
    gets alone: slots do not interact."""
    sched = NoiseSchedule.create(steps=12)

    def fresh():
        return ContinuousDiffusionBatcher(stub_apply, sched, img_shape=IMG, slots=3,
                                          steps_per_poll=2)

    b = fresh()
    b.admit(0, gen(1))
    b.advance()  # slot 0 is now 2 steps in
    b.admit(1, gen(2))  # staggered join
    for _ in range(8):
        b.advance()
    ii, active = b.poll()
    assert active[0] and active[1] and not active[2]
    assert ii[0] == 12 and ii[1] == 12
    got_a, got_b = b.finish(0), b.finish(1)
    _, active = b.poll()
    assert not active.any()
    np.testing.assert_array_equal(fresh().run_jobs([(gen(2), None)])[0], got_b)
    np.testing.assert_array_equal(got_a, seq_reference("ddpm", gen(1), sched=sched))


@pytest.mark.parametrize("method", ["dpm", "ddpm"])
def test_conditional_and_guided_jobs_match_jax(method):
    """Per-slot labels flow through and the guided wrapper composes on the
    slot batch (one doubled mixed-t forward): against the JAX batcher, and
    against the port's guided sequential run to the bit."""
    js = JaxSchedule.create(steps=10)
    sched = port_schedule(js)
    guided = sampling.make_guided_apply(stub_apply, 2.0, null_label=9)
    keys = [jax.random.PRNGKey(7), jax.random.PRNGKey(8)]
    want = jcontinuous.ContinuousDiffusionBatcher(
        jsampling.make_guided_apply(jax_stub, 2.0, null_label=9), js, img_shape=IMG, slots=2,
        params=JPARAMS, method=method, dpm_steps=5, steps_per_poll=2, conditional=True,
    ).run_jobs([(keys[0], 3), (keys[1], 5)])
    batcher = ContinuousDiffusionBatcher(guided, sched, img_shape=IMG, slots=2, method=method,
                                         dpm_steps=5, steps_per_poll=2, conditional=True)
    got = batcher.run_jobs([(jax_job_noise(k, method, 10, 5), c) for k, c in zip(keys, (3, 5))])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=TOL, atol=TOL)
    assert not np.array_equal(got[0], got[1])
    own = batcher.run_jobs([(gen(3), 3), (gen(4), 5)])
    for img, seed, cid in zip(own, (3, 4), (3, 5)):
        want = seq_reference(method, gen(seed), sched=sched, apply=guided, steps=5,
                             y=torch.full((1,), cid, dtype=torch.long))
        np.testing.assert_array_equal(img, want)


def test_host_mirror_agrees_with_device():
    """The serving loop never reads the device to learn progress: the host
    mirror must agree with the device state exactly."""
    sched = NoiseSchedule.create(steps=12)
    b = ContinuousDiffusionBatcher(stub_apply, sched, img_shape=IMG, slots=3, steps_per_poll=5)
    b.admit(1, gen(0))
    b.advance()
    b.admit(0, gen(1))
    b.advance()
    ii, active = b.poll()
    assert b.steps_done == {1: 10, 0: 5}
    assert ii[1] == 10 and ii[0] == 5 and not active[2]
    assert b.finished() == [] and b.free_slots() == [2]
    b.advance()  # slot 1 clips at n_trans = 12
    ii, _ = b.poll()
    assert b.steps_done == {1: 12, 0: 10}
    assert ii[1] == 12 and ii[0] == 10
    assert b.finished() == [1]
    b.finish(1)
    assert sorted(b.free_slots()) == [1, 2]


def test_a_mesh_is_refused():
    """Over a grid's data ranks the slots must divide them (JAX's message);
    a grid that runs the batch whole on every rank splits nothing."""
    with pytest.raises(ValueError, match=r"slots \(8\) must be divisible by the mesh's 3 data "
                                         "shards"):
        ContinuousDiffusionBatcher(stub_apply, NoiseSchedule.create(steps=10), img_shape=IMG,
                                   slots=8, mesh=Grid(world=3, data=3))
    whole = ContinuousDiffusionBatcher(stub_apply, NoiseSchedule.create(steps=10),
                                       img_shape=IMG, slots=8,
                                       mesh=Grid(world=3, data=3, replicated=True))
    assert whole.mesh is None and whole.x.shape[0] == 8


def test_admit_many_finish_many_match_per_slot():
    """Batched admission and fetch equal per-slot admit() / finish() calls,
    partial waves over slots whose neighbours are mid-trajectory included."""
    sched = NoiseSchedule.create(steps=12)

    def fresh():
        return ContinuousDiffusionBatcher(stub_apply, sched, img_shape=IMG, slots=4,
                                          steps_per_poll=4, conditional=True)

    a = fresh()
    a.admit(2, gen(70), 1)
    a.advance()
    a.admit(0, gen(71), 2)
    a.admit(3, gen(72), 3)
    for _ in range(2):
        a.advance()
    out_a = {2: a.finish(2)}
    a.admit(1, gen(73), 4)
    for _ in range(3):
        a.advance()
    for s in (0, 3, 1):
        out_a[s] = a.finish(s)

    b = fresh()
    b.admit_many({2: (gen(70), 1)})
    b.advance()
    b.admit_many({0: (gen(71), 2), 3: (gen(72), 3)})
    for _ in range(2):
        b.advance()
    assert b.finished() == [2]
    (img2,) = b.finish_many([2])
    out_b = {2: img2}
    b.admit_many({1: (gen(73), 4)})
    for _ in range(3):
        b.advance()
    assert sorted(b.finished()) == [0, 1, 3]
    for s, img in zip((0, 3, 1), b.finish_many([0, 3, 1])):
        out_b[s] = img
    assert sorted(b.free_slots()) == [0, 1, 2, 3]
    for s in out_a:
        np.testing.assert_array_equal(out_a[s], out_b[s])
    b.admit_many({})  # an empty wave is a no-op
    assert b.finish_many([]) == []
    _, active = b.poll()
    assert not active.any()


def test_begin_finish_snapshot_survives_reuse():
    """begin_finish frees the slots at once but copies from a gather of the
    rows: re-admitting and advancing the same slots before materialize()
    must not change the deferred images."""
    sched = NoiseSchedule.create(steps=8)

    def fresh():
        return ContinuousDiffusionBatcher(stub_apply, sched, img_shape=IMG, slots=2,
                                          steps_per_poll=8, conditional=True)

    ref = fresh()
    ref.admit_many({0: (gen(200), 1), 1: (gen(201), 2)})
    ref.advance()
    imgs_ref = ref.finish_many([0, 1])

    b = fresh()
    b.admit_many({0: (gen(200), 1), 1: (gen(201), 2)})
    b.advance()
    materialize = b.begin_finish([0, 1])
    assert sorted(b.free_slots()) == [0, 1]  # freed before materialize
    b.admit_many({0: (gen(202), 3), 1: (gen(203), 4)})
    b.advance()
    for a, r in zip(materialize(), imgs_ref):
        np.testing.assert_array_equal(a, r)
    ref2 = fresh()
    ref2.admit_many({0: (gen(202), 3), 1: (gen(203), 4)})
    ref2.advance()
    for a, r in zip(b.finish_many([0, 1]), ref2.finish_many([0, 1])):
        np.testing.assert_array_equal(a, r)


def test_begin_finish_transform_runs_on_the_gathered_rows():
    """A decode passed to begin_finish sees the finished rows only, in order."""
    sched = NoiseSchedule.create(steps=4)
    b = ContinuousDiffusionBatcher(stub_apply, sched, img_shape=IMG, slots=3, steps_per_poll=4)
    b.admit_many({0: (gen(1), None), 2: (gen(2), None)})
    b.advance()
    x = b.x.clone()
    seen = []
    imgs = b.begin_finish([2, 0], transform=lambda r: seen.append(r.shape) or r * 2.0)()
    assert seen == [(2,) + IMG]
    np.testing.assert_array_equal(imgs[0], (x[2] * 2.0).numpy())
    np.testing.assert_array_equal(imgs[1], (x[0] * 2.0).numpy())


@pytest.mark.parametrize("kwargs,match", [
    (dict(slots=0), "slots"),
    (dict(slots=1, steps_per_poll=0), "steps_per_poll"),
    (dict(slots=1, method="euler"), "unknown method"),
    (dict(slots=1, method="dpm", parametrization="predict_previous"), "predict_noise"),
    # ddim takes epsilon-form output only: never misread x0 predictions as noise
    (dict(slots=1, method="ddim", parametrization="predict_original"), "predict_noise"),
], ids=["slots", "steps_per_poll", "method", "dpm_param", "ddim_param"])
def test_validation_errors(kwargs, match):
    with pytest.raises(ValueError, match=match):
        ContinuousDiffusionBatcher(stub_apply, NoiseSchedule.create(steps=10), img_shape=IMG,
                                   **kwargs)


def test_admission_refusals():
    b = ContinuousDiffusionBatcher(stub_apply, NoiseSchedule.create(steps=10), img_shape=IMG,
                                   slots=2)
    with pytest.raises(TypeError, match="Generator or a TableNoise"):
        b.admit(0, 123)
    with pytest.raises(ValueError, match="needs its table"):
        b.admit(0, TableNoise(torch.zeros(IMG)))
    b.admit(0, gen(0))
    with pytest.raises(ValueError, match="not a free slot"):
        b.admit(0, gen(1))
    with pytest.raises(ValueError, match="not a free slot"):
        b.admit(2, gen(1))


@pytest.mark.parametrize("method,steps,every", [
    ("ddpm", 13, 3),   # (steps - 1) % every == 0: the t-anchor covers a fresh slot's step
    ("dpm", 12, 2),    # index-anchored: any every
])
def test_cached_staggered_jobs_match_jax(method, steps, every):
    """5 jobs through 2 slots of a cached batcher (admissions held to
    phase-aligned waves): against the JAX batcher on its draws, and against
    the port's sequential cached run to the bit; caching is not a no-op."""
    js = JaxSchedule.create(steps=steps)
    sched = port_schedule(js)
    keys = [jax.random.PRNGKey(300 + j) for j in range(5)]
    want = jcontinuous.ContinuousDiffusionBatcher(
        jax_stub, js, img_shape=IMG, slots=2, params=JPARAMS, method=method, dpm_steps=6,
        steps_per_poll=2, cache=jax_cache_tuple(every),
    ).run_jobs([(k, None) for k in keys])
    batcher = ContinuousDiffusionBatcher(stub_apply, sched, img_shape=IMG, slots=2,
                                         method=method, dpm_steps=6, steps_per_poll=2,
                                         cache=cache_tuple(every))
    got = batcher.run_jobs([(jax_job_noise(k, method, steps), None) for k in keys])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=TOL, atol=TOL)
    own = batcher.run_jobs([(gen(300 + j), None) for j in range(3)])
    for j, img in enumerate(own):
        g = gen(300 + j)
        if method == "ddpm":
            sampler = sampling.DDPMSampler(
                sampling.make_block_cached_apply(stub_anchor, stub_cached, every, steps - 1),
                sched, init_state_fn=cache_tuple(every)[3])
            x = sampler.init(g, (1,) + IMG)
            seq = sampler.run(x, g, steps - 1, 0, state=cache_tuple(every)[3](x))[0]
        else:
            seq = sampling.dpm_solver_sample(None, g, schedule=sched, shape=(1,) + IMG,
                                             dpm_steps=6, cache=cache_tuple(every))
        np.testing.assert_array_equal(img, seq[0].numpy())
    dense = seq_reference(method, gen(300), sched=sched)
    assert np.any(own[0] != dense)


def test_cached_admission_gating():
    """Admitting off-phase raises (a silent accept would consume a stale
    delta on the new slot's first step); run_jobs defers and completes."""
    sched = NoiseSchedule.create(steps=13)
    b = ContinuousDiffusionBatcher(stub_apply, sched, img_shape=IMG, slots=1, steps_per_poll=1,
                                   cache=cache_tuple(3))
    assert b.can_admit_cached()
    b.admit(0, gen(0))
    b.advance()  # w = 1: off-phase
    assert not b.can_admit_cached()
    with pytest.raises(RuntimeError, match="phase-aligned"):
        b.admit_many({0: (gen(1), None)})
    b2 = ContinuousDiffusionBatcher(stub_apply, sched, img_shape=IMG, slots=1, steps_per_poll=2,
                                    cache=cache_tuple(3))
    assert len(b2.run_jobs([(gen(5), None), (gen(6), None)])) == 2


@pytest.mark.parametrize("method,every,match", [
    ("ddim", 3, "ddpm/dpm"),
    # 10 steps: (steps - 1) = 9 and every 2 leave a fresh slot's first step
    # un-anchored
    ("ddpm", 2, "anchor"),
    # bool is an int subclass: True must not silently mean every = 1
    ("ddpm", True, "int or a pattern"),
    ("ddpm", 0, ">= 1"),
    # dpm anchors on its own solver-grid indices, never on a wave pattern
    ("dpm", np.array([1, 0], bool), "method='ddpm' only"),
    # a fresh slot's first step needs a real delta
    ("ddpm", np.array([0, 1], bool), r"pattern\[0\] True"),
], ids=["ddim", "unanchored_first_step", "bool", "zero", "dpm_pattern", "pattern_first_off"])
def test_cached_validation(method, every, match):
    with pytest.raises(ValueError, match=match):
        ContinuousDiffusionBatcher(stub_apply, NoiseSchedule.create(steps=10), img_shape=IMG,
                                   slots=1, method=method, cache=cache_tuple(every))


def test_pattern_table_helpers_match_jax():
    """periodic_pattern_table and fold_table_to_pattern equal JAX's: the
    round trip, the uniform special case, and the two refusals (aperiodic;
    t = T-1 not an anchor)."""
    from duodiff_tpu_torch.diffusion.cache_schedule import uniform_table

    pat = np.array([1, 0, 1, 0, 0], bool)
    table = continuous.periodic_pattern_table(pat, 11)
    np.testing.assert_array_equal(table, jcontinuous.periodic_pattern_table(pat, 11))
    assert table[10]
    np.testing.assert_array_equal(continuous.fold_table_to_pattern(table), pat)
    np.testing.assert_array_equal(continuous.fold_table_to_pattern(uniform_table(3, 13)),
                                  np.array([1, 0, 0], bool))
    t = np.zeros(12, bool)
    t[[11, 8, 3]] = True
    assert continuous.fold_table_to_pattern(t) is None is jcontinuous.fold_table_to_pattern(t)
    assert continuous.fold_table_to_pattern(uniform_table(2, 32)) is None
    with pytest.raises(ValueError, match="pattern"):
        continuous.periodic_pattern_table([0, 1], 8)


def test_pattern_cached_staggered_jobs_match_jax():
    """A wave-index anchor pattern through 2 slots: against the JAX batcher,
    and to the bit against the port's sequential cached sampler on the
    equivalent absolute-t table; the pattern is not a no-op."""
    pat = np.array([1, 0, 1, 0, 0], bool)
    steps = 11
    js = JaxSchedule.create(steps=steps)
    sched = port_schedule(js)
    keys = [jax.random.PRNGKey(600 + j) for j in range(5)]
    want = jcontinuous.ContinuousDiffusionBatcher(
        jax_stub, js, img_shape=IMG, slots=2, params=JPARAMS, method="ddpm", steps_per_poll=2,
        cache=jax_cache_tuple(pat),
    ).run_jobs([(k, None) for k in keys])
    batcher = ContinuousDiffusionBatcher(stub_apply, sched, img_shape=IMG, slots=2,
                                         steps_per_poll=2, cache=cache_tuple(pat))
    got = batcher.run_jobs([(jax_job_noise(k, "ddpm", steps), None) for k in keys])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=TOL, atol=TOL)
    table = continuous.periodic_pattern_table(pat, steps)
    sampler = sampling.DDPMSampler(
        sampling.make_block_cached_apply(stub_anchor, stub_cached, table, steps - 1), sched,
        init_state_fn=cache_tuple(pat)[3])
    own = batcher.run_jobs([(gen(600 + j), None) for j in range(3)])
    for j, img in enumerate(own):
        g = gen(600 + j)
        x = sampler.init(g, (1,) + IMG)
        np.testing.assert_array_equal(img, sampler.run(x, g, steps - 1, 0,
                                                       state=sampler.init_state_fn(x))[0][0])
    assert np.any(own[0] != seq_reference("ddpm", gen(600), sched=sched))


@pytest.mark.parametrize("method,pattern,match", [
    ("ddpm", [0, 1], r"pattern\[0\]"),
    ("dpm", [1, 0], "ddpm"),
], ids=["first_not_anchor", "dpm"])
def test_pattern_cached_validation(method, pattern, match):
    with pytest.raises(ValueError, match=match):
        ContinuousDiffusionBatcher(stub_apply, NoiseSchedule.create(steps=11), img_shape=IMG,
                                   slots=1, method=method, dpm_steps=6,
                                   cache=cache_tuple(np.array(pattern, bool)))


@pytest.mark.parametrize("parametrization", ["predict_noise", "predict_original",
                                             "predict_previous"])
@pytest.mark.parametrize("variance_mode", ["beta", "beta_tilde"])
def test_per_row_step_equals_the_int_step(parametrization, variance_mode):
    """NoiseSchedule.step on a (B,) tensor of per-row timesteps equals, row
    by row, the step at each row's int t, to the bit; likewise ddim_step."""
    sched = NoiseSchedule.create(steps=20)
    rng = np.random.RandomState(1)
    shape = (4, 5, 5, 3)
    mo, x, z = (torch.from_numpy(rng.randn(*shape).astype(np.float32)) for _ in range(3))
    ts = [19, 7, 0, 1]
    got = sched.step(parametrization, mo, x, torch.tensor(ts), z, variance_mode)
    for r, t in enumerate(ts):
        want = sched.step(parametrization, mo[r:r + 1], x[r:r + 1], t, z[r:r + 1], variance_mode)
        assert torch.equal(got[r:r + 1], want)
    ss = [12, 3, 0, 0]
    got = sched.ddim_step(mo, x, torch.tensor([19, 7, 2, 1]), torch.tensor(ss), z, eta=0.5)
    for r, (t, s) in enumerate(zip((19, 7, 2, 1), ss)):
        want = sched.ddim_step(mo[r:r + 1], x[r:r + 1], t, s, z[r:r + 1], eta=0.5)
        assert torch.equal(got[r:r + 1], want)


# --- a tiny U-ViT whose weights cross over from JAX ---------------------------

SMALL = dict(img_size=8, patch_size=2, in_chans=3, embed_dim=32, num_heads=2, mlp_ratio=2,
             depth=3)
UVIT_STEPS = 7
N_OUTER = 1


@pytest.fixture(scope="module")
def uvit():
    """(JAX apply (params, x, t, y), its params, its anchor / cached, the port's UViT)."""
    jmodel, params = jax_init_uvit(JaxConfig(**SMALL), jax.random.PRNGKey(0),
                                   dtype=jnp.float32, attn_impl="xla")
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rng.randn(*a.shape).astype(np.float32), params)
    model = UViT(UViTConfig(**SMALL), dtype=torch.float32, attn_impl="plain")
    model.load_state_dict(uvit_state_dict_from_jax(params), strict=True)
    model.eval().pack_for_kernels()

    def japply(p, x, t, y):
        return jmodel.apply({"params": p}, x, t, y)

    def janchor(p, x, t, y):
        return jmodel.apply({"params": p}, x, t, y, n_outer=N_OUTER, method=jmodel.forward_anchor)

    def jcached(p, x, t, y, d):
        return jmodel.apply({"params": p}, x, t, y, n_outer=N_OUTER, delta=d,
                            method=jmodel.forward_cached)

    return japply, params, (janchor, jcached), model


@pytest.mark.parametrize("method,cache_every", [
    ("ddpm", None), ("ddim", None), ("dpm", None), ("ddpm", 3), ("dpm", 2),
], ids=["ddpm", "ddim", "dpm", "ddpm_cached", "dpm_cached"])
def test_uvit_jobs_match_jax(uvit, method, cache_every):
    """3 jobs through 2 slots of a depth-3 U-ViT (fp32, the JAX weights
    crossed over): the port's batcher against the JAX batcher on JAX's
    draws, cached and uncached."""
    japply, params, (janchor, jcached), model = uvit
    js = JaxSchedule.create(steps=UVIT_STEPS)
    tokens = model.config.extras + model.config.num_patches
    jcache = cache = None
    if cache_every is not None:
        jcache = (janchor, jcached, cache_every,
                  lambda x: jnp.zeros((x.shape[0], tokens, SMALL["embed_dim"]), jnp.float32))
        cache = (lambda x, t, y: model.forward_anchor(x, t, y, n_outer=N_OUTER),
                 lambda x, t, y, d: model.forward_cached(x, t, y, n_outer=N_OUTER, delta=d),
                 cache_every,
                 lambda x: torch.zeros((x.shape[0], tokens, SMALL["embed_dim"])))
    keys = [jax.random.PRNGKey(40 + j) for j in range(3)]
    kw = dict(img_shape=IMG, slots=2, method=method, ddim_steps=4, dpm_steps=4, steps_per_poll=2)
    want = jcontinuous.ContinuousDiffusionBatcher(japply, js, params=params, cache=jcache,
                                                  **kw).run_jobs([(k, None) for k in keys])
    with torch.no_grad():
        got = ContinuousDiffusionBatcher(model, port_schedule(js), cache=cache, **kw).run_jobs(
            [(jax_job_noise(k, method, UVIT_STEPS, 4), None) for k in keys])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=TOL, atol=TOL)
