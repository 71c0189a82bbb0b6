"""The port's block caching against the JAX package: UViT.forward_anchor /
forward_cached on JAX-initialised weights carried across,
make_block_cached_apply and the stateful sampler contract, a block-cached
DuoDiff trajectory driven by one injected noise table, and the anchor
schedule reader on the committed assets.

Tolerances, fp32 throughout: forward_anchor's prediction equals the
port's own forward exactly, forward_cached at the anchor's own x is within
1e-5 of it (the JAX test's bound: region_in + delta rounds once more); both
against JAX's within 1e-4, the bound of the port's fp32 forward
(tests/test_torch_uvit.py); the 20-step trajectory within 1e-4 (as
tests/test_torch_sampling.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duodiff_tpu.config import UViTConfig as JaxConfig
from duodiff_tpu.diffusion import cache_schedule as jax_cs
from duodiff_tpu.diffusion.sampling import ddpm_scan
from duodiff_tpu.diffusion.sampling import make_block_cached_apply as jax_cached_apply
from duodiff_tpu.diffusion.schedule import NoiseSchedule as JaxSchedule
from duodiff_tpu.models.uvit import init_uvit as jax_init_uvit
from duodiff_tpu_torch.config import UViTConfig
from duodiff_tpu_torch.diffusion import cache_schedule as cs
from duodiff_tpu_torch.diffusion.sampling import (
    DDPMSampler,
    ddpm_loop,
    make_block_cached_apply,
)
from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
from duodiff_tpu_torch.models.uvit import UViT
from duodiff_tpu_torch.utils.convert import uvit_state_dict_from_jax

torch.set_num_threads(1)

SMALL = dict(img_size=16, patch_size=4, in_chans=3, embed_dim=64, num_heads=4, mlp_ratio=4)
STEPS, T_SWITCH, BATCH = 20, 6, 2
TOKENS = (16 // 4) ** 2 + 1
ASSETS = ["cache_schedule_celeba_duodiff.json", "cache_schedule_celeba_flagship.json",
          "cache_schedule_imagenet64.json", "cache_schedule_imagenet256.json"]


def _models(depth, seed):
    """(JAX model and params with attn_impl="fused", the port's model), same
    weights, every leaf perturbed off its init value."""
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
def depth5():
    return _models(5, 0)


@pytest.mark.parametrize("n_outer", [0, 1, 2])
def test_forward_anchor_and_cached_match_forward_and_jax(depth5, n_outer):
    jmodel, params, model = depth5
    rng = np.random.RandomState(1)
    x = rng.randn(BATCH, 16, 16, 3).astype(np.float32)
    t = np.array([5.0, 600.0], np.float32)
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    with torch.no_grad():
        full = model(xt, tt)
        anchor, delta = model.forward_anchor(xt, tt, n_outer=n_outer)
        cached = model.forward_cached(xt, tt, n_outer=n_outer, delta=delta)
    assert torch.equal(anchor, full)
    assert delta.shape == (BATCH, TOKENS, 64) and delta.dtype == torch.float32
    np.testing.assert_allclose(cached.numpy(), full.numpy(), atol=1e-5, rtol=0)

    v = {"params": params}
    j_anchor, j_delta = jmodel.apply(v, jnp.asarray(x), jnp.asarray(t), None, n_outer=n_outer,
                                     method=jmodel.forward_anchor)
    j_cached = jmodel.apply(v, jnp.asarray(x), jnp.asarray(t), None, n_outer=n_outer,
                            delta=j_delta, method=jmodel.forward_cached)
    for got, want in ((anchor, j_anchor), (delta, j_delta), (cached, j_cached)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_n_outer_out_of_range_is_refused(depth5):
    _, _, model = depth5
    x, t = torch.zeros(1, 16, 16, 3), torch.zeros(1)
    with pytest.raises(ValueError, match="n_outer"):
        model.forward_anchor(x, t, n_outer=3)
    with pytest.raises(ValueError, match="n_outer"):
        model.forward_cached(x, t, n_outer=-1, delta=torch.zeros(1, TOKENS, 64))


def _noise(seed=3):
    rng = np.random.RandomState(seed)
    shape = (BATCH, 16, 16, 3)
    table = rng.randn(STEPS, *shape).astype(np.float32)
    table[0] = 0.0
    return rng.randn(*shape).astype(np.float32), table


def _cached_apply(model, n_outer, every, t_first):
    return make_block_cached_apply(
        lambda x, t, y: model.forward_anchor(x, t, y, n_outer=n_outer),
        lambda x, t, y, d: model.forward_cached(x, t, y, n_outer=n_outer, delta=d),
        every, t_first,
    )


def test_every_one_equals_dense(depth5):
    """every=1 anchors every step: the same trajectory as the dense loop."""
    _, _, model = depth5
    x0, table = _noise()
    sched = NoiseSchedule.create(steps=STEPS)
    ts = range(STEPS - 1, -1, -1)
    with torch.no_grad():
        dense = ddpm_loop(model, sched, "predict_noise", torch.from_numpy(x0), None, ts,
                          noise_table=torch.from_numpy(table))
        cached, state = ddpm_loop(_cached_apply(model, 1, 1, STEPS - 1), sched, "predict_noise",
                                  torch.from_numpy(x0), None, ts,
                                  noise_table=torch.from_numpy(table),
                                  state=torch.zeros(BATCH, TOKENS, 64))
    assert torch.equal(cached, dense)
    assert state.shape == (BATCH, TOKENS, 64)


@pytest.mark.parametrize("rule", ["every3", "table"])
def test_anchor_rule(rule):
    """Which steps anchor: t % every == 0 or table[t], plus t_first; a
    cached step gets the last anchor's delta and keeps it as the state."""
    calls = []

    def anchor(x, t, y):
        calls.append(("anchor", int(t[0])))
        return x, torch.tensor(float(t[0]))

    def cached(x, t, y, delta):
        calls.append(("cached", int(t[0]), float(delta)))
        return x

    table = cs.anchors_to_table([0, 4], 10)
    every = 3 if rule == "every3" else table
    apply = make_block_cached_apply(anchor, cached, every, t_first=8)
    state = torch.tensor(-1.0)
    for t in range(8, -1, -1):
        _, state = apply(state, torch.zeros(1), torch.full((1,), float(t)), None, t)
    anchors = [c[1] for c in calls if c[0] == "anchor"]
    assert anchors == ([8, 6, 3, 0] if rule == "every3" else [8, 4, 0])
    for c in calls:
        if c[0] == "cached":
            assert c[2] == min(a for a in anchors if a > c[1])


def test_make_block_cached_apply_refuses_bad_rules():
    with pytest.raises(ValueError, match="every"):
        make_block_cached_apply(None, None, 0, 9)
    with pytest.raises(ValueError, match="boolean"):
        make_block_cached_apply(None, None, np.arange(10), 9)


def test_stateful_sampler_contract():
    """A stateful sampler needs state= and returns it; two segments that
    thread the state equal one run over both."""
    sched = NoiseSchedule.create(steps=STEPS)

    def apply(state, x, t_batch, y, t):
        return 0.1 * x + state, state + 1e-3 * t

    sampler = DDPMSampler(apply, sched, init_state_fn=lambda x: torch.zeros_like(x))
    x = sampler.init(torch.Generator().manual_seed(0), (BATCH, 4, 4, 3))
    with pytest.raises(ValueError, match="state="):
        sampler.run(x, torch.Generator().manual_seed(1), STEPS - 1, 0)
    with pytest.raises(ValueError, match="state="):
        DDPMSampler(lambda x, t, y: x, sched).run(x, None, 3, 0, state=x)
    one, s_one = sampler.run(x, torch.Generator().manual_seed(1), STEPS - 1, 0,
                             state=sampler.init_state_fn(x))
    g = torch.Generator().manual_seed(1)
    mid, s_mid = sampler.run(x, g, STEPS - 1, T_SWITCH, state=sampler.init_state_fn(x))
    two, s_two = sampler.run(mid, g, T_SWITCH - 1, 0, state=s_mid)
    assert torch.equal(one, two) and torch.equal(s_one, s_two)


def test_cached_duodiff_trajectory_matches_jax():
    """Depth 3 dense for the high-noise steps, then depth 5 block-cached on a
    boolean anchor table from the handoff (its first step forced), against
    JAX ddpm_scan(state=...) with make_block_cached_apply."""
    j_early, jp_early, t_early = _models(3, 0)
    j_late, jp_late, t_late = _models(5, 1)
    x0, noise = _noise()
    handoff = STEPS - T_SWITCH
    table = cs.anchors_to_table([0, 5, 9], STEPS)
    n_outer = 1

    j_sched = JaxSchedule.create(steps=STEPS)
    j_apply_late = jax_cached_apply(
        lambda x, t, y: j_late.apply({"params": jp_late}, x, t, y, n_outer=n_outer,
                                     method=j_late.forward_anchor),
        lambda x, t, y, d: j_late.apply({"params": jp_late}, x, t, y, n_outer=n_outer,
                                        delta=d, method=j_late.forward_cached),
        jnp.asarray(table), handoff - 1,
    )
    key = jax.random.PRNGKey(0)
    xj, key = ddpm_scan(lambda x, t, y: j_early.apply({"params": jp_early}, x, t, y),
                        j_sched, "predict_noise", jnp.asarray(x0), key,
                        jnp.arange(STEPS - 1, handoff - 1, -1), noise_table=jnp.asarray(noise))
    want, _, _ = ddpm_scan(j_apply_late, j_sched, "predict_noise", xj, key,
                           jnp.arange(handoff - 1, -1, -1), noise_table=jnp.asarray(noise),
                           state=jnp.zeros((BATCH, TOKENS, 64), jnp.float32))

    sched = NoiseSchedule.create(steps=STEPS)
    with torch.no_grad():
        xt = ddpm_loop(t_early, sched, "predict_noise", torch.from_numpy(x0), None,
                       range(STEPS - 1, handoff - 1, -1), noise_table=torch.from_numpy(noise))
        got, _ = ddpm_loop(_cached_apply(t_late, n_outer, table, handoff - 1), sched,
                           "predict_noise", xt, None, range(handoff - 1, -1, -1),
                           noise_table=torch.from_numpy(noise),
                           state=torch.zeros(BATCH, TOKENS, 64))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("asset", ASSETS)
def test_cache_schedule_loader_matches_jax(asset):
    path = f"assets/{asset}"
    table, meta = cs.load_cache_schedule(path, with_meta=True)
    j_table, j_meta = jax_cs.load_cache_schedule(path, with_meta=True)
    np.testing.assert_array_equal(table, j_table)
    assert table.dtype == np.bool_ and meta == j_meta
    assert cs.table_to_anchors(table) == jax_cs.table_to_anchors(j_table)
    steps = table.shape[0]
    np.testing.assert_array_equal(cs.load_cache_schedule(path, num_timesteps=steps), table)
    with pytest.raises(ValueError, match="num_timesteps"):
        cs.load_cache_schedule(path, num_timesteps=steps + 1)


def test_duodiff_asset_anchors_the_headline_late_segment():
    """The committed DuoDiff schedule: derived at t_switch 300 with n_outer 2,
    80 anchors below the handoff t = 700, and t = 699 not among them (so
    the late segment's forced first-step anchor makes 81)."""
    table, meta = cs.load_cache_schedule(f"assets/{ASSETS[0]}", num_timesteps=1000,
                                         with_meta=True)
    assert meta["t_switch"] == 300 and meta["n_outer"] == 2 and meta["gelu_approx"]
    assert int(table[:700].sum()) == 80 and not table[699]


@pytest.mark.parametrize("every", [1, 3, 7])
def test_table_helpers_match_jax(every):
    np.testing.assert_array_equal(cs.uniform_table(every, 50), jax_cs.uniform_table(every, 50))
    anchors = [0, 7, 3, 49]
    np.testing.assert_array_equal(cs.anchors_to_table(anchors, 50),
                                  jax_cs.anchors_to_table(anchors, 50))
    with pytest.raises(ValueError, match="anchor timesteps"):
        cs.anchors_to_table([50], 50)
    with pytest.raises(ValueError, match="every"):
        cs.uniform_table(0, 50)
