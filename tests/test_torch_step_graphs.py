"""The samplers' step bodies (``diffusion/graphs.py``, ``diffusion/sampling.py``,
``diffusion/continuous.py``) run eagerly on the CPU against plain loops
written here with Python-int timesteps, fresh tensors and rebound state, as
the samplers ran before their steps became graphs: every sampler, its
generator's state after the run and its aux rows equal to the bit. Beside:
the host loop's plan of graph kinds over the CelebA DuoDiff schedule, the step
body's read of t from the device table alone, the launch counters of a
stubbed graph, the refusal of CPU tensors and the tensor-parallel eager
route. Nothing here needs a card; the graphs themselves are held to the
eager loop on the card by ``chip_smoke.py``'s phase 19."""

import contextlib
import gc
import types

import numpy as np
import pytest
import torch

from duodiff_tpu_torch import sample
from duodiff_tpu_torch.config import UViTConfig
from duodiff_tpu_torch.diffusion import graphs, sampling
from duodiff_tpu_torch.diffusion.cache_schedule import load_cache_schedule
from duodiff_tpu_torch.diffusion.continuous import ContinuousDiffusionBatcher
from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
from duodiff_tpu_torch.models.uvit import init_uvit
from duodiff_tpu_torch.ops import block

torch.set_num_threads(1)

STEPS, BATCH, T_SWITCH, N_OUTER = 24, 2, 8, 1
SMALL = dict(img_size=8, patch_size=2, in_chans=3, embed_dim=64, num_heads=4, mlp_ratio=2)
SHAPE = (BATCH, 8, 8, 3)


def _model(depth, seed, num_classes=0):
    cfg = UViTConfig(**SMALL, depth=depth, num_classes=num_classes)
    model = init_uvit(cfg, device="cpu", dtype=torch.float32,
                      generator=torch.Generator().manual_seed(seed), attn_impl="plain")
    model.pack_for_kernels()
    return model.eval()


@pytest.fixture(scope="module")
def models():
    return _model(3, 0), _model(5, 1)


@pytest.fixture(scope="module")
def sched():
    return NoiseSchedule.create(steps=STEPS)


def _x(seed=5):
    return torch.randn(SHAPE, generator=torch.Generator().manual_seed(seed))


def _table(seed=6):
    return torch.randn((STEPS, *SHAPE), generator=torch.Generator().manual_seed(seed))


# ------------------------------------------------------------ plain loops

def plain_noise(x, t, g, table):
    if t == 0:
        return torch.zeros_like(x)
    if table is not None:
        return table[t]
    return torch.randn(x.shape, generator=g, dtype=x.dtype)


def t_batch(t):
    return torch.full((BATCH,), float(t), dtype=torch.float32)


def plain_ddpm(model_at, sched, param, x, g, ts, vm="beta_tilde", table=None):
    """``model_at(x, t_batch, t)``: the model of step t, chosen with Python-int t."""
    for t in ts:
        x = sched.step(param, model_at(x, t_batch(t), t), x, t, plain_noise(x, t, g, table), vm)
    return x


def plain_cached(anchor, cached, is_anchor):
    state = {}

    def model_at(x, tb, t):
        if is_anchor(t):
            out, state["delta"] = anchor(x, tb, None)
            return out
        return cached(x, tb, None, state["delta"])

    return model_at


def anchor_of(model):
    return (lambda x, t, y: model.forward_anchor(x, t, y, n_outer=N_OUTER),
            lambda x, t, y, d: model.forward_cached(x, t, y, n_outer=N_OUTER, delta=d))


def zero_delta(model):
    tokens = model.config.extras + model.config.num_patches
    return lambda x: torch.zeros((x.shape[0], tokens, model.config.embed_dim))


def gens(seed=11):
    return torch.Generator().manual_seed(seed), torch.Generator().manual_seed(seed)


def same_state(a, b):
    return torch.equal(a.get_state(), b.get_state())


# ----------------------------------------------------------------- DDPM

@pytest.mark.parametrize("param", ["predict_noise", "predict_original", "predict_previous"])
@pytest.mark.parametrize("vm", ["beta", "beta_tilde"])
def test_ddpm_bodies_equal_the_plain_loop(models, sched, param, vm):
    model = models[0]
    g1, g2 = gens()
    ts = range(STEPS - 1, -1, -1)
    with torch.no_grad():
        got = sampling.ddpm_loop(model, sched, param, _x(), g1, ts, variance_mode=vm)
        want = plain_ddpm(lambda x, tb, t: model(x, tb), sched, param, _x(), g2, ts, vm)
    assert torch.equal(got, want) and same_state(g1, g2)


def test_ddpm_noise_table_and_aux_rows(models, sched):
    model = models[0]
    table = _table()
    with torch.no_grad():
        got, (mean, std) = sampling.ddpm_loop(
            model, sched, "predict_noise", _x(), None, range(STEPS - 1, 3, -1),
            noise_table=table, aux_fn=lambda mo: (mo, (mo.mean(), mo.std())))
        rows = []

        def model_at(x, tb, t):
            out = model(x, tb)
            rows.append((out.mean(), out.std()))
            return out

        want = plain_ddpm(model_at, sched, "predict_noise", _x(), None, range(STEPS - 1, 3, -1),
                          table=table)
    assert torch.equal(got, want)
    assert torch.equal(mean, torch.stack([r[0] for r in rows]))
    assert torch.equal(std, torch.stack([r[1] for r in rows]))


def test_duodiff_equals_the_plain_loop(models, sched):
    early, late = models
    g1, g2 = gens()
    x0 = _x()
    handoff = STEPS - T_SWITCH
    with torch.no_grad():
        got = sampling.duodiff_sample(early, late, g1, schedule=sched, shape=SHAPE,
                                      t_switch=T_SWITCH, x_init=x0)
        want = plain_ddpm(lambda x, tb, t: (early if t >= handoff else late)(x, tb), sched,
                          "predict_noise", x0, g2, range(STEPS - 1, -1, -1))
    assert torch.equal(got, want) and same_state(g1, g2)


@pytest.mark.parametrize("rule", ["period", "table"])
def test_block_cached_duodiff_equals_the_plain_loop(models, sched, rule):
    """Dense shallow steps, then the late model cached from the handoff on a
    period or an anchor table, its first step a forced anchor, through one
    run's shared buffers (the sampling CLI's composition)."""
    early, late = models
    handoff = STEPS - T_SWITCH
    every = 3 if rule == "period" else np.arange(STEPS) % 5 == 1
    anchor, cached = anchor_of(late)
    g1, g2 = gens()
    with torch.no_grad():
        run = graphs.StepGraphs("cpu")
        dense = sampling.DDPMSampler(early, sched, graphs=run)
        cached_sampler = sampling.DDPMSampler(
            sampling.make_block_cached_apply(anchor, cached, every, handoff - 1), sched,
            init_state_fn=zero_delta(late), graphs=run)
        x = dense.run(_x(), g1, STEPS - 1, handoff)
        got, _ = cached_sampler.run(x, g1, handoff - 1, 0, state=zero_delta(late)(x))

        def is_anchor(t):
            return t == handoff - 1 or (t % 3 == 0 if rule == "period" else t % 5 == 1)

        late_at = plain_cached(anchor, cached, is_anchor)
        want = plain_ddpm(lambda x, tb, t: early(x, tb) if t >= handoff else late_at(x, tb, t),
                          sched, "predict_noise", _x(), g2, range(STEPS - 1, -1, -1))
    assert torch.equal(got, want) and same_state(g1, g2)


def test_interleaving_equals_the_plain_loop(models, sched):
    early, late = models
    g1, g2 = gens()
    with torch.no_grad():
        got, state = sampling.ddpm_loop(sampling.make_interleaved_apply(late, early, 4), sched,
                                        "predict_noise", _x(), g1, range(STEPS - 1, -1, -1),
                                        state=())
        want = plain_ddpm(lambda x, tb, t: (late if t % 4 == 0 else early)(x, tb), sched,
                          "predict_noise", _x(), g2, range(STEPS - 1, -1, -1))
    assert state == () and torch.equal(got, want) and same_state(g1, g2)


def test_guided_equals_the_plain_loop(sched):
    model = _model(3, 2, num_classes=5)
    guided = sampling.make_guided_apply(model, 1.5, 4)
    y = torch.tensor([1, 3])
    g1, g2 = gens()
    with torch.no_grad():
        got = sampling.ddpm_loop(guided, sched, "predict_noise", _x(), g1,
                                 range(STEPS - 1, -1, -1), y)
        want = plain_ddpm(lambda x, tb, t: guided(x, tb, y), sched, "predict_noise", _x(), g2,
                          range(STEPS - 1, -1, -1))
    assert torch.equal(got, want) and same_state(g1, g2)


def test_ddpm_sample_snapshots_are_copies(models, sched):
    model = models[0]
    g1, g2 = gens()
    with torch.no_grad():
        x, (s5, s20) = sampling.ddpm_sample(model, g1, schedule=sched, shape=SHAPE,
                                            timesteps_save=(5, 20), x_init=_x())
        w5 = plain_ddpm(lambda x, tb, t: model(x, tb), sched, "predict_noise", _x(), g2,
                        range(STEPS - 1, STEPS - 6, -1))
        w20 = plain_ddpm(lambda x, tb, t: model(x, tb), sched, "predict_noise", w5, g2,
                         range(STEPS - 6, STEPS - 21, -1))
        want = plain_ddpm(lambda x, tb, t: model(x, tb), sched, "predict_noise", w20, g2,
                          range(STEPS - 21, -1, -1))
    assert torch.equal(s5, w5) and torch.equal(s20, w20) and torch.equal(x, want)


# --------------------------------------------------------- DDIM, DPM-Solver

@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_equals_the_plain_loop(models, sched, eta):
    early, late = models
    g1, g2 = gens()
    with torch.no_grad():
        got, (kept,) = sampling.ddim_sample(
            early, g1, schedule=sched, shape=SHAPE, ddim_steps=10, eta=eta, x_init=_x(),
            late_apply_fn=late, t_switch=T_SWITCH, timesteps_save=(STEPS - 12,))
        e_pairs, l_pairs = sampling.ddim_pairs(STEPS, 10, T_SWITCH)
        x, snap = _x(), None
        for model, (t, s) in [(early, p) for p in e_pairs] + [(late, p) for p in l_pairs]:
            z = torch.zeros_like(x) if s == 0 else torch.randn(x.shape, generator=g2)
            x = sched.ddim_step(model(x, t_batch(t)), x, t, s, z, eta=eta)
            if t == 12:
                snap = x
    assert torch.equal(got, x) and torch.equal(kept, snap) and same_state(g1, g2)


def plain_dpm(apply_fn, sched, x, n, order, param, cache=None):
    """dpm_solver_sample as it ran before its steps became graphs."""
    c = sampling.dpm_solver_tables(sched, n)
    delta, x0_prev = None, None
    if cache is not None:
        delta = cache[3](x)
    for i, t in enumerate(c["t_prev_host"]):
        tb = t_batch(t)
        if cache is None:
            out = apply_fn(x, tb, None)
        elif i % cache[2] == 0:
            out, delta = cache[0](x, tb, None)
        else:
            out = cache[1](x, tb, None, delta)
        x0 = out if param == "predict_original" else (
            (x - c["sigma_prev"][i] * out) / c["alpha_prev"][i])
        d = x0 if order == 1 or i == 0 else c["c_cur"][i] * x0 - c["c_prev"][i] * x0_prev
        x = c["sigma_ratio"][i] * x - c["alpha_t"][i] * c["phi"][i] * d
        x0_prev = x0
    return x


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("param", ["predict_noise", "predict_original"])
def test_dpm_solver_equals_the_plain_loop(models, sched, order, cached, param):
    model = models[1]
    cache = (*anchor_of(model), 2, zero_delta(model)) if cached else None
    with torch.no_grad():
        got = sampling.dpm_solver_sample(model, None, schedule=sched, shape=SHAPE, dpm_steps=8,
                                         order=order, parametrization=param, x_init=_x(),
                                         cache=cache)
        want = plain_dpm(model, sched, _x(), 8, order, param, cache)
    assert torch.equal(got, want)


# ------------------------------------------------------------- early exit

def ee_stub(x, t, y):
    """(backbone, u (3, B), g (3, B, ...)) that depend on x and t."""
    backbone = 0.9 * x + 0.01 * t[:, None, None, None]
    u = torch.stack([torch.sigmoid(x.mean(dim=(1, 2, 3)) * k + t / STEPS - 0.5)
                     for k in (1.0, 2.0, 3.0)])
    g = torch.stack([backbone * (1.0 + 0.1 * k) for k in range(3)])
    return backbone, u, g


@pytest.mark.parametrize("threshold", [0.5, -1.0])
def test_early_exit_equals_the_plain_loop(sched, threshold):
    g1, g2 = gens()
    got, errs, idxs = sampling.early_exit_sample(ee_stub, g1, schedule=sched, shape=SHAPE,
                                                 threshold=threshold, x_init=_x())
    x, err_rows, idx_rows = _x(), [], []
    for t in range(STEPS - 1, -1, -1):
        backbone, u, g = ee_stub(x, t_batch(t), None)
        probes = torch.cat([u, torch.zeros((1, BATCH))])
        idx = (probes <= threshold).to(torch.int32).argmax(0)
        sel = torch.cat([g, backbone[None]])[idx, torch.arange(BATCH)]
        x = sched.step_predict_noise(sel, x, t, plain_noise(x, t, g2, None))
        err_rows.append(probes[:-1].mean(1))
        idx_rows.append(idx.to(torch.int32))
    assert torch.equal(got, x) and same_state(g1, g2)
    assert torch.equal(errs, torch.stack(err_rows).flip(0))
    assert torch.equal(idxs, torch.stack(idx_rows).flip(0))


# ---------------------------------------------------------- slot batcher

def plain_step(b, progress, w):
    """The batcher's step before it became a step body: the anchor choice on
    the Python-int wave, fresh tensors, its state rebound."""
    ic = b.i.clamp(0, b.n_trans - 1)
    x, tm = b.x, b._t_model[ic]
    if b.cache is None:
        mo = b.apply_fn(x, tm, None)
    elif (bool(b._pattern[w % b.cache_every]) if b._pattern is not None
          else w % b.cache_every == 0):
        mo, b.delta = b.cache[0](x, tm, None)
    else:
        mo = b.cache[1](x, tm, None, b.delta)
    z = torch.zeros_like(x)
    for slot, j in progress.items():
        if b._draw_rows is None or j >= b.n_trans or int(b._draw_rows[j]) <= 0:
            continue
        z[slot:slot + 1].normal_(generator=b._noise[slot])
    x0 = None
    if b.method == "ddpm":
        xn = b.schedule.step(b.parametrization, mo, x, b._t[ic], z)
    elif b.method == "ddim":
        xn = b.schedule.ddim_step(mo, x, b._t[ic], b._s[ic], z)
    else:
        c = {k: v[ic].reshape(-1, 1, 1, 1) for k, v in b._dpm.items()}
        x0 = (x - c["sigma_prev"] * mo) / c["alpha_prev"]
        d = torch.where(c["is_first"] > 0, x0, c["c_cur"] * x0 - c["c_prev"] * b.x0_prev)
        xn = c["sigma_ratio"] * x - c["alpha_t"] * c["phi"] * d
    live = b.active & (b.i < b.n_trans)
    b.x = torch.where(live.reshape(-1, 1, 1, 1), xn, x)
    if x0 is not None:
        b.x0_prev = torch.where(live.reshape(-1, 1, 1, 1), x0, b.x0_prev)
    b.i = b.i + live


@pytest.mark.parametrize("method,cache", [("ddpm", None), ("ddpm", 3), ("ddpm", "pattern"),
                                          ("ddim", None), ("dpm", 2)])
def test_slot_batcher_equals_the_plain_step(models, method, cache):
    model = models[0]
    sched = NoiseSchedule.create(steps=STEPS - 2 if cache == 3 else STEPS)  # (steps-1) % 3 == 0
    rule = np.array([1, 0, 0, 1, 0], bool) if cache == "pattern" else cache
    cache_tuple = None if cache is None else (*anchor_of(model), rule, zero_delta(model))

    def batcher():
        return ContinuousDiffusionBatcher(model, sched, img_shape=SHAPE[1:], slots=2,
                                          method=method, ddim_steps=10, dpm_steps=10,
                                          steps_per_poll=3, cache=cache_tuple)

    plain = batcher()
    plain._step = types.MethodType(plain_step, plain)
    jobs = [(torch.Generator().manual_seed(30 + k), None) for k in range(3)]
    plain_jobs = [(torch.Generator().manual_seed(30 + k), None) for k in range(3)]
    with torch.no_grad():
        got = batcher().run_jobs(jobs)
        want = plain.run_jobs(plain_jobs)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    for (a, _), (b, _) in zip(jobs, plain_jobs):
        assert same_state(a, b)


# ---------------------------------------------- the plan, t, counters, refusals

class Recording(graphs.StepGraphs):
    def __init__(self):
        super().__init__("cpu")
        self.plan = []

    def step(self, key, body, buffers=()):
        self.plan.append(key[1])
        super().step(key, body, buffers)


def test_plan_equals_the_anchor_rule_on_the_celeba_duodiff_schedule():
    """The kinds the host loop replays over the 1000-step CelebA DuoDiff run on
    the committed anchor table (the late model cached from the handoff)
    equal the rule: an anchor where the table says so or at the segment's
    first step."""
    steps, t_switch = 1000, 300
    table = load_cache_schedule("assets/cache_schedule_celeba_duodiff.json", num_timesteps=steps)
    handoff = steps - t_switch
    sched = NoiseSchedule.create(steps=steps)
    x = torch.zeros((1, 2))
    apply = sampling.make_block_cached_apply(
        lambda x, t, y: (torch.zeros_like(x), torch.ones(1)),
        lambda x, t, y, d: torch.zeros_like(x), table, handoff - 1)
    run = Recording()
    sampling.ddpm_loop(lambda x, t, y: torch.zeros_like(x), sched, "predict_noise", x, None,
                       range(steps - 1, handoff - 1, -1), noise_table=torch.zeros(steps, 1, 2),
                       graphs=run)
    sampling.ddpm_loop(apply, sched, "predict_noise", x, None, range(handoff - 1, -1, -1),
                       noise_table=torch.zeros(steps, 1, 2), state=torch.zeros(1), graphs=run)
    want = [None] * t_switch + ["anchor" if table[t] or t == handoff - 1 else "cached"
                                for t in range(handoff - 1, -1, -1)]
    assert run.plan == want
    assert run.plan.count("anchor") == int(table[:handoff].sum()) + (not table[handoff - 1])


def test_step_body_reads_t_from_the_device_table_alone(models, sched):
    """The body takes t from ``ts[i]`` on the device: with the host's t set
    to a wrong step, the step is still the one at ts[i]."""
    model = models[0]
    x = _x()
    run = graphs.StepGraphs("cpu")
    loop = sampling._DDPMSteps(run, model, sched, "predict_noise", "beta_tilde", None, x, None)
    loop.start(x, [17, 9, 4], None)
    loop.i.fill_(1)
    loop.t_host = 17
    loop.z.copy_(_table()[9])
    with torch.no_grad():
        loop.body(None)
        want = sched.step("predict_noise", model(x, t_batch(9)), x, 9, _table()[9])
    assert torch.equal(loop.x, want) and int(loop.i) == 2


class StubGraph:
    replays = 0

    def replay(self):
        StubGraph.replays += 1


def test_counter_deltas_are_added_per_replay(monkeypatch):
    """A stubbed capture runs the body once: its launches are taken back,
    and each replay adds them again, so the counts are an eager run's."""
    monkeypatch.setattr(graphs, "_new_graph", StubGraph)
    monkeypatch.setattr(graphs, "_capture", lambda g, pool: contextlib.nullcontext())
    monkeypatch.setattr(block.fused_attn_sublayer, "launches", 0)
    monkeypatch.setattr(block.fused_mlp_sublayer, "launches", 0)
    runs = []

    def body():
        runs.append(1)
        block.fused_attn_sublayer.launches += 13
        block.fused_mlp_sublayer.launches += 13

    graph = graphs.StepGraph(body)
    graph()  # the eager warm-up
    assert block.fused_attn_sublayer.launches == 13 and graph.graph is None
    StubGraph.replays = 0
    for n in range(2, 6):
        graph()
        assert block.fused_attn_sublayer.launches == 13 * n
        assert block.fused_mlp_sublayer.launches == 13 * n
    assert len(runs) == 2 and StubGraph.replays == 4  # warm-up and capture; 4 replays
    assert graph.deltas == {"fused_attn_sublayer": 13, "fused_mlp_sublayer": 13}


@pytest.mark.parametrize("enabled", [True, False])
@pytest.mark.parametrize("fails", [False, True])
def test_no_garbage_collection_runs_during_a_capture(monkeypatch, enabled, fails):
    """A collection inside a capture could tear down an earlier run's graph
    held in a cycle, which spoils the capture on the card: the capture runs
    with automatic collection off, and leaves it as it found it, also when
    the body raises."""
    monkeypatch.setattr(graphs, "_new_graph", StubGraph)
    monkeypatch.setattr(graphs, "_capture", lambda g, pool: contextlib.nullcontext())
    seen = []

    def body():
        seen.append(gc.isenabled())
        if fails and len(seen) == 2:
            raise RuntimeError("capture failed")

    graph = graphs.StepGraph(body)
    was = gc.isenabled()
    (gc.enable if enabled else gc.disable)()
    try:
        graph()  # the eager warm-up
        if fails:
            with pytest.raises(RuntimeError, match="capture failed"):
                graph()
        else:
            graph()
        after = gc.isenabled()
    finally:
        (gc.enable if was else gc.disable)()
    assert seen == [enabled, False]
    assert after == enabled


def test_cpu_tensors_are_refused():
    with pytest.raises(ValueError, match="CUDA tensors"):
        graphs.StepGraph(lambda: None, [torch.zeros(1)])
    assert not graphs.StepGraphs("cpu", graphed=True).graphed
    assert graphs.step_graphs(False, "cuda").graphed is False


def test_a_stateful_apply_on_the_host_step_is_refused_when_graphed(sched):
    run = graphs.StepGraphs("cpu")
    run.graphed = True  # as on the card
    with pytest.raises(ValueError, match="StepKinds"):
        sampling.ddpm_loop(lambda s, x, tb, y, t: (x, s), sched, "predict_noise",
                           torch.zeros(1, 2), None, range(3, -1, -1), state=(), graphs=run)


def test_routes():
    graphed, line = sample.graph_route("cuda", 2)
    assert not graphed and "--model_parallel 2" in line and "eager" in line
    assert sample.graph_route("cuda:0", 1)[0]
    graphed, line = sample.graph_route("cpu", 1)
    assert not graphed and "CPU" in line
