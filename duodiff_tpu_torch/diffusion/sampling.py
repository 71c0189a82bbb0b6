"""Ancestral DDPM samplers (counterpart of ``duodiff_tpu/diffusion/sampling.py``).

The JAX package runs the reverse process as an on-device ``lax.scan``; here
it is a Python loop of eager steps. ``apply_fn(x, t_batch, y)`` is the
model; timesteps go in as a float32 (B,) tensor. Noise comes from an
explicit ``torch.Generator`` on the sampling device, or from an injected
``noise_table`` (steps, *x.shape) whose row t is used at step t (zero at
t == 0), which is how the tests drive the JAX and torch samplers with the
same noise.

Stateful mode (``ddpm_scan(state=...)``): ``apply_fn(state, x, t_batch, y,
t) -> (model_output, new_state)``, where ``t`` is the step as a Python int,
so a choice per step (block caching's anchor rule, heavy-light
interleaving's model choice) is a host branch that never waits for the
device. The state threads from step to step and from one segment to the
next.

``aux_fn(model_output) -> (eps, aux)`` splits a model output into the
prediction that drives the update and per-step diagnostics; the loop stacks
the aux rows in step order on the device and reads nothing back, so the
caller transfers them once, after the loop.

Beside DDPM: :func:`ddim_sample` (DDIM over a linspace grid, with the
DuoDiff handoff) and :func:`dpm_solver_sample` (DPM-Solver++ 1S / 2M, with
block caching anchored by transition index).
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule


def ddpm_loop(
    apply_fn: Callable,
    schedule: NoiseSchedule,
    parametrization: str,
    x: torch.Tensor,
    generator: Optional[torch.Generator],
    ts: Iterable[int],
    y: Optional[torch.Tensor] = None,
    variance_mode: str = "beta_tilde",
    noise_table: Optional[torch.Tensor] = None,
    state=None,
    aux_fn: Optional[Callable] = None,
):
    """The ancestral update over the descending timesteps ``ts``
    (``ddpm_scan``). With ``state`` the apply is stateful (module
    docstring) and the result is ``(x, state)``; with ``aux_fn`` the aux
    rows, stacked in step order, come last: ``(x, aux)`` or ``(x, state,
    aux)``."""
    batch = x.shape[0]
    stateful = state is not None
    rows = []
    for t in ts:
        t = int(t)
        t_batch = torch.full((batch,), float(t), dtype=torch.float32, device=x.device)
        if stateful:
            model_output, state = apply_fn(state, x, t_batch, y, t)
        else:
            model_output = apply_fn(x, t_batch, y)
        if aux_fn is not None:
            model_output, aux = aux_fn(model_output)
            rows.append(aux)
        if t == 0:  # no noise on the last step, whatever the table holds
            z = torch.zeros_like(x)
        elif noise_table is not None:
            z = noise_table[t]
        else:
            z = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
        x = schedule.step(parametrization, model_output, x, t, z, variance_mode)
    out = (x, state) if stateful else (x,)
    if aux_fn is not None:
        out = (*out, _stack_rows(rows))
    return out if len(out) > 1 else x


def _stack_rows(rows: list):
    """Per-step aux values (tensors, or tuples of them) -> the same structure
    of tensors stacked along a new leading step axis, on their device."""
    if rows and isinstance(rows[0], (tuple, list)):
        return tuple(_stack_rows([r[i] for r in rows]) for i in range(len(rows[0])))
    return torch.stack([torch.as_tensor(r) for r in rows]) if rows else torch.empty(0)


def make_guided_apply(apply_fn: Callable, guidance_scale: float, null_label: int) -> Callable:
    """Classifier-free guidance: an ``apply_fn(x, t, y)`` computing

        out = out_null + w * (out_cond - out_null)

    with ONE forward at twice the batch (the conditional half first, the
    null-label half second), so it composes with :func:`ddpm_loop`,
    :class:`DDPMSampler` and :func:`duodiff_sample` unchanged. ``w = 1`` is
    the conditional model, ``w = 0`` the unconditional one. Any leading
    arguments pass through untouched; only the trailing (x, t, y) triple is
    doubled."""

    def guided(*args):
        *lead, x, t, y = args
        if y is None:
            raise ValueError("guidance needs class labels")
        b = x.shape[0]
        out = apply_fn(*lead, torch.cat([x, x]), torch.cat([t, t]),
                       torch.cat([y, torch.full_like(y, null_label)]))
        cond, uncond = out[:b], out[b:]
        return uncond + guidance_scale * (cond - uncond)

    return guided


def make_interleaved_apply(apply_full: Callable, apply_shallow: Callable, every: int) -> Callable:
    """Heavy-light interleaving: the full model on the steps with ``t %
    every == 0`` (t = 0 among them), the shallow model on the others.
    Both take ``(x, t_batch, y)``. The JAX package reads the step from the
    timestep vector under ``lax.cond``; here it is the Python-int step, so
    the choice is a host branch, with no read from the device. Returns a
    stateful apply (module docstring) whose state passes through untouched:
    start it as ``()``."""
    if every < 1:
        raise ValueError(f"every must be >= 1, got {every}")

    def apply(state, x, t_batch, y, t: int):
        model = apply_full if t % every == 0 else apply_shallow
        return model(x, t_batch, y), state

    return apply


def make_block_cached_apply(apply_anchor: Callable, apply_cached: Callable, every,
                            t_first: int) -> Callable:
    """Training-free block caching (the Delta-DiT / DeepCache family): on
    anchor steps run the full model and keep the centered region's residual
    (``apply_anchor(x, t_batch, y) -> (out, delta)``, UViT.forward_anchor);
    on the steps between, run only the outer blocks with that residual
    (``apply_cached(x, t_batch, y, delta) -> out``, UViT.forward_cached).

    Anchors: ``t % every == 0`` for an int period, or ``table[t]`` for a
    1-D boolean table indexed by t (a drift-derived schedule); in both
    forms also ``t == t_first``, the segment's first step, where no delta
    exists yet. Returns the stateful apply of :func:`ddpm_loop`, whose
    state is the delta (start it as zeros (B, L, D) in the compute dtype).
    """
    table = None
    if isinstance(every, (int, np.integer)):
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
    else:
        table = np.asarray(every)
        if table.ndim != 1 or table.dtype != np.bool_:
            raise ValueError(
                "anchor table must be a 1-D boolean array indexed by t, "
                f"got shape {table.shape} dtype {table.dtype}"
            )

    def apply(state, x, t_batch, y, t: int):
        anchor = (t % every == 0) if table is None else bool(table[t])
        if anchor or t == t_first:
            return apply_anchor(x, t_batch, y)
        return apply_cached(x, t_batch, y, state), state

    return apply


class DDPMSampler:
    """``init`` draws x_T; ``run(x, generator, t_start, t_end, y)`` advances
    t = t_start down to t_end inclusive, so callers can compose segments
    over different models (the DuoDiff handoff). The counterpart of
    ``ChunkedDDPMSampler`` without its chunking, a TPU compile-time device.

    With ``init_state_fn`` the sampler is stateful: ``apply_fn`` follows
    the stateful contract, ``init_state_fn(x)`` builds a segment's first
    state, and ``run(..., state=)`` returns ``(x, state)`` for the next
    segment."""

    def __init__(self, apply_fn: Callable, schedule: NoiseSchedule, *,
                 parametrization: str = "predict_noise",
                 variance_mode: str = "beta_tilde",
                 init_state_fn: Optional[Callable] = None):
        self.apply_fn = apply_fn
        self.schedule = schedule
        self.parametrization = parametrization
        self.variance_mode = variance_mode
        self.init_state_fn = init_state_fn

    def init(self, generator: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=generator,
                           device=generator.device, dtype=torch.float32)

    def run(self, x, generator, t_start: int, t_end: int = 0, y=None, state=None):
        if (self.init_state_fn is not None) != (state is not None):
            raise ValueError("a stateful sampler (init_state_fn) runs with state=, "
                             "a stateless one without")
        return ddpm_loop(
            self.apply_fn, self.schedule, self.parametrization, x, generator,
            range(t_start, t_end - 1, -1), y, self.variance_mode, state=state,
        )


def duodiff_sample(
    early_apply_fn: Callable,
    late_apply_fn: Callable,
    generator: Optional[torch.Generator],
    *,
    schedule: NoiseSchedule,
    shape: Sequence[int],
    t_switch: int,
    parametrization: str = "predict_noise",
    y: Optional[torch.Tensor] = None,
    x_init: Optional[torch.Tensor] = None,
    variance_mode: str = "beta_tilde",
    noise_table: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """DuoDiff: the shallow model runs the first ``t_switch`` (high-noise)
    steps t = T-1 .. T-t_switch, the full model the remaining ones."""
    steps = schedule.steps
    if x_init is None:
        x_init = torch.randn(tuple(shape), generator=generator,
                             device=generator.device, dtype=torch.float32)
    t_switch = min(max(int(t_switch), 0), steps)
    handoff = steps - t_switch
    x = ddpm_loop(early_apply_fn, schedule, parametrization, x_init, generator,
                  range(steps - 1, handoff - 1, -1), y, variance_mode, noise_table)
    return ddpm_loop(late_apply_fn, schedule, parametrization, x, generator,
                     range(handoff - 1, -1, -1), y, variance_mode, noise_table)


def split_segments(segments: list, stops) -> list:
    """Cut ``(sampler, t_hi, t_lo)`` segments so that the update at every t in
    ``stops`` is the last of a segment. Empty segments (t_hi < t_lo) stay as
    they are."""
    out = []
    for sampler, t_hi, t_lo in segments:
        for t in sorted((t for t in stops if t_lo < t <= t_hi), reverse=True):
            out.append((sampler, t_hi, t))
            t_hi = t - 1
        out.append((sampler, t_hi, t_lo))
    return out


def _initial_noise(x_init, shape, generator):
    if x_init is not None:
        return x_init
    return torch.randn(tuple(shape), generator=generator, device=generator.device,
                       dtype=torch.float32)


def ddpm_sample(
    apply_fn: Callable,
    generator: Optional[torch.Generator],
    *,
    schedule: NoiseSchedule,
    shape: Sequence[int],
    parametrization: str = "predict_noise",
    y: Optional[torch.Tensor] = None,
    timesteps_save: Sequence[int] = (),
    x_init: Optional[torch.Tensor] = None,
    variance_mode: str = "beta_tilde",
    noise_table: Optional[torch.Tensor] = None,
):
    """Ancestral DDPM over t = T-1 .. 0. ``timesteps_save`` counts reverse
    steps: the state after the update at t = steps - s is kept for each s in
    [1, steps], others are skipped, as in the JAX package. Returns ``(x,
    intermediates)``, the latter ordered like the kept values of
    ``timesteps_save``."""
    steps = schedule.steps
    x = _initial_noise(x_init, shape, generator)
    valid = [int(s) for s in timesteps_save if 1 <= int(s) <= steps]
    kept = {}
    for _, t_hi, t_lo in split_segments([(None, steps - 1, 0)], {steps - s for s in valid}):
        x = ddpm_loop(apply_fn, schedule, parametrization, x, generator,
                      range(t_hi, t_lo - 1, -1), y, variance_mode, noise_table)
        kept[t_lo] = x
    return x, [kept[steps - s] for s in valid]


def ddim_timestep_grid(steps: int, ddim_steps: int) -> np.ndarray:
    """``linspace(0, steps-1, ddim_steps)`` truncated to int, descending
    (reference sampler.py:104)."""
    return np.linspace(0, steps - 1, ddim_steps).astype(int)[::-1].copy()


def ddim_pairs(steps: int, ddim_steps: int, t_switch: Optional[int] = None):
    """The DDIM transitions (t, s), s < t, split into the early model's and
    the late model's: ``(early_pairs, late_pairs)``. The reference switches
    after the step whose current t first falls below ``steps - t_switch``,
    so the early model also runs that first pair below the boundary. Without
    ``t_switch`` every pair is the early model's."""
    grid = ddim_timestep_grid(steps, ddim_steps)
    pairs = [(int(t), int(s)) for t, s in zip(grid[:-1], grid[1:])]
    if t_switch is None:
        return pairs, []
    boundary = steps - t_switch
    for i, (t, _) in enumerate(pairs):
        if t < boundary:
            return pairs[:i + 1], pairs[i + 1:]
    return pairs, []


def ddim_sample(
    apply_fn: Callable,
    generator: Optional[torch.Generator],
    *,
    schedule: NoiseSchedule,
    shape: Sequence[int],
    ddim_steps: int = 50,
    eta: float = 0.0,
    y: Optional[torch.Tensor] = None,
    timesteps_save: Sequence[int] = (),
    x_init: Optional[torch.Tensor] = None,
    late_apply_fn: Optional[Callable] = None,
    t_switch: Optional[int] = None,
    noise_table: Optional[torch.Tensor] = None,
):
    """DDIM over :func:`ddim_timestep_grid` (reference sampler.py:103-126),
    with the DuoDiff handoff of :func:`ddim_pairs` when both
    ``late_apply_fn`` and ``t_switch`` are given. The noise of the pair (t,
    s) is zero where s == 0; ``noise_table`` (steps, *shape) gives it as row
    s in place of a draw from ``generator``. The state after the pair (t, s)
    is kept when ``steps - t`` is in ``timesteps_save``. Returns ``(x,
    intermediates)``, the latter ordered like the kept values of
    ``timesteps_save``."""
    steps = schedule.steps
    split = t_switch if late_apply_fn is not None else None
    early_pairs, late_pairs = ddim_pairs(steps, ddim_steps, split)
    x = _initial_noise(x_init, shape, generator)
    batch = x.shape[0]
    save_set = {int(v) for v in timesteps_save}
    snapshots = {}
    for apply, pairs in ((apply_fn, early_pairs), (late_apply_fn, late_pairs)):
        for t, s in pairs:
            t_batch = torch.full((batch,), float(t), dtype=torch.float32, device=x.device)
            model_output = apply(x, t_batch, y)
            if s == 0:
                z = torch.zeros_like(x)
            elif noise_table is not None:
                z = noise_table[s]
            else:
                z = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
            x = schedule.ddim_step(model_output, x, t, s, z, eta=eta)
            if steps - t in save_set:
                snapshots[steps - t] = x
    return x, [snapshots[int(s)] for s in timesteps_save if int(s) in snapshots]


def dpm_solver_tables(schedule: NoiseSchedule, dpm_steps: int) -> dict:
    """Per-transition DPM-Solver++ constants, one row per transition i-1 ->
    i over the deduplicated DDIM grid (``dpm_steps`` past the schedule's
    steps repeats grid points, and h = 0 would divide by zero). Computed in
    numpy from the fp32 ``alphas_bar`` with numpy's own type promotion, then
    cast to fp32 tensors on the schedule's device, as the JAX package does;
    ``t_prev`` is also kept as host ints (``t_prev_host``), so a step's
    timestep never has to be read from the device. Serving gathers from the
    same tables."""
    if dpm_steps < 2:
        raise ValueError(f"dpm_steps must be >= 2 (need >= 1 transition), got {dpm_steps}")
    grid = ddim_timestep_grid(schedule.steps, dpm_steps)
    grid = grid[np.concatenate([[True], np.diff(grid) != 0])]
    a_bar = schedule.alphas_bar.cpu().numpy()[grid]
    alpha = np.sqrt(a_bar)
    sigma = np.sqrt(1.0 - a_bar)
    lam = np.log(alpha / sigma)
    h = lam[1:] - lam[:-1]
    r = np.concatenate([np.ones((1,)), h[:-1]]) / h  # r[0] unused
    consts = {
        "t_prev": grid[:-1].astype(np.float32),
        "sigma_ratio": (sigma[1:] / sigma[:-1]).astype(np.float32),
        "alpha_t": alpha[1:].astype(np.float32),
        "phi": np.expm1(-h).astype(np.float32),
        "c_cur": (1.0 + 1.0 / (2.0 * r)).astype(np.float32),
        "c_prev": (1.0 / (2.0 * r)).astype(np.float32),
        "alpha_prev": alpha[:-1].astype(np.float32),
        "sigma_prev": sigma[:-1].astype(np.float32),
        "is_first": np.zeros(len(h), np.float32),
    }
    consts["is_first"][0] = 1.0
    device = schedule.alphas_bar.device
    tables = {k: torch.from_numpy(v).to(device) for k, v in consts.items()}
    tables["t_prev_host"] = [int(t) for t in grid[:-1]]
    return tables


def dpm_solver_sample(
    apply_fn: Optional[Callable],
    generator: Optional[torch.Generator],
    *,
    schedule: NoiseSchedule,
    shape: Sequence[int],
    dpm_steps: int = 20,
    order: int = 2,
    parametrization: str = "predict_noise",
    y: Optional[torch.Tensor] = None,
    x_init: Optional[torch.Tensor] = None,
    cache: Optional[tuple] = None,
) -> torch.Tensor:
    """DPM-Solver++ (Lu et al. 2022) in data-prediction form over
    :func:`dpm_solver_tables`: order 1 is DDIM at eta 0 on the same grid,
    order 2 the 2M multistep update

        x_i = (sigma_i / sigma_{i-1}) x_{i-1} - alpha_i (e^{-h_i} - 1) D_i
        D_i = (1 + 1/(2 r_i)) x0_{i-1} - 1/(2 r_i) x0_{i-2}   (D_1 = x0_0).

    ``cache=(apply_anchor, apply_cached, every, init_state)`` composes block
    caching: transition i runs ``apply_anchor(x, t, y) -> (out, delta)``
    when ``i % every == 0`` (the first transition always anchors, so the
    zero state is never consumed) and ``apply_cached(x, t, y, delta)``
    otherwise; the choice is a host branch on the transition index.
    ``apply_fn`` is not called when ``cache`` is given."""
    if order not in (1, 2):
        raise ValueError(f"order must be 1 or 2, got {order}")
    if parametrization not in ("predict_noise", "predict_original"):
        raise ValueError(f"DPM-Solver takes predict_noise or predict_original, got "
                         f"{parametrization!r}")
    c = dpm_solver_tables(schedule, dpm_steps)
    x = _initial_noise(x_init, shape, generator)
    batch = x.shape[0]
    delta = None
    if cache is not None:
        apply_anchor, apply_cached, every, init_state = cache
        if every < 1:
            raise ValueError(f"cache every must be >= 1, got {every}")
        delta = init_state(x)
    x0_prev = None
    for i, t in enumerate(c["t_prev_host"]):
        t_batch = torch.full((batch,), float(t), dtype=torch.float32, device=x.device)
        if cache is None:
            model_output = apply_fn(x, t_batch, y)
        elif i % every == 0:
            model_output, delta = apply_anchor(x, t_batch, y)
        else:
            model_output = apply_cached(x, t_batch, y, delta)
        if parametrization == "predict_original":
            x0 = model_output
        else:
            x0 = (x - c["sigma_prev"][i] * model_output) / c["alpha_prev"][i]
        if order == 1 or i == 0:
            d = x0
        else:
            d = c["c_cur"][i] * x0 - c["c_prev"][i] * x0_prev
        x = c["sigma_ratio"][i] * x - c["alpha_t"][i] * c["phi"][i] * d
        x0_prev = x0
    return x
