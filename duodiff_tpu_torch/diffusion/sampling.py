"""Ancestral DDPM samplers (counterpart of ``duodiff_tpu/diffusion/sampling.py``).

The JAX package runs the reverse process as an on-device ``lax.scan``; here
each sampler is a step body that reads its timestep from a device table at
a device index and writes x in place, and a host loop that chooses each
step's kind and replays it: a CUDA graph of each kind on the card
(``diffusion/graphs.py``), the same bodies eagerly on the CPU or with
``graphs=False``. ``apply_fn(x, t_batch, y)`` is the model; timesteps go in
as a float32 (B,) tensor. Noise comes from an explicit ``torch.Generator``
on the sampling device, or from an injected ``noise_table`` (steps,
*x.shape) whose row t is used at step t (zero at t == 0), which is how the
tests drive the JAX and torch samplers with the same noise. It is drawn on
the host, into a static buffer, before each step, with the draw an eager
loop makes, so the generator ends every run in the eager run's state.

Stateful mode (``ddpm_scan(state=...)``): ``apply_fn(state, x, t_batch, y,
t) -> (model_output, new_state)``, where ``t`` is the step as a Python int,
so a choice per step (block caching's anchor rule, heavy-light
interleaving's model choice) is a host branch that never waits for the
device. The port's stateful applies are :class:`StepKinds`, which name
that choice, so that each kind is one graph. The state threads from step
to step and from one segment to the next.

``aux_fn(model_output) -> (eps, aux)`` splits a model output into the
prediction that drives the update and per-step diagnostics; the loop writes
the aux rows in step order into a buffer on the device and reads nothing
back, so the caller transfers them once, after the loop.

Beside DDPM: :func:`ddim_sample` (DDIM over a linspace grid, with the
DuoDiff handoff), :func:`dpm_solver_sample` (DPM-Solver++ 1S / 2M, with
block caching anchored by transition index) and :func:`early_exit_sample`
(the DeeDiff / AdaDiff threshold rule over an early-exit model's heads).
"""

from __future__ import annotations

import functools
from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from duodiff_tpu_torch.diffusion.graphs import StepGraphs, device_index, step_graphs
from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule


class RowDraws:
    """A generator whose every draw of a batch (x_T, each step's z) is rows
    lo:hi of a draw of ``total`` rows, ``rows = (lo, hi, total)``: a
    data-parallel rank draws the global batch's noise from the shared
    generator and keeps its rows, so its samples are those a one-process run
    makes for them. The samplers take it where they take a generator."""

    def __init__(self, generator: torch.Generator, rows: tuple):
        self.generator, self.rows = generator, rows

    @property
    def device(self) -> torch.device:
        return self.generator.device


def randn(shape: Sequence[int], generator, device, dtype=torch.float32) -> torch.Tensor:
    """``torch.randn(shape)`` from ``generator``, or from a :class:`RowDraws`
    its rows of the global draw."""
    shape = tuple(shape)
    if not isinstance(generator, RowDraws):
        return torch.randn(shape, generator=generator, device=device, dtype=dtype)
    lo, hi, total = generator.rows
    if shape[0] != hi - lo:
        raise ValueError(f"a draw of {shape[0]} rows from the RowDraws of rows {lo}:{hi}")
    return torch.randn((total, *shape[1:]), generator=generator.generator, device=device,
                       dtype=dtype)[lo:hi]


def draw_into(z: torch.Tensor, generator) -> None:
    """Write into ``z`` the draw :func:`randn` makes of its shape: the
    generator is used as an eager loop's ``randn`` uses it, to the bit."""
    if isinstance(generator, RowDraws):
        z.copy_(randn(z.shape, generator, z.device, z.dtype))
    else:
        z.normal_(generator=generator)


def fill_noise(z: torch.Tensor, row: int, generator, noise_table) -> None:
    """A step's z into the static ``z``, on the host before the step runs:
    zeros at row 0 (the last step draws nothing, whatever the table holds),
    else row ``row`` of ``noise_table`` (copied on the device) or a draw."""
    if row == 0:
        z.zero_()
    elif noise_table is not None:
        z.copy_(noise_table[row])
    else:
        draw_into(z, generator)


class StepKinds:
    """A stateful apply (module docstring) whose choice per step is made on
    the host: ``kind(t)`` names step t's kind and ``kinds[name](state, x,
    t_batch, y) -> (model_output, state)`` runs it, so that each kind can be
    one step graph. Called as ``apply(state, x, t_batch, y, t)`` it runs
    step t's kind."""

    def __init__(self, kinds: dict, kind: Callable[[int], str]):
        self.kinds, self.kind = kinds, kind

    def __call__(self, state, x, t_batch, y, t: int):
        return self.kinds[self.kind(int(t))](state, x, t_batch, y)


def _clone_state(state):
    if isinstance(state, torch.Tensor):
        return state.clone()
    if isinstance(state, (tuple, list)):
        return type(state)(_clone_state(s) for s in state)
    return state


def _write_state(dst, src):
    """``src`` written into the static state ``dst`` in place; returns
    ``dst`` (a state that holds no tensor is taken as it is)."""
    if isinstance(dst, torch.Tensor):
        if src is not dst:
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(f"a step's state must keep its shape and dtype: "
                                 f"{tuple(dst.shape)} {dst.dtype} became {tuple(src.shape)} "
                                 f"{src.dtype}")
            dst.copy_(src)
        return dst
    if isinstance(dst, (tuple, list)) and isinstance(src, (tuple, list)) and len(dst) == len(src):
        return type(dst)(_write_state(d, s) for d, s in zip(dst, src))
    return src


def _write_row(buf, value, i: torch.Tensor, rows: int):
    """Row ``i`` (a 0-d device index) of the static rows ``buf`` (made at the
    first, eager, step: (rows, *value.shape)) set to ``value``, a tensor or
    a tuple of them; returns ``buf``."""
    if isinstance(value, (tuple, list)):
        buf = buf or [None] * len(value)
        return tuple(_write_row(b, v, i, rows) for b, v in zip(buf, value))
    if buf is None:
        buf = torch.zeros((rows, *value.shape), dtype=value.dtype, device=value.device)
    buf.index_copy_(0, i.reshape(1), value.unsqueeze(0))
    return buf


def _rows_of(buf, n: int):
    """The first ``n`` rows of static rows, copied out; ``torch.empty(0)``
    for a loop that ran no step."""
    if buf is None:
        return torch.empty(0)
    if isinstance(buf, tuple):
        return tuple(_rows_of(b, n) for b in buf)
    return buf[:n].clone()


class _Steps:
    """A loop's static buffers on its run's :class:`StepGraphs`: ``x`` and
    ``z`` (the run's, shared by its loops of that shape), the timestep table
    ``ts`` and the step index ``i`` (the loop's own, advanced by the step
    body on the device) and the labels ``y``. The host keeps its own copy of
    the timesteps to choose each step's kind and its noise."""

    def __init__(self, run: StepGraphs, x: torch.Tensor, y, rows: int):
        self.run, self.rows = run, rows
        self.x = run.buffer("x", x.shape, x.dtype)
        self.z = run.buffer("z", x.shape, x.dtype)
        self.i = torch.zeros((), dtype=torch.long, device=self.x.device)
        self.ts = torch.zeros(rows, dtype=torch.long, device=self.x.device)
        self.y = None if y is None else torch.empty(y.shape, dtype=y.dtype, device=self.x.device)
        self._bodies: dict = {}

    def start(self, x, ts: list, y) -> None:
        """A call's inputs into the buffers: x (unless it is the buffer), the
        timesteps, y; the index to 0."""
        if len(ts) > self.rows:
            raise ValueError(f"{len(ts)} steps for a loop of at most {self.rows}")
        if x is not self.x:
            self.x.copy_(x)
        if ts:
            self.ts[:len(ts)].copy_(torch.tensor(ts))
        self.i.zero_()
        if self.y is not None:
            self.y.copy_(y)

    def timestep(self, table=None):
        """The step's t, a 0-d tensor read from ``ts`` (or ``table``) at ``i``
        on the device, and the model's (B,) float32 timesteps."""
        t = device_index(self.i, self.ts if table is None else table)
        return t, t.to(torch.float32).expand(self.x.shape[0]).contiguous()

    def step(self, kind) -> None:
        """One step of ``kind``: its body, graphed or eager by the run."""
        body = self._bodies.get(kind)
        if body is None:
            body = self._bodies[kind] = functools.partial(self.body, kind)
        self.run.step((id(self), kind), body, (self.x, self.z, self.i, self.ts))


class _DDPMSteps(_Steps):
    """:func:`ddpm_loop`'s buffers and step body; kinds: None (a stateless
    apply), a :class:`StepKinds` name, or "host" (a stateful apply that reads
    the Python-int step: eager only)."""

    def __init__(self, run, apply_fn, schedule, parametrization, variance_mode, aux_fn, x, y):
        super().__init__(run, x, y, schedule.steps)
        self.apply_fn, self.schedule, self.aux_fn = apply_fn, schedule, aux_fn
        self.parametrization, self.variance_mode = parametrization, variance_mode
        self.state = self.aux = self.t_host = None

    def body(self, kind) -> None:
        t, t_batch = self.timestep()
        if kind is None:
            out = self.apply_fn(self.x, t_batch, self.y)
        else:
            if kind == "host":
                out, new = self.apply_fn(self.state, self.x, t_batch, self.y, self.t_host)
            else:
                out, new = self.apply_fn.kinds[kind](self.state, self.x, t_batch, self.y)
            self.state = _write_state(self.state, new)
        if self.aux_fn is not None:
            out, aux = self.aux_fn(out)
            self.aux = _write_row(self.aux, aux, self.i, self.rows)
        self.x.copy_(self.schedule.step(self.parametrization, out, self.x, t, self.z,
                                        self.variance_mode))
        self.i.add_(1)

    def __call__(self, x, generator, ts: list, y, noise_table, state):
        stateful = state is not None
        kinds = isinstance(self.apply_fn, StepKinds)
        if stateful and not kinds and self.run.graphed:
            raise ValueError("a stateful apply that reads the Python-int step cannot be "
                             "graphed: make it a StepKinds, or pass graphs=False")
        self.start(x, ts, y)
        if stateful:
            self.state = (_clone_state(state) if self.state is None
                          else _write_state(self.state, state))
        for t in ts:
            self.t_host = t
            fill_noise(self.z, t, generator, noise_table)
            self.step(None if not stateful else self.apply_fn.kind(t) if kinds else "host")
        out = (self.x, self.state) if stateful else (self.x,)
        if self.aux_fn is not None:
            out = (*out, _rows_of(self.aux, len(ts)))
        return out if len(out) > 1 else self.x


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
    graphs=True,
):
    """The ancestral update over the descending timesteps ``ts``
    (``ddpm_scan``). With ``state`` the apply is stateful (module
    docstring) and the result is ``(x, state)``; with ``aux_fn`` the aux
    rows, stacked in step order, come last: ``(x, aux)`` or ``(x, state,
    aux)``.

    Each step is one step body (:class:`_DDPMSteps`) that reads t from a
    device table and writes x in place; ``graphs`` (:func:`step_graphs`)
    replays it as a CUDA graph a kind on the card, by default, or runs it
    eagerly (on the CPU, or ``graphs=False``). Given a run's
    :class:`StepGraphs`, the loop keeps its graphs there for the run's later
    calls, and the x and state it returns are the run's buffers, which
    those calls overwrite. The ``state`` a call is given is copied into
    the loop's own static state (a chunk's zero probe sum, a drift scan's
    zero delta), outside the graphs. The aux rows are static too,
    ``schedule.steps`` of them, each step's written at its device index."""
    ts = [int(t) for t in ts]
    run = step_graphs(graphs, x.device)
    key = ("ddpm", id(apply_fn), id(aux_fn), id(schedule), parametrization, variance_mode,
           tuple(x.shape), x.dtype, y is None)
    loop = run.loop(key, lambda: _DDPMSteps(run, apply_fn, schedule, parametrization,
                                            variance_mode, aux_fn, x, y))
    return loop(x, generator, ts, y, noise_table, state)


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
        lead, b, doubled = _double_batch_for_cfg(args, null_label)
        out = apply_fn(*lead, *doubled)
        cond, uncond = out[:b], out[b:]
        return uncond + guidance_scale * (cond - uncond)

    return guided


def _double_batch_for_cfg(args, null_label: int):
    """Split the leading (pass-through) arguments from the trailing (x, t, y)
    triple and double its batch, the conditional half first and the
    null-label half second: ``(lead, b, (xx, tt, yy))``."""
    *lead, x, t, y = args
    if y is None:
        raise ValueError("guidance needs class labels")
    doubled = (torch.cat([x, x]), torch.cat([t, t]),
               torch.cat([y, torch.full_like(y, null_label)]))
    return lead, x.shape[0], doubled


def make_guided_apply_ee(apply_fn: Callable, guidance_scale: float, null_label: int) -> Callable:
    """Classifier-free guidance for an early-exit apply returning
    ``(backbone (B, ...), probes (depth, B), heads (depth, B, ...))``: one
    forward at twice the batch (:func:`make_guided_apply`'s doubling); the
    backbone and every head are guided, the probes come from the
    conditional half. Returns the same triple on the original batch."""

    def guided(*args):
        lead, b, doubled = _double_batch_for_cfg(args, null_label)
        backbone, probes, heads = apply_fn(*lead, *doubled)
        backbone = backbone[b:] + guidance_scale * (backbone[:b] - backbone[b:])
        heads = heads[:, b:] + guidance_scale * (heads[:, :b] - heads[:, b:])
        return backbone, probes[:, :b], heads

    return guided


def make_interleaved_apply(apply_full: Callable, apply_shallow: Callable, every: int) -> StepKinds:
    """Heavy-light interleaving: the full model on the steps with ``t %
    every == 0`` (t = 0 among them), the shallow model on the others.
    Both take ``(x, t_batch, y)``. The JAX package reads the step from the
    timestep vector under ``lax.cond``; here the choice is the host's, on
    the Python-int step, with no read from the device: a
    :class:`StepKinds` of the kinds "full" and "shallow", whose state
    passes through untouched (start it as ``()``)."""
    if every < 1:
        raise ValueError(f"every must be >= 1, got {every}")
    return StepKinds(
        {"full": lambda state, x, t_batch, y: (apply_full(x, t_batch, y), state),
         "shallow": lambda state, x, t_batch, y: (apply_shallow(x, t_batch, y), state)},
        lambda t: "full" if t % every == 0 else "shallow")


def make_block_cached_apply(apply_anchor: Callable, apply_cached: Callable, every,
                            t_first: int) -> StepKinds:
    """Training-free block caching (the Delta-DiT / DeepCache family): on
    anchor steps run the full model and keep the centered region's residual
    (``apply_anchor(x, t_batch, y) -> (out, delta)``, UViT.forward_anchor);
    on the steps between, run only the outer blocks with that residual
    (``apply_cached(x, t_batch, y, delta) -> out``, UViT.forward_cached).

    Anchors: ``t % every == 0`` for an int period, or ``table[t]`` for a
    1-D boolean table indexed by t (a drift-derived schedule); in both
    forms also ``t == t_first``, the segment's first step, where no delta
    exists yet. Returns a :class:`StepKinds` of the kinds "anchor" and
    "cached", whose state is the delta (start it as zeros (B, L, D) in the
    compute dtype).
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

    def kind(t: int) -> str:
        anchor = (t % every == 0) if table is None else bool(table[t])
        return "anchor" if anchor or t == t_first else "cached"

    return StepKinds(
        {"anchor": lambda state, x, t_batch, y: apply_anchor(x, t_batch, y),
         "cached": lambda state, x, t_batch, y: (apply_cached(x, t_batch, y, state), state)},
        kind)


class DDPMSampler:
    """``init`` draws x_T; ``run(x, generator, t_start, t_end, y)`` advances
    t = t_start down to t_end inclusive, so callers can compose segments
    over different models (the DuoDiff handoff). The counterpart of
    ``ChunkedDDPMSampler``: its chunk, one jitted scan with the timesteps as
    a dynamic argument, is here a set of step graphs replayed over the
    segment's timesteps (:func:`ddpm_loop`).

    With ``init_state_fn`` the sampler is stateful: ``apply_fn`` follows
    the stateful contract, ``init_state_fn(x)`` builds a segment's first
    state, and ``run(..., state=)`` returns ``(x, state)`` for the next
    segment. ``noise_table`` (steps, *shape) replaces the generator's draws
    (module docstring). ``graphs`` is :func:`ddpm_loop`'s: by default each
    ``run`` captures its own graphs; a run's :class:`StepGraphs` shares
    them, and its buffers, across the runs given it."""

    def __init__(self, apply_fn: Callable, schedule: NoiseSchedule, *,
                 parametrization: str = "predict_noise",
                 variance_mode: str = "beta_tilde",
                 init_state_fn: Optional[Callable] = None,
                 noise_table: Optional[torch.Tensor] = None,
                 graphs=True):
        self.apply_fn = apply_fn
        self.schedule = schedule
        self.parametrization = parametrization
        self.variance_mode = variance_mode
        self.init_state_fn = init_state_fn
        self.noise_table = noise_table
        self.graphs = graphs

    def init(self, generator: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
        return randn(shape, generator, generator.device)

    def run(self, x, generator, t_start: int, t_end: int = 0, y=None, state=None):
        if (self.init_state_fn is not None) != (state is not None):
            raise ValueError("a stateful sampler (init_state_fn) runs with state=, "
                             "a stateless one without")
        return ddpm_loop(
            self.apply_fn, self.schedule, self.parametrization, x, generator,
            range(t_start, t_end - 1, -1), y, self.variance_mode,
            noise_table=self.noise_table, state=state, graphs=self.graphs,
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
    graphs=True,
) -> torch.Tensor:
    """DuoDiff: the shallow model runs the first ``t_switch`` (high-noise)
    steps t = T-1 .. T-t_switch, the full model the remaining ones; both
    segments' graphs share one run, and with it one x buffer."""
    steps = schedule.steps
    if x_init is None:
        x_init = randn(shape, generator, generator.device)
    run = step_graphs(graphs, x_init.device)
    t_switch = min(max(int(t_switch), 0), steps)
    handoff = steps - t_switch
    x = ddpm_loop(early_apply_fn, schedule, parametrization, x_init, generator,
                  range(steps - 1, handoff - 1, -1), y, variance_mode, noise_table, graphs=run)
    return ddpm_loop(late_apply_fn, schedule, parametrization, x, generator,
                     range(handoff - 1, -1, -1), y, variance_mode, noise_table, graphs=run)


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
    return randn(shape, generator, generator.device)


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
    graphs=True,
):
    """Ancestral DDPM over t = T-1 .. 0. ``timesteps_save`` counts reverse
    steps: the state after the update at t = steps - s is kept for each s in
    [1, steps], others are skipped, as in the JAX package. Returns ``(x,
    intermediates)``, the latter ordered like the kept values of
    ``timesteps_save``, each copied out of the run's x buffer after its
    step."""
    steps = schedule.steps
    x = _initial_noise(x_init, shape, generator)
    run = step_graphs(graphs, x.device)
    valid = [int(s) for s in timesteps_save if 1 <= int(s) <= steps]
    kept = {}
    for _, t_hi, t_lo in split_segments([(None, steps - 1, 0)], {steps - s for s in valid}):
        x = ddpm_loop(apply_fn, schedule, parametrization, x, generator,
                      range(t_hi, t_lo - 1, -1), y, variance_mode, noise_table, graphs=run)
        kept[t_lo] = x.clone()
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


class _DDIMSteps(_Steps):
    """:func:`ddim_sample`'s buffers and step body: the pair (t, s) read from
    the device tables ``ts`` and ``ss``; kinds "early" and "late" (the
    DuoDiff handoff's two models). The pair with s = 0 draws nothing: its
    static z is zeroed on the host."""

    def __init__(self, run, applies: dict, schedule, eta: float, x, y, rows: int):
        super().__init__(run, x, y, rows)
        self.applies, self.schedule, self.eta = applies, schedule, eta
        self.ss = torch.zeros(rows, dtype=torch.long, device=self.x.device)

    def body(self, kind) -> None:
        t, t_batch = self.timestep()
        s = device_index(self.i, self.ss)
        out = self.applies[kind](self.x, t_batch, self.y)
        self.x.copy_(self.schedule.ddim_step(out, self.x, t, s, self.z, eta=self.eta))
        self.i.add_(1)


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
    graphs=True,
):
    """DDIM over :func:`ddim_timestep_grid` (reference sampler.py:103-126),
    with the DuoDiff handoff of :func:`ddim_pairs` when both
    ``late_apply_fn`` and ``t_switch`` are given. The noise of the pair (t,
    s) is zero where s == 0; ``noise_table`` (steps, *shape) gives it as row
    s in place of a draw from ``generator``. The state after the pair (t, s)
    is kept when ``steps - t`` is in ``timesteps_save``. Returns ``(x,
    intermediates)``, the latter ordered like the kept values of
    ``timesteps_save``. ``graphs`` is :func:`ddpm_loop`'s."""
    steps = schedule.steps
    split = t_switch if late_apply_fn is not None else None
    early_pairs, late_pairs = ddim_pairs(steps, ddim_steps, split)
    pairs = [("early", t, s) for t, s in early_pairs] + [("late", t, s) for t, s in late_pairs]
    x = _initial_noise(x_init, shape, generator)
    run = step_graphs(graphs, x.device)
    key = ("ddim", id(apply_fn), id(late_apply_fn), id(schedule), float(eta), len(pairs),
           tuple(x.shape), x.dtype, y is None)
    loop = run.loop(key, lambda: _DDIMSteps(run, {"early": apply_fn, "late": late_apply_fn},
                                            schedule, float(eta), x, y, max(len(pairs), 1)))
    loop.start(x, [t for _, t, _ in pairs], y)
    if pairs:
        loop.ss[:len(pairs)].copy_(torch.tensor([s for _, _, s in pairs]))
    save_set = {int(v) for v in timesteps_save}
    snapshots = {}
    for kind, t, s in pairs:
        fill_noise(loop.z, s, generator, noise_table)
        loop.step(kind)
        if steps - t in save_set:
            snapshots[steps - t] = loop.x.clone()
    return loop.x, [snapshots[int(s)] for s in timesteps_save if int(s) in snapshots]


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


class _DPMSteps(_Steps):
    """:func:`dpm_solver_sample`'s buffers and step body: transition ``i``'s
    constants gathered from the device tables at the device index, the
    previous x0 a static buffer; kinds (model, first): model "plain",
    "anchor" (writes the static residual) or "cached" (reads it), and
    whether the transition is the first, whose D is x0 alone."""

    def __init__(self, run, apply_fn, cache, tables: dict, order: int, parametrization: str,
                 x, y):
        super().__init__(run, x, y, len(tables["t_prev_host"]))
        self.apply_fn, self.cache, self.c = apply_fn, cache, tables
        self.order, self.parametrization = order, parametrization
        self.x0_prev = torch.zeros_like(self.x)
        self.delta = None

    def body(self, kind) -> None:
        model, first = kind
        _, t_batch = self.timestep(self.c["t_prev"])
        x = self.x
        if model == "plain":
            out = self.apply_fn(x, t_batch, self.y)
        elif model == "anchor":
            out, delta = self.cache[0](x, t_batch, self.y)
            self.delta.copy_(delta)
        else:
            out = self.cache[1](x, t_batch, self.y, self.delta)

        def c(name):
            return device_index(self.i, self.c[name])

        x0 = out if self.parametrization == "predict_original" else (
            (x - c("sigma_prev") * out) / c("alpha_prev"))
        if self.order == 1 or first:
            d = x0
        else:
            d = c("c_cur") * x0 - c("c_prev") * self.x0_prev
        x.copy_(c("sigma_ratio") * x - c("alpha_t") * c("phi") * d)
        self.x0_prev.copy_(x0)
        self.i.add_(1)


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
    graphs=True,
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
    ``apply_fn`` is not called when ``cache`` is given. ``graphs`` is
    :func:`ddpm_loop`'s."""
    if order not in (1, 2):
        raise ValueError(f"order must be 1 or 2, got {order}")
    if parametrization not in ("predict_noise", "predict_original"):
        raise ValueError(f"DPM-Solver takes predict_noise or predict_original, got "
                         f"{parametrization!r}")
    every = None
    if cache is not None:
        every = cache[2]
        if every < 1:
            raise ValueError(f"cache every must be >= 1, got {every}")
    x = _initial_noise(x_init, shape, generator)
    run = step_graphs(graphs, x.device)
    key = ("dpm", id(apply_fn), None if cache is None else tuple(map(id, cache)), id(schedule),
           dpm_steps, order, parametrization, tuple(x.shape), x.dtype, y is None)
    loop = run.loop(key, lambda: _DPMSteps(run, apply_fn, cache,
                                           dpm_solver_tables(schedule, dpm_steps), order,
                                           parametrization, x, y))
    loop.start(x, [], y)
    if cache is not None:
        delta = cache[3](x)
        loop.delta = delta.clone() if loop.delta is None else loop.delta.copy_(delta)
    for i in range(len(loop.c["t_prev_host"])):
        model = "plain" if cache is None else "anchor" if i % every == 0 else "cached"
        loop.step((model, i == 0))
    return loop.x


class _EESteps(_Steps):
    """:func:`ee_loop`'s buffers and step body: the exit chosen on the
    device, the probes' batch means and the exit indices written to static
    rows at the device index."""

    def __init__(self, run, apply_fn, schedule, threshold: float, x, y):
        super().__init__(run, x, y, schedule.steps)
        self.apply_fn, self.schedule, self.threshold = apply_fn, schedule, threshold
        self.errs = self.idxs = None

    def body(self, kind) -> None:
        batch = self.x.shape[0]
        t, t_batch = self.timestep()
        backbone, u, g = self.apply_fn(self.x, t_batch, self.y)
        outputs = torch.cat([g, backbone[None]])
        probes = torch.cat([u, torch.zeros((1, batch), dtype=u.dtype, device=u.device)])
        indices = (probes <= self.threshold).to(torch.int32).argmax(0)
        selected = outputs[indices, torch.arange(batch, device=self.x.device)]
        self.x.copy_(self.schedule.step_predict_noise(selected, self.x, t, self.z))
        self.errs = _write_row(self.errs, probes[:-1].mean(1), self.i, self.rows)
        self.idxs = _write_row(self.idxs, indices.to(torch.int32), self.i, self.rows)
        self.i.add_(1)


def ee_loop(apply_fn: Callable, schedule: NoiseSchedule, threshold: float, x: torch.Tensor,
            generator: Optional[torch.Generator], ts: Iterable[int],
            y: Optional[torch.Tensor] = None, noise_table: Optional[torch.Tensor] = None,
            graphs=True):
    """The early-exit update over the descending timesteps ``ts`` (``ee_scan``).
    ``apply_fn(x, t_batch, y)`` returns ``(backbone, u (depth, B), g (depth,
    B, ...))``. Each sample takes the output of the first probe point whose
    probe reads ``<= threshold``, the backbone appended with probe 0; when
    none qualifies (threshold < 0) the argmax over an all-false mask is 0,
    the shallowest head, as in the reference. Returns ``(x, err_rows
    (len(ts), depth), idx_rows (len(ts), B))`` in ``ts``' order, on the
    device: the batch mean of each probe and each sample's exit index.
    ``graphs`` is :func:`ddpm_loop`'s."""
    ts = [int(t) for t in ts]
    run = step_graphs(graphs, x.device)
    key = ("ee", id(apply_fn), id(schedule), float(threshold), tuple(x.shape), x.dtype,
           y is None)
    loop = run.loop(key, lambda: _EESteps(run, apply_fn, schedule, float(threshold), x, y))
    loop.start(x, ts, y)
    for t in ts:
        fill_noise(loop.z, t, generator, noise_table)
        loop.step("ee")
    return loop.x, _rows_of(loop.errs, len(ts)), _rows_of(loop.idxs, len(ts))


def early_exit_sample(
    apply_fn: Callable,
    generator: Optional[torch.Generator],
    *,
    schedule: NoiseSchedule,
    shape: Sequence[int],
    threshold: float,
    y: Optional[torch.Tensor] = None,
    x_init: Optional[torch.Tensor] = None,
    noise_table: Optional[torch.Tensor] = None,
    graphs=True,
):
    """DeeDiff / AdaDiff early-exit sampling over t = T-1 .. 0 with
    :func:`ee_loop`'s rule and the predict_noise update. Returns ``(x,
    err_by_t (T, depth), idx_by_t (T, B))``, the diagnostics indexed by t
    ascending, as the reference logs them. ``graphs`` is :func:`ddpm_loop`'s."""
    x = _initial_noise(x_init, shape, generator)
    x, errs, idxs = ee_loop(apply_fn, schedule, threshold, x, generator,
                            range(schedule.steps - 1, -1, -1), y, noise_table, graphs)
    return x, errs.flip(0), idxs.flip(0)


def early_exit_select(lambda_threshold: float, model_output, earliest_exit_index: int):
    """The legacy DeeDiff gate (reference ddpm_core.py:7-52): per sample the
    first layer with ``1 - u > lambda``, clamped up to
    ``earliest_exit_index``; where no layer qualifies, the backbone's
    prediction and exit layer ``depth`` as a sentinel.

    ``model_output = (predicted_noise (B, ...), u (depth, B) or (B, depth,
    ...), g (depth, B, ...))``. Returns ``(selected (B, ...), exit_layers
    (B,) int32)``."""
    predicted_noise, u, g = model_output
    u = torch.as_tensor(u)
    if u.ndim > 2:  # (B, depth, ...) layout of the legacy path
        u = u.mean(dim=tuple(range(2, u.ndim))).transpose(0, 1)
    depth = u.shape[0]
    layer_ids = torch.arange(depth, device=u.device)[:, None]
    masked = torch.where((1.0 - u) > lambda_threshold, layer_ids, depth)
    first_true = masked.min(0).values
    never_met = first_true >= depth
    exit_layers = torch.where(never_met, depth,
                              torch.clamp(first_true, min=earliest_exit_index))
    stacked = torch.cat([g, predicted_noise[None]])
    selected = stacked[exit_layers, torch.arange(u.shape[1], device=u.device)]
    return selected, exit_layers.to(torch.int32)
