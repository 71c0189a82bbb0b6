"""Mixed-timestep continuous batching for diffusion serving (counterpart of
``duodiff_tpu/diffusion/continuous.py``).

One step over a fixed slot batch where every slot carries its own
timestep: requests at different points of their trajectories share every
model forward, new requests join free slots between advances, and finished
slots free up at once. The batch never changes shape (``slots`` rows every
step, a ``live`` mask selects which rows the update takes), so the kernels
always see one shape.

Per-slot timesteps are data: the U-ViT forward takes a per-row timestep
vector, and the reverse steps (``NoiseSchedule.step`` / ``ddim_step``)
take a (B,) tensor of per-row timesteps, gathering each row's
coefficients. Everything per step stays on the device; the host keeps a
mirror of each slot's progress (``steps_done``), so no advance waits for
the device to learn who finished.

Noise. Each job carries its own source: a ``torch.Generator`` on the
serving device, or a :class:`TableNoise` (x_T and the per-step rows, the
counterpart of the sequential samplers' ``noise_table``). A slot consumes
its generator exactly as the port's bucket-1 sequential sampler does: x_T
first, then for DDPM one draw for each t > 0, for DDIM one for each pair
(t, s) with s > 0, for DPM-Solver++ none. So a slot's trajectory equals a
dedicated bucket-1 run of :class:`~duodiff_tpu_torch.diffusion.sampling.DDPMSampler`,
:func:`~duodiff_tpu_torch.diffusion.sampling.ddim_sample` or
:func:`~duodiff_tpu_torch.diffusion.sampling.dpm_solver_sample` from the same
generator, wherever the model's rows do not depend on the batch (the plain
PyTorch path on the CPU: to the bit). The JAX package gives each slot a
threefry key instead, which torch cannot reproduce; the tests drive both
batchers with JAX's own draws through :class:`TableNoise`.

Over the data ranks of a process grid (``mesh``, the JAX batcher's mesh):
data rank d holds the global slots [d S / n, (d + 1) S / n) (their x,
noise sources, labels and cache deltas), so a step advances S / n slots on
each rank with no collective of its own. Every rank makes the same calls
with the same global slot numbers (a server's rank 0 broadcasts them), so
the host mirror and the wave counter are the same on every rank; a rank
ignores the noise source of a slot it does not hold, and the finished
images are gathered on the host. A request's images stay the one-process
batcher's.

A step is one step body that writes the slot state (x, the step counts,
the solver's previous x0, the cache's residual) in place, and each kind of
step (plain, or a block cache's anchor and cached steps, chosen by the
host's wave counter) is captured once as a CUDA graph and replayed
(``diffusion/graphs.py``): the counterpart of the JAX batcher's
``fori_loop`` over a poll's steps. Each slot's noise is drawn on the host,
from the slot's own source, into a static buffer before each step, as the
eager step draws it.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from duodiff_tpu_torch.diffusion.graphs import step_graphs
from duodiff_tpu_torch.diffusion.sampling import ddim_timestep_grid, dpm_solver_tables
from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule


def periodic_pattern_table(pattern, steps: int) -> np.ndarray:
    """The absolute-t anchor table equivalent to a wave-index ``pattern``.

    A slot admitted on a phase-aligned wave sees step j at timestep ``t =
    steps-1-j``, so ``table[t] = pattern[(steps-1-t) % p]``. The sequential
    samplers on this table (``--cache_schedule``) reproduce the
    pattern-cached batcher's per-slot trajectories to the bit."""
    pattern = np.asarray(pattern).astype(bool).ravel()
    if pattern.size < 1 or not pattern[0]:
        raise ValueError("pattern must be non-empty with pattern[0] True")
    t = np.arange(steps)
    return pattern[(steps - 1 - t) % pattern.size]


def fold_table_to_pattern(table) -> Optional[np.ndarray]:
    """Smallest wave-index pattern whose :func:`periodic_pattern_table`
    reproduces ``table`` exactly, or None if the table is aperiodic or its
    first reverse step (t = T-1) is not an anchor."""
    table = np.asarray(table).astype(bool).ravel()
    steps = table.size
    idx = table[::-1]  # wave-index view: idx[j] = table[steps-1-j]
    if not idx[0]:
        return None
    for p in range(1, steps):
        if np.array_equal(idx, np.resize(idx[:p], steps)):
            return idx[:p].copy()
    return None  # only "period" = full length: aperiodic


@dataclasses.dataclass(frozen=True)
class TableNoise:
    """A job's injected noise: ``x_init`` (H, W, C), its x_T, and ``table``
    (steps, H, W, C), indexed as the sequential samplers index their
    ``noise_table``: row t at the DDPM step t, row s at the DDIM pair (t,
    s). DPM-Solver++ draws nothing past x_T, so it takes no table."""

    x_init: torch.Tensor
    table: Optional[torch.Tensor] = None


class ContinuousDiffusionBatcher:
    """Slot-batched mixed-timestep sampler.

    Host API:

    - ``admit(slot, noise, class_id)``: seed a free slot with a job's noise
      source (a ``torch.Generator`` or a :class:`TableNoise`); x_T is drawn
      or copied into the slot;
    - ``advance()``: ``steps_per_poll`` mixed-timestep steps;
    - ``finished()`` / ``free_slots()``: the host mirror's view;
    - ``begin_finish(slots)`` / ``finish_many`` / ``finish``: fetch finished
      images and free their slots;
    - ``poll()``: the device's (steps done, active), for tests.

    The reverse steps are fixed at the serving forms: DDPM with the
    beta_tilde variance, deterministic DDIM (eta 0), DPM-Solver++ 2M.

    ``apply_fn(x, t_batch, y) -> model_output`` is the sequential samplers'
    apply (guidance wrappers compose unchanged); ``y`` is None for an
    unconditional model (``conditional=False``).

    ``cache=(apply_anchor, apply_cached, every, init_state)`` composes block
    caching as in :func:`~duodiff_tpu_torch.diffusion.sampling.dpm_solver_sample`:
    ``apply_anchor(x, t, y) -> (out, delta)``, ``apply_cached(x, t, y,
    delta) -> out``, ``init_state(x) -> delta0``. The anchor decision must be
    the same for every slot, so admissions happen only on phase-aligned
    waves (``can_admit_cached()``: the global step counter is 0 modulo the
    period) and every slot in flight anchors together. The decision is a
    host branch on the host's step counter; nothing is read from the
    device. DDPM with an int period needs ``(steps - 1) % every == 0`` so
    that a fresh slot's first step is an anchor, as the t-anchored
    sequential rule has it; DPM-Solver++ anchors by transition index, any
    period. ``every`` may instead be a 1-D boolean wave-index pattern (DDPM
    only, ``pattern[0]`` True): step j of every slot anchors iff
    ``pattern[j % len(pattern)]``; :func:`periodic_pattern_table` is the
    equivalent absolute-t table of the sequential samplers.

    ``mesh``: a process grid (``parallel/mesh.py``) whose data ranks split
    the slots (module docstring); the slots must divide them. A grid that
    runs the batch whole on every rank (``replicated``) splits nothing.

    ``graphs`` (:func:`~duodiff_tpu_torch.diffusion.graphs.step_graphs`):
    the steps replay as CUDA graphs on the card by default
    (:meth:`capture_graphs` makes them before any slot is admitted), or run
    eagerly (on the CPU, or ``graphs=False``).
    """

    def __init__(
        self,
        apply_fn: Callable,
        schedule: NoiseSchedule,
        *,
        img_shape,
        slots: int,
        method: str = "ddpm",
        parametrization: str = "predict_noise",
        ddim_steps: int = 50,
        dpm_steps: int = 20,
        steps_per_poll: int = 5,
        conditional: bool = False,
        cache: Optional[tuple] = None,
        mesh=None,
        graphs=True,
    ):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        n_data = 1 if mesh is None or mesh.replicated else mesh.data
        if slots % n_data:
            raise ValueError(f"slots ({slots}) must be divisible by the mesh's {n_data} data "
                             "shards")
        # this rank's slots: [lo, lo + held) of the global slot numbers
        self.mesh = mesh if n_data > 1 else None
        self._held = slots // n_data
        self._lo = 0 if self.mesh is None else mesh.data_rank * self._held
        if steps_per_poll < 1:
            raise ValueError(f"steps_per_poll must be >= 1, got {steps_per_poll}")
        if method not in ("ddpm", "ddim", "dpm"):
            raise ValueError(f"unknown method {method!r}")
        self.apply_fn = apply_fn
        self.schedule = schedule
        self.method = method
        self.parametrization = parametrization
        self.slots = slots
        self.img_shape = tuple(img_shape)
        self.conditional = conditional
        self.steps_per_poll = steps_per_poll
        self._pattern = None
        if cache is not None:
            if method not in ("ddpm", "dpm"):
                raise ValueError(f"cache composes with ddpm/dpm methods, not {method!r}")
            rule = cache[2]
            if isinstance(rule, bool):
                raise ValueError(f"cache every must be an int or a pattern, got {rule!r}")
            if isinstance(rule, (int, np.integer)):
                if rule < 1:
                    raise ValueError(f"cache every must be >= 1, got {rule}")
                if method == "ddpm" and (schedule.steps - 1) % rule != 0:
                    raise ValueError(
                        "ddpm block caching in the continuous batcher needs (steps - 1) % every "
                        f"== 0 so a fresh slot's first step is an anchor (steps={schedule.steps}, "
                        f"every={rule}); use e.g. every=3 at 1000 steps")
                period = int(rule)
            else:
                pattern = np.asarray(rule).astype(bool).ravel()
                if method != "ddpm":
                    raise ValueError("wave-index anchor patterns compose with method='ddpm' "
                                     f"only, not {method!r} (dpm anchors on its own solver-grid "
                                     "indices)")
                if pattern.size < 1 or not pattern[0]:
                    raise ValueError("anchor pattern must be non-empty with pattern[0] True (a "
                                     "fresh slot's first step needs a real delta)")
                self._pattern = pattern
                period = int(pattern.size)
        self.cache = cache
        self.cache_every = period if cache is not None else 1
        # the host's step counter: every advance() adds steps_per_poll; the
        # anchor phase and the admission gate read it
        self._w_host = 0

        device = schedule.alphas_bar.device
        if method == "ddpm":
            t_host = np.arange(schedule.steps - 1, -1, -1)
            self._draw_rows = t_host  # the noise row of step j, drawn where > 0
        elif method == "ddim":
            if parametrization != "predict_noise":
                raise ValueError("ddim continuous batching supports predict_noise only, got "
                                 f"{parametrization!r}")
            grid = ddim_timestep_grid(schedule.steps, ddim_steps)
            t_host, s_host = grid[:-1], grid[1:]
            self._s = torch.as_tensor(s_host, dtype=torch.long, device=device)
            self._draw_rows = s_host
        else:
            if parametrization not in ("predict_noise", "predict_original"):
                raise ValueError("dpm supports predict_noise/predict_original, got "
                                 f"{parametrization!r}")
            tab = dpm_solver_tables(schedule, dpm_steps)
            t_host = np.asarray(tab.pop("t_prev_host"))
            del tab["t_prev"]  # the model's timestep: self._t_model below
            self._dpm = tab
            self._draw_rows = None
        self.n_trans = len(t_host)
        self._t = torch.as_tensor(t_host, dtype=torch.long, device=device)
        self._t_model = self._t.to(torch.float32)

        s = self._held
        f32 = torch.float32
        self.x = torch.zeros((s,) + self.img_shape, dtype=f32, device=device)
        self.x0_prev = torch.zeros_like(self.x)
        self.i = torch.full((s,), self.n_trans, dtype=torch.long, device=device)
        self.active = torch.zeros((s,), dtype=torch.bool, device=device)
        self.y = torch.zeros((s,), dtype=torch.long, device=device)
        self.delta = cache[3](self.x) if cache is not None else None
        self._z = torch.zeros_like(self.x)  # the step's noise, drawn on the host
        self.graphs = step_graphs(graphs, device)
        self._bodies = {kind: (lambda kind=kind: self._body(kind))
                        for kind in ((None,) if cache is None else ("anchor", "cached"))}
        self._noise: dict = {}
        # host mirror of per-slot progress: slot -> steps completed
        # (occupied slots only). Progress is deterministic: an occupied slot
        # gains steps_per_poll steps an advance(), clipped at n_trans.
        self.steps_done: dict[int, int] = {}

    # -- host API ----------------------------------------------------------

    def admit(self, slot: int, noise, class_id: Optional[int] = None):
        """Seed free ``slot`` with a job: x_T from ``noise`` (a generator's
        first draw, or a :class:`TableNoise`'s ``x_init``), its label."""
        self._assert_admissible()
        self._admit(slot, noise, class_id)

    def admit_many(self, assignments: dict):
        """Admit ``{slot: (noise, class_id)}`` on one wave; the same as
        per-slot :meth:`admit` calls in slot order."""
        if not assignments:
            return
        self._assert_admissible()
        for slot in sorted(assignments):
            self._admit(slot, *assignments[slot])

    def _admit(self, slot: int, noise, class_id):
        if not 0 <= slot < self.slots or slot in self.steps_done:
            raise ValueError(f"slot {slot} is not a free slot of {self.slots}")
        if not isinstance(noise, (torch.Generator, TableNoise)):
            raise TypeError(f"a job's noise is a torch.Generator or a TableNoise, got "
                            f"{type(noise).__name__}")
        if isinstance(noise, TableNoise) and self._draw_rows is not None and noise.table is None:
            raise ValueError(f"{self.method} draws noise every step: a TableNoise needs its "
                             "table")
        self.steps_done[slot] = 0
        j = slot - self._lo
        if not 0 <= j < self._held:
            return  # another data rank's slot
        if isinstance(noise, torch.Generator):
            # the sequential samplers' x_T: randn((1, H, W, C), generator)
            self.x[j:j + 1].normal_(generator=noise)
        else:
            self.x[j].copy_(noise.x_init)
        self.x0_prev[j] = 0.0
        self.i[j] = 0
        self.active[j] = True
        self.y[j] = 0 if class_id is None else int(class_id)
        self._noise[slot] = noise

    def can_admit_cached(self) -> bool:
        """True when admissions are allowed now: always without caching;
        with caching only on phase-aligned waves (the step counter is 0
        modulo the period), so that a new slot's first step is an anchor and
        the whole batch keeps one phase. Held requests wait at most
        period - 1 waves."""
        return self.cache is None or self._w_host % self.cache_every == 0

    def _assert_admissible(self):
        if not self.can_admit_cached():
            raise RuntimeError(
                "cached batcher: admissions only on phase-aligned waves "
                f"(w={self._w_host}, every={self.cache_every}); check can_admit_cached() "
                "before admitting")

    def _noise_for_step(self, progress: dict) -> None:
        """The (slots, H, W, C) noise of one step into the static z: each
        live slot's own draw (or table row) where its step draws, zeros
        elsewhere; nothing when the method draws none. ``progress`` is each
        occupied slot's step; the slots of other data ranks draw there."""
        if self._draw_rows is None:
            return
        z = self._z
        z.zero_()
        for slot, j in progress.items():
            if j >= self.n_trans or slot not in self._noise:
                continue
            row = int(self._draw_rows[j])
            if row <= 0:
                continue  # the last step adds no noise and draws none
            noise, k = self._noise[slot], slot - self._lo
            if isinstance(noise, torch.Generator):
                z[k:k + 1].normal_(generator=noise)
            else:
                z[k].copy_(noise.table[row])

    def _kind(self, w: int):
        """Step ``w``'s kind, by the host's step counter: None without
        caching, else "anchor" or "cached"."""
        if self.cache is None:
            return None
        if self._pattern is not None:
            anchor = bool(self._pattern[w % self.cache_every])
        else:
            anchor = w % self.cache_every == 0
        return "anchor" if anchor else "cached"

    def _body(self, kind) -> None:
        """One step of every slot, of ``kind``: reads the slot state and z,
        writes x, x0_prev, the step counts and the residual in place."""
        ic = self.i.clamp(0, self.n_trans - 1)
        y = self.y if self.conditional else None
        x, t_model = self.x, self._t_model[ic]
        if kind is None:
            mo = self.apply_fn(x, t_model, y)
        elif kind == "anchor":
            mo, delta = self.cache[0](x, t_model, y)
            self.delta.copy_(delta)
        else:
            mo = self.cache[1](x, t_model, y, self.delta)
        z, x0 = self._z, None
        if self.method == "ddpm":
            xn = self.schedule.step(self.parametrization, mo, x, self._t[ic], z)
        elif self.method == "ddim":
            xn = self.schedule.ddim_step(mo, x, self._t[ic], self._s[ic], z)
        else:
            c = {k: v[ic].reshape(-1, *(1,) * len(self.img_shape))
                 for k, v in self._dpm.items()}
            if self.parametrization == "predict_original":
                x0 = mo
            else:
                x0 = (x - c["sigma_prev"] * mo) / c["alpha_prev"]
            d = torch.where(c["is_first"] > 0, x0, c["c_cur"] * x0 - c["c_prev"] * self.x0_prev)
            xn = c["sigma_ratio"] * x - c["alpha_t"] * c["phi"] * d
        live = self.active & (self.i < self.n_trans)
        rows = live.reshape(-1, *(1,) * len(self.img_shape))
        x.copy_(torch.where(rows, xn, x))
        if x0 is not None:
            self.x0_prev.copy_(torch.where(rows, x0, self.x0_prev))
        self.i.add_(live)

    def _run_step(self, kind) -> None:
        self.graphs.step((id(self), kind), self._bodies[kind], (self.x, self._z, self.i))

    def _step(self, progress: dict, w: int):
        self._noise_for_step(progress)
        self._run_step(self._kind(w))

    def capture_graphs(self) -> None:
        """Warm up and capture every kind of step before any slot is
        admitted: with no slot live a step changes no slot's x, x0 or count
        (the residual it writes is rewritten by the first admitted wave's
        anchor), and it draws nothing. Eager batchers do nothing."""
        if not self.graphs.graphed:
            return
        if self.steps_done:
            raise RuntimeError("capture_graphs runs before any slot is admitted")
        self._noise_for_step({})
        for kind in self._bodies:
            for _ in range(2):  # the eager warm-up, then the capture and a replay
                self._run_step(kind)

    def advance(self):
        """``steps_per_poll`` steps of every slot in flight."""
        for k in range(self.steps_per_poll):
            self._step({slot: done + k for slot, done in self.steps_done.items()},
                       self._w_host + k)
        self._w_host += self.steps_per_poll
        for slot, done in self.steps_done.items():
            self.steps_done[slot] = min(done + self.steps_per_poll, self.n_trans)

    def finished(self):
        """Slots whose trajectories are complete (host bookkeeping only)."""
        return [s for s, d in self.steps_done.items() if d >= self.n_trans]

    def free_slots(self):
        return [s for s in range(self.slots) if s not in self.steps_done]

    def poll(self):
        """(steps done (S,), active (S,)) read from the device (and gathered
        from the data ranks): one blocking round trip. The serving loop reads
        the host mirror instead; this is for tests (it must always agree
        with the mirror)."""
        if self.mesh is None:
            return self.i.cpu().numpy(), self.active.cpu().numpy()
        return (self.mesh.gather_rows(self.i.cpu()).numpy(),
                self.mesh.gather_rows(self.active.cpu()).numpy())

    def begin_finish(self, slots, transform: Optional[Callable] = None):
        """Free ``slots`` and start the copy of their images to the host;
        return ``materialize() -> [image (H, W, C) numpy, ...]`` in
        ``slots`` order, which waits for the copy.

        The finished rows are first gathered into a tensor of their own:
        the slot buffer is written in place by later admissions and
        rebound by later steps, so the copy reads the gather, never the
        slots, and the freed slots can be re-admitted and advanced before
        ``materialize()`` is called. ``transform`` (a latent model's decode)
        runs on the gathered rows before the copy. On a GPU the copy goes
        to pinned host memory behind an event. Over a grid's data ranks
        every rank gathers (and transforms) the rows it holds and the host
        gathers them all, before this returns."""
        slots = list(slots)
        if not slots:
            return lambda: []
        if self.mesh is not None:
            images = self._gather_finished(slots, transform)
            return lambda: images
        rows = torch.stack([self.x[s] for s in slots])
        if transform is not None:
            rows = transform(rows)
        for s in slots:
            self.active[s] = False
            del self.steps_done[s]
            del self._noise[s]
        done = None
        host = rows
        if rows.device.type == "cuda":
            host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
            host.copy_(rows, non_blocking=True)
            done = torch.cuda.Event()
            done.record()

        def materialize():
            if done is not None:
                done.synchronize()
            return [host[j].numpy() for j in range(len(slots))]

        return materialize

    def _gather_finished(self, slots: list, transform) -> list:
        """:meth:`begin_finish` over the data ranks: each rank's finished
        rows (padded to the most any rank holds, so that every rank gathers
        one shape), transformed, gathered on the host; the slots freed."""
        mesh = self.mesh
        held = collections.Counter()  # finished slots on each data rank
        place = {}  # slot -> (its data rank, its row among that rank's)
        for s in slots:
            d = s // self._held
            place[s] = (d, held[d])
            held[d] += 1
        mine = [s for s in slots if place[s][0] == mesh.data_rank]
        rows = torch.zeros((max(held.values()), *self.img_shape), dtype=self.x.dtype,
                           device=self.x.device)
        for k, s in enumerate(mine):
            rows[k] = self.x[s - self._lo]
        if transform is not None:
            rows = transform(rows)
        parts = mesh.gather_host(rows.cpu())[::mesh.model]
        for s in slots:
            del self.steps_done[s]
        for s in mine:
            self.active[s - self._lo] = False
            del self._noise[s]
        return [parts[d][k].numpy() for d, k in (place[s] for s in slots)]

    def finish_many(self, slots) -> list:
        """The finished images of ``slots`` (in that order) in one copy; frees them."""
        return self.begin_finish(slots)()

    def finish(self, slot: int) -> np.ndarray:
        """A finished slot's image (H, W, C); frees the slot."""
        return self.finish_many([slot])[0]

    # -- convenience driver (tests, batch use) -------------------------------

    def run_jobs(self, jobs):
        """Drive a FIFO list of ``(noise, class_id)`` jobs to completion and
        return their images in submission order, admitting greedily into
        free slots between advances: the serving loop's scheduling."""
        pending = list(enumerate(jobs))
        results: dict[int, np.ndarray] = {}
        slot_owner: dict[int, int] = {}
        while pending or slot_owner:
            wave = {}
            if self.can_admit_cached():
                for slot in self.free_slots():
                    if not pending:
                        break
                    job_id, (noise, class_id) = pending.pop(0)
                    wave[slot] = (noise, class_id)
                    slot_owner[slot] = job_id
            self.admit_many(wave)
            self.advance()
            done = self.finished()
            for slot, img in zip(done, self.finish_many(done)):
                results[slot_owner.pop(slot)] = img
        return [results[j] for j in range(len(jobs))]
