"""Pipeline-parallel DuoDiff sampling over two rank groups (counterpart of
``duodiff_tpu/diffusion/pipeline.py``).

DuoDiff's shallow -> full handoff is a two-stage temporal pipeline: the
shallow model denoises the first ``t_switch`` reverse steps (t = T-1 ..
T-t_switch, the high-noise regime), the full model the remaining ones (t =
T-t_switch-1 .. 0). The ranks of
:func:`~duodiff_tpu_torch.parallel.mesh.pipeline_grid` form two disjoint
stages: stage A holds only the shallow model, stage B only the full one. A
batch streams through them as micro-batches: rank r of A runs stage 1 of
micro-batch i + 1 while its partner in B (:attr:`Grid.peer`) runs stage 2
of micro-batch i. A hands each micro-batch over with a blocking send, which
returns once B has taken it, so A runs at most one micro-batch ahead: the
JAX package's dispatch order, where stage 1 of key i + 1 is dispatched
before the host blocks on stage 2 of key i. Within a stage the micro-batch
is data-parallel over the stage's ranks. Steady-state throughput is set by
the slower stage, not by the two stages' sum.

Noise follows the port's rule for data parallelism, not the JAX package's
key per micro-batch: stage A of micro-batch i draws x_T and each step's z as
rows [i mb + r mb / n, i mb + (r + 1) mb / n) of a draw of the whole batch
(:class:`~duodiff_tpu_torch.diffusion.sampling.RowDraws`; n the stage's
ranks, r this rank's place among them), from the run's generator set back
to its state at the start of the run, and hands the generator's state (a
CPU byte tensor: on CUDA the Philox seed and offset) to B with the
micro-batch, where B goes on drawing the same way. So the pipelined samples
are those of the one-process
:func:`~duodiff_tpu_torch.diffusion.sampling.duodiff_sample` run on the same
generator (to the bit on the CPU). An injected ``noise_table`` (steps,
batch, ...) takes the place of the steps' draws, sliced by the same rows.

A stage's steps hold no collective, so they run as step graphs
(``diffusion/graphs.py``) on the card: a stream's micro-batches replay the
graphs its first one captured.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from duodiff_tpu_torch.diffusion.graphs import step_graphs
from duodiff_tpu_torch.diffusion.sampling import RowDraws, ddpm_loop, randn
from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule


class DuoDiffPipeline:
    """Two-stage pipelined DuoDiff sampler on a pipeline grid.

    ``apply_shallow`` / ``apply_full``: ``fn(x, t_batch, y)``, the sampling
    CLI's applies (guidance wrappers compose unchanged). A stage A rank
    needs only the first, a stage B rank only the second; the other may be
    None, and a waiting rank needs neither. ``graphs`` is
    :func:`~duodiff_tpu_torch.diffusion.sampling.ddpm_loop`'s."""

    def __init__(
        self,
        apply_shallow: Optional[Callable],
        apply_full: Optional[Callable],
        schedule: NoiseSchedule,
        *,
        t_switch: int,
        grid,
        parametrization: str = "predict_noise",
        noise_table: Optional[torch.Tensor] = None,
        graphs=True,
    ):
        if not 0 < t_switch <= schedule.steps:
            raise ValueError(f"t_switch must be in (0, {schedule.steps}]")
        if grid.stages != 2:
            raise ValueError("DuoDiffPipeline runs on the two stages of a pipeline_grid")
        self.grid = grid
        self.apply = {0: apply_shallow, 1: apply_full}.get(grid.stage)
        if grid.active and self.apply is None:
            raise ValueError(f"a stage {'AB'[grid.stage]} rank needs its model's apply")
        self.schedule = schedule
        self.parametrization = parametrization
        self.noise_table = noise_table
        self.handoff = schedule.steps - t_switch
        self.graphs = graphs
        self._run_graphs = None  # the stream's StepGraphs

    def _rows(self, i: int, mb: int, batch: int) -> tuple:
        """This rank's rows of micro-batch i in the whole batch's draws."""
        lo, hi, _ = self.grid.rows(mb)
        return i * mb + lo, i * mb + hi, batch

    def _run(self, x, draws: RowDraws, t_hi: int, t_lo: int, y):
        table = self.noise_table
        if table is not None:
            table = table[:, draws.rows[0]:draws.rows[1]]
        # a copy: the next micro-batch writes the stream's x buffer
        return ddpm_loop(self.apply, self.schedule, self.parametrization, x, draws,
                         range(t_hi, t_lo - 1, -1), y, noise_table=table,
                         graphs=self._run_graphs).clone()

    def _stage1(self, draws: RowDraws, shape, y):
        x = randn((draws.rows[1] - draws.rows[0], *shape[1:]), draws, self.grid.device)
        return self._run(x, draws, self.schedule.steps - 1, self.handoff, y)

    def _stage2(self, x_mid, draws: RowDraws, y):
        if self.handoff == 0:
            return x_mid
        return self._run(x_mid, draws, self.handoff - 1, 0, y)

    def sample_stream(self, generator: torch.Generator, shape, n_micro: int, y=None):
        """Run ``n_micro`` micro-batches of ``shape`` (the whole micro-batch,
        (mb, H, W, C)) through this rank's stage, in order. ``generator`` is
        the run's, on this rank's device, at the run's starting state; ``y``
        a list of each micro-batch's labels (mb,) or None. Yields, a
        micro-batch at a time, its final rows of this rank on a stage B rank
        and None on a stage A rank (after the handoff); nothing on a
        waiting rank."""
        grid = self.grid
        if not grid.active:
            return
        ys = list(y) if y is not None else [None] * n_micro
        if len(ys) != n_micro:
            raise ValueError(f"{len(ys)} label batches for {n_micro} micro-batches")
        mb, batch = shape[0], shape[0] * n_micro
        lo, hi, _ = grid.rows(mb)
        self._run_graphs = step_graphs(self.graphs, grid.device)
        start = generator.get_state()
        for i, yy in enumerate(ys):
            draws = RowDraws(generator, self._rows(i, mb, batch))
            if yy is not None:
                yy = yy[lo:hi]
            if grid.stage == 0:
                generator.set_state(start)
                x_mid = self._stage1(draws, shape, yy)
                grid.send_to(x_mid, grid.peer)
                grid.send_to(generator.get_state(), grid.peer)
                yield None
            else:
                x_mid = grid.recv_from((hi - lo, *shape[1:]), torch.float32, grid.peer)
                state = grid.recv_from(start.shape, start.dtype, grid.peer)
                generator.set_state(state.cpu())
                yield self._stage2(x_mid, draws, yy)

    def sample(self, generator: torch.Generator, shape, n_micro: int, y=None) -> list:
        """The micro-batches' final batches (whole, on the host) on rank 0,
        in order, gathered from stage B's ranks; an empty list on the other
        ranks."""
        return self.gather(list(self.sample_stream(generator, shape, n_micro, y)), shape)

    def gather(self, outs: list, shape) -> list:
        """:meth:`sample`'s gather of what :meth:`sample_stream` yielded on
        each rank: stage B's rows of every micro-batch sent to rank 0 over
        the host."""
        grid, n_micro = self.grid, len(outs)
        if not grid.active:
            return []
        stage_b = grid.data * grid.model
        senders = [stage_b + r for r in range(1 if grid.replicated else grid.data)]
        if grid.rank in senders:
            grid.send_to(torch.stack(outs), 0, host=True)
        if not grid.is_main:
            return []
        lo, hi, _ = grid.rows(shape[0])
        parts = [grid.recv_from((n_micro, hi - lo, *shape[1:]), torch.float32, src, host=True)
                 for src in senders]
        return [torch.cat([p[i] for p in parts]) for i in range(n_micro)]
