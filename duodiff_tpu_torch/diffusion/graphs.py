"""Step graphs: the port's form of the JAX samplers' on-device loop.

In the JAX package a sampler is one jitted ``lax.scan`` over the timestep
axis and the slot batcher one ``fori_loop`` a poll, so no step returns to
the host. Here each kind of sampling step (a plain step, a block cache's
anchor or cached step, a DuoDiff segment's model, a DPM-Solver++ first
step, ...) is captured once as a CUDA graph and replayed for every step of
that kind. A step's body reads and writes only static buffers: the
timestep and the step index live in device tensors that the body reads
(``ts[i]``) and advances (``i += 1``), the noise is drawn outside the graph
into a static ``z`` before each replay, and the state (x, a cache's
residual, the solver's previous x0, the aux rows) is written in place. The
host only chooses which graph replays, from its own copy of the timesteps.
The trainer's steps are step graphs too, the counterpart of the JAX
trainer's one jitted, donated step (``training/train_state.py``): a kind
of train step ("update", and with accumulation "fold") reads the static
batch and draws and writes the weights, their gradients, the optimizer's
state, the EMA and the metrics in place.

On the CPU, or with ``graphed=False``, the same bodies run eagerly, one
step at a time: the CPU tests hold them to a plain loop with Python-int
timesteps, and on the card the graphed run gives the eager run's bits,
since it launches the same kernels in the same order on the same data.

The kernel wrappers count their launches on the host, which a replay
never reaches: a :class:`StepGraph` records each counter's change during
capture, takes it back, and adds it again at every replay, so a graphed
run counts what an eager one does.
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Callable, Sequence

import torch


def _new_graph():
    return torch.cuda.CUDAGraph()


def _capture(graph, pool):
    return torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local")


@contextlib.contextmanager
def _no_collection():
    """No automatic garbage collection inside the block. A collection there
    may free an earlier run's CUDA graph held in a reference cycle, and a
    graph's teardown is a call that a capturing stream forbids: it would
    invalidate the capture under way."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def _counters() -> dict:
    from duodiff_tpu_torch.tools._measure import _counted_wrappers

    return _counted_wrappers()


def _read_counters(counters: dict) -> dict:
    return {name: getattr(w, attr) for name, (w, attr) in counters.items()}


class StepGraph:
    """One kind of step, ``body()``, which reads and writes only the static
    CUDA tensors ``buffers`` (and the model's weights). The first call runs
    ``body`` eagerly: that warm-up makes the one-time set-ups (a kernel's
    shared-memory attribute, a library handle, the packed operands) happen
    outside capture, and it is a real step. The second call captures
    ``body`` into ``pool`` (with thread-local capture, so other threads may
    copy to the host meanwhile, and with no garbage collection during it)
    and replays it, on the current stream; later
    calls replay. A failed capture raises: there is no eager fallback."""

    def __init__(self, body: Callable[[], None], buffers: Sequence[torch.Tensor] = (),
                 pool=None):
        for b in buffers:
            if b.device.type != "cuda":
                raise ValueError(f"a step graph replays on the card: its buffers must be CUDA "
                                 f"tensors, got one on {b.device}")
        self.body, self.pool = body, pool
        self.graph = None
        self.calls = 0
        self.deltas: dict = {}  # each counter's launches a replay
        self._added: list = []  # (wrapper, attribute, launches) a replay adds
        self.capture_seconds = None

    def capture(self) -> None:
        counters = _counters()
        before = _read_counters(counters)
        tic = time.perf_counter()
        graph = _new_graph()
        with _no_collection(), _capture(graph, self.pool):
            self.body()
        self.capture_seconds = time.perf_counter() - tic
        after = _read_counters(counters)
        self.deltas = {name: after[name] - before[name] for name in after
                       if after[name] != before[name]}
        self._added = [(*counters[name], n) for name, n in self.deltas.items()]
        for name, (w, attr) in counters.items():  # capture launched nothing
            setattr(w, attr, before[name])
        self.graph = graph

    def __call__(self) -> None:
        self.calls += 1
        if self.calls == 1:
            self.body()
            return
        if self.graph is None:
            self.capture()
        self.graph.replay()
        for w, attr, n in self._added:
            setattr(w, attr, getattr(w, attr) + n)


class StepGraphs:
    """A run's step graphs and static buffers, one memory pool for all of
    its graphs. ``step(key, body, buffers)`` runs one step of the kind
    ``key``: through its :class:`StepGraph` on a CUDA device when
    ``graphed``, else ``body()`` eagerly. ``loop(key, make)`` keeps a
    sampler's buffers and bodies for the run, so that its later segments,
    or a server's later requests, replay the graphs they captured.

    The graphs read the weights' buffers as they were at capture, so a run's
    graphs are for that run's weights: a caller whose weights are replaced
    (not updated in place) between runs starts a new one."""

    def __init__(self, device, graphed: bool = True):
        self.device = torch.device(device)
        self.graphed = bool(graphed) and self.device.type == "cuda"
        self.pool = None
        self.graphs: dict = {}
        self.loops: dict = {}
        self._buffers: dict = {}

    def buffer(self, name: str, shape, dtype=torch.float32) -> torch.Tensor:
        """The run's static buffer ``name`` of that shape and dtype (zeros
        when first made), shared by every sampler or train step of the run
        that asks for it: a DuoDiff segment's x is the next segment's, the
        loader's batch the train step's."""
        key = (name, tuple(shape), dtype)
        if key not in self._buffers:
            self._buffers[key] = torch.zeros(key[1], dtype=dtype, device=self.device)
        return self._buffers[key]

    def loop(self, key, make: Callable):
        if key not in self.loops:
            self.loops[key] = make()
        return self.loops[key]

    def step(self, key, body: Callable[[], None], buffers: Sequence[torch.Tensor] = ()) -> None:
        if not self.graphed:
            body()
            return
        graph = self.graphs.get(key)
        if graph is None:
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            graph = self.graphs[key] = StepGraph(body, buffers, self.pool)
        graph()

    def summary(self) -> dict:
        """Each graph's calls (its eager warm-up included) and capture time."""
        return {str(k): {"calls": g.calls, "capture_s": g.capture_seconds}
                for k, g in self.graphs.items()}

    def pool_bytes(self) -> int:
        """The card's memory the run's pool holds: the segments the caching
        allocator gave the graphs (0 before a capture)."""
        if self.pool is None:
            return 0
        return sum(seg["total_size"] for seg in torch.cuda.memory._snapshot()["segments"]
                   if tuple(seg.get("segment_pool_id", ())) == tuple(self.pool))


def step_graphs(graphs, device) -> StepGraphs:
    """``graphs`` as a run's :class:`StepGraphs`: one given is used as it
    is; ``True`` makes a new one, graphed on a CUDA device; ``False`` a new
    eager one."""
    if isinstance(graphs, StepGraphs):
        return graphs
    return StepGraphs(device, graphed=bool(graphs))


def device_index(i: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``table[i]`` for the 0-d device index ``i``, read on the device (a
    gather, never a host read); a 1-D table gives a 0-d tensor."""
    return table.index_select(0, i.reshape(1)).reshape(table.shape[1:])
