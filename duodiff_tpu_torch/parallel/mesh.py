"""The process grid over ``torch.distributed`` (counterpart of
``duodiff_tpu/parallel/mesh.py`` and of the device split of
``duodiff_tpu/diffusion/pipeline.py``).

A run under ``python -m torch.distributed.run --nproc_per_node N`` (or across
nodes with ``--multihost``) holds N ranks, one process each, laid out as a
(data, model) grid: ``model`` consecutive ranks on one node form a model
group, which shards the attention heads and the MLP hidden columns of every
block (tensor parallelism, :mod:`duodiff_tpu_torch.parallel.tp_fused`), as
``create_hybrid_mesh`` keeps tensor parallelism on a host; the ranks with the
same place in their model groups form a data group, which splits the batch
and averages the gradients (data parallelism). A run without the torchrun
environment is one process on one device with no process group, and every
collective here is then nothing. Pipeline-parallel DuoDiff
(:func:`pipeline_grid`) lays the ranks out as two such grids, the stages A
and B, one after the other, whose paired ranks hand tensors over point to
point (:meth:`Grid.send_to`, :meth:`Grid.recv_from`).

The backend follows the topology: ranks whose devices are all distinct
reduce over NCCL, ranks that share a device (more ranks on a node than it
has cards, or ``--device cpu``) over gloo, since NCCL refuses two ranks on
one card. The choice is printed. Every collective is synchronous on the
current stream (no ``async_op``): the weight-gradient kernels of the
backward (``csrc/gemm.cuh``) spin on per-tile flags and assume every block
of their grid is resident, which a communication kernel overlapping them on
another stream would break, so nothing here overlaps a backward kernel
(and training takes no DDP bucket overlap, and FSDP's gathers and
scatters, :mod:`duodiff_tpu_torch.parallel.fsdp`, run in line too). Every
collective a grid issues is counted by kind with its payload bytes
(:attr:`Grid.collectives`: an all-reduce's tensor, an all-gather's gathered
output, a reduce-scatter's input, a broadcast's or a point-to-point tensor)
and shows in a profile as a ``grid.<kind>`` span (``grid.all_reduce``,
``grid.all_gather``, ``grid.reduce_scatter``, ...).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
from contextlib import contextmanager
from typing import Optional

import torch
import torch.distributed as dist
from torch.profiler import record_function

# the torchrun environment, all of it or none
ENV_KEYS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")
# the process group's init_method (default env://, torchrun's MASTER_ADDR and
# MASTER_PORT); a file:// URL lets processes meet without a port
INIT_METHOD_ENV = "DUODIFF_INIT_METHOD"
# how long a rank of a serving grid waits in a collective for the others: a
# rank that died or hangs fails the request instead of hanging the server
SERVE_TIMEOUT = datetime.timedelta(seconds=300)
# how long a follower rank of a server waits for rank 0's next unit of work
IDLE_TIMEOUT = datetime.timedelta(days=365)


@dataclasses.dataclass
class Grid:
    """One rank's place in the (data, model) grid, or in one of the
    ``stages`` such grids of a pipeline. ``stages`` x ``data`` x ``model``
    ranks take part (``active``); a rank past them, which the batch rule of
    :func:`training_grid` leaves without rows or an odd world leaves
    outside the pipeline's two stages, only waits for the others."""

    rank: int = 0
    world: int = 1
    data: int = 1
    model: int = 1
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None
    model_group: object = None   # the model group of this rank (None: size 1)
    data_group: object = None    # the data group of this rank (None: size 1)
    active_group: object = None  # every active rank (None: one process)
    host_group: object = None    # the active ranks over gloo, for CPU tensors
    idle_group: object = None    # host_group's ranks with IDLE_TIMEOUT (serving)
    replicated: bool = False     # every rank holds the whole batch (sampling)
    joined: bool = False         # this grid joined the process group: close leaves it
    stages: int = 1              # 2 for pipeline-parallel DuoDiff (stage A, then B)
    # kind -> {"calls": n, "bytes": payload}, every collective this grid issued
    collectives: dict = dataclasses.field(default_factory=dict)

    @property
    def distributed(self) -> bool:
        return self.world > 1

    @property
    def active(self) -> bool:
        return self.rank < self.stages * self.data * self.model

    @property
    def stage(self) -> Optional[int]:
        """0 for stage A, 1 for stage B; None for a waiting rank."""
        return self.rank // (self.data * self.model) if self.active else None

    @property
    def peer(self) -> int:
        """The rank of the other stage with this rank's place in its grid."""
        size = self.data * self.model
        return self.rank + size if self.stage == 0 else self.rank - size

    @property
    def data_rank(self) -> int:
        return 0 if self.replicated else self.rank % (self.data * self.model) // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def is_main(self) -> bool:
        """Rank 0, which writes the metrics, the files and the checkpoints."""
        return self.rank == 0

    def rows(self, batch: int) -> tuple[int, int, int]:
        """(lo, hi, batch): the rows of a global batch this rank holds."""
        shards = 1 if self.replicated else self.data
        per = batch // shards
        return self.data_rank * per, (self.data_rank + 1) * per, batch

    # --- collectives: synchronous, nothing on a group of one ----------------

    @contextmanager
    def _collective(self, kind: str, nbytes: int):
        """Count one collective of ``kind`` moving ``nbytes`` and show it as a
        ``grid.<kind>`` span."""
        c = self.collectives.setdefault(kind, {"calls": 0, "bytes": 0})
        c["calls"] += 1
        c["bytes"] += int(nbytes)
        with record_function(f"grid.{kind}"):
            yield

    def reset_collectives(self) -> dict:
        """The counts so far (a copy), then zero them."""
        counts = {k: dict(v) for k, v in self.collectives.items()}
        self.collectives.clear()
        return counts

    def _sum(self, t: torch.Tensor, group) -> torch.Tensor:
        """``t`` summed over ``group``, in place, in its own dtype (a bf16
        partial rounds to bf16 at each add of the collective's order: over 2
        shards that is the fp32 sum rounded once)."""
        if group is not None:
            with self._collective("all_reduce", _nbytes(t)):
                dist.all_reduce(t, group=group)
        return t

    def model_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over this rank's model group (a new tensor)."""
        return self._sum(t.clone(), self.model_group)

    def model_sum_(self, t: torch.Tensor) -> torch.Tensor:
        return self._sum(t, self.model_group)

    def data_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over this rank's data group, in place."""
        return self._sum(t, self.data_group)

    def model_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The model group's ``t`` (the same shape on each rank) side by side
        on ``dim``, in rank order: one all-gather."""
        if self.model_group is None:
            return t
        moved = t.movedim(dim, 0).contiguous()
        out = torch.empty((self.model * moved.shape[0], *moved.shape[1:]), dtype=t.dtype,
                          device=t.device)
        with self._collective("all_gather", _nbytes(out)):
            dist.all_gather_into_tensor(out, moved, group=self.model_group)
        return out.movedim(0, dim)

    def data_gather(self, shard: torch.Tensor) -> torch.Tensor:
        """The data group's flat ``shard`` (the same length on each rank) one
        after the other, in data-rank order: one all-gather (FSDP's gather
        of a unit's weights)."""
        if self.data_group is None:
            return shard
        out = torch.empty(self.data * shard.numel(), dtype=shard.dtype, device=shard.device)
        with self._collective("all_gather", _nbytes(out)):
            dist.all_gather_into_tensor(out, shard.contiguous(), group=self.data_group)
        return out

    def data_scatter_mean(self, full: torch.Tensor) -> torch.Tensor:
        """This data rank's chunk of the data group's mean of the flat
        ``full`` (a length ``data`` divides): one reduce-scatter, then the
        division (FSDP's scatter of a unit's gradients)."""
        if self.data_group is None:
            return full
        out = torch.empty(full.numel() // self.data, dtype=full.dtype, device=full.device)
        with self._collective("reduce_scatter", _nbytes(full)):
            dist.reduce_scatter_tensor(out, full.contiguous(), group=self.data_group)
        return out.div_(self.data)

    def data_mean_(self, tensors: list) -> None:
        """Average fp32 ``tensors`` over the data group in place, as one flat
        all-reduce."""
        if self.data_group is None or not tensors:
            return
        flat = torch.cat([t.reshape(-1) for t in tensors])
        with self._collective("all_reduce", _nbytes(flat)):
            dist.all_reduce(flat, group=self.data_group)
        flat /= self.data
        at = 0
        for t in tensors:
            t.copy_(flat[at:at + t.numel()].view_as(t))
            at += t.numel()

    def all_true(self, flag: torch.Tensor) -> torch.Tensor:
        """A bool device flag agreed over every active rank: true where it is
        true on all of them."""
        if self.active_group is None:
            return flag
        v = flag.to(torch.int32).reshape(1)
        with self._collective("all_reduce", _nbytes(v)):
            dist.all_reduce(v, op=dist.ReduceOp.MIN, group=self.active_group)
        return v[0].bool()

    def any_on_host(self, flag: bool) -> bool:
        """A host flag agreed over every active rank: true where it is true
        on any of them (a CPU all-reduce, which waits for no device)."""
        if self.host_group is None:
            return flag
        v = torch.tensor([int(flag)], dtype=torch.int32)
        with self._collective("all_reduce", _nbytes(v)):
            dist.all_reduce(v, op=dist.ReduceOp.MAX, group=self.host_group)
        return bool(v[0])

    def barrier(self) -> None:
        if self.host_group is not None:
            with self._collective("barrier", 0):
                dist.barrier(group=self.host_group)

    def gather_host(self, t: torch.Tensor) -> list:
        """Every active rank's CPU tensor ``t`` (the same shape on each), in
        rank order, on every active rank."""
        if self.host_group is None:
            return [t]
        out = [torch.empty_like(t) for _ in range(self.stages * self.data * self.model)]
        with self._collective("all_gather", _nbytes(t) * len(out)):
            dist.all_gather(out, t.contiguous(), group=self.host_group)
        return out

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The global batch from each data rank's rows ``t`` (CPU tensors; the
        first model rank's of each data rank), on every active rank."""
        if self.host_group is None or self.replicated:
            return t
        parts = self.gather_host(t)
        return torch.cat(parts[::self.model])

    def broadcast_obj(self, obj=None):
        """Rank 0's picklable ``obj`` on every active rank, over the host
        (``idle_group`` where the grid has one: a follower waits there for
        the next unit of work however long the server stays idle)."""
        group = self.host_group if self.idle_group is None else self.idle_group
        if group is None:
            return obj
        box = [obj]
        with self._collective("broadcast", len(pickle.dumps(obj)) if self.is_main else 0):
            dist.broadcast_object_list(box, src=0, group=group)
        return box[0]

    # --- point to point: the pipeline's handoff -----------------------------

    def _wire(self, host: bool) -> torch.device:
        """Where a point-to-point tensor travels: on the device under NCCL,
        through the host under gloo (whose send and recv take CPU tensors
        only) or when ``host`` asks for it."""
        return self.device if self.backend == "nccl" and not host else torch.device("cpu")

    def send_to(self, t: torch.Tensor, dst: int, host: bool = False) -> None:
        """Send ``t`` to rank ``dst``; returns once it has left (gloo) or is
        queued on the current stream (NCCL)."""
        with self._collective("send", _nbytes(t)):
            dist.send(t.to(self._wire(host)).contiguous(), dst=dst,
                      group=self.host_group if host else None)

    def recv_from(self, shape, dtype, src: int, host: bool = False) -> torch.Tensor:
        """The tensor rank ``src`` sends, on this rank's device (on the host
        with ``host``)."""
        buf = torch.empty(shape, dtype=dtype, device=self._wire(host))
        with self._collective("recv", _nbytes(buf)):
            dist.recv(buf, src=src, group=self.host_group if host else None)
        return buf if host else buf.to(self.device)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def env_spec() -> Optional[dict]:
    """The torchrun environment as ints, or None when none of it is set;
    refuses a partial one (as ``main.py:maybe_init_distributed`` refuses a
    partial ``JAX_*`` spec) and one that needs a rendezvous it lacks."""
    env = os.environ
    present = {k: env[k] for k in ENV_KEYS if env.get(k)}
    if not present:
        return None
    missing = [k for k in ENV_KEYS if k not in present]
    if missing:
        raise SystemExit(f"{', '.join(sorted(present))} set but {' and '.join(missing)} "
                         "missing: run under python -m torch.distributed.run, which sets all of "
                         f"{', '.join(ENV_KEYS)}")
    if not env.get(INIT_METHOD_ENV) and not (env.get("MASTER_ADDR") and env.get("MASTER_PORT")):
        raise SystemExit("the torchrun environment lacks MASTER_ADDR / MASTER_PORT (or "
                         f"{INIT_METHOD_ENV}): the ranks have nowhere to meet")
    spec = {k.lower(): int(v) for k, v in present.items()}
    if not 0 <= spec["rank"] < spec["world_size"] or not (
            0 <= spec["local_rank"] < spec["local_world_size"] <= spec["world_size"]):
        raise SystemExit(f"inconsistent torchrun environment: {present}")
    return spec


def _device(device: str, local_rank: int) -> torch.device:
    """``cuda:{LOCAL_RANK % cards}`` for a CUDA run, else the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise SystemExit(f"--device {device}: no CUDA device is available")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def _backend(dev: torch.device, local_world: int) -> str:
    """NCCL when every rank of the node has a card of its own, else gloo.

    The rule assumes that every rank sees every card of its node, as
    torchrun leaves them: a launcher that hides all but one card from each
    rank (``CUDA_VISIBLE_DEVICES`` a rank) makes ``device_count()`` 1, and
    such ranks reduce over gloo through the host although their cards are
    distinct."""
    if dev.type == "cuda" and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def _grid(model_parallel: int, device: str, multihost: bool,
          data_size, what: str, stages: int = 1, timeout=None) -> Grid:
    """Join the process group (or keep the one this process joined for an
    earlier grid, as when one process trains, then samples: :func:`close`
    then leaves it only through the grid that joined it) and build the
    grid; ``data_size(world // (stages * mp))`` picks the data size (or
    refuses). With a ``timeout`` (serving) every collective of the grid's
    groups fails after it, and the grid gets an ``idle_group``."""
    mp = max(1, int(model_parallel or 1))
    spec = env_spec()
    if spec is None:
        if multihost:
            raise SystemExit("--multihost needs the torchrun environment (RANK, WORLD_SIZE, "
                             "LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT): run under "
                             "python -m torch.distributed.run --nnodes ... --nproc_per_node ...")
        if mp > 1:
            raise SystemExit(f"--model_parallel {mp} does not divide 1 process: run under "
                             f"python -m torch.distributed.run --nproc_per_node {mp}")
        return Grid(device=torch.device(device))
    rank, world = spec["rank"], spec["world_size"]
    local_rank, local_world = spec["local_rank"], spec["local_world_size"]
    if world > local_world and not multihost:
        raise SystemExit(f"{world} ranks over {world // local_world} nodes: pass --multihost "
                         "for a run across nodes")
    if world % mp:
        raise SystemExit(f"--model_parallel {mp} does not divide {world} ranks")
    if local_world % mp:
        raise SystemExit(f"--model_parallel {mp} does not divide the {local_world} ranks of a "
                         "node: a model group stays on one node")
    data = data_size(world // (stages * mp))
    dev = _device(device, local_rank)
    backend = _backend(dev, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    joined = not dist.is_initialized()
    if joined:
        dist.init_process_group(backend, init_method=os.environ.get(INIT_METHOD_ENV, "env://"),
                                rank=rank, world_size=world, timeout=timeout)
    elif (dist.get_rank(), dist.get_world_size(), dist.get_backend()) != (rank, world, backend):
        raise SystemExit("this process already joined another process group")
    grid = Grid(rank=rank, world=world, data=data, model=mp, device=dev, backend=backend,
                joined=joined, stages=stages)
    # every rank creates every group, in the same order; each stage is a
    # (data, model) grid of its own
    size = data * mp
    for s in range(stages):
        for d in range(data if mp > 1 else 0):
            g = dist.new_group([s * size + d * mp + m for m in range(mp)], timeout=timeout)
            if grid.stage == s and grid.data_rank == d:
                grid.model_group = g
        for m in range(mp if data > 1 else 0):
            g = dist.new_group([s * size + d * mp + m for d in range(data)], timeout=timeout)
            if grid.stage == s and grid.model_rank == m:
                grid.data_group = g
    active = list(range(stages * size))
    if len(active) > 1:
        whole = dist.new_group(active, timeout=timeout)
        host = (whole if backend == "gloo" else
                dist.new_group(active, backend="gloo", timeout=timeout))
        idle = None if timeout is None else dist.new_group(active, backend="gloo",
                                                           timeout=IDLE_TIMEOUT)
        if grid.active:
            grid.active_group, grid.host_group, grid.idle_group = whole, host, idle
    if rank == 0:
        staged = "" if stages == 1 else f"{stages} stages of "
        print(f"{what} on {staged}a (data {data}, model {mp}) grid of {world} ranks: backend "
              f"{backend} ({'ranks share a device' if backend == 'gloo' else 'a device a rank'}), "
              f"{dev.type}", flush=True)
    return grid


def training_grid(model_parallel: int, batch_size: int, device: str,
                  multihost: bool = False) -> Grid:
    """The training grid (``duodiff_tpu/training/trainer.py``'s mesh rule):
    on one node the data size drops to the largest divisor of the batch
    (the ranks past data x model wait), across nodes the batch must divide
    it."""

    def data_size(n: int) -> int:
        if multihost:
            if batch_size % n:
                raise SystemExit(f"batch_size {batch_size} must be divisible by the {n} data "
                                 "shards of a multi-node grid")
            return n
        d = n
        while batch_size % d:
            d -= 1
        if d != n:
            print(f"batch_size {batch_size} not divisible by {n} data shards; using {d}-way "
                  "data parallelism", flush=True)
        return d

    return _grid(model_parallel, device, multihost, data_size, "Training")


def sampling_grid(model_parallel: int, batch_size: int, device: str,
                  multihost: bool = False, split: bool = True, timeout=None) -> Grid:
    """The sampling grid (``sampling_mesh`` / ``setup_sampling_sharding``):
    with ``model_parallel`` > 1 the batch must divide the data shards; without,
    a batch that divides the world runs data-parallel, and any other batch
    (or any batch with ``split=False``) runs whole on every rank
    (``replicated``), rank 0 writing it. A server passes ``timeout``
    (:data:`SERVE_TIMEOUT`)."""
    mp = max(1, int(model_parallel or 1))
    whole = []

    def data_size(n: int) -> int:
        if mp > 1 and batch_size % n:
            raise SystemExit(f"batch_size {batch_size} must be divisible by the {n} data "
                             "shards")
        if mp == 1 and (batch_size % n or not split):
            whole.append(n)
        return n

    grid = _grid(mp, device, multihost, data_size, "Sampling", timeout=timeout)
    if whole:
        grid.replicated = True
        if grid.is_main:
            print(f"every one of the {whole[0]} ranks samples the whole batch of "
                  f"{batch_size}", flush=True)
    return grid


def pipeline_grid(batch_size: int, microbatch: int, device: str,
                  multihost: bool = False) -> Grid:
    """The two stages of pipeline-parallel DuoDiff (``DuoDiffPipeline``'s
    device split): stage A is ranks [0, N // 2), stage B ranks [N // 2, 2 (N
    // 2)), and with an odd N the last rank waits. Rank r of A hands its
    micro-batches to rank N // 2 + r of B (:attr:`Grid.peer`). Within a
    stage a micro-batch that divides the stage's ranks runs data-parallel,
    any other whole on every rank of the stage (``replicated``)."""
    if microbatch < 1 or batch_size % microbatch:
        raise SystemExit(f"--batch_size {batch_size} must be a multiple of "
                         f"--pipeline_microbatch {microbatch}")
    spec = env_spec()
    world = 1 if spec is None else spec["world_size"]
    if world < 2:
        raise SystemExit(f"pipeline parallelism needs >= 2 ranks (have {world}): run under "
                         "python -m torch.distributed.run --nproc_per_node 2 (or more)")
    whole = []

    def data_size(n: int) -> int:
        if microbatch % n:
            whole.append(n)
        return n

    grid = _grid(1, device, multihost, data_size, "Pipelined sampling", stages=2)
    grid.replicated = bool(whole)
    if grid.is_main:
        per = "the whole micro-batch" if whole else f"{microbatch // grid.data} of its rows"
        waits = f"; rank {world - 1} waits" if world % 2 else ""
        print(f"stage A ranks 0-{grid.data - 1}, stage B ranks {grid.data}-{2 * grid.data - 1}: "
              f"{batch_size // microbatch} micro-batches of {microbatch}, {per} a rank{waits}",
              flush=True)
    return grid


def close(grid: Grid, barrier: bool = True) -> None:
    """Leave the process group (after a barrier, unless ``barrier`` is
    false, as after a failed collective), if this grid joined it; a grid
    built on a group an earlier grid joined leaves it to that one."""
    if grid.joined and dist.is_initialized():
        if barrier and grid.host_group is not None:
            dist.barrier(group=grid.host_group)
        dist.destroy_process_group()
