"""The multi-process dry run (counterpart of the repository's
``__graft_entry__.dryrun_multichip``), in worlds of gloo processes on the
CPU:

    python -m duodiff_tpu_torch.tools.dryrun_multichip [N]   # N ranks, default 8

Its legs, each one step of a small U-ViT (img 16, patch 2, D 64, depth 5,
4 heads) in one world of N ranks that joins its process group once:

- the data-parallel train step (every rank a data rank);
- FSDP: the same step with every leaf of >= 1024 elements cut over the data
  ranks (``parallel/fsdp.py``), its loss held to the data-parallel step's;
- tensor parallelism with the fused kernels (``--model_parallel 2``, their
  shard forms; the plain versions on the CPU), on a (N / 2, 2) grid;
- the DuoDiff pipeline (``pipeline_grid``): a depth-3 model on stage A, the
  depth-5 one on stage B, micro-batches handed over point to point, the
  gathered batch equal to one process's;

and, in a second world of N ranks laid out as two nodes of N / 2:

- the multihost layout (``--multihost``): every model group on one node, one
  tensor-parallel train step across the nodes' data ranks.

Each leg prints one ``dryrun_multichip ... leg OK`` line with what it ran,
or ``... leg SKIPPED: <reason>`` where the world has no axis for it (no data
axis for FSDP, an odd N for tensor parallelism, one rank for the pipeline,
fewer than 4 ranks or a number 4 does not divide for two nodes of model
groups of 2). A failing leg fails the tool.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

CFG = dict(img_size=16, patch_size=2, in_chans=3, embed_dim=64, depth=5, num_heads=4,
           mlp_ratio=4, qkv_bias=False, mlp_time_embed=False, num_classes=-1,
           normalize_timesteps=True)
MIN_SIZE = 1024
STEPS = 10  # the pipeline's DDPM steps, 4 of them on stage A
TIMEOUT = 600.0  # seconds a world may take


def _step(grid, impl: str, fsdp_on: bool = False):
    """One train step of the U-ViT on ``grid``: (the data group's mean loss,
    the model)."""
    import torch

    from duodiff_tpu_torch.config import UViTConfig
    from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
    from duodiff_tpu_torch.models.uvit import init_uvit
    from duodiff_tpu_torch.parallel import fsdp
    from duodiff_tpu_torch.training.train_state import TrainState, make_optimizer, make_train_step

    cfg = UViTConfig(**CFG)
    model = init_uvit(cfg, device="cpu", dtype=torch.float32, attn_impl=impl,
                      generator=torch.Generator().manual_seed(0))
    model.shard_(grid)
    names = frozenset()
    if fsdp_on:
        names = fsdp.shard_model(model, grid, MIN_SIZE, cfg.num_heads).names
    batch = max(2 * grid.data, 4)
    lo, hi, _ = grid.rows(batch)
    x = torch.randn((batch, 16, 16, 3), generator=torch.Generator().manual_seed(1))[lo:hi]
    opt = make_optimizer(dict(model.named_parameters()), lr=1e-4, weight_decay=0.03, beta1=0.99,
                         beta2=0.999, max_grad_norm=1.0, num_warmup_steps=10,
                         num_training_steps=100, grid=grid, fsdp=names)
    state = TrainState.create(model, opt)
    step = make_train_step(model, NoiseSchedule.create(steps=100), parametrization="predict_noise",
                           seed=0, grid=grid, rows=(lo, hi, batch))
    loss = step(state, {"image": x}, 1)["train_loss"].reshape(1).clone()
    grid.data_mean_([loss])
    if not torch.isfinite(loss).all() or state.optimizer.count != 1:
        raise SystemExit(f"non-finite loss {loss} or no update")
    return float(loss[0]), model


def _say(grid, text: str) -> None:
    if grid.is_main:
        print(f"dryrun_multichip {text}", flush=True)


def _pipeline(n: int) -> None:
    """The pipeline leg: the DuoDiff pair on two stages against one process."""
    import torch

    from duodiff_tpu_torch.config import UViTConfig
    from duodiff_tpu_torch.diffusion.pipeline import DuoDiffPipeline
    from duodiff_tpu_torch.diffusion.sampling import duodiff_sample
    from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
    from duodiff_tpu_torch.models.uvit import init_uvit
    from duodiff_tpu_torch.parallel.mesh import pipeline_grid

    micro = 2
    batch = micro * 2
    grid = pipeline_grid(batch, micro, "cpu")

    def model(depth: int):
        m = init_uvit(UViTConfig(**dict(CFG, depth=depth)), device="cpu", dtype=torch.float32,
                      attn_impl="fused", generator=torch.Generator().manual_seed(depth))
        m.eval().pack_for_kernels()
        return lambda x, t, y: m(x, t, y)

    shallow, full = model(3), model(5)
    schedule = NoiseSchedule.create(steps=STEPS)
    shape = (micro, 16, 16, 3)
    with torch.no_grad():
        pipe = DuoDiffPipeline(shallow, full, schedule, t_switch=4, grid=grid)
        got = pipe.sample(torch.Generator().manual_seed(0), shape, batch // micro)
        if grid.is_main:
            want = duodiff_sample(shallow, full, torch.Generator().manual_seed(0),
                                  schedule=schedule, shape=(batch, 16, 16, 3), t_switch=4)
            if not torch.equal(torch.cat(got), want):
                raise SystemExit("the pipeline's batch differs from one process's")
    _say(grid, f"pipeline leg OK: stages A ranks 0-{grid.data - 1} (depth 3), B ranks "
               f"{grid.data}-{2 * grid.data - 1} (depth 5), {batch // micro} micro-batches of "
               f"{micro}, {STEPS} steps, t_switch 4, equal to one process's"
               f"{'' if n % 2 == 0 else f'; rank {n - 1} waits'}")


def worker(n: int) -> None:
    """The first world's legs, in one process group."""
    import torch

    from duodiff_tpu_torch.parallel.mesh import close, training_grid

    torch.set_num_threads(1)
    first = training_grid(1, max(2 * n, 4), "cpu")
    try:
        loss, _ = _step(first, "xla")
        _say(first, f"data-parallel leg OK: (data {first.data}, model 1) grid of {n} ranks, "
                    f"backend {first.backend}, loss {loss:.6f}")
        if first.data > 1:
            fs_loss, model = _step(first, "xla", fsdp_on=True)
            cut = len(model.fsdp.shapes)
            if abs(fs_loss - loss) > 1e-5 * abs(loss):
                raise SystemExit(f"FSDP loss {fs_loss} != data-parallel {loss}")
            _say(first, f"FSDP leg OK: {cut} leaves of >= {MIN_SIZE} elements over {first.data} "
                        f"data ranks, loss {fs_loss:.6f} (data-parallel {loss:.6f})")
        else:
            _say(first, "FSDP leg SKIPPED: the data axis is 1 (one rank), FSDP shards nothing")
        if n % 2 == 0:
            tp = training_grid(2, max(2 * n, 4), "cpu")
            tp_loss, _ = _step(tp, "fused")
            _say(tp, f"tensor-parallel leg OK: (data {tp.data}, model 2) grid, the fused "
                     f"kernels' shard forms, loss {tp_loss:.6f}")
        else:
            _say(first, f"tensor-parallel leg SKIPPED: {n} ranks do not split into model "
                        "groups of 2")
        if n >= 2:
            _pipeline(n)
        else:
            _say(first, "pipeline leg SKIPPED: one rank has no second stage")
    finally:
        close(first)


def multihost_worker(n: int) -> None:
    """The second world: two nodes of n / 2 ranks, --multihost."""
    import torch

    from duodiff_tpu_torch.parallel.mesh import close, training_grid

    torch.set_num_threads(1)
    grid = training_grid(2, 2 * n, "cpu", multihost=True)
    try:
        nodes = n // int(os.environ["LOCAL_WORLD_SIZE"])
        node = grid.rank // (n // nodes)
        peers = [grid.rank - grid.model_rank + m for m in range(grid.model)]
        if any(p // (n // nodes) != node for p in peers):
            raise SystemExit(f"rank {grid.rank}'s model group {peers} spans nodes")
        loss, _ = _step(grid, "fused")
        _say(grid, f"multihost leg OK: {nodes} nodes of {n // nodes} ranks, (data {grid.data}, "
                   f"model 2) grid, every model group on one node, the data group's gradient "
                   f"mean across the nodes, loss {loss:.6f}")
    finally:
        close(grid)


def main(argv=None) -> None:
    from duodiff_tpu_torch.tools._world import run_world

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n", nargs="?", type=int, default=8, help="ranks a world")
    p.add_argument("--worker", choices=["legs", "multihost"], help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker == "legs":
        return worker(args.n)
    if args.worker == "multihost":
        return multihost_worker(args.n)
    me = ["-m", "duodiff_tpu_torch.tools.dryrun_multichip", str(args.n)]
    with tempfile.TemporaryDirectory() as work:
        out = run_world(args.n, [*me, "--worker", "legs"], work, TIMEOUT)[0]
        print("".join(line + "\n" for line in out.splitlines()
                      if line.startswith("dryrun_multichip")), end="", flush=True)
        if args.n >= 4 and args.n % 4 == 0:
            out = run_world(args.n, [*me, "--worker", "multihost"], work, TIMEOUT,
                            nodes=2)[0]
            print("".join(line + "\n" for line in out.splitlines()
                          if line.startswith("dryrun_multichip")), end="", flush=True)
        else:
            print("dryrun_multichip multihost leg SKIPPED: needs 4 ranks or more, a multiple "
                  f"of 4, for two nodes of model groups of 2; got {args.n}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
