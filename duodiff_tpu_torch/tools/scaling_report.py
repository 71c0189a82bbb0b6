"""Multi-process scaling report from the grid's collective counts
(counterpart of the repository's ``tools/scaling_report.py``).

    python -m duodiff_tpu_torch.tools.scaling_report [--mode train|sample] [--fsdp]
        [--meshes 1x1,2x1,4x1,8x1,4x2,2x4] [--batch 32] [--depth 5] [--embed 256] ...

For each DPxTP shape it starts a world of DP x TP gloo processes on the CPU
(the torchrun environment set by hand), each rank building the U-ViT the
flags size on the grid (fp32, the unfused ``xla`` block; ``--fsdp`` cutting
its large leaves over the data ranks), and runs one step: a train step
(``--mode train``: forward, loss, backward, the gradients' mean, AdamW) or a
sampling step (``--mode sample``: one forward of the rank's rows, as the
sampling CLI's step), once to warm up and once counted. Where the JAX tool
counts the collectives in compiled HLO, this one counts those the grid
issued in the counted step (``Grid.collectives``). One row a shape: the
collectives of the step by kind, the all-reduce, all-gather and
reduce-scatter payload MB of the step, the parameter MB a rank and the
world's wall seconds; the rows also print as one JSON line.

What the rows should show: pure data-parallel sampling runs no collective;
tensor parallelism sums twice a block a forward (the attention's and the
MLP's partials); the data-parallel train step's all-reduce payload tracks
the fp32 gradient bytes; ``--fsdp`` replaces most of it by all-gathers and
reduce-scatters, and the parameter MB a rank fall by about the data size.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

KINDS = ("all_reduce", "all_gather", "reduce_scatter")
TIMEOUT = 600.0  # seconds a world may take


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--mode", default="train", choices=["train", "sample"])
    p.add_argument("--meshes", default="1x1,2x1,4x1,8x1,4x2,2x4",
                   help="comma-separated DPxTP shapes")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--img", type=int, default=32)
    p.add_argument("--patch", type=int, default=4)
    p.add_argument("--embed", type=int, default=256)
    p.add_argument("--depth", type=int, default=5)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--fsdp", action="store_true", default=False,
                   help="cut the large leaves over the data ranks (ZeRO-3)")
    p.add_argument("--fsdp_min_size", type=int, default=16384)
    p.add_argument("--rank_of", default=None, help=argparse.SUPPRESS)  # a rank of a world
    p.add_argument("--out", default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def _shapes(text: str) -> list:
    shapes = []
    for part in text.split(","):
        dp, tp = part.lower().split("x")
        shapes.append((int(dp), int(tp)))
    return shapes


def rank_main(args) -> None:
    """One rank: build the model on the grid, run the step twice, write the
    counted step's collectives and the rank's parameter bytes to ``--out``."""
    import torch

    from duodiff_tpu_torch.config import UViTConfig
    from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
    from duodiff_tpu_torch.models.uvit import init_uvit
    from duodiff_tpu_torch.parallel import fsdp
    from duodiff_tpu_torch.parallel.mesh import close, sampling_grid, training_grid
    from duodiff_tpu_torch.training.train_state import (
        TrainState,
        make_optimizer,
        make_train_step,
    )

    torch.set_num_threads(1)
    dp, tp = _shapes(args.rank_of)[0]
    make_grid = training_grid if args.mode == "train" else sampling_grid
    grid = make_grid(tp, args.batch, "cpu")
    try:
        if (grid.data, grid.model) != (dp, tp):
            raise SystemExit(f"the grid is (data {grid.data}, model {grid.model}), not {dp}x{tp}: "
                             f"--batch {args.batch} must divide the {dp} data ranks")
        cfg = UViTConfig(img_size=args.img, patch_size=args.patch, in_chans=3,
                         embed_dim=args.embed, depth=args.depth, num_heads=args.heads,
                         mlp_ratio=4, qkv_bias=False, mlp_time_embed=False, num_classes=-1,
                         normalize_timesteps=True)
        model = init_uvit(cfg, device="cpu", dtype=torch.float32, attn_impl="xla",
                          generator=torch.Generator().manual_seed(0))
        model.shard_(grid)
        if args.fsdp:
            fsdp.shard_model(model, grid, args.fsdp_min_size, cfg.num_heads)
        param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
        lo, hi, n = grid.rows(args.batch)
        g = torch.Generator().manual_seed(0)
        x = torch.randn((n, args.img, args.img, 3), generator=g)[lo:hi]
        t = torch.randint(0, 1000, (n,), generator=g)[lo:hi]
        if args.mode == "train":
            opt = make_optimizer(dict(model.named_parameters()), lr=2e-4, weight_decay=0.03,
                                 beta1=0.99, beta2=0.999, max_grad_norm=1.0, num_warmup_steps=10,
                                 num_training_steps=1000, grid=grid,
                                 fsdp=getattr(getattr(model, "fsdp", None), "names", frozenset()))
            state = TrainState.create(model, opt)
            step = make_train_step(model, NoiseSchedule.create(steps=100),
                                   parametrization="predict_noise", seed=0, grid=grid,
                                   rows=(lo, hi, n))

            def run(i):
                step(state, {"image": x}, i)
        else:
            model.eval()
            model.pack_for_kernels()

            def run(i):
                with torch.no_grad():
                    model(x, t.float())
        run(1)
        grid.reset_collectives()
        run(2)
        counts = grid.reset_collectives()
        record = {"rank": grid.rank, "collectives": counts, "param_bytes": param_bytes}
        Path(f"{args.out}.rank{grid.rank}").write_text(json.dumps(record))
    finally:
        close(grid)


def row_of(mesh: str, records: list, seconds: float) -> dict:
    """The report's row from the ranks' records (rank 0's counts; every
    rank's must agree)."""
    counts = records[0]["collectives"]
    for rec in records[1:]:
        if rec["collectives"] != counts:
            raise SystemExit(f"{mesh}: rank {rec['rank']} issued other collectives than rank "
                             f"0: {rec['collectives']} vs {counts}")
    row = {"mesh": mesh, "collectives": {k: v["calls"] for k, v in counts.items()}}
    for kind in KINDS:
        row[kind] = counts.get(kind, {}).get("calls", 0)
        row[f"{kind}_mb"] = counts.get(kind, {}).get("bytes", 0) / 1e6
    row["param_mb_per_rank"] = max(rec["param_bytes"] for rec in records) / 1e6
    row["seconds"] = seconds
    return row


def main(argv=None) -> list:
    from duodiff_tpu_torch.tools._world import run_world

    args = get_args(argv)
    if args.rank_of is not None:
        rank_main(args)
        return []
    fsdp = " --fsdp" if args.fsdp else ""
    print(f"{args.mode}-step collective schedule{fsdp} (batch={args.batch}, D={args.embed}, "
          f"depth={args.depth}, img={args.img}; counted by the grid)", flush=True)
    print(f"{'mesh':>6} {'all-red':>8} {'MB/step':>9} {'all-gat':>8} {'MB/step':>9} "
          f"{'red-sct':>8} {'MB/step':>9} {'par MB/rank':>12} {'wall s':>8}", flush=True)
    passed = list(sys.argv[1:] if argv is None else argv)
    rows = []
    with tempfile.TemporaryDirectory() as work:
        for dp, tp in _shapes(args.meshes):
            mesh, n = f"{dp}x{tp}", dp * tp
            out = Path(work) / mesh
            tic = time.perf_counter()
            run_world(n, ["-m", "duodiff_tpu_torch.tools.scaling_report", *passed,
                          "--rank_of", mesh, "--out", str(out)], work, TIMEOUT)
            seconds = time.perf_counter() - tic
            records = [json.loads(Path(f"{out}.rank{r}").read_text()) for r in range(n)]
            row = row_of(mesh, records, seconds)
            rows.append(row)
            print(f"{mesh:>6} {row['all_reduce']:>8} {row['all_reduce_mb']:>9.3f} "
                  f"{row['all_gather']:>8} {row['all_gather_mb']:>9.3f} "
                  f"{row['reduce_scatter']:>8} {row['reduce_scatter_mb']:>9.3f} "
                  f"{row['param_mb_per_rank']:>12.3f} {seconds:>8.1f}", flush=True)
    print(json.dumps(rows), flush=True)
    return rows


if __name__ == "__main__":
    main()
