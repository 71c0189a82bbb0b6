"""The torch.distributed worlds of the port's tests: ``run_world`` starts
the ranks of a world of gloo processes on the CPU (the torchrun environment
set by hand, the ranks meeting through a file, so that no two test workers
contend for a port) and waits for them, ``start_world`` only starts them;
this file run as a script is a rank of the tensor-parallel checks of
tests/test_torch_tp.py, with ``pipeline`` first of the pipeline checks of
tests/test_torch_pipeline.py, or with ``fsdp`` first of the FSDP train
steps of tests/test_torch_fsdp.py. Nothing here imports JAX: a rank is a
plain PyTorch process.

    python tests/torch_dist_worker.py INPUTS.pth MODEL_PARALLEL OUT.pth
    python tests/torch_dist_worker.py pipeline INPUTS.pth OUT_DIR
    python tests/torch_dist_worker.py fsdp INPUTS.pth OUT_DIR
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
import uuid
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def start_world(n: int, argv: list, tmp_path, env: dict | None = None) -> list:
    """Start ``python *argv`` as the ``n`` ranks of one world; returns
    (process, path of its output) of each rank."""
    tag = uuid.uuid4().hex
    init = Path(tmp_path) / f"init_{tag}"
    base = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "MASTER_PORT")}
    ranks = []
    for rank in range(n):
        rank_env = dict(base, RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank),
                        LOCAL_WORLD_SIZE=str(n), DUODIFF_INIT_METHOD=f"file://{init}",
                        OMP_NUM_THREADS="1", PYTHONPATH=str(REPO), **(env or {}))
        log = Path(tmp_path) / f"rank{rank}_{tag}.log"
        with open(log, "w") as f:
            ranks.append((subprocess.Popen([sys.executable, *argv], env=rank_env, cwd=REPO,
                                           stdout=f, stderr=subprocess.STDOUT), log))
    return ranks


def wait_world(ranks: list, timeout: float, what: str) -> tuple:
    """Wait for the ranks of :func:`start_world`; returns (their exit codes,
    their outputs). A world still running after ``timeout`` seconds is
    killed and fails the test, where a hung collective would otherwise hang
    the run."""
    deadline = time.monotonic() + timeout
    try:
        for proc, _ in ranks:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for proc, _ in ranks:
            proc.kill()
            proc.wait()
        raise AssertionError(f"{what} did not end within {timeout} s:\n" + "\n".join(
            log.read_text()[-3000:] for _, log in ranks))
    return [proc.returncode for proc, _ in ranks], [log.read_text() for _, log in ranks]


def run_world(n: int, argv: list, tmp_path, timeout: float = 120, env: dict | None = None):
    """``python *argv`` as the ``n`` ranks of one world; returns (their exit
    codes, their outputs)."""
    return wait_world(start_world(n, argv, tmp_path, env), timeout,
                      f"a world of {n} ranks ({argv})")


def _sublayer(grid, data, which: str) -> dict:
    """One tensor-parallel sublayer on this rank's rows and shard: the output
    rows and dx gathered, the parameter gradients summed over the data ranks
    and gathered, on rank 0."""
    import torch

    from duodiff_tpu_torch.parallel.tp_fused import tp_attn_sublayer_train, tp_mlp_sublayer_train
    from duodiff_tpu_torch.utils.convert import gather_state_dict, shard_kind, shard_tensor

    lo, hi, _ = grid.rows(data["x"].shape[0])
    names = {"attn": ("norm1.weight", "norm1.bias", "attn.qkv.weight", "attn.qkv.bias",
                      "attn.proj.weight", "attn.proj.bias"),
             "mlp": ("norm2.weight", "norm2.bias", "mlp.fc1.weight", "mlp.fc1.bias",
                     "mlp.fc2.weight", "mlp.fc2.bias")}[which]
    names = [f"mid_block.{n}" for n in names]
    params = []
    for name, t in zip(names, data[which]):
        kind = shard_kind(name)
        if kind is not None:
            t = shard_tensor(kind, t, grid.model_rank, grid.model)
        params.append(t.clone().requires_grad_())
    x = data["x"][lo:hi].clone().requires_grad_()
    if which == "attn":
        y = tp_attn_sublayer_train(x, *params, num_heads=data["heads"] // grid.model, grid=grid)
    else:
        y = tp_mlp_sublayer_train(x, *params, gelu_approx=False, grid=grid)
    y.backward(data["dy"][lo:hi])
    grads = [p.grad for p in params]
    grid.data_mean_(grads)
    grads = gather_state_dict({n: g * grid.data for n, g in zip(names, grads)}, grid)
    return {"y": grid.gather_rows(y.detach()), "dx": grid.gather_rows(x.grad),
            "grads": {n.split(".", 1)[1]: g for n, g in grads.items()}}


def _grads(model, grid) -> dict:
    """The model's gradients, summed over the data ranks and gathered."""
    grads = [p.grad for p in model.parameters()]
    grid.data_mean_(grads)
    from duodiff_tpu_torch.utils.convert import gather_state_dict

    return gather_state_dict({name: p.grad * grid.data for name, p in model.named_parameters()},
                             grid)


def _uvit(grid, data) -> dict:
    """The depth-3 U-ViT (fused, and the unfused pallas and xla blocks), a
    U-ViT with the time embedding's MLP, and the early-exit U-ViT as
    tensor-parallel shards: forwards and the gradients of mean(y^2) over the
    global batch (for the early-exit model of the mean squares of its three
    outputs), summed over the data ranks and gathered; the shards of the
    U-ViT's and the early-exit model's state dicts gathered back."""
    import torch

    from duodiff_tpu_torch.config import UViTConfig
    from duodiff_tpu_torch.models.early_exit import EarlyExitUViT
    from duodiff_tpu_torch.models.uvit import UViT
    from duodiff_tpu_torch.utils.convert import gather_state_dict, shard_state_dict

    n = data["img"].shape[0]
    lo, hi, _ = grid.rows(n)
    img, t = data["img"][lo:hi], data["t"][lo:hi]

    def roundtrip(model, prefix: str) -> dict:
        full = {k: v.clone() for k, v in model.state_dict().items()}
        model.shard_(grid)
        shard = model.state_dict()
        gathered = gather_state_dict(shard, grid)
        return {f"{prefix}shard_equal": all(torch.equal(shard[k], v)
                                            for k, v in shard_state_dict(full, grid).items()),
                f"{prefix}roundtrip_equal": set(gathered) == set(full) and all(
                    torch.equal(gathered[k], v) for k, v in full.items())}

    def train_forward(model, key: str) -> None:
        model.train()
        y = model(img, t)
        (y.square().sum() / (y[0].numel() * n)).backward()
        out[f"{key}_grads"] = _grads(model, grid)
        model.eval()
        model.pack_for_kernels()
        with torch.no_grad():
            out[f"{key}_y"] = grid.gather_rows(model(img, t))

    out = {}
    for impl, key in (("fused", "uvit"), ("pallas", "pallas"), ("xla", "xla")):
        model = UViT(UViTConfig(**data["uvit_config"]), dtype=torch.float32, attn_impl=impl)
        model.load_state_dict(data["uvit_sd"])
        out.update(roundtrip(model, "" if impl == "fused" else f"{impl}_"))
        train_forward(model, key)
    model = UViT(UViTConfig(**data["te_config"]), dtype=torch.float32, attn_impl="fused")
    model.load_state_dict(data["te_sd"])
    out.update(roundtrip(model, "te_"))
    train_forward(model, "te")
    ee = EarlyExitUViT(UViTConfig(**data["ee_config"]), dtype=torch.float32, attn_impl="fused")
    ee.load_state_dict(data["ee_sd"])
    out.update(roundtrip(ee, "ee_"))
    ee.train()
    backbone, u, g = ee(img, t)
    loss = (backbone.square().sum() / backbone[0].numel() + u.square().sum() / u.shape[0]
            + g.square().sum() / (g.shape[0] * g[0, 0].numel())) / n
    loss.backward()
    out["ee_grads"] = _grads(ee, grid)
    ee.eval().pack_for_kernels()
    with torch.no_grad():
        backbone, u, g = ee(img, t)
    out["ee"] = (grid.gather_rows(backbone), grid.gather_rows(u.t().contiguous()).t(),
                 grid.gather_rows(g.transpose(0, 1).contiguous()).transpose(0, 1))
    return out


def pipeline(inputs: str, out: str) -> None:
    """A rank of a pipeline world: each job of INPUTS through
    ``DuoDiffPipeline`` on the pipeline grid, on the CPU. Rank 0 saves each
    job's gathered batches; every rank writes its place in the grid and the
    monotonic clock at the end of each micro-batch of its stage (A: its last
    model call; B: the yield) to ``OUT_DIR/rank{R}.pth``."""
    import torch

    from duodiff_tpu_torch.config import UViTConfig
    from duodiff_tpu_torch.diffusion.pipeline import DuoDiffPipeline
    from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
    from duodiff_tpu_torch.models.uvit import UViT
    from duodiff_tpu_torch.parallel.mesh import close, pipeline_grid

    torch.set_num_threads(1)
    data = torch.load(inputs, weights_only=False)
    batch, mb, steps = data["batch"], data["microbatch"], data["steps"]
    grid = pipeline_grid(batch, mb, "cpu")
    record = {"rank": grid.rank, "stage": grid.stage, "replicated": grid.replicated,
              "peer": grid.peer if grid.active else None, "ends": {}}
    gathered = {}
    try:
        model = None
        if grid.active:
            which = ("shallow", "full")[grid.stage]
            model = UViT(UViTConfig(**data[f"{which}_config"]), dtype=torch.float32,
                         attn_impl="fused")
            model.load_state_dict(data[which])
            model.eval().pack_for_kernels()
        shape = (mb, *data["img"])
        for job in data["jobs"]:
            name, t_switch = job["name"], job["t_switch"]
            calls = []

            def apply(x, t, y, sleep=job.get("sleep", 0.0)):
                if grid.stage == 1 and t_switch == steps:
                    raise AssertionError("the full model ran with t_switch == steps")
                out = model(x, t, y)
                time.sleep(sleep)
                calls.append(time.monotonic())
                return out

            pipe = DuoDiffPipeline(apply, apply, NoiseSchedule.create(steps=steps),
                                   t_switch=t_switch, grid=grid, noise_table=job.get("table"))
            generator = torch.Generator().manual_seed(data["seed"])
            ends = []
            with torch.no_grad():
                outs = []
                for out_rows in pipe.sample_stream(generator, shape, batch // mb):
                    ends.append(time.monotonic())
                    outs.append(out_rows)
                if grid.stage == 0:  # stage 1 of micro-batch i ends at its last model call
                    ends = calls[t_switch - 1::t_switch]
                record["ends"][name] = ends
                gathered[name] = pipe.gather(outs, shape)
    finally:
        close(grid)
    torch.save(record, Path(out) / f"rank{grid.rank}.pth")
    if grid.is_main:
        torch.save(gathered, Path(out) / "samples.pth")


def fsdp_step(inputs: str, out: str) -> None:
    """A rank of an FSDP world: one train step of the U-ViT of INPUTS on the
    training grid, first with ``--fsdp``'s sharding, then data-parallel, on
    the injected timesteps and noise (this rank's rows). Every rank writes
    ``OUT_DIR/rank{R}.pth``: each leaf's elements on this rank (parameter,
    mu, nu, EMA) and the collectives of each step; rank 0 also the loss
    (the data group's mean), the gradient norm and the gathered gradients
    (averaged over the data group), parameters, EMA and mu of each run."""
    import torch

    from duodiff_tpu_torch.config import UViTConfig
    from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
    from duodiff_tpu_torch.models.uvit import UViT
    from duodiff_tpu_torch.parallel import fsdp
    from duodiff_tpu_torch.parallel.mesh import close, training_grid
    from duodiff_tpu_torch.training.train_state import TrainState, make_optimizer, make_train_step
    from duodiff_tpu_torch.utils.convert import gather_state_dict

    torch.set_num_threads(1)
    data = torch.load(inputs, weights_only=False)
    n = data["img"].shape[0]
    grid = training_grid(data["model_parallel"], n, "cpu")
    lo, hi, _ = grid.rows(n)
    record, gathered = {"rank": grid.rank, "data": grid.data, "model": grid.model}, {}
    try:
        for tag in ("fsdp", "dp"):
            cfg = UViTConfig(**data["config"])
            model = UViT(cfg, dtype=torch.float32, attn_impl=data["attn_impl"])
            model.load_state_dict(data["sd"])
            model.shard_(grid)
            shapes = {}
            if tag == "fsdp":
                shapes = fsdp.shard_model(model, grid, data["min_size"], cfg.num_heads).shapes
            opt = make_optimizer(dict(model.named_parameters()), grid=grid, fsdp=shapes.keys(),
                                 **data["opt"])
            state = TrainState.create(model, opt, ema_decay=0.9)
            step = make_train_step(model, NoiseSchedule.create(steps=1000),
                                   parametrization="predict_noise", seed=0, grid=grid,
                                   rows=(lo, hi, n))
            grid.reset_collectives()
            metrics = step(state, {"image": data["img"][lo:hi]}, 1, data["t"][lo:hi],
                           data["noise"][lo:hi])
            record[f"{tag}_collectives"] = grid.reset_collectives()
            loss = metrics["train_loss"].reshape(1).clone()
            grid.data_mean_([loss])
            names = [name for name, _ in model.named_parameters()]
            record[f"{tag}_numels"] = {
                name: (p.numel(), opt.mu[i].numel(), opt.nu[i].numel(), state.ema[name].numel())
                for i, (name, p) in enumerate(model.named_parameters())}
            record[f"{tag}_shapes"] = dict(shapes)
            gathered[tag] = {
                "loss": float(loss[0]), "grad_norm": float(metrics["grad_norm"]),
                "params": gather_state_dict(model.state_dict(), grid, shapes),
                "grads": gather_state_dict({name: p.grad for name, p in model.named_parameters()},
                                           grid, shapes),
                "ema": gather_state_dict(state.ema, grid, shapes),
                "mu": gather_state_dict(dict(zip(names, opt.mu)), grid, shapes)}
    finally:
        close(grid)
    torch.save(record, Path(out) / f"rank{grid.rank}.pth")
    if grid.is_main:
        torch.save(gathered, Path(out) / "gathered.pth")


def main(inputs: str, model_parallel: str, out: str) -> None:
    import torch

    from duodiff_tpu_torch.parallel.mesh import close, training_grid

    torch.set_num_threads(1)
    data = torch.load(inputs, weights_only=False)
    grid = training_grid(int(model_parallel), data["x"].shape[0], "cpu")
    try:
        result = {"attn": _sublayer(grid, data, "attn"), "mlp": _sublayer(grid, data, "mlp"),
                  **_uvit(grid, data), "data": grid.data, "backend": grid.backend}
    finally:
        close(grid)
    if grid.is_main:
        torch.save(result, out)


if __name__ == "__main__":
    if sys.argv[1] == "pipeline":
        pipeline(*sys.argv[2:4])
    elif sys.argv[1] == "fsdp":
        fsdp_step(*sys.argv[2:4])
    else:
        main(*sys.argv[1:4])
