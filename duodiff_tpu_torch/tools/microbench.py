"""Microbenchmarks of the hot kernels on the card (counterpart of the
repository's ``tools/microbench.py``).

    python -m duodiff_tpu_torch.tools.microbench [fwd|kernels|train|all] [config] [--device cuda]

Times (a) the full U-ViT forward (the flagship CelebA-64 model, or the given
config) at batch 128 in bf16 under each attention impl: ``pallas`` (the
unfused block around the attention kernel K9), ``fused`` (K1, K2) and
``xla`` (the unfused block with plain attention); (b) K9 alone on q, k, v
(128, 8, 257, 64), K1 alone on x (128, 257, 512) with the JAX tool's
operands, and one ``Block`` under ``pallas``, ``xla`` and ``fused``; (c) a
full train step (forward, loss, backward, AdamW with the JAX package's
hyperparameters; 3 warm-up steps, 20 timed) for the four variants
``(fused, auto)``, ``(pallas, fused)``, ``(pallas, xla)`` and ``(xla, xla)``,
so that regressions can be told apart: the kernel itself against the
surrounding model. A train row times the step the trainer runs: on the
card a step graph (``diffusion/graphs.py``), the batch in its run's static
buffers, its eager warm-up and capture among the warm-up steps
(``bench_train(graphs=False)`` times the eager step body). The port's
unfused MLP is ``mlp_impl="auto"``, which the JAX package also runs for
``"xla"``, so ``xla`` maps to it; the rows keep the JAX tool's labels.

Times are CUDA events around the timed calls on the card
(``tools/_measure.py``), never the host clock there. The card's name and
power limit print first, and every part prints the launches of each kernel
it made. Environment, as in the JAX tool: ``MB_GELU`` (tanh|exact; default
tanh for the forward, exact for training), ``MB_MODEL=deediff`` (the
early-exit model with ``mlp_probe_per_layer`` probes in training),
``MB_CONFIG`` (training's config), ``MB_BATCH`` (training's batch),
``MB_ONLY`` (a comma list of attention impls to train), ``MB_REMAT=1``
(``--use_checkpoint``). ``--device cpu`` runs everything on the CPU, where
the wrappers take their plain versions and the times are the host's.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from duodiff_tpu_torch.tools._measure import (
    card_line,
    device_from_arg,
    launch_counts,
    launches_since,
    time_ms,
)

BATCH = 128
REPS = 20
WARMUP = 2
TRAIN_WARMUP = 3
HEADS, LEN, HEAD_DIM = 8, 257, 64
TRAIN_VARIANTS = (
    ("fused", "auto"),    # fused sublayer kernels, hand-written backwards
    ("pallas", "fused"),  # attention kernels K9 / K10 + the fused MLP sublayer (K2 / K7)
    ("pallas", "xla"),    # attention kernels + the plain MLP
    ("xla", "xla"),
)
# the JAX package runs mlp_impl "xla" as "auto" (duodiff_tpu/models/layers.py:312-317)
MLP_IMPL = {"xla": "auto", "auto": "auto", "fused": "fused"}


def timeit(fn, *args, device, reps: int = REPS, warmup: int = WARMUP) -> float:
    """Seconds per call of ``fn(*args)`` over ``reps`` calls after
    ``warmup``: CUDA events on the card, the host clock on the CPU."""
    return time_ms(lambda: fn(*args), device, reps, warmup) / 1e3


def _config(config_path):
    from duodiff_tpu_torch.config import flagship_config, load_model_config

    return load_model_config(config_path) if config_path else flagship_config()


def _launches(label: str, before: dict) -> None:
    print(f"  launches {label}: {launches_since(before)}")


def bench_forward(config_path=None, *, device, batch: int = BATCH, reps: int = REPS) -> dict:
    """The full forward under pallas, fused and xla; returns {impl: seconds}."""
    from duodiff_tpu_torch.models.uvit import init_uvit
    from duodiff_tpu_torch.utils.profiling import flops_per_uvit_forward

    cfg = _config(config_path)
    x = torch.zeros((batch, cfg.img_size, cfg.img_size, cfg.in_chans), dtype=torch.bfloat16,
                    device=device)
    t = torch.full((batch,), 500.0, dtype=torch.float32, device=device)
    y = torch.zeros((batch,), dtype=torch.long, device=device) if cfg.num_classes > 0 else None
    flops = flops_per_uvit_forward(cfg, batch)
    # default tanh: the sampling production setting; MB_GELU=exact for the
    # training-parity form (bench_train defaults the other way around)
    gelu_approx = os.environ.get("MB_GELU", "tanh") == "tanh"
    times = {}
    for impl in ("pallas", "fused", "xla"):
        model = init_uvit(cfg, device=device, dtype=torch.bfloat16,
                          generator=torch.Generator().manual_seed(0), attn_impl=impl,
                          gelu_approx=gelu_approx)
        model.eval().pack_for_kernels()
        before = launch_counts()
        with torch.inference_mode():
            dt = timeit(model, x, t, y, device=device, reps=reps)
        times[impl] = dt
        print(f"forward[{impl:6s}] gelu={'tanh' if gelu_approx else 'exact'}:"
              f" {dt*1e3:8.2f} ms ({flops/dt/1e12:6.1f} TF/s effective)")
        _launches(f"forward[{impl}]", before)
        del model
    return times


def _block(d: int, impl: str, device, seed: int = 0):
    """A Block with weights drawn from ``seed`` (weights N(0, 0.02), biases 0,
    LayerNorms 1 and 0), in eval mode with its operands packed in bf16."""
    from duodiff_tpu_torch.models.layers import Block

    blk = Block(d, HEADS, mlp_ratio=4, attn_impl=impl)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            if name.startswith("norm"):
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("weight"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.02)
            else:
                p.zero_()
    blk = blk.to(device).eval()
    blk.pack(torch.bfloat16)
    return blk


def bench_kernels(*, device, batch: int = BATCH, reps: int = REPS) -> dict:
    """K9 and K1 alone, then a Block under pallas, xla and fused; returns
    {row: seconds}."""
    from duodiff_tpu_torch.ops.block import attn_operands, fused_attn_sublayer
    from duodiff_tpu_torch.ops.flash_attention import flash_attention

    b, h, l, dh = batch, HEADS, LEN, HEAD_DIM
    d = h * dh
    times = {}

    def normal(seed: int, shape, dtype=torch.bfloat16):
        g = torch.Generator().manual_seed(seed)
        return torch.randn(shape, generator=g).to(dtype).to(device)

    q, k, v = (normal(i, (b, h, l, dh)) for i in range(3))
    sdpa_flops = 2 * 2 * b * h * l * l * dh
    with torch.inference_mode():
        before = launch_counts()
        dt = times["flash_attention"] = timeit(flash_attention, q, k, v, device=device, reps=reps)
        print(f"flash_attention:      {dt*1e3:8.2f} ms ({sdpa_flops/dt/1e12:6.1f} TF/s)")
        _launches("flash_attention", before)

        # the JAX tool's operands: LayerNorm 1 and 0, wqkv (D, 3D) and wp (D, D)
        # N(0, 0.02) in fp32, bp 0, no qkv bias
        x = normal(3, (b, l, d))
        wqkv = normal(4, (d, 3 * d), torch.float32) * 0.02
        wp = normal(5, (d, d), torch.float32) * 0.02
        ops = attn_operands(torch.ones(d, device=device), torch.zeros(d, device=device),
                            wqkv.t(), None, wp.t(), torch.zeros(d, device=device),
                            num_heads=h, dtype=torch.bfloat16)
        before = launch_counts()
        dt = times["fused_attn_sublayer"] = timeit(
            lambda x: fused_attn_sublayer(x, *ops, num_heads=h), x, device=device, reps=reps)
        sub_flops = 2 * b * l * d * 4 * d + sdpa_flops
        print(f"fused_attn_sublayer:  {dt*1e3:8.2f} ms ({sub_flops/dt/1e12:6.1f} TF/s)")
        _launches("fused_attn_sublayer", before)

        blk_flops = sub_flops + 2 * 2 * b * l * d * 4 * d
        for impl in ("pallas", "xla", "fused"):
            blk = _block(d, impl, device)
            before = launch_counts()
            dt = times[f"Block[{impl}]"] = timeit(blk, x, device=device, reps=reps)
            print(f"full Block[{impl:6s}]:   {dt*1e3:8.2f} ms ({blk_flops/dt/1e12:6.1f} TF/s)")
            _launches(f"Block[{impl}]", before)
    return times


def bench_train(*, device, batch: int | None = None, reps: int = REPS,
                warmup: int = TRAIN_WARMUP, graphs: bool = True) -> dict:
    """A full train step per (attention, MLP) variant; returns {row label:
    seconds per step, "train_loss": {row label: the last step's loss}}.
    ``graphs``: the step replays a CUDA graph on the card, captured in the
    warm-up (at least two steps, graphed or not, so that both routes take
    the same steps)."""
    from duodiff_tpu_torch.diffusion.graphs import StepGraphs
    from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
    from duodiff_tpu_torch.models.early_exit import init_early_exit_uvit
    from duodiff_tpu_torch.models.uvit import init_uvit
    from duodiff_tpu_torch.training.train_state import (
        TrainState,
        make_optimizer,
        make_train_step,
        step_buffer,
    )

    # MB_MODEL=deediff benches the DeeDiff fine-tune step with the
    # mlp-probe-per-layer classifier: depth output heads + probes on the U-ViT
    model_kind = "deediff_uvit" if os.environ.get("MB_MODEL") == "deediff" else "uvit"
    # MB_CONFIG=configs/uvit_imagenet64.yaml benches other model scales
    cfg = _config(os.environ.get("MB_CONFIG"))
    schedule = NoiseSchedule.create(steps=1000, device=device)
    bsz = batch if batch is not None else int(os.environ.get("MB_BATCH", str(BATCH)))
    image = np.random.RandomState(0).randn(bsz, cfg.img_size, cfg.img_size, cfg.in_chans)
    host_batch = {"image": torch.from_numpy(image.astype(np.float32)),
                  "label": torch.zeros((bsz,), dtype=torch.long)}
    variants = TRAIN_VARIANTS
    only = os.environ.get("MB_ONLY")
    if only:
        variants = tuple(v for v in variants if v[0] in only.split(","))
    gelu_approx = os.environ.get("MB_GELU", "exact") == "tanh"
    # MB_REMAT=1 benches --use_checkpoint (per-block activation recompute)
    use_checkpoint = os.environ.get("MB_REMAT") == "1"
    times, losses = {}, {}
    for impl, mlp_impl in variants:
        generator = torch.Generator().manual_seed(0)
        if model_kind == "deediff_uvit":
            model = init_early_exit_uvit(
                dataclasses.replace(cfg, classifier_type="mlp_probe_per_layer"),
                device=device, dtype=torch.bfloat16, generator=generator, attn_impl=impl,
                gelu_approx=gelu_approx, use_checkpoint=use_checkpoint)
        else:
            model = init_uvit(cfg, device=device, dtype=torch.bfloat16, generator=generator,
                              attn_impl=impl, mlp_impl=MLP_IMPL[mlp_impl],
                              gelu_approx=gelu_approx, use_checkpoint=use_checkpoint)
        optimizer = make_optimizer(dict(model.named_parameters()), lr=2e-4, weight_decay=0.03,
                                   beta1=0.99, beta2=0.999, max_grad_norm=1.0,
                                   num_warmup_steps=1500, num_training_steps=500000)
        state = TrainState.create(model, optimizer)
        run = StepGraphs(device, graphs)  # the row's graphs and its batch's static buffers
        batch_ = {k: step_buffer(run, k, v).copy_(v) for k, v in host_batch.items()}
        step = make_train_step(model, schedule, parametrization="predict_noise", seed=1,
                               model_kind=model_kind, has_labels=cfg.num_classes > 0,
                               graphs=run)
        metrics = {}

        def one_step():
            # one step's draws throughout, as the JAX tool keeps one key
            metrics.update(step(state, batch_, 1))

        before = launch_counts()
        dt = timeit(one_step, device=device, reps=reps, warmup=max(warmup, 2))
        times[f"{impl}+mlp:{mlp_impl}"] = dt
        losses[f"{impl}+mlp:{mlp_impl}"] = float(metrics["train_loss"])
        print(f"train_step[{impl:6s}+mlp:{mlp_impl:5s}] "
              f"gelu={'tanh' if gelu_approx else 'exact'}: {dt*1e3:7.1f} "
              f"ms/step ({1/dt:.2f} steps/s, loss {float(metrics['train_loss']):.4f})")
        _launches(f"train_step[{impl}+mlp:{mlp_impl}]", before)
        del model, optimizer, state, step, run, batch_
    return {**times, "train_loss": losses}


def main(argv=None, graphs: bool = True) -> dict:
    """Run the parts named by ``which`` (fwd, kernels, train or all) on the
    model of ``config``; returns {"card", part: {row: seconds}}, and with
    train {"train_loss": {row: the last step's loss}}. ``graphs=False``
    times the eager train step bodies on the card too."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("which", nargs="?", default="all", choices=["fwd", "kernels", "train", "all"])
    p.add_argument("config", nargs="?", default=None,
                   help="model YAML of the forward (default: flagship CelebA-64)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = device_from_arg(args.device)
    card = card_line(device)
    print(card)
    result = {"card": card}
    if args.which in ("fwd", "all"):
        result["fwd"] = bench_forward(args.config, device=device)
    if args.which in ("kernels", "all"):
        result["kernels"] = bench_kernels(device=device)
    if args.which in ("train", "all"):
        result["train"] = bench_train(device=device, graphs=graphs)
        result["train_loss"] = result["train"].pop("train_loss")
    return result


if __name__ == "__main__":
    main()
