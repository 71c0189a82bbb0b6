"""Dense / DuoDiff DDPM sampling CLI (counterpart of the repository's
``sampler.py``, a subset of its flags).

    python -m duodiff_tpu_torch.sample \\
        --config_path configs/uvit_celeba_3.yaml \\
        --config_path_late configs/uvit_celeba.yaml --t_switch 300 \\
        --random_init --batch_size 16 --parametrization predict_noise \\
        --output_folder out --device cuda

With a late model and ``--t_switch N`` the first model runs the N high-noise
steps t = T-1 .. T-N and the late model the rest; without, the first model
runs all T steps. The samples are written as ``{i}.png`` each, a square
``grid_image.png`` and one ``samples.npy`` (uint8 NHWC); ``--timesteps_save
s1 s2 ...`` also writes the state after s1, s2, ... reverse steps as
``{i}_{s}.png`` (each s in [1, num_timesteps]; not with block caching).
``--use_ema`` samples with the EMA weights of a checkpoint trained with
``--ema_decay`` (both models of a pair). ``--attn_impl`` picks the block:
``fused`` (the fused sublayer
kernels K1 / K2; default on a CUDA device), ``plain`` (their plain PyTorch
versions; default on the CPU), ``fused_int8`` (the W8A8 kernels K11 / K12;
``--int8_scales`` / ``--int8_scales_late`` give the early / late model
static MLP activation scales, else they are dynamic per row), ``pallas``
(the unfused block around the attention kernel K9) or ``xla`` (the unfused
block around plain attention).

Class-conditional models need labels: ``--fixed_class N`` (every sample
class N), ``--class_id`` alone (random labels in [1, min(1001,
num_classes)), the reference's behaviour, the value ignored), or
``--class_id N --guidance_scale W`` (classifier-free guidance on class N,
``-1`` for random real classes in [0, null_class); ``--null_class`` is the
null label, default ``num_classes - 1``). A guided step is one forward at
twice the batch.

Block caching (``--cache_every N`` or ``--cache_schedule FILE``): the
centered blocks recompute only on anchor steps and their residual is reused
in between. A single model runs cached from its first step; with the
DuoDiff pair the late model's segment runs cached from the handoff, and the
shallow model stays dense. ``--cache_outer`` sets the blocks run every step
at each end (default ``ceil((depth//2) / 3)``).

The other samplers, dispatched in the JAX CLI's order:
``--interleave_every N`` (heavy-light interleaving: the late model on the
steps with t % N == 0, the first model on the others; needs the pair,
without ``--t_switch``), ``--use_dpm_solver`` (DPM-Solver++ over
``--dpm_steps`` grid points, ``--dpm_order`` 1 or 2; one model, block-cached
by transition index with ``--cache_every``), ``--use_ddim`` (DDIM over
``--ddim_steps`` grid points with ``--ddim_eta``, with the DuoDiff handoff
when the pair and ``--t_switch`` are given). Guidance composes with each of
them. The refusals follow ``sampler.py``, and the port refuses three more
combinations whose output the JAX CLI gets wrong: with DDIM a
``--timesteps_save`` value that is not ``num_timesteps - t`` for a grid
step t (the JAX CLI shifts every later label), and with DPM-Solver a late
model (the JAX CLI samples the first model alone) or ``--timesteps_save``
(the JAX CLI writes no intermediate).

A latent-diffusion config (one with an ``autoencoder:`` block, such as
``configs/uvit_imagenet256.yaml``) samples latents, which the frozen KL
autoencoder of that block (``autoencoder_checkpoint_path``, loaded in bf16)
decodes to images before they are written, the ``--timesteps_save`` states
too; the printed sampling time leaves the decode out, and the decode time
is printed apart. A DuoDiff pair decodes with the first config's block; a
pair of which only one config is latent is refused.

Under ``python -m torch.distributed.run --nproc_per_node N`` the CLI samples
on the (data, model) grid of ``parallel/mesh.py``: ``--model_parallel M``
shards every block's heads and hidden columns over groups of M ranks (the
batch must divide the N / M data shards; with ``fused`` or the unfused
blocks of ``pallas`` and ``xla``, not with ``plain`` or ``fused_int8``,
which have no shard form); without it a batch
that divides N runs data-parallel, any other whole on every rank. Every rank
draws the global batch's noise and labels from the shared generator and
keeps its rows (``diffusion/sampling.py:RowDraws``), so the samples are
those of a one-process run; rank 0 gathers the rows on the host and writes
the files. ``--multihost`` lets the grid span nodes.

On a CUDA device every sampler runs as step graphs
(``diffusion/graphs.py``): each kind of step is captured once as a CUDA
graph and replayed for every step of that kind, with the samples of the
eager loop to the bit; a failed capture ends the run with an error. The
one eager route is ``--model_parallel M > 1``, whose steps hold all-reduces
that go through the host over gloo, which a graph cannot capture; a line
says which route a run takes. On the CPU the same step bodies run eagerly.

``--pipeline_parallel`` (pipeline-parallel DuoDiff, the DuoDiff pair with
``--t_switch``, plain DDPM) splits the N ranks into two stages
(``parallel/mesh.py:pipeline_grid``): ranks [0, N // 2) hold only the first
model and run the first ``t_switch`` steps, ranks [N // 2, 2 (N // 2)) only
the late model and run the rest, and with an odd N the last rank waits. The
batch streams through them in micro-batches of ``--pipeline_microbatch``
(default ``batch_size // 4``), data-parallel within a stage
(``diffusion/pipeline.py``); the samples are those of the one-process run.
Rank 0, of the first stage, gathers the final rows from the second stage on
the host, decodes a latent pair's samples with the autoencoder only it
loads, and writes the files.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from duodiff_tpu_torch.config import load_autoencoder_config, load_model_config
from duodiff_tpu_torch.diffusion.cache_schedule import load_cache_schedule
from duodiff_tpu_torch.diffusion.graphs import StepGraphs
from duodiff_tpu_torch.diffusion.pipeline import DuoDiffPipeline
from duodiff_tpu_torch.diffusion.sampling import (
    DDPMSampler,
    RowDraws,
    ddim_pairs,
    ddim_sample,
    dpm_solver_sample,
    make_block_cached_apply,
    make_guided_apply,
    make_interleaved_apply,
    randn,
    split_segments,
)
from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
from duodiff_tpu_torch.parallel.mesh import close, pipeline_grid, sampling_grid
from duodiff_tpu_torch.utils.image import save_samples, to_uint8
from duodiff_tpu_torch.utils.model_loading import load_autoencoder, load_model


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--checkpoint_path", type=str, default=None,
                        help="Checkpoint (.pth) of the (early, for DuoDiff) model")
    parser.add_argument("--checkpoint_path_late", type=str, default=None,
                        help="Checkpoint (.pth) of the model used for the latest steps")
    parser.add_argument("--batch_size", type=int, required=True)
    parser.add_argument("--parametrization", type=str, required=True,
                        choices=["predict_noise", "predict_original", "predict_previous"])
    parser.add_argument("--output_folder", type=str, required=True)
    parser.add_argument("--config_path", type=str, required=True)
    parser.add_argument("--config_path_late", type=str, default=None)
    parser.add_argument("--t_switch", type=int, default=None,
                        help="Number of high-noise steps the first model runs "
                             "before the late model takes over")
    parser.add_argument("--class_id", type=int, default=None,
                        help="Class-conditional sampling. Unguided: random labels in "
                             "[1, min(1001, num_classes)) (the value is ignored). Guided "
                             "(--guidance_scale): sample this class; -1 draws uniform "
                             "random real classes in [0, null_class)")
    parser.add_argument("--guidance_scale", type=float, default=None,
                        help="Classifier-free guidance weight w: out = out_null + "
                             "w * (out_cond - out_null) from one forward at twice the "
                             "batch. Needs weights trained with --label_dropout")
    parser.add_argument("--null_class", type=int, default=None,
                        help="Null-label index for guidance (default num_classes - 1)")
    parser.add_argument("--fixed_class", type=int, default=None,
                        help="Unguided class-conditional sampling of this class for "
                             "every sample")
    parser.add_argument("--cache_every", type=int, default=None,
                        help="Block caching: recompute the middle blocks only on "
                             "anchor steps (t %% N == 0, and the first step of the "
                             "cached segment) and reuse their residual in between "
                             "(single model, or the DuoDiff late segment)")
    parser.add_argument("--cache_outer", type=int, default=None,
                        help="Blocks recomputed every step at EACH end of the network "
                             "under block caching. Default: ceil(depth//2 / 3)")
    parser.add_argument("--cache_schedule", type=str, default=None,
                        help="Anchor schedule JSON (tools/derive_cache_schedule.py) "
                             "in place of --cache_every: anchors exactly the listed "
                             "timesteps (plus the cached segment's first step)")
    parser.add_argument("--interleave_every", type=int, default=None,
                        help="Heavy-light interleaving: the late (full) model on the "
                             "steps with t %% N == 0, t = 0 among them, the first "
                             "(shallow) model elsewhere. Needs the model pair, without "
                             "--t_switch; plain DDPM only")
    parser.add_argument("--use_ddim", action="store_true",
                        help="DDIM over --ddim_steps linspace grid points (with the "
                             "DuoDiff handoff when --t_switch and the late model are "
                             "given)")
    parser.add_argument("--ddim_steps", type=int, default=50)
    parser.add_argument("--ddim_eta", type=float, default=0.0)
    parser.add_argument("--use_dpm_solver", action="store_true",
                        help="DPM-Solver++ over --dpm_steps grid points (one model; "
                             "block-cached by transition index with --cache_every)")
    parser.add_argument("--dpm_steps", type=int, default=20)
    parser.add_argument("--dpm_order", type=int, default=2, choices=[1, 2])
    parser.add_argument("--timesteps_save", type=int, nargs="+", default=[],
                        help="Also save the state after this many reverse steps, "
                             "each in [1, num_timesteps], as {i}_{s}.png")
    parser.add_argument("--use_ema", action="store_true",
                        help="Sample with the EMA shadow params from an --ema_decay-"
                             "trained checkpoint (both models for DuoDiff)")
    parser.add_argument("--random_init", action="store_true",
                        help="Skip checkpoint loading (random weights from --seed)")
    parser.add_argument("--num_timesteps", type=int, default=1000)
    parser.add_argument("--gelu_approx", action="store_true",
                        help="tanh-approximate GELU in the MLP sublayers")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--attn_impl", type=str, default=None,
                        choices=["fused", "plain", "fused_int8", "pallas", "xla"],
                        help="Block: fused sublayer kernels, their plain PyTorch "
                             "versions, the W8A8 kernels, or the unfused block around "
                             "the attention kernel (pallas) or plain attention (xla) "
                             "(default: fused on CUDA, plain on the CPU)")
    parser.add_argument("--int8_scales", type=str, default=None,
                        help="tools/calibrate_int8.py JSON: static MLP activation "
                             "scales of the (early) model for --attn_impl fused_int8")
    parser.add_argument("--int8_scales_late", type=str, default=None,
                        help="int8 scales JSON for the DuoDiff late model")
    parser.add_argument("--model_parallel", type=int, default=1,
                        help="Tensor-parallel degree over the ranks of torch.distributed.run: "
                             "shard the heads and the MLP hidden columns over groups of this "
                             "many ranks")
    parser.add_argument("--multihost", action="store_true",
                        help="Let the torch.distributed.run grid span nodes")
    parser.add_argument("--pipeline_parallel", action="store_true",
                        help="Pipeline-parallel DuoDiff over the ranks of torch.distributed.run: "
                             "the first half holds the first model and runs the first "
                             "--t_switch steps, the second half the late model and the rest, "
                             "the batch streaming through them in micro-batches (stage 1 of "
                             "micro-batch i+1 overlaps stage 2 of i). Needs the DuoDiff pair, "
                             "--t_switch and >= 2 ranks")
    parser.add_argument("--pipeline_microbatch", type=int, default=None,
                        help="Micro-batch size for --pipeline_parallel (default: batch_size / 4)")
    return parser.parse_args(argv)


def graph_route(device, model_parallel: int = 1, graphs: bool = True) -> tuple:
    """Whether a sampling run's steps replay as CUDA graphs, and the line
    that says which route it takes; ``graphs=False`` asks for the eager
    loop (a library caller's comparison, never a flag)."""
    if not graphs:
        return False, "step graphs: off (the caller asked for the eager loop)"
    if torch.device(device).type != "cuda":
        return False, "step graphs: off (the CPU runs each step body eagerly)"
    if model_parallel > 1:
        return False, (f"step graphs: off, eager steps (--model_parallel {model_parallel}: a "
                       "step's all-reduces go through the host over gloo, which a CUDA graph "
                       "cannot capture)")
    return True, "step graphs: on (each kind of step captured once as a CUDA graph, replayed)"


def check_parallel_flags(args, attn_impl: str) -> None:
    """The refusals of the grid's flags (``sampler.py:162-196``, ``:588-620``),
    and int8 with tensor parallelism, which the JAX CLI runs without the
    shards."""
    mp = args.model_parallel or 1
    if mp < 1:
        raise SystemExit(f"--model_parallel must be >= 1, got {mp}")
    if mp > 1 and attn_impl in ("fused_int8", "plain_int8"):
        raise SystemExit(f"--attn_impl {attn_impl} does not combine with --model_parallel: the "
                         "int8 kernels K11 / K12 have no tensor-parallel shard form")
    if mp > 1 and attn_impl not in ("fused", "pallas", "xla"):
        raise SystemExit(f"--attn_impl {attn_impl} with --model_parallel: only fused, pallas "
                         "and xla have a tensor-parallel form")


def class_labels(args, num_classes: int, generator: torch.Generator):
    """The labels (B,) int64 on the generator's device, or None, and the null
    label for guidance, by the JAX CLI's rules. Every label is checked
    against ``num_classes`` here, on the host: an out-of-range index into
    the label embedding would fail on the device, far from its cause."""
    batch, device = args.batch_size, generator.device
    if args.fixed_class is not None:
        if args.class_id is not None or args.guidance_scale is not None:
            raise SystemExit("--fixed_class is the unguided fixed-label mode; don't combine "
                             "with --class_id/--guidance_scale (guided sampling already "
                             "honors --class_id)")
        if not 0 <= args.fixed_class < num_classes:
            raise SystemExit(f"--fixed_class must be in [0, {num_classes})")
        return torch.full((batch,), args.fixed_class, dtype=torch.long, device=device), None
    if args.guidance_scale is None:
        if args.class_id is None:
            return None, None
        if num_classes < 2:
            raise SystemExit(f"--class_id needs a class-conditional model with at least 2 "
                             f"classes, got num_classes={num_classes}")
        # the reference draws in [1, 1001); labels past the embedding table are refused
        return torch.randint(1, min(1001, num_classes), (batch,), generator=generator,
                             device=device), None
    if args.class_id is None:
        raise SystemExit("--guidance_scale needs --class_id (labels)")
    null = args.null_class if args.null_class is not None else num_classes - 1
    if null < 1:
        raise SystemExit("--guidance_scale needs a class-conditional model with a reserved "
                         f"null slot: num_classes={num_classes}, null_class={null} leaves no "
                         "real classes")
    if null >= num_classes:
        raise SystemExit(f"--null_class {null} is not a label of this model: labels lie in "
                         f"[0, {num_classes})")
    if args.class_id >= null:
        raise SystemExit(f"--class_id {args.class_id} is not a real class: guided labels "
                         f"must lie in [0, {null}) (null_class and above are reserved)")
    if args.class_id >= 0:
        return torch.full((batch,), args.class_id, dtype=torch.long, device=device), null
    return torch.randint(0, null, (batch,), generator=generator, device=device), null


def check_flags(args, has_late: bool, cache_on: bool, steps: int) -> None:
    """The refusals of ``sampler.py``, in its order, and the port's own."""
    if args.pipeline_parallel:
        if not has_late or args.t_switch is None:
            raise SystemExit("--pipeline_parallel needs the DuoDiff pair "
                             "(--config_path_late/--checkpoint_path_late and --t_switch)")
        if (args.model_parallel or 1) > 1:
            raise SystemExit("--pipeline_parallel does not combine with --model_parallel")
        if args.use_ddim or args.use_dpm_solver or args.timesteps_save:
            raise SystemExit("--pipeline_parallel supports plain DDPM sampling (no "
                             "--use_ddim/--use_dpm_solver/--timesteps_save)")
    if args.interleave_every is not None:
        if args.interleave_every < 1:
            raise SystemExit("--interleave_every must be >= 1")
        if not has_late:
            raise SystemExit("--interleave_every needs the model pair "
                             "(--config_path_late/--checkpoint_path_late)")
        if (args.t_switch is not None or args.use_ddim or args.use_dpm_solver
                or args.pipeline_parallel or args.timesteps_save):
            raise SystemExit("--interleave_every supports plain DDPM sampling (no "
                             "--t_switch/--use_ddim/--use_dpm_solver/--pipeline_parallel/"
                             "--timesteps_save)")
    if cache_on:
        if args.cache_every is not None and args.cache_every < 1:
            raise SystemExit("--cache_every must be >= 1")
        if args.use_ddim or args.pipeline_parallel or args.interleave_every is not None:
            raise SystemExit("--cache_every/--cache_schedule supports plain DDPM or "
                             "DPM-Solver sampling (single model, or the DuoDiff pair with "
                             "--t_switch: the full model's segment runs cached; no "
                             "--use_ddim/--pipeline_parallel/--interleave_every)")
        if args.guidance_scale is not None:
            raise SystemExit("--cache_every/--cache_schedule does not support "
                             "--guidance_scale")
        if args.timesteps_save:
            raise SystemExit("--cache_every/--cache_schedule does not support "
                             "--timesteps_save")
        if args.use_dpm_solver and args.cache_schedule is not None:
            raise SystemExit("--cache_schedule is t-indexed; the solver's anchors are "
                             "transition-indexed: use --cache_every with --use_dpm_solver")
        if args.use_dpm_solver and has_late:
            raise SystemExit("--cache_every with --use_dpm_solver supports the "
                             "single-model solver only")
        if has_late and args.t_switch is None:
            raise SystemExit("--cache_every/--cache_schedule with a late model needs "
                             "--t_switch (the cached segment starts at the DuoDiff "
                             "handoff)")
    elif args.cache_outer is not None:
        raise SystemExit("--cache_outer requires --cache_every or --cache_schedule")
    if args.interleave_every is None and has_late != (args.t_switch is not None):
        raise SystemExit("DuoDiff needs both --t_switch and the late model "
                         "(--config_path_late / --checkpoint_path_late)")
    if args.t_switch is not None and not 0 <= args.t_switch <= steps:
        raise SystemExit(f"--t_switch must be in [0, {steps}], got {args.t_switch}")
    outside = [s for s in args.timesteps_save if not 1 <= s <= steps]
    if outside:
        raise SystemExit(f"--timesteps_save counts reverse steps, each in [1, {steps}]: "
                         f"got {outside}")
    if args.use_dpm_solver:
        if args.parametrization == "predict_previous":
            raise SystemExit("--use_dpm_solver supports predict_noise/predict_original")
        if has_late:
            raise SystemExit("--use_dpm_solver samples one model: drop the late model "
                             "(--config_path_late/--checkpoint_path_late/--t_switch), "
                             "which the solver would never run")
        if args.timesteps_save:
            raise SystemExit("--use_dpm_solver keeps no intermediate state: drop "
                             "--timesteps_save")
        if args.dpm_steps < 2:
            raise SystemExit(f"--dpm_steps must be >= 2, got {args.dpm_steps}")
    elif args.use_ddim and args.timesteps_save:
        reachable = {steps - t for pairs in ddim_pairs(steps, args.ddim_steps) for t, _ in pairs}
        unreachable = [s for s in args.timesteps_save if s not in reachable]
        if unreachable:
            raise SystemExit(f"--use_ddim keeps the state only after a grid step t, as "
                             f"--timesteps_save {steps} - t: {unreachable} is not such a "
                             f"value for --ddim_steps {args.ddim_steps} (the grid's: "
                             f"{sorted(reachable)})")


def latent_decoder(config_path, device, late_config_path=None, load: bool = True):
    """The decode of a latent-diffusion config's frozen autoencoder (bf16),
    or None for a config without an ``autoencoder`` block (or with ``load``
    false, after the checks). With a late config (a DuoDiff pair) the first
    config's block decodes, and a pair of which only one config is latent
    is refused."""
    ae_cfg = load_autoencoder_config(config_path)
    if late_config_path is not None and (
            (load_autoencoder_config(late_config_path) is None) != (ae_cfg is None)):
        raise SystemExit(f"one of {config_path} and {late_config_path} samples latents and "
                         "the other images: a DuoDiff pair must share its sample space")
    if ae_cfg is None or not load:
        return None
    autoencoder = load_autoencoder(ae_cfg.autoencoder_checkpoint_path, ae_cfg,
                                   dtype=torch.bfloat16, device=device)
    return autoencoder.decode


def decode_all(decode, x, kept: dict, device) -> tuple:
    """``decode`` (or nothing, when None) applied to the samples and each
    kept state; returns (samples, kept, seconds the decode took)."""
    if decode is None:
        return x, kept, 0.0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    tic = time.perf_counter()
    x, kept = decode(x), {s: decode(v) for s, v in kept.items()}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return x, kept, time.perf_counter() - tic


def main(argv=None, *, graphs: bool = True) -> dict:
    """Run the CLI; returns {"samples": float (B, H, W, C) in about [0, 1],
    decoded images for a latent config, "intermediates": {s: the same after
    s reverse steps, for --timesteps_save}, "seconds": sampling wall time,
    "decode_seconds": the decode's (0 without an autoencoder)}.
    ``graphs=False`` runs the step bodies eagerly on a CUDA device too (a
    library caller's comparison; the CLI has no such flag)."""
    args = get_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available")
    mp = args.model_parallel or 1
    attn_impl = args.attn_impl or ("fused" if args.device.startswith("cuda") or mp > 1
                                   else "plain")
    check_parallel_flags(args, attn_impl)
    if not args.random_init and args.checkpoint_path is None:
        raise SystemExit("--checkpoint_path is required (or pass --random_init)")
    has_late = args.config_path_late is not None or args.checkpoint_path_late is not None
    steps = args.num_timesteps

    # anchor rule for block caching: the uniform period or a boolean table
    cache_rule = args.cache_every
    if args.cache_schedule is not None:
        if args.cache_every is not None:
            raise SystemExit("--cache_schedule and --cache_every are mutually exclusive")
        cache_rule = load_cache_schedule(args.cache_schedule, num_timesteps=steps)
    cache_on = cache_rule is not None
    check_flags(args, has_late, cache_on, steps)
    if args.pipeline_parallel:
        microbatch = args.pipeline_microbatch or max(1, args.batch_size // 4)
        grid = pipeline_grid(args.batch_size, microbatch, args.device, args.multihost)
        try:
            return _sample_pipeline(args, grid, microbatch, steps, attn_impl, graphs)
        finally:
            close(grid)
    grid = sampling_grid(mp, args.batch_size, args.device, args.multihost)
    try:
        return _sample(args, grid, has_late, steps, cache_rule, cache_on, attn_impl, graphs)
    finally:
        close(grid)


def _load(args, grid, attn_impl, late: bool):
    """The first (or the late) model of the CLI's flags, packed, in eval mode."""
    config_path, checkpoint_path, seed, scales = (
        (args.config_path_late or args.config_path, args.checkpoint_path_late, args.seed + 1,
         args.int8_scales_late) if late else
        (args.config_path, args.checkpoint_path, args.seed, args.int8_scales))
    model, cfg = load_model(
        config_path, None if args.random_init else checkpoint_path,
        device=grid.device, seed=seed, attn_impl=attn_impl,
        gelu_approx=args.gelu_approx, int8_scales=scales, use_ema=args.use_ema,
        grid=grid,
    )
    model.pack_for_kernels()
    return model.eval(), cfg


def _guided(args, model, null_label):
    if null_label is None:
        return model
    return make_guided_apply(model, args.guidance_scale, null_label)


def _sample_pipeline(args, grid, microbatch: int, steps: int, attn_impl: str,
                     graphs: bool) -> dict:
    """:func:`main` for ``--pipeline_parallel``: this rank's stage of the
    pipeline (nothing on a waiting rank); rank 0 writes the files."""
    device = grid.device
    output_folder = Path(args.output_folder)
    decode = latent_decoder(args.config_path, device, args.config_path_late, load=grid.is_main)
    schedule = NoiseSchedule.create(steps=steps, device=device)
    cfg = load_model_config(args.config_path)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    y, null_label = class_labels(args, cfg.num_classes, generator)
    if cfg.num_classes > 0 and y is None:
        raise SystemExit("a class-conditional model needs labels: pass --class_id "
                         "(with or without --guidance_scale) or --fixed_class")
    apply = None
    if grid.active:
        apply = _guided(args, _load(args, grid, attn_impl, late=grid.stage == 1)[0], null_label)
    graphed, route = graph_route(device, graphs=graphs)
    pipe = DuoDiffPipeline(apply, apply, schedule, t_switch=args.t_switch, grid=grid,
                           parametrization=args.parametrization, graphs=graphed)
    n_micro = args.batch_size // microbatch
    shape = (microbatch, cfg.img_size, cfg.img_size, cfg.in_chans)
    if grid.is_main:
        output_folder.mkdir(parents=True, exist_ok=True)
        print(f"Sampling {args.batch_size} images on {device} (ddpm pipelined over 2 stages of "
              f"{grid.data} ranks, {n_micro} micro-batches of {microbatch}, t_switch "
              f"{args.t_switch}, attn_impl={attn_impl})...")
        print(route)
    with torch.inference_mode():
        grid.barrier()  # every stage has its model
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        tic = time.perf_counter()
        outs = pipe.sample(generator, shape, n_micro, None if y is None else y.split(microbatch))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        elapsed = time.perf_counter() - tic
        if not grid.is_main:
            return {"samples": None, "intermediates": {}, "seconds": elapsed,
                    "decode_seconds": 0.0}
        x, _, decode_seconds = decode_all(decode, torch.cat(outs).to(device), {}, device)
        samples = ((x + 1.0) / 2.0).cpu().numpy()
    return _write(output_folder, samples, {}, elapsed, decode, decode_seconds)


def _write(output_folder: Path, samples, intermediates: dict, elapsed: float, decode,
           decode_seconds: float) -> dict:
    """Rank 0's files: ``samples.npy``, ``statistics.txt``, the PNGs; returns
    :func:`main`'s result."""
    np.save(output_folder / "samples.npy", to_uint8(samples))
    with open(output_folder / "statistics.txt", "w") as f:
        f.write(f"Elapsed time: {elapsed} s\n")
    save_samples(samples, output_folder)
    for s, inter in intermediates.items():
        save_samples(inter, output_folder, timestep=s)
    if decode is not None:
        print(f"Decode time: {decode_seconds:.2f} s")
    print(f"Elapsed time: {elapsed:.2f} s -> {output_folder}")
    return {"samples": samples, "intermediates": intermediates, "seconds": elapsed,
            "decode_seconds": decode_seconds}


def _sample(args, grid, has_late, steps, cache_rule, cache_on, attn_impl,
            use_graphs: bool) -> dict:
    """:func:`main` once the flags are checked and the grid is formed."""
    device = grid.device
    output_folder = Path(args.output_folder)
    if grid.is_main:
        output_folder.mkdir(parents=True, exist_ok=True)

    decode = latent_decoder(args.config_path, device,
                            args.config_path_late if has_late else None)
    schedule = NoiseSchedule.create(steps=steps, device=device)
    graphed, route = graph_route(device, grid.model, use_graphs)
    graphs = StepGraphs(device, graphed)  # the run's graphs, buffers and memory pool

    def guided(model):
        return _guided(args, model, null_label)

    def dense_sampler(model):
        return DDPMSampler(guided(model), schedule, parametrization=args.parametrization,
                           graphs=graphs)

    def cache_parts(model, cfg, which: str):
        """(anchor, cached, init_state) of the model's block cache: its
        forward_anchor / forward_cached at n_outer, and the state at a
        segment's first step, zeros (B, L, D) in the compute dtype."""
        k_half = cfg.depth // 2
        n_outer = args.cache_outer if args.cache_outer is not None else max(1, -(-k_half // 3))
        if not 1 <= n_outer <= k_half:
            raise SystemExit(f"--cache_outer must be in [1, {k_half}] for {which}depth "
                             f"{cfg.depth}, got {n_outer}")
        tokens = cfg.extras + cfg.num_patches
        return (
            lambda x, t, y: model.forward_anchor(x, t, y, n_outer=n_outer),
            lambda x, t, y, delta: model.forward_cached(x, t, y, n_outer=n_outer, delta=delta),
            lambda x: torch.zeros((x.shape[0], tokens, cfg.embed_dim), dtype=model.dtype,
                                  device=x.device),
        )

    def cached_sampler(model, cfg, t_first: int, which: str):
        """The model's block-cached DDPM sampler; its state is the cached residual."""
        anchor, cached, init_state = cache_parts(model, cfg, which)
        apply = make_block_cached_apply(anchor, cached, cache_rule, t_first)
        return DDPMSampler(apply, schedule, parametrization=args.parametrization,
                           init_state_fn=init_state, graphs=graphs)

    model, cfg = _load(args, grid, attn_impl, late=False)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    y, null_label = class_labels(args, cfg.num_classes, generator)
    if cfg.num_classes > 0 and y is None:
        raise SystemExit("a class-conditional model needs labels: pass --class_id "
                         "(with or without --guidance_scale) or --fixed_class")
    rows = grid.rows(args.batch_size)  # this rank's rows of the global batch
    if y is not None:
        y = y[rows[0]:rows[1]]
    if grid.distributed:
        generator = RowDraws(generator, rows)
    late = None
    if has_late:
        late, late_cfg = _load(args, grid, attn_impl, late=True)
    shape = (rows[1] - rows[0], cfg.img_size, cfg.img_size, cfg.in_chans)

    if args.interleave_every is not None:
        kind = f"interleave_every={args.interleave_every}"
        apply = make_interleaved_apply(guided(late), guided(model), args.interleave_every)
        sampler = DDPMSampler(apply, schedule, parametrization=args.parametrization,
                              init_state_fn=lambda x: (), graphs=graphs)

        def run(x0):
            return sampler.run(x0, generator, steps - 1, 0, y, state=())[0], {}
    elif args.use_dpm_solver:
        kind = f"dpm_solver order {args.dpm_order}, {args.dpm_steps} steps"
        cache = None
        if cache_on:
            anchor, cached, init_state = cache_parts(model, cfg, "")
            cache = (anchor, cached, args.cache_every, init_state)

        def run(x0):
            return dpm_solver_sample(
                guided(model), generator, schedule=schedule, shape=shape,
                dpm_steps=args.dpm_steps, order=args.dpm_order,
                parametrization=args.parametrization, y=y, x_init=x0, cache=cache,
                graphs=graphs,
            ), {}
    elif args.use_ddim:
        kind = f"ddim {args.ddim_steps} steps, eta {args.ddim_eta}"

        def run(x0):
            x, inter = ddim_sample(
                guided(model), generator, schedule=schedule, shape=shape,
                ddim_steps=args.ddim_steps, eta=args.ddim_eta, y=y,
                timesteps_save=args.timesteps_save, x_init=x0,
                late_apply_fn=guided(late) if late is not None else None,
                t_switch=args.t_switch, graphs=graphs,
            )
            return x, dict(zip(args.timesteps_save, inter))
    else:
        kind = "ddpm"
        if late is not None:
            handoff = steps - args.t_switch
            late_sampler = (cached_sampler(late, late_cfg, handoff - 1, "the late model's ")
                            if cache_on else dense_sampler(late))
            segments = [(dense_sampler(model), steps - 1, handoff),
                        (late_sampler, handoff - 1, 0)]
        else:
            single = (cached_sampler(model, cfg, steps - 1, "") if cache_on
                      else dense_sampler(model))
            segments = [(single, steps - 1, 0)]
        # the state is kept after the update at t = steps - s
        save_at = {steps - s for s in args.timesteps_save}
        segments = split_segments(segments, save_at)

        def run(x):
            kept = {}
            for sampler, t_hi, t_lo in segments:
                if t_hi < t_lo:
                    continue
                if sampler.init_state_fn is None:
                    x = sampler.run(x, generator, t_hi, t_lo, y)
                else:
                    x, _ = sampler.run(x, generator, t_hi, t_lo, y,
                                       state=sampler.init_state_fn(x))
                if t_lo in save_at:  # out of the run's x buffer, which goes on
                    kept[steps - t_lo] = x.clone()
            return x, {s: kept[s] for s in args.timesteps_save}

    if grid.is_main:
        print(f"Sampling {args.batch_size} images on {device} ({kind}, attn_impl={attn_impl}, "
              f"cache={'on' if cache_on else 'off'}, grid data {grid.data} x model "
              f"{grid.model})...")
        print(route)
    with torch.inference_mode():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        tic = time.perf_counter()
        x = randn(shape, generator, device)
        x, kept = run(x)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        elapsed = time.perf_counter() - tic
        x, kept, decode_seconds = decode_all(decode, x, kept, device)
        # rank 0 gathers every data rank's rows on the host
        samples = grid.gather_rows(((x + 1.0) / 2.0).cpu()).numpy()
        intermediates = {s: grid.gather_rows(((v + 1.0) / 2.0).cpu()).numpy()
                         for s, v in kept.items()}
    if not grid.is_main:
        return {"samples": samples, "intermediates": intermediates, "seconds": elapsed,
                "decode_seconds": decode_seconds}
    return _write(output_folder, samples, intermediates, elapsed, decode, decode_seconds)


if __name__ == "__main__":
    main()
