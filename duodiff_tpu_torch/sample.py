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
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from duodiff_tpu_torch.diffusion.cache_schedule import load_cache_schedule
from duodiff_tpu_torch.diffusion.sampling import (
    DDPMSampler,
    make_block_cached_apply,
    make_guided_apply,
)
from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
from duodiff_tpu_torch.utils.image import save_samples, to_uint8
from duodiff_tpu_torch.utils.model_loading import load_model


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
    return parser.parse_args(argv)


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


def main(argv=None) -> dict:
    """Run the CLI; returns {"samples": float (B, H, W, C) in about [0, 1],
    "intermediates": {s: the same after s reverse steps, for --timesteps_save},
    "seconds": sampling wall time}."""
    args = get_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available")
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
    if cache_on:
        if args.cache_every is not None and args.cache_every < 1:
            raise SystemExit("--cache_every must be >= 1")
        if args.guidance_scale is not None:
            raise SystemExit("--cache_every/--cache_schedule does not support "
                             "--guidance_scale")
        if args.timesteps_save:
            raise SystemExit("--cache_every/--cache_schedule does not support "
                             "--timesteps_save")
        if has_late and args.t_switch is None:
            raise SystemExit("--cache_every/--cache_schedule with a late model needs "
                             "--t_switch (the cached segment starts at the DuoDiff "
                             "handoff)")
    elif args.cache_outer is not None:
        raise SystemExit("--cache_outer requires --cache_every or --cache_schedule")

    if has_late != (args.t_switch is not None):
        raise SystemExit("DuoDiff needs both --t_switch and the late model "
                         "(--config_path_late / --checkpoint_path_late)")
    if args.t_switch is not None and not 0 <= args.t_switch <= steps:
        raise SystemExit(f"--t_switch must be in [0, {steps}], got {args.t_switch}")
    outside = [s for s in args.timesteps_save if not 1 <= s <= steps]
    if outside:
        raise SystemExit(f"--timesteps_save counts reverse steps, each in [1, {steps}]: "
                         f"got {outside}")
    attn_impl = args.attn_impl or ("fused" if device.type == "cuda" else "plain")
    output_folder = Path(args.output_folder)
    output_folder.mkdir(parents=True, exist_ok=True)

    def load(config_path, checkpoint_path, seed, int8_scales):
        model, cfg = load_model(
            config_path, None if args.random_init else checkpoint_path,
            device=device, seed=seed, attn_impl=attn_impl,
            gelu_approx=args.gelu_approx, int8_scales=int8_scales, use_ema=args.use_ema,
        )
        model.pack_for_kernels()
        return model.eval(), cfg

    schedule = NoiseSchedule.create(steps=steps, device=device)

    def dense_sampler(model):
        apply = model
        if null_label is not None:
            apply = make_guided_apply(model, args.guidance_scale, null_label)
        return DDPMSampler(apply, schedule, parametrization=args.parametrization)

    def cached_sampler(model, cfg, t_first: int, which: str):
        """The model's block-cached sampler; its state is the cached residual,
        zeros (B, L, D) in the compute dtype at the segment's first step."""
        k_half = cfg.depth // 2
        n_outer = args.cache_outer if args.cache_outer is not None else max(1, -(-k_half // 3))
        if not 1 <= n_outer <= k_half:
            raise SystemExit(f"--cache_outer must be in [1, {k_half}] for {which}depth "
                             f"{cfg.depth}, got {n_outer}")
        apply = make_block_cached_apply(
            lambda x, t, y: model.forward_anchor(x, t, y, n_outer=n_outer),
            lambda x, t, y, delta: model.forward_cached(x, t, y, n_outer=n_outer, delta=delta),
            cache_rule, t_first,
        )
        tokens = cfg.extras + cfg.num_patches
        return DDPMSampler(
            apply, schedule, parametrization=args.parametrization,
            init_state_fn=lambda x: torch.zeros((x.shape[0], tokens, cfg.embed_dim),
                                                dtype=model.dtype, device=x.device),
        )

    model, cfg = load(args.config_path, args.checkpoint_path, args.seed, args.int8_scales)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    y, null_label = class_labels(args, cfg.num_classes, generator)
    if cfg.num_classes > 0 and y is None:
        raise SystemExit("a class-conditional model needs labels: pass --class_id "
                         "(with or without --guidance_scale) or --fixed_class")
    if has_late:
        late, late_cfg = load(args.config_path_late or args.config_path,
                              args.checkpoint_path_late, args.seed + 1,
                              args.int8_scales_late)
        handoff = steps - args.t_switch
        late_sampler = (cached_sampler(late, late_cfg, handoff - 1, "the late model's ")
                        if cache_on else dense_sampler(late))
        segments = [(dense_sampler(model), steps - 1, handoff),
                    (late_sampler, handoff - 1, 0)]
    else:
        sampler = cached_sampler(model, cfg, steps - 1, "") if cache_on else dense_sampler(model)
        segments = [(sampler, steps - 1, 0)]
    # the state is kept after the update at t = steps - s
    save_at = {steps - s for s in args.timesteps_save}
    segments = split_segments(segments, save_at)
    shape = (args.batch_size, cfg.img_size, cfg.img_size, cfg.in_chans)

    print(f"Sampling {args.batch_size} images on {device} (attn_impl={attn_impl}, "
          f"cache={'on' if cache_on else 'off'})...")
    with torch.inference_mode():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        tic = time.perf_counter()
        x = segments[0][0].init(generator, shape)
        kept = {}
        for sampler, t_hi, t_lo in segments:
            if t_hi < t_lo:
                continue
            if sampler.init_state_fn is None:
                x = sampler.run(x, generator, t_hi, t_lo, y)
            else:
                x, _ = sampler.run(x, generator, t_hi, t_lo, y,
                                       state=sampler.init_state_fn(x))
            if t_lo in save_at:
                kept[t_lo] = x
        samples = ((x + 1.0) / 2.0).cpu().numpy()  # waits for the device
        elapsed = time.perf_counter() - tic
        intermediates = {s: ((kept[steps - s] + 1.0) / 2.0).cpu().numpy()
                         for s in args.timesteps_save}

    np.save(output_folder / "samples.npy", to_uint8(samples))
    with open(output_folder / "statistics.txt", "w") as f:
        f.write(f"Elapsed time: {elapsed} s\n")
    save_samples(samples, output_folder)
    for s, inter in intermediates.items():
        save_samples(inter, output_folder, timestep=s)
    print(f"Elapsed time: {elapsed:.2f} s -> {output_folder}")
    return {"samples": samples, "intermediates": intermediates, "seconds": elapsed}


if __name__ == "__main__":
    main()
