"""Training orchestration on one device or a process grid (counterpart of
``duodiff_tpu/training/trainer.py``).

``Trainer(args).train()`` with ``main.py``'s flag surface: the model, a
U-ViT or (``--model deediff_uvit``) the DeeDiff early-exit U-ViT (the fused
K1/K2 forward and K6/K7 backward kernels on CUDA by default, the plain
PyTorch sublayers on the CPU, or the unfused block around the attention
kernels K9/K10 with ``--attn_impl pallas``), for the early-exit model a
backbone loaded (``--load_backbone``) and frozen (``--freeze_backbone``),
an optional distillation teacher, the CIFAR-10 or cached CelebA /
ImageNet-64 / ImageNet-256 loader, for a latent-diffusion config the frozen
KL autoencoder that encodes every batch before its step,
classifier-free-guidance label dropout, AdamW with clipping and the
cosine-warmup schedule, an optional EMA, gradient
accumulation (``--grad_accum``), skipping of non-finite updates
(``--skip_nonfinite``), activation checkpointing (``--use_checkpoint``),
sampling during training (``--log_every_n_steps``), the profiler
(``--profile``), checkpoints with exact resume, also in the middle of an
accumulation window, written in the background with
``--async_checkpoint``, and a SIGTERM checkpoint-and-exit.

Under ``python -m torch.distributed.run`` the run forms the (data, model)
grid of ``parallel/mesh.py`` (``--model_parallel``, ``--multihost``): the
blocks are tensor-parallel shards (``fused`` by default, or the unfused
block of ``pallas`` / ``xla``), and so are the time embedding's MLP and the
early-exit heads and probes by JAX's rules; each data rank reads and draws
its rows of the global batch, the gradients are averaged over the data
group, and rank 0 alone writes the metrics, ``hparams.json``, the samples
and the checkpoints, which hold the full state gathered from the shards, so
any one-GPU tool loads them and a grid of any shape resumes from them.
``--fsdp`` (``--fsdp_min_size``) also cuts every large leaf over the data
group, with the optimizer's moments and the EMA (``parallel/fsdp.py``): the
weights are gathered around each block's forward and again for its
backward, the gradients reduce-scattered; with a data group of 1 it shards
nothing and says so. Under ``--fsdp --freeze_backbone`` the frozen backbone
takes no gradient at all (it is gathered, never reduce-scattered), so the
logged ``grad_norm`` is the trained leaves' norm.

On one process on a CUDA device each kind of train step is one CUDA graph
(:func:`train_graph_route`, ``training/train_state.py:make_train_step``):
the loader's arrays are copied into static buffers, the step's draws made
eagerly into more, and the step graph (forward, loss, backward, clipping,
AdamW, EMA, metrics) replayed; a latent config's encode is a graph of its
own. On the CPU, with ``Trainer(args, graphs=False)`` or on a process grid
(whose collectives go through the host over gloo) the same bodies run
eagerly.

Deliberate difference: the in-training samples go to a PNG grid beside the
metrics, not to TensorBoard (an RGBA grid of the undecoded latents for a
latent model, as JAX logs them).
"""

from __future__ import annotations

import signal
import threading
import time
from pathlib import Path

import numpy as np
import torch

from duodiff_tpu_torch.config import UViTConfig, load_autoencoder_config
from duodiff_tpu_torch.data.datasets import get_dataloader
from duodiff_tpu_torch.diffusion.graphs import StepGraphs
from duodiff_tpu_torch.diffusion.sampling import ddpm_loop
from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
from duodiff_tpu_torch.models.early_exit import EarlyExitUViT, init_early_exit_uvit
from duodiff_tpu_torch.models.uvit import init_uvit
from duodiff_tpu_torch.parallel import fsdp
from duodiff_tpu_torch.parallel.mesh import training_grid
from duodiff_tpu_torch.training.checkpointer import Checkpointer
from duodiff_tpu_torch.training.train_state import (
    TrainState,
    make_optimizer,
    make_train_step,
    step_buffer,
    step_generator,
)
from duodiff_tpu_torch.utils.convert import (
    early_exit_state_dict_from_reference,
    early_exit_state_dict_to_reference,
    gather_state_dict,
    shard_state_dict,
)
from duodiff_tpu_torch.utils.image import make_grid, save_image
from duodiff_tpu_torch.utils.model_loading import load_autoencoder, load_backbone, load_model
from duodiff_tpu_torch.utils.train_utils import MetricsLogger

ENCODE_STREAM = 7  # the JAX trainer's fold_in constant for the encode's draw

TP_IMPLS = (None, "auto", "fused", "pallas", "xla", "pallas_plain")


def refuse_unported(args) -> None:
    """Raise ValueError for a combination of flags the trainer cannot run."""
    impl = getattr(args, "attn_impl", None)
    if (getattr(args, "model_parallel", 1) or 1) > 1 and impl not in TP_IMPLS:
        raise ValueError(f"--attn_impl {impl} with --model_parallel: only fused, pallas and xla "
                         "have a tensor-parallel form")
    model = getattr(args, "model", "uvit")
    if model != "deediff_uvit":
        for flag in ("load_backbone", "freeze_backbone"):
            if getattr(args, flag, None):
                raise ValueError(f"--{flag} applies to --model deediff_uvit only; with "
                                 f"--model {model} it would do nothing")


def sample_rows(model, schedule: NoiseSchedule, x, generator, y=None, noise_table=None,
                graphs=True):
    """The in-training sampler: ancestral DDPM over every step, predicting
    the noise, variance ``beta``, from ``x``. Returns ``(x_0, probe_rows,
    stat_rows)``: per step the mean and std of the model's output (T, 2),
    and for an early-exit model, which steps on its backbone, its probes'
    outputs (T, depth, B), else None; rows in step order, T-1 first.
    ``graphs`` is :func:`ddpm_loop`'s: each call captures afresh, since the
    weights move between calls."""
    early_exit = isinstance(model, EarlyExitUViT)

    def stats(out):
        out = out.float()
        return torch.stack([out.mean(), out.std(unbiased=False)])

    def aux(out):
        if early_exit:
            return out[0], (out[1], stats(out[0]))
        return out, stats(out)

    x, rows = ddpm_loop(model, schedule, "predict_noise", x, generator,
                        range(schedule.steps - 1, -1, -1), y, "beta", noise_table, aux_fn=aux,
                        graphs=graphs)
    return (x, *rows) if early_exit else (x, None, rows)


def train_graph_route(device, grid=None, graphs: bool = True) -> tuple:
    """Whether a training run's steps replay as CUDA graphs, and the line
    that says which route it takes; ``graphs=False`` asks for the eager
    steps (a library caller's comparison, never a flag)."""
    if not graphs:
        return False, "train step graphs: off (the caller asked for the eager steps)"
    if torch.device(device).type != "cuda":
        return False, "train step graphs: off (the CPU runs each step body eagerly)"
    if grid is not None and grid.distributed:
        return False, (f"train step graphs: off, eager steps (a process grid of {grid.world} "
                       f"ranks, data {grid.data} x model {grid.model}: its all-reduces, "
                       "--model_parallel's and --fsdp's too, go through the host over gloo, "
                       "which a CUDA graph cannot capture)")
    return True, ("train step graphs: on (each kind of train step, and a latent config's "
                  "encode, captured once as a CUDA graph, replayed)")


class Trainer:
    def __init__(self, args, graphs: bool = True):
        refuse_unported(args)
        self.args = args
        self.logs = []
        self.grid = training_grid(getattr(args, "model_parallel", 1), args.batch_size,
                                  args.device, bool(getattr(args, "multihost", False)))
        if not self.grid.active:
            print(f"rank {self.grid.rank}: no rows of the batch for this rank; it waits")
            return
        self.device = self.grid.device
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise SystemExit(f"--device {args.device}: no CUDA device is available")
        self.rows = self.grid.rows(args.batch_size)  # this data rank's rows of the batch
        self.log_path = Path(args.log_path) / args.exp_name
        self.log_path.mkdir(parents=True, exist_ok=True)
        self.compute_dtype = (
            torch.bfloat16 if args.use_amp and args.amp_dtype == "bfloat16" else torch.float32
        )
        self.model_config = UViTConfig.from_dict(vars(args))
        self.schedule = NoiseSchedule.create(steps=args.num_timesteps, device=self.device)
        self.attn_impl = args.attn_impl
        if self.attn_impl in (None, "auto"):
            tp = self.grid.model > 1
            self.attn_impl = "fused" if self.device.type == "cuda" or tp else "plain"
        self.gelu_approx = args.gelu == "tanh"
        self.use_graphs = graphs  # False: the in-training sampler's steps are eager too
        graphed, route = train_graph_route(self.device, self.grid, graphs)
        if self.grid.is_main:
            print(route, flush=True)
        self.graphs = StepGraphs(self.device, graphed)  # the run's graphs, buffers and pool

        self._init_model()
        self._init_teacher()
        self._init_autoencoder()
        self.dataloader = get_dataloader(args.dataset, args.batch_size, args.seed,
                                         args.data_path, rows=self.rows)
        # labels feed the model for ImageNet and for any class-conditional model
        self.has_labels = "imagenet" in args.dataset or self.model_config.num_classes > 0
        grad_accum = getattr(args, "grad_accum", 1) or 1
        if grad_accum > 1 and args.n_steps % grad_accum:
            raise ValueError(f"--n_steps {args.n_steps} must be a multiple of "
                             f"--grad_accum {grad_accum}")
        trainable = dict(self.model.named_parameters())
        if getattr(args, "freeze_backbone", False):
            print("Freezing the backbone...")
            trainable = {n: p for n, p in trainable.items() if not n.startswith("uvit.")}
        optimizer = make_optimizer(
            trainable, lr=args.lr, weight_decay=args.weight_decay,
            beta1=args.beta1, beta2=args.beta2, max_grad_norm=args.max_grad_norm,
            # schedule positions count optimizer updates, not data steps
            num_warmup_steps=args.num_warmup_steps,
            num_training_steps=max(args.n_steps // grad_accum, 1),
            skip_nonfinite=getattr(args, "skip_nonfinite", 0) or 0, grad_accum=grad_accum,
            grid=self.grid, fsdp=self.fsdp_shapes.keys(),
        )
        self.state = TrainState.create(self.model, optimizer, ema_decay=args.ema_decay or 0.0)
        self.checkpointer = Checkpointer(args.log_path, args.exp_name,
                                         save_name=args.save_checkpoint_path,
                                         dataset=args.dataset, model=args.model,
                                         async_save=bool(getattr(args, "async_checkpoint", False)))
        self.logger = MetricsLogger(self.log_path, enabled=self.grid.is_main)
        self.logger.log_hparams(vars(args))
        self.start_step = 0
        self._maybe_resume()
        label_dropout = getattr(args, "label_dropout", 0.0) or 0.0
        self._train_step = make_train_step(
            self.model, self.schedule, parametrization=args.parametrization, seed=args.seed,
            model_kind=args.model,
            use_unweighted_loss=bool(getattr(args, "use_unweighted_loss", False)),
            has_labels=self.has_labels, teacher=self.teacher,
            distill_alpha=args.distill_alpha, t_min=args.distill_t_min or 0,
            label_dropout=label_dropout, null_label=self._null_label(label_dropout),
            grid=self.grid, rows=self.rows, graphs=self.graphs,
        )

    def _null_label(self, label_dropout: float):
        """The null label of classifier-free-guidance training, the last
        embedding slot, or None without ``--label_dropout``. Refuses a
        model without labels, and a config whose ``num_classes`` leaves the
        null token no slot beyond the dataset's real classes (it would alias
        the last class)."""
        if label_dropout <= 0.0:
            return None
        num_classes = self.model_config.num_classes
        if not self.has_labels or num_classes <= 0:
            raise ValueError("--label_dropout needs a class-conditional model "
                             "(num_classes > 0); it would silently be a no-op here")
        real = getattr(self.dataloader.dataset, "num_real_classes", None)
        if real is not None and num_classes <= real:
            raise ValueError(
                f"--label_dropout needs num_classes > the dataset's real class count ({real}) "
                f"so the null token gets its own embedding slot; this config has "
                f"num_classes={num_classes}, which would alias the null token onto real class "
                f"{num_classes - 1} (use e.g. num_classes: {real + 1})")
        print(f"label_dropout={label_dropout}: using null label {num_classes - 1}")
        return num_classes - 1

    @property
    def early_exit(self) -> bool:
        return self.args.model == "deediff_uvit"

    def _init_model(self):
        args = self.args
        if self.grid.is_main:
            print(f"Training {args.model} on {self.device} (attn_impl={self.attn_impl}, "
                  f"dtype={self.compute_dtype})")
        init = init_early_exit_uvit if self.early_exit else init_uvit
        self.model = init(
            self.model_config, device="cpu", dtype=self.compute_dtype,
            generator=torch.Generator().manual_seed(args.seed),
            attn_impl=self.attn_impl, gelu_approx=self.gelu_approx,
            use_checkpoint=bool(getattr(args, "use_checkpoint", False)),
        )
        if getattr(args, "load_backbone", None):
            print(f"Loading backbone from {args.load_backbone}")
            load_backbone(args.load_backbone, self.model.uvit)
        self.model.shard_(self.grid)
        self.fsdp_shapes = {}
        if getattr(args, "fsdp", False):
            self._shard_fsdp()
        self.model.to(self.device).train()

    def _shard_fsdp(self) -> None:
        """--fsdp: cut the large leaves over the data group (a no-op, said
        so, with a data group of 1)."""
        args, grid, model = self.args, self.grid, self.model
        min_size = getattr(args, "fsdp_min_size", 16384)
        if getattr(args, "freeze_backbone", False):
            model.uvit.requires_grad_(False)  # gathered, never reduce-scattered
        before = sum(p.numel() for p in model.parameters())
        state = fsdp.shard_model(model, grid, min_size, self.model_config.num_heads)
        if state is None:
            if grid.is_main:
                print(f"--fsdp: the data group is 1 (grid data {grid.data}, model {grid.model}), "
                      "so FSDP shards nothing", flush=True)
            return
        self.fsdp_shapes = state.shapes
        after = sum(p.numel() for p in model.parameters())
        if grid.is_main:
            print(f"--fsdp: {len(state.shapes)} leaves of >= {min_size} elements cut over "
                  f"{grid.data} data ranks, {len(state.units)} blocks and the root; parameters "
                  f"a rank {before} -> {after}", flush=True)

    def _init_teacher(self):
        """Optional distillation teacher: a frozen model in eval mode, its
        operands packed for the forward kernels."""
        args = self.args
        self.teacher = None
        if not args.distill_config:
            return
        if self.early_exit:
            raise ValueError("distillation targets a plain UViT student (--model uvit)")
        if not args.distill_from:
            print("WARNING: random-init teacher (--distill_from not given)")
        self.teacher, _ = load_model(
            args.distill_config, args.distill_from, device=self.device,
            dtype=self.compute_dtype, seed=args.seed + 1, attn_impl=self.attn_impl,
            gelu_approx=self.gelu_approx,
        )
        self.teacher.requires_grad_(False)
        self.teacher.pack_for_kernels()
        self.teacher.eval()
        print(f"Distilling from {args.distill_config} "
              f"(alpha={args.distill_alpha}, t_min={args.distill_t_min})")

    def _init_autoencoder(self):
        """The frozen KL autoencoder of a latent-diffusion config (its
        ``autoencoder`` block) in the compute dtype, or None. It is in no
        optimizer, no EMA and no checkpoint."""
        config_path = getattr(self.args, "config_path", None)
        ae_cfg = load_autoencoder_config(config_path) if config_path else None
        self.autoencoder = None
        if ae_cfg is not None:
            print(f"Encoding with the autoencoder {ae_cfg.autoencoder_checkpoint_path}")
            self.autoencoder = load_autoencoder(ae_cfg.autoencoder_checkpoint_path, ae_cfg,
                                                dtype=self.compute_dtype, device=self.device)

    def _encode(self, batch: dict, step: int) -> dict:
        """The batch with its images encoded to latents (a latent config), the
        draw from the step's own generator, stream 7, so a resumed run
        encodes what an unbroken one would; else the batch as it is. The
        noise is drawn eagerly into a static buffer, then the encode (the
        moments and the reparameterised sample) runs as a step graph of its
        own, from the static image buffer into the static latent one, of
        which the batch holds a copy (the next step rewrites the buffer)."""
        if self.autoencoder is None:
            return batch
        ae, graphs = self.autoencoder, self.graphs
        g = step_generator(self.args.seed, step, self.device, ENCODE_STREAM)
        images = batch["image"]
        lo, hi, total = self.rows
        f = 2 ** (len(ae.config.ch_mult) - 1)  # the encoder's downsampling
        shape = (total, images.shape[1] // f, images.shape[2] // f, ae.config.embed_dim)
        # the global batch's draw, this rank's rows of it
        noise = graphs.buffer("encode noise", (hi - lo, *shape[1:]))
        noise.copy_(torch.randn(shape, generator=g, device=self.device)[lo:hi])
        source = graphs.buffer("batch image", images.shape, images.dtype)
        if source is not images:
            source.copy_(images)
        latent = graphs.buffer("encode latent", noise.shape)

        def body():
            with torch.no_grad():
                latent.copy_(ae.sample_latent(ae.encode_moments(source), noise=noise))

        graphs.step(("encode",), body)
        return {**batch, "image": latent.clone()}

    def _maybe_resume(self):
        args = self.args
        path = args.load_checkpoint_path
        if path is None and args.resume:
            path = self.checkpointer.last_checkpoint()
        if path is None:
            return
        print(f"Loading training state from {path}")
        restored = Checkpointer.restore(path)
        grid, shapes = self.grid, self.fsdp_shapes
        self.model.load_state_dict(
            shard_state_dict(self._from_saved(restored["model_state_dict"]), grid, shapes),
            strict=True)
        optimizer = dict(restored["optimizer"])
        for key in ("mu", "nu", "acc_grads"):
            if key in optimizer:
                optimizer[key] = shard_state_dict(optimizer[key], grid, shapes)
        self.state.optimizer.load_state_dict(optimizer)
        if self.state.ema is not None:
            ema = restored.get("ema_state_dict")
            if ema is not None:
                ema = shard_state_dict(self._from_saved(ema), grid, shapes)
            else:
                print("Checkpoint has no EMA params; starting EMA from the restored params")
                ema = dict(self.model.named_parameters())
            if set(ema) != set(self.state.ema):
                raise KeyError("checkpoint EMA names other parameters than the model's")
            with torch.no_grad():
                for name, t in self.state.ema.items():
                    t.copy_(ema[name])
        self.dataloader.set_state(restored["sampler_state"])
        self.start_step = int(restored["step"])

    def train(self) -> list:
        """Run steps start_step + 1 .. n_steps; returns the logged metrics.
        SIGTERM checkpoints at the next step boundary and returns."""
        if not self.grid.active:
            return self.logs
        self._preempted = False
        in_main_thread = threading.current_thread() is threading.main_thread()
        prev_handler = None
        if in_main_thread:
            prev_handler = signal.signal(signal.SIGTERM, self._on_sigterm)
        try:
            self.logs = []
            batches = self.dataloader.prefetching_iterator()
            try:
                self._run_steps(batches, self.logs)
            finally:
                batches.close()
            return self.logs
        finally:
            if in_main_thread:
                signal.signal(signal.SIGTERM, prev_handler)
            self.close()

    def _on_sigterm(self, signum, frame):
        self._preempted = True

    def close(self) -> None:
        """Wait for a checkpoint in flight, then release the logger's file, the
        checkpointer's and the loader's threads. Idempotent."""
        if not self.grid.active:
            return
        try:
            self.checkpointer.close()
        finally:
            self.logger.close()
            self.dataloader.close()

    def _to_device(self, batch: dict) -> dict:
        """The loader's arrays copied into the run's static buffers: the
        images into the train step's (or, for a latent config, the
        encode's), the labels into the train step's. On the card the copy
        goes from pinned memory without waiting, so the host may queue the
        next steps."""
        arrays = {"image": torch.from_numpy(batch["image"]),
                  "label": torch.from_numpy(batch["label"]).long()}
        out = {}
        for key, src in arrays.items():
            if key == "image" and self.autoencoder is not None:
                buf = self.graphs.buffer("batch image", src.shape, src.dtype)
            else:
                buf = step_buffer(self.graphs, key, src)
            if self.device.type == "cuda":
                src = src.pin_memory()
            out[key] = buf.copy_(src, non_blocking=True)
        return out

    def _run_steps(self, batches, logs: list) -> None:
        args = self.args
        self._profiler = None
        t_last, last_logged = time.time(), self.start_step
        try:
            for step in range(self.start_step + 1, args.n_steps + 1):
                if getattr(args, "profile", False):
                    # the JAX trainer's window: steps start + 3 .. start + 8
                    if step == self.start_step + 3:
                        self._start_profile()
                    elif step == self.start_step + 9:
                        self._stop_profile()
                batch = self._encode(self._to_device(next(batches)), step)
                metrics = self._train_step(self.state, batch, step)
                if step % 50 == 0 or step == args.n_steps or step == self.start_step + 1:
                    metrics = self._data_mean(metrics)  # waits for the device
                    dt = time.time() - t_last
                    t_last = time.time()
                    # the steps since the previous log (the first log includes set-up)
                    metrics["steps_per_sec"] = (step - last_logged) / max(dt, 1e-9)
                    last_logged = step
                    self.logger.log_scalars(step, metrics)
                    logs.append({"step": step, **metrics})
                    if self.grid.is_main:
                        print(f"step {step:>7} | {metrics}", flush=True)
                if args.log_every_n_steps is not None and (
                        step % args.log_every_n_steps == 0 or step == args.n_steps):
                    self._log_samples(step)
                if (args.save_every_n_steps and step % args.save_every_n_steps == 0
                        or step == args.n_steps):
                    self._save(step, new_checkpoint=False)
                if (args.save_new_every_n_steps is not None
                        and step % args.save_new_every_n_steps == 0):
                    self._save(step, new_checkpoint=True)
                if self._agreed_preempted():
                    if step % (args.save_every_n_steps or step + 1) != 0 and step != args.n_steps:
                        self._save(step, new_checkpoint=False)
                    print(f"preempted: saved checkpoint at step {step}, exiting cleanly "
                          "(resume with --resume)")
                    break
        finally:
            self._stop_profile()

    def _data_mean(self, metrics: dict) -> dict:
        """The step's metrics as floats, averaged over the data group (each
        data rank's loss is the mean over its rows)."""
        names = list(metrics)
        values = torch.stack([metrics[k].float().reshape(()) for k in names])
        self.grid.data_mean_([values])
        return dict(zip(names, values.tolist()))

    def _agreed_preempted(self) -> bool:
        """Whether any rank saw SIGTERM, agreed over the grid, so that every
        rank saves and stops at the same step."""
        return self.grid.any_on_host(self._preempted)

    def _start_profile(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        if not self.grid.is_main:
            return
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._profiler = profile(activities=activities)
        self._profiler.start()

    def _stop_profile(self) -> None:
        """End the profile window, if one is open, and write its trace to
        ``<log_path>/<exp_name>/profile/trace.json``."""
        if self._profiler is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof, self._profiler = self._profiler, None
        prof.stop()
        out = self.log_path / "profile"
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / "trace.json"))
        print(f"profile trace written to {out}")

    @torch.no_grad()
    def _log_samples(self, step: int) -> None:
        """Sample ``--n_samples`` images of ``--sample_height`` x
        ``--sample_width`` from seed ``--sample_seed`` (:func:`sample_rows`),
        with the EMA weights when an EMA is kept (under FSDP the chunks,
        then gathered whole for the sampling), and write
        ``sample_stats_step{step}.npy`` (T, 2), for an early-exit model
        ``sample_classifier_outputs_step{step}.npy`` (T, depth, n_samples),
        their means as scalars, and ``samples_step{step}.png``, the grid."""
        args, model = self.args, self.model
        cfg = self.model_config
        shape = (args.n_samples, args.sample_height, args.sample_width, cfg.in_chans)
        cpu = torch.Generator().manual_seed(args.sample_seed)
        y = None
        if self.has_labels and cfg.num_classes > 0:
            y = torch.randint(0, cfg.num_classes, (args.n_samples,), generator=cpu)
            y = y.to(self.device)
        generator = torch.Generator(device=self.device).manual_seed(args.sample_seed)
        x = torch.randn(shape, generator=generator, device=self.device, dtype=torch.float32)
        live = None
        if self.state.ema is not None:  # sample from the EMA weights, then put the live ones back
            live = {n: p.detach().clone() for n, p in model.named_parameters()}
            for n, p in model.named_parameters():
                p.copy_(self.state.ema[n])
        model.eval()
        try:
            with fsdp.full_params(model):
                model.pack_for_kernels()
                # eager under --model_parallel: its all-reduces go through the host
                x, probe_rows, stat_rows = sample_rows(
                    model, self.schedule, x, generator, y,
                    graphs=self.use_graphs and self.grid.model == 1)
        finally:
            if live is not None:
                for n, p in model.named_parameters():
                    p.copy_(live[n])
            model.train()
        if not self.grid.is_main:
            return
        scalars = {}
        if probe_rows is not None:
            probe_rows = probe_rows.float().cpu().numpy()
            np.save(self.log_path / f"sample_classifier_outputs_step{step}.npy", probe_rows)
            scalars["sample_mean_probe_error"] = float(probe_rows.mean())
        stat_rows = stat_rows.float().cpu().numpy()
        np.save(self.log_path / f"sample_stats_step{step}.npy", stat_rows)
        scalars["sample_model_output_mean"] = float(stat_rows[:, 0].mean())
        scalars["sample_model_output_std"] = float(stat_rows[:, 1].mean())
        self.logger.log_scalars(step, scalars)
        save_image(make_grid((x.float().cpu().numpy() + 1.0) / 2.0),
                   self.log_path / f"samples_step{step}.png")
        print(f"step {step:>7} | samples: {scalars}", flush=True)

    def _from_saved(self, state: dict) -> dict:
        """A saved state dict (reference names) -> the model's names."""
        if self.early_exit:
            return early_exit_state_dict_from_reference(state, self.model_config)
        return state

    def _to_saved(self, state: dict) -> dict:
        """The model's names -> the reference's, which the checkpoint holds."""
        if self.early_exit:
            return early_exit_state_dict_to_reference(state, self.model_config)
        return state

    def _save(self, step: int, new_checkpoint: bool):
        """Rank 0 writes the full state, gathered from the shards first (also
        before an asynchronous write's thread starts); every rank then waits
        at a barrier. Returns the checkpoint's directory on rank 0."""
        grid, shapes = self.grid, self.fsdp_shapes
        optimizer = self.state.optimizer.state_dict()
        for key in ("mu", "nu", "acc_grads"):
            if key in optimizer:
                optimizer[key] = gather_state_dict(optimizer[key], grid, shapes)
        model = gather_state_dict(self.model.state_dict(), grid, shapes)
        ema = None if self.state.ema is None else self._to_saved(
            gather_state_dict(self.state.ema, grid, shapes))
        path = None
        if grid.is_main:
            path = self.checkpointer.save(
                step=step, model_state=self._to_saved(model), optimizer_state=optimizer,
                ema_state=ema, sampler_state=self.dataloader.get_state(), args=vars(self.args),
                new_checkpoint=new_checkpoint,
            )
        grid.barrier()
        return path
