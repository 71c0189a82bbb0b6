"""Training orchestration on one device (counterpart of
``duodiff_tpu/training/trainer.py``).

``Trainer(args).train()`` with ``main.py``'s flag surface: the model (the
fused K1/K2 forward and K6/K7 backward kernels on CUDA by default, the
plain PyTorch sublayers on the CPU, or the unfused block around the
attention kernels K9/K10 with ``--attn_impl pallas``), an optional
distillation teacher, the CIFAR-10 or cached ImageNet-64 loader,
classifier-free-guidance label dropout, AdamW with clipping and the cosine-warmup schedule, an
optional EMA, gradient accumulation (``--grad_accum``), skipping of
non-finite updates (``--skip_nonfinite``), activation checkpointing
(``--use_checkpoint``), checkpoints with exact resume, also in the middle of
an accumulation window, and a SIGTERM checkpoint-and-exit. Flags whose machinery is not ported are refused
(:func:`refuse_unported`).
"""

from __future__ import annotations

import signal
import threading
import time
from pathlib import Path

import torch

from duodiff_tpu_torch.config import UViTConfig
from duodiff_tpu_torch.data.datasets import get_dataloader
from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
from duodiff_tpu_torch.models.uvit import init_uvit
from duodiff_tpu_torch.training.checkpointer import Checkpointer
from duodiff_tpu_torch.training.train_state import TrainState, make_optimizer, make_train_step
from duodiff_tpu_torch.utils.model_loading import load_model
from duodiff_tpu_torch.utils.train_utils import MetricsLogger

# flag -> (is it set?, what it needs): refused until that machinery is ported
_UNPORTED = {
    "model": (lambda v: v != "uvit", "early-exit training (deediff_uvit; ROADMAP item 7)"),
    "load_backbone": (bool, "early-exit backbone loading (ROADMAP item 7)"),
    "freeze_backbone": (bool, "early-exit backbone freezing (ROADMAP item 7)"),
    "log_every_n_steps": (lambda v: v is not None, "in-training sampling and image logging"),
    "async_checkpoint": (bool, "asynchronous checkpoints"),
    "profile": (bool, "the profiler hook"),
    "fsdp": (bool, "multi-GPU parameter sharding"),
    "model_parallel": (lambda v: (v or 1) > 1, "multi-GPU tensor parallelism"),
    "multihost": (bool, "multi-host training"),
}


def refuse_unported(args) -> None:
    """Raise ValueError for any flag whose machinery is not ported yet."""
    for flag, (is_set, needs) in _UNPORTED.items():
        value = getattr(args, flag, None)
        if value is not None and is_set(value):
            raise ValueError(f"--{flag} {value!r} needs {needs}, which is not ported yet")


class Trainer:
    def __init__(self, args):
        refuse_unported(args)
        self.args = args
        self.device = torch.device(args.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise SystemExit(f"--device {args.device}: no CUDA device is available")
        self.log_path = Path(args.log_path) / args.exp_name
        self.log_path.mkdir(parents=True, exist_ok=True)
        self.compute_dtype = (
            torch.bfloat16 if args.use_amp and args.amp_dtype == "bfloat16" else torch.float32
        )
        self.model_config = UViTConfig.from_dict(vars(args))
        self.schedule = NoiseSchedule.create(steps=args.num_timesteps, device=self.device)
        self.attn_impl = args.attn_impl
        if self.attn_impl in (None, "auto"):
            self.attn_impl = "fused" if self.device.type == "cuda" else "plain"
        self.gelu_approx = args.gelu == "tanh"

        self._init_model()
        self._init_teacher()
        self.dataloader = get_dataloader(args.dataset, args.batch_size, args.seed,
                                         args.data_path)
        # labels feed the model for ImageNet and for any class-conditional model
        self.has_labels = "imagenet" in args.dataset or self.model_config.num_classes > 0
        grad_accum = getattr(args, "grad_accum", 1) or 1
        if grad_accum > 1 and args.n_steps % grad_accum:
            raise ValueError(f"--n_steps {args.n_steps} must be a multiple of "
                             f"--grad_accum {grad_accum}")
        optimizer = make_optimizer(
            dict(self.model.named_parameters()), lr=args.lr, weight_decay=args.weight_decay,
            beta1=args.beta1, beta2=args.beta2, max_grad_norm=args.max_grad_norm,
            # schedule positions count optimizer updates, not data steps
            num_warmup_steps=args.num_warmup_steps,
            num_training_steps=max(args.n_steps // grad_accum, 1),
            skip_nonfinite=getattr(args, "skip_nonfinite", 0) or 0, grad_accum=grad_accum,
        )
        self.state = TrainState.create(self.model, optimizer, ema_decay=args.ema_decay or 0.0)
        self.checkpointer = Checkpointer(args.log_path, args.exp_name,
                                         save_name=args.save_checkpoint_path,
                                         dataset=args.dataset, model=args.model)
        self.logger = MetricsLogger(self.log_path)
        self.logger.log_hparams(vars(args))
        self.start_step = 0
        self._maybe_resume()
        label_dropout = getattr(args, "label_dropout", 0.0) or 0.0
        self._train_step = make_train_step(
            self.model, self.schedule, parametrization=args.parametrization, seed=args.seed,
            has_labels=self.has_labels, teacher=self.teacher,
            distill_alpha=args.distill_alpha, t_min=args.distill_t_min or 0,
            label_dropout=label_dropout, null_label=self._null_label(label_dropout),
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

    def _init_model(self):
        print(f"Training on {self.device} (attn_impl={self.attn_impl}, "
              f"dtype={self.compute_dtype})")
        self.model = init_uvit(
            self.model_config, device=self.device, dtype=self.compute_dtype,
            generator=torch.Generator().manual_seed(self.args.seed),
            attn_impl=self.attn_impl, gelu_approx=self.gelu_approx,
            use_checkpoint=bool(getattr(self.args, "use_checkpoint", False)),
        )
        self.model.train()

    def _init_teacher(self):
        """Optional distillation teacher: a frozen model in eval mode, its
        operands packed for the forward kernels."""
        args = self.args
        self.teacher = None
        if not args.distill_config:
            return
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

    def _maybe_resume(self):
        args = self.args
        path = args.load_checkpoint_path
        if path is None and args.resume:
            path = self.checkpointer.last_checkpoint()
        if path is None:
            return
        print(f"Loading training state from {path}")
        restored = Checkpointer.restore(path)
        self.model.load_state_dict(restored["model_state_dict"], strict=True)
        self.state.optimizer.load_state_dict(restored["optimizer"])
        if self.state.ema is not None:
            ema = restored.get("ema_state_dict")
            if ema is None:
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
        """Release the logger's file and the loader's threads. Idempotent."""
        self.logger.close()
        self.dataloader.close()

    def _to_device(self, batch: dict) -> dict:
        return {"image": torch.from_numpy(batch["image"]).to(self.device),
                "label": torch.from_numpy(batch["label"]).long().to(self.device)}

    def _run_steps(self, batches, logs: list) -> None:
        args = self.args
        t_last, last_logged = time.time(), self.start_step
        for step in range(self.start_step + 1, args.n_steps + 1):
            batch = self._to_device(next(batches))
            metrics = self._train_step(self.state, batch, step)
            if step % 50 == 0 or step == args.n_steps or step == self.start_step + 1:
                metrics = {k: float(v) for k, v in metrics.items()}  # waits for the device
                dt = time.time() - t_last
                t_last = time.time()
                # the steps since the previous log (the first log includes set-up)
                metrics["steps_per_sec"] = (step - last_logged) / max(dt, 1e-9)
                last_logged = step
                self.logger.log_scalars(step, metrics)
                logs.append({"step": step, **metrics})
                print(f"step {step:>7} | {metrics}", flush=True)
            if (args.save_every_n_steps and step % args.save_every_n_steps == 0
                    or step == args.n_steps):
                self._save(step, new_checkpoint=False)
            if args.save_new_every_n_steps is not None and step % args.save_new_every_n_steps == 0:
                self._save(step, new_checkpoint=True)
            if self._preempted:
                if step % (args.save_every_n_steps or step + 1) != 0 and step != args.n_steps:
                    self._save(step, new_checkpoint=False)
                print(f"preempted: saved checkpoint at step {step}, exiting cleanly "
                      "(resume with --resume)")
                break

    def _save(self, step: int, new_checkpoint: bool) -> Path:
        return self.checkpointer.save(
            step=step, model_state=self.model.state_dict(),
            optimizer_state=self.state.optimizer.state_dict(), ema_state=self.state.ema,
            sampler_state=self.dataloader.get_state(), args=vars(self.args),
            new_checkpoint=new_checkpoint,
        )
