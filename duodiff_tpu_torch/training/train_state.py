"""Optimizer, train state and train step (counterpart of
``duodiff_tpu/training/train_state.py``).

The JAX package's optax chain, global-norm clipping then AdamW on the
cosine-warmup schedule, written out in plain PyTorch with the same order of
operations, plus the optional EMA shadow of the parameters. Every update
stays on the device: clipping scales by a device scalar, so a step never
waits for the host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
from duodiff_tpu_torch.training.losses import uvit_loss
from duodiff_tpu_torch.training.lr import cosine_schedule_with_warmup


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


class AdamW:
    """``optax.chain(clip_by_global_norm(max_grad_norm), adamw(lr_schedule,
    b1, b2, eps=1e-8, weight_decay))`` over named parameters, updated in
    place. Weight decay applies to every parameter (optax's default mask),
    and the learning rate of the n-th update is ``lr_schedule(n - 1)``."""

    EPS = 1e-8  # optax.adamw's default

    def __init__(self, params: dict, *, lr_schedule: Callable[[int], float], beta1: float,
                 beta2: float, weight_decay: float, max_grad_norm: float):
        self.names = list(params)
        self.params = [params[n] for n in self.names]
        self.lr_schedule = lr_schedule
        self.beta1, self.beta2 = beta1, beta2
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: list) -> torch.Tensor:
        """Clip ``grads`` (in place) to the global norm, then one AdamW update;
        returns the global norm before clipping."""
        g_norm = global_norm(grads)
        # optax.clip_by_global_norm: g if |g| < max, else g / |g| * max
        factor = torch.where(g_norm < self.max_grad_norm, torch.ones_like(g_norm),
                             self.max_grad_norm / g_norm)
        torch._foreach_mul_(grads, factor)
        self.count += 1
        b1, b2 = self.beta1, self.beta2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        mu_hat = torch._foreach_div(self.mu, 1.0 - b1 ** self.count)
        denom = torch._foreach_div(self.nu, 1.0 - b2 ** self.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.EPS)
        update = torch._foreach_div(mu_hat, denom)
        torch._foreach_add_(update, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, update, alpha=-self.lr_schedule(self.count - 1))
        return g_norm

    def state_dict(self) -> dict:
        return {"count": self.count,
                "mu": dict(zip(self.names, self.mu)), "nu": dict(zip(self.names, self.nu))}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Strict: the moments must name exactly this optimizer's parameters."""
        for key in ("mu", "nu"):
            if set(state[key]) != set(self.names):
                raise KeyError(f"optimizer state {key!r} names other parameters "
                               f"than the model's: {sorted(set(state[key]) ^ set(self.names))}")
        self.count = int(state["count"])
        for dst, key in ((self.mu, "mu"), (self.nu, "nu")):
            for t, name in zip(dst, self.names):
                t.copy_(state[key][name])


def make_optimizer(params: dict, *, lr: float, weight_decay: float, beta1: float, beta2: float,
                   max_grad_norm: float, num_warmup_steps: int,
                   num_training_steps: int) -> AdamW:
    """AdamW with global-norm clipping on the cosine-warmup schedule."""
    return AdamW(params,
                 lr_schedule=cosine_schedule_with_warmup(lr, num_warmup_steps, num_training_steps),
                 beta1=beta1, beta2=beta2, weight_decay=weight_decay, max_grad_norm=max_grad_norm)


@dataclasses.dataclass
class TrainState:
    """The model (whose parameters are the live params), its optimizer, and
    the EMA shadow of the parameters (None when ``ema_decay`` is 0)."""

    model: nn.Module
    optimizer: AdamW
    ema: Optional[dict] = None
    ema_decay: float = 0.0

    @classmethod
    def create(cls, model: nn.Module, optimizer: AdamW, ema_decay: float = 0.0) -> "TrainState":
        ema = None
        if ema_decay > 0.0:
            ema = {n: p.detach().clone() for n, p in model.named_parameters()}
        return cls(model, optimizer, ema, ema_decay)

    @torch.no_grad()
    def update_ema(self) -> None:
        if self.ema is None:
            return
        d = self.ema_decay
        shadow = [self.ema[n] for n in self.optimizer.names]
        torch._foreach_mul_(shadow, d)
        torch._foreach_add_(shadow, self.optimizer.params, alpha=1.0 - d)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one step's draws, a function of (seed, step) only,
    so a resumed run draws what an unbroken one would."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def make_train_step(model: nn.Module, schedule: NoiseSchedule, *, parametrization: str,
                    seed: int, has_labels: bool = False, teacher: Optional[nn.Module] = None,
                    distill_alpha: float = 1.0, t_min: int = 0):
    """Build ``train_step(state, batch, step) -> metrics``.

    A step draws uniform timesteps in [t_min, steps) and the noise from
    :func:`step_generator`, noises the batch with q(x_t | x_0), runs the
    model, takes the parametrization's loss, backpropagates and updates.
    ``batch`` holds "image" (B, H, W, C) float and "label" (B,) on the
    model's device.

    Distillation: with a ``teacher`` (in eval mode, operands packed) the
    loss is ``alpha * MSE(student, teacher) + (1 - alpha) * task``, the
    teacher run under no grad. ``train_step.loss_fn(batch, timesteps,
    noise)`` returns (loss, metrics) for injected draws.
    """
    params = list(model.parameters())

    def draws(batch, step: int):
        clean = batch["image"]
        g = step_generator(seed, step, clean.device)
        timesteps = torch.randint(t_min, schedule.steps, (clean.shape[0],), generator=g,
                                  device=clean.device)
        noise = torch.randn(clean.shape, generator=g, device=clean.device, dtype=torch.float32)
        return timesteps, noise

    def loss_fn(batch, timesteps, noise):
        clean = batch["image"].float()
        labels = batch.get("label") if has_labels else None
        noisy = schedule.add_noise(clean, timesteps, noise)
        t = timesteps.float()
        pred = model(noisy, t, labels)
        loss = uvit_loss(pred, parametrization=parametrization, noise=noise, clean=clean,
                         noisy=noisy, timesteps=timesteps, schedule=schedule)
        metrics = {"train_loss": loss}
        if teacher is not None:
            with torch.no_grad():
                teacher_out = teacher(noisy, t, labels).float()
            distill = (pred.float() - teacher_out).square().mean()
            task = loss
            loss = distill_alpha * distill + (1.0 - distill_alpha) * task
            metrics = {"train_loss": loss, "distill_loss": distill, "task_loss": task}
        return loss, metrics

    def backward(batch, timesteps, noise) -> tuple[dict, list]:
        """Loss and gradients (fp32, one per parameter) for injected draws."""
        model.train()
        for p in params:
            p.grad = None
        loss, metrics = loss_fn(batch, timesteps, noise)
        loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        return metrics, grads

    def train_step(state: TrainState, batch, step: int, timesteps=None, noise=None) -> dict:
        if timesteps is None:
            timesteps, noise = draws(batch, step)
        metrics, grads = backward(batch, timesteps, noise)
        metrics["grad_norm"] = state.optimizer.step(grads)
        state.update_ema()
        return {k: v.detach() for k, v in metrics.items()}

    train_step.loss_fn = loss_fn
    train_step.backward = backward
    train_step.draws = draws
    return train_step
