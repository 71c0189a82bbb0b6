"""Optimizer, train state and train step (counterpart of
``duodiff_tpu/training/train_state.py``).

The JAX package's optax chain, global-norm clipping then AdamW on the
cosine-warmup schedule, written out in plain PyTorch with the same order of
operations, plus the optional EMA shadow of the parameters, gradient
accumulation (``optax.MultiSteps``) and the skipping of non-finite updates
(``optax.apply_if_finite``). Every update stays on the device: clipping
scales by a device scalar and the finite check selects on a device flag, so
a step never waits for the host.
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


def tensor_norms(tensors) -> tuple[torch.Tensor, torch.Tensor]:
    """Each tensor's 2-norm, stacked, and the norm of those: the sqrt of the
    sum of squares of every element (optax.global_norm)."""
    norms = torch.stack(torch._foreach_norm(list(tensors)))
    return norms, torch.linalg.vector_norm(norms)


class AdamW:
    """``optax.chain(clip_by_global_norm(max_grad_norm), adamw(lr_schedule,
    b1, b2, eps=1e-8, weight_decay))`` over named parameters, updated in
    place. Weight decay applies to every parameter (optax's default mask),
    and the learning rate of the n-th update is ``lr_schedule(n - 1)``.

    ``grad_accum = k > 1`` is ``optax.MultiSteps(every_k_schedule=k)`` around
    it: :meth:`step` folds each data step's gradients into a running fp32
    mean (``acc + (g - acc) / (n + 1)``, optax's), and only every k-th call
    clips that mean and updates; in between the parameters do not move, and
    ``count``, the learning-rate position, advances once per k.

    ``skip_nonfinite = n > 0`` is ``optax.apply_if_finite(...,
    max_consecutive_errors=n)`` inside that: an update whose gradients hold
    an inf or a NaN leaves parameters, moments and ``count`` untouched, until
    more than n updates in a row were bad, from when on it is applied as it
    is. The decision is a device flag (every tensor's norm is finite) that
    selects between the old and the new value of each tensor, so nothing
    waits for the host; ``count`` and optax's three counters
    (``notfinite_count``, ``total_notfinite``, ``last_finite``) then live on
    the device. With both, a bad data step makes its window's mean
    non-finite and the window's update is the one skipped; the mean starts
    again from zero with the next window."""

    EPS = 1e-8  # optax.adamw's default

    def __init__(self, params: dict, *, lr_schedule: Callable[[int], float], beta1: float,
                 beta2: float, weight_decay: float, max_grad_norm: float,
                 skip_nonfinite: int = 0, grad_accum: int = 1):
        if grad_accum < 1 or skip_nonfinite < 0:
            raise ValueError(f"grad_accum must be >= 1 and skip_nonfinite >= 0, got "
                             f"{grad_accum} and {skip_nonfinite}")
        self.names = list(params)
        self.params = [params[n] for n in self.names]
        self.lr_schedule = lr_schedule
        self.beta1, self.beta2 = beta1, beta2
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.skip_nonfinite = skip_nonfinite
        self.grad_accum = grad_accum
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self._count = 0
        self.mini_step = 0
        self.acc_grads = ([torch.zeros_like(p, dtype=torch.float32) for p in self.params]
                          if grad_accum > 1 else None)
        if skip_nonfinite:
            device = self.params[0].device
            self._count = torch.zeros((), dtype=torch.int64, device=device)
            self.notfinite_count = torch.zeros((), dtype=torch.int64, device=device)
            self.total_notfinite = torch.zeros((), dtype=torch.int64, device=device)
            self.last_finite = torch.ones((), dtype=torch.bool, device=device)

    @property
    def count(self) -> int:
        """Updates applied so far (reads the device when ``skip_nonfinite``)."""
        return int(self._count)

    @count.setter
    def count(self, value: int) -> None:
        if self.skip_nonfinite:
            self._count.fill_(int(value))
        else:
            self._count = int(value)

    @torch.no_grad()
    def step(self, grads: list) -> torch.Tensor:
        """One data step: returns the global norm of ``grads`` before any
        clipping. Without accumulation it clips ``grads`` (in place) and
        updates; with it, it folds them into the running mean and updates
        from the mean on every ``grad_accum``-th call."""
        norms, g_norm = tensor_norms(grads)
        if self.grad_accum == 1:
            self._update(grads, norms, g_norm)
            return g_norm
        diff = torch._foreach_sub(grads, self.acc_grads)
        torch._foreach_div_(diff, float(self.mini_step + 1))
        torch._foreach_add_(self.acc_grads, diff)
        self.mini_step = (self.mini_step + 1) % self.grad_accum
        if self.mini_step == 0:
            self._update(self.acc_grads, *tensor_norms(self.acc_grads))
            torch._foreach_zero_(self.acc_grads)
        return g_norm

    def _update(self, grads: list, norms: torch.Tensor, g_norm: torch.Tensor) -> None:
        """Clip ``grads`` (in place) to the global norm ``g_norm``, then one
        AdamW update, skipped on the device if it is to be."""
        # optax.clip_by_global_norm: g if |g| < max, else g / |g| * max
        factor = torch.where(g_norm < self.max_grad_norm, torch.ones_like(g_norm),
                             self.max_grad_norm / g_norm)
        torch._foreach_mul_(grads, factor)
        if self.skip_nonfinite:
            self._update_if_finite(grads, torch.isfinite(norms).all())
            return
        self._count += 1
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

    def _update_if_finite(self, grads: list, finite: torch.Tensor) -> None:
        """The same update computed beside the state, then taken or dropped
        tensor by tensor on ``finite`` (a device bool) and the run of bad
        updates so far, as optax.apply_if_finite does."""
        bad_run = torch.where(finite, torch.zeros_like(self.notfinite_count),
                              self.notfinite_count + 1)
        ok = finite | (bad_run > self.skip_nonfinite)
        self.notfinite_count = bad_run
        self.total_notfinite = self.total_notfinite + (~finite)
        self.last_finite = finite
        count = self._count + 1
        b1, b2 = self.beta1, self.beta2
        mu = torch._foreach_mul(self.mu, b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        nu = torch._foreach_mul(self.nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
        mu_hat = torch._foreach_div(mu, (1.0 - b1 ** count.double()).float())
        denom = torch._foreach_div(nu, (1.0 - b2 ** count.double()).float())
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.EPS)
        update = torch._foreach_div(mu_hat, denom)
        torch._foreach_add_(update, self.params, alpha=self.weight_decay)
        torch._foreach_mul_(update, (-self.lr_schedule(count - 1)).float())
        new_params = torch._foreach_add(self.params, update)
        for old, new in ((self.mu, mu), (self.nu, nu), (self.params, new_params)):
            for t, n in zip(old, new):
                t.copy_(torch.where(ok, n, t))
        self._count = torch.where(ok, count, self._count)

    def state_dict(self) -> dict:
        state = {"count": self.count,
                 "mu": dict(zip(self.names, self.mu)), "nu": dict(zip(self.names, self.nu))}
        if self.grad_accum > 1:
            state["mini_step"] = self.mini_step
            state["acc_grads"] = dict(zip(self.names, self.acc_grads))
        if self.skip_nonfinite:
            state["notfinite_count"] = int(self.notfinite_count)
            state["total_notfinite"] = int(self.total_notfinite)
            state["last_finite"] = bool(self.last_finite)
        return state

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Strict: the moments must name exactly this optimizer's parameters.
        The accumulation window (``mini_step``, ``acc_grads``) and the
        non-finite counters are restored where the state holds them, so a
        run saved in the middle of a window continues it; a state without
        them starts a new window with the counters at zero."""
        tensors = [(self.mu, "mu"), (self.nu, "nu")]
        if self.grad_accum > 1 and "acc_grads" in state:
            if not 0 <= int(state["mini_step"]) < self.grad_accum:
                raise ValueError(f"the state was saved at mini-step {state['mini_step']} of a "
                                 f"window; this optimizer accumulates {self.grad_accum}")
            tensors.append((self.acc_grads, "acc_grads"))
        for _, key in tensors:
            if set(state[key]) != set(self.names):
                raise KeyError(f"optimizer state {key!r} names other parameters "
                               f"than the model's: {sorted(set(state[key]) ^ set(self.names))}")
        self.count = int(state["count"])
        for dst, key in tensors:
            for t, name in zip(dst, self.names):
                t.copy_(state[key][name])
        if self.grad_accum > 1:
            self.mini_step = int(state.get("mini_step", 0))
            if "acc_grads" not in state:
                torch._foreach_zero_(self.acc_grads)
        if self.skip_nonfinite:
            self.notfinite_count.fill_(int(state.get("notfinite_count", 0)))
            self.total_notfinite.fill_(int(state.get("total_notfinite", 0)))
            self.last_finite.fill_(bool(state.get("last_finite", True)))


def make_optimizer(params: dict, *, lr: float, weight_decay: float, beta1: float, beta2: float,
                   max_grad_norm: float, num_warmup_steps: int, num_training_steps: int,
                   skip_nonfinite: int = 0, grad_accum: int = 1) -> AdamW:
    """AdamW with global-norm clipping on the cosine-warmup schedule.
    ``num_warmup_steps`` and ``num_training_steps`` count optimizer updates:
    with ``grad_accum`` the caller divides its data steps by it."""
    return AdamW(params,
                 lr_schedule=cosine_schedule_with_warmup(lr, num_warmup_steps, num_training_steps),
                 beta1=beta1, beta2=beta2, weight_decay=weight_decay, max_grad_norm=max_grad_norm,
                 skip_nonfinite=skip_nonfinite, grad_accum=grad_accum)


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


_LABEL_DROP_STREAM = 0x1ABE1  # the JAX package's fold_in constant for the drop draw


def step_generator(seed: int, step: int, device, stream: int = 0) -> torch.Generator:
    """The generator of one step's draws, a function of (seed, step) only,
    so a resumed run draws what an unbroken one would. ``stream`` gives a
    second, independent generator for the same step."""
    entropy = [seed, step] + ([stream] if stream else [])
    state = np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def make_train_step(model: nn.Module, schedule: NoiseSchedule, *, parametrization: str,
                    seed: int, has_labels: bool = False, teacher: Optional[nn.Module] = None,
                    distill_alpha: float = 1.0, t_min: int = 0, label_dropout: float = 0.0,
                    null_label: Optional[int] = None):
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

    Classifier-free-guidance training: with ``label_dropout`` > 0 a
    Bernoulli(label_dropout) mask per sample replaces labels by
    ``null_label``. The mask comes from a generator of its own
    (:func:`drop_mask`), so the timesteps and the noise are those of a
    ``label_dropout=0`` run to the bit. ``loss_fn(..., drop=mask)`` injects it.
    """
    params = list(model.parameters())
    if label_dropout > 0.0 and (not has_labels or null_label is None):
        raise ValueError("label_dropout needs labels and a null_label")

    def draws(batch, step: int):
        clean = batch["image"]
        g = step_generator(seed, step, clean.device)
        timesteps = torch.randint(t_min, schedule.steps, (clean.shape[0],), generator=g,
                                  device=clean.device)
        noise = torch.randn(clean.shape, generator=g, device=clean.device, dtype=torch.float32)
        return timesteps, noise

    def drop_mask(batch, step: int):
        """The step's label-drop mask (B,) bool, or None without label_dropout."""
        if label_dropout <= 0.0:
            return None
        clean = batch["image"]
        g = step_generator(seed, step, clean.device, _LABEL_DROP_STREAM)
        return torch.rand((clean.shape[0],), generator=g, device=clean.device) < label_dropout

    def loss_fn(batch, timesteps, noise, drop=None):
        clean = batch["image"].float()
        labels = batch.get("label") if has_labels else None
        if drop is not None:
            labels = torch.where(drop, torch.full_like(labels, null_label), labels)
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

    def backward(batch, timesteps, noise, drop=None) -> tuple[dict, list]:
        """Loss and gradients (fp32, one per parameter) for injected draws."""
        model.train()
        for p in params:
            p.grad = None
        loss, metrics = loss_fn(batch, timesteps, noise, drop)
        loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        return metrics, grads

    def train_step(state: TrainState, batch, step: int, timesteps=None, noise=None,
                   drop=None) -> dict:
        if timesteps is None:
            timesteps, noise = draws(batch, step)
            drop = drop_mask(batch, step)
        metrics, grads = backward(batch, timesteps, noise, drop)
        metrics["grad_norm"] = state.optimizer.step(grads)
        state.update_ema()
        return {k: v.detach() for k, v in metrics.items()}

    train_step.loss_fn = loss_fn
    train_step.backward = backward
    train_step.draws = draws
    train_step.drop_mask = drop_mask
    return train_step
