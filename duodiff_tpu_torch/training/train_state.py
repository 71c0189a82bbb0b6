"""Optimizer, train state and train step (counterpart of
``duodiff_tpu/training/train_state.py``).

The JAX package's optax chain, global-norm clipping then AdamW on the
cosine-warmup schedule, written out in plain PyTorch with the same order of
operations, plus the optional EMA shadow of the parameters, gradient
accumulation (``optax.MultiSteps``) and the skipping of non-finite updates
(``optax.apply_if_finite``). Every update stays on the device: clipping
scales by a device scalar and the finite check selects on a device flag, so
a step never waits for the host.

An optimizer over a subset of the model's parameters is the JAX package's
``optax.multi_transform`` with ``set_to_zero`` on the rest (``--freeze_backbone``):
clipping, AdamW, accumulation and the finite check see the subset's
gradients only, the rest never move, and the logged ``grad_norm`` is still
the norm of every gradient.

On a process grid (``parallel/mesh.py``) the gradients are averaged over the
data group after the backward, as one flat all-reduce that overlaps nothing
(no DDP buckets); under FSDP (``parallel/fsdp.py``) a sharded leaf's
gradient arrives averaged already, the rank's chunk of it (the unit's
reduce-scatter in the backward), and only the rest are all-reduced. The
global norm sums the squares of a tensor-parallel shard's gradients over the
model group, an FSDP chunk's over the data group (a leaf cut both ways: over
both), and a replicated one's once; the finite flag of ``skip_nonfinite`` is
agreed over every rank; AdamW, the accumulation and the EMA stay local to
the shard or chunk. A step draws the global batch's timesteps and noise and
keeps its rows, so it computes what one process computes for them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from duodiff_tpu_torch.diffusion.graphs import StepGraphs
from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
from duodiff_tpu_torch.training.losses import deediff_loss, total_deediff_loss, uvit_loss
from duodiff_tpu_torch.training.lr import cosine_schedule_with_warmup
from duodiff_tpu_torch.utils.convert import shard_kind


def tensor_norms(tensors) -> tuple[torch.Tensor, torch.Tensor]:
    """Each tensor's 2-norm, stacked, and the norm of those: the sqrt of the
    sum of squares of every element (optax.global_norm)."""
    norms = torch.stack(torch._foreach_norm(list(tensors)))
    return norms, torch.linalg.vector_norm(norms)


def grid_norms(tensors, names, grid=None, fsdp=frozenset()) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`tensor_norms` of a model the grid shards: a tensor-parallel
    shard's squares are summed over the model group, an FSDP chunk's (the
    names in ``fsdp``) over the data group, a leaf cut both ways over both
    (two all-reduces of two numbers), a replicated tensor's counted once.
    The first result is each local tensor's norm, in order."""
    tensors = list(tensors)
    tp = [grid is not None and grid.model > 1 and shard_kind(n) is not None for n in names]
    fs = [n in fsdp for n in names]
    if not any(tp) and not any(fs):
        return tensor_norms(tensors)
    each = torch._foreach_norm(tensors)
    zero = torch.zeros((), dtype=each[0].dtype, device=each[0].device)

    def part(t_cut: bool, f_cut: bool) -> torch.Tensor:
        picked = [n for n, a, b in zip(each, tp, fs) if a == t_cut and b == f_cut]
        return torch.stack(picked).square().sum() if picked else zero

    by_data = grid.data_sum_(torch.stack([part(False, True), part(True, True)]))
    by_model = grid.model_sum_(torch.stack([part(True, False), by_data[1]]))
    return torch.stack(each), (part(False, False) + by_data[0] + by_model.sum()).sqrt()


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
    waits for the host; optax's three counters (``notfinite_count``,
    ``total_notfinite``, ``last_finite``) live on the device. With both, a
    bad data step makes its window's mean
    non-finite and the window's update is the one skipped; the mean starts
    again from zero with the next window.

    ``grid``: clip to the global norm over the grid's shards
    (:func:`grid_norms`, with ``fsdp`` the names of the FSDP chunks) and
    take the finite flag agreed over every rank.

    Every tensor of the state lives on the device and is written in place:
    ``count`` (the learning-rate position and the bias corrections read
    it there), the window position that divides the running mean, the
    moments, the mean and the counters. So a CUDA graph of a step replays
    what the eager step computes; only the host's copy of the window
    position (:attr:`update_due`) picks which graph."""

    EPS = 1e-8  # optax.adamw's default

    def __init__(self, params: dict, *, lr_schedule: Callable[[int], float], beta1: float,
                 beta2: float, weight_decay: float, max_grad_norm: float,
                 skip_nonfinite: int = 0, grad_accum: int = 1, grid=None,
                 fsdp=frozenset()):
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
        self.grid = grid
        self.fsdp = fsdp
        device = self.params[0].device
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self._count = torch.zeros((), dtype=torch.int64, device=device)
        self.mini_step = 0  # the host's copy of the window position: it picks the step's kind
        self.acc_grads = None
        if grad_accum > 1:
            self.acc_grads = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
            self._mini = torch.zeros((), dtype=torch.int64, device=device)
        if skip_nonfinite:
            self.notfinite_count = torch.zeros((), dtype=torch.int64, device=device)
            self.total_notfinite = torch.zeros((), dtype=torch.int64, device=device)
            self.last_finite = torch.ones((), dtype=torch.bool, device=device)

    @property
    def count(self) -> int:
        """Updates applied so far (reads the device)."""
        return int(self._count)

    @count.setter
    def count(self, value: int) -> None:
        self._count.fill_(int(value))

    @property
    def update_due(self) -> bool:
        """Whether the next data step ends an accumulation window, and so
        updates (always without accumulation)."""
        return self.mini_step == self.grad_accum - 1

    @torch.no_grad()
    def step(self, grads: list) -> torch.Tensor:
        """One data step: returns the global norm of ``grads`` before any
        clipping. Without accumulation it clips ``grads`` (in place) and
        updates; with it, it folds them into the running mean and updates
        from the mean on every ``grad_accum``-th call."""
        g_norm = self.step_body(grads, self.update_due)
        self.advance()
        return g_norm

    @torch.no_grad()
    def step_body(self, grads: list, update: bool) -> torch.Tensor:
        """:meth:`step`'s work on the device, which reads and writes the
        optimizer's tensors in place and nothing on the host: a step graph
        captures it. ``update`` (the host's :attr:`update_due`) says whether
        the step ends its window; :meth:`advance` moves the host's window
        position after it."""
        norms, g_norm = grid_norms(grads, self.names, self.grid, self.fsdp)
        if self.grad_accum == 1:
            self._update(grads, norms, g_norm)
            return g_norm
        diff = torch._foreach_sub(grads, self.acc_grads)
        torch._foreach_div_(diff, (self._mini + 1).float())
        torch._foreach_add_(self.acc_grads, diff)
        self._mini.add_(1).remainder_(self.grad_accum)
        if update:
            self._update(self.acc_grads,
                         *grid_norms(self.acc_grads, self.names, self.grid, self.fsdp))
            torch._foreach_zero_(self.acc_grads)
        return g_norm

    def advance(self) -> None:
        """The host's window position after a data step (:meth:`step_body`
        moved the device's)."""
        self.mini_step = (self.mini_step + 1) % self.grad_accum

    def _update(self, grads: list, norms: torch.Tensor, g_norm: torch.Tensor) -> None:
        """Clip ``grads`` (in place) to the global norm ``g_norm``, then one
        AdamW update, its bias corrections and learning rate from the
        device's count. With ``skip_nonfinite`` the update is computed beside
        the state and taken or dropped tensor by tensor on the device's
        finite flag and the run of bad updates so far, as
        optax.apply_if_finite does."""
        # optax.clip_by_global_norm: g if |g| < max, else g / |g| * max
        factor = torch.where(g_norm < self.max_grad_norm, torch.ones_like(g_norm),
                             self.max_grad_norm / g_norm)
        torch._foreach_mul_(grads, factor)
        ok = None
        if self.skip_nonfinite:
            finite = torch.isfinite(norms).all()
            ok = self._take(finite if self.grid is None else self.grid.all_true(finite))
        count = self._count + 1
        b1, b2 = self.beta1, self.beta2
        if ok is None:
            mu, nu = self.mu, self.nu
            torch._foreach_mul_(mu, b1)
            torch._foreach_mul_(nu, b2)
        else:
            mu, nu = torch._foreach_mul(self.mu, b1), torch._foreach_mul(self.nu, b2)
        torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
        mu_hat = torch._foreach_div(mu, (1.0 - b1 ** count.double()).float())
        denom = torch._foreach_div(nu, (1.0 - b2 ** count.double()).float())
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.EPS)
        update = torch._foreach_div(mu_hat, denom)
        torch._foreach_add_(update, self.params, alpha=self.weight_decay)
        torch._foreach_mul_(update, (-self.lr_schedule(count - 1)).float())
        if ok is None:
            torch._foreach_add_(self.params, update)
            self._count.copy_(count)
            return
        new_params = torch._foreach_add(self.params, update)
        for old, new in ((self.mu, mu), (self.nu, nu), (self.params, new_params)):
            for t, n in zip(old, new):
                t.copy_(torch.where(ok, n, t))
        self._count.copy_(torch.where(ok, count, self._count))

    def _take(self, finite: torch.Tensor) -> torch.Tensor:
        """Whether this update is taken: it is finite, or more than
        ``skip_nonfinite`` in a row were not. Advances optax's three
        counters in place."""
        bad_run = torch.where(finite, torch.zeros_like(self.notfinite_count),
                              self.notfinite_count + 1)
        ok = finite | (bad_run > self.skip_nonfinite)
        self.notfinite_count.copy_(bad_run)
        self.total_notfinite.add_(~finite)
        self.last_finite.copy_(finite)
        return ok

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
            self._mini.fill_(self.mini_step)
            if "acc_grads" not in state:
                torch._foreach_zero_(self.acc_grads)
        if self.skip_nonfinite:
            self.notfinite_count.fill_(int(state.get("notfinite_count", 0)))
            self.total_notfinite.fill_(int(state.get("total_notfinite", 0)))
            self.last_finite.fill_(bool(state.get("last_finite", True)))


def make_optimizer(params: dict, *, lr: float, weight_decay: float, beta1: float, beta2: float,
                   max_grad_norm: float, num_warmup_steps: int, num_training_steps: int,
                   skip_nonfinite: int = 0, grad_accum: int = 1, grid=None,
                   fsdp=frozenset()) -> AdamW:
    """AdamW with global-norm clipping on the cosine-warmup schedule.
    ``num_warmup_steps`` and ``num_training_steps`` count optimizer updates:
    with ``grad_accum`` the caller divides its data steps by it."""
    return AdamW(params,
                 lr_schedule=cosine_schedule_with_warmup(lr, num_warmup_steps, num_training_steps),
                 beta1=beta1, beta2=beta2, weight_decay=weight_decay, max_grad_norm=max_grad_norm,
                 skip_nonfinite=skip_nonfinite, grad_accum=grad_accum, grid=grid, fsdp=fsdp)


@dataclasses.dataclass
class TrainState:
    """The model (whose parameters are the live params), its optimizer (over
    all of them, or over the trainable ones), and the EMA shadow of every
    parameter (None when ``ema_decay`` is 0)."""

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
        names, params = zip(*self.model.named_parameters())
        shadow = [self.ema[n] for n in names]
        torch._foreach_mul_(shadow, d)
        torch._foreach_add_(shadow, list(params), alpha=1.0 - d)


_LABEL_DROP_STREAM = 0x1ABE1  # the JAX package's fold_in constant for the drop draw


def step_buffer(graphs, key: str, like: torch.Tensor) -> torch.Tensor:
    """The run's static buffer of the train step's input ``key`` ("image",
    "label", "timesteps", "noise", "drop") shaped and typed as ``like``."""
    return graphs.buffer(f"step {key}", like.shape, like.dtype)


def step_generator(seed: int, step: int, device, stream: int = 0) -> torch.Generator:
    """The generator of one step's draws, a function of (seed, step) only,
    so a resumed run draws what an unbroken one would. ``stream`` gives a
    second, independent generator for the same step."""
    entropy = [seed, step] + ([stream] if stream else [])
    state = np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def make_train_step(model: nn.Module, schedule: NoiseSchedule, *, parametrization: str,
                    seed: int, model_kind: str = "uvit", use_unweighted_loss: bool = False,
                    has_labels: bool = False, teacher: Optional[nn.Module] = None,
                    distill_alpha: float = 1.0, t_min: int = 0, label_dropout: float = 0.0,
                    null_label: Optional[int] = None, grid=None, rows: Optional[tuple] = None,
                    graphs=None):
    """Build ``train_step(state, batch, step) -> metrics``.

    A step draws uniform timesteps in [t_min, steps) and the noise from
    :func:`step_generator`, noises the batch with q(x_t | x_0), runs the
    model, takes the parametrization's loss, backpropagates and updates.
    ``batch`` holds "image" (B, H, W, C) float and "label" (B,) on the
    model's device.

    ``model_kind="deediff_uvit"``: the model is an early-exit U-ViT returning
    ``(backbone, u, g)``, the loss is DeeDiff's
    (:func:`~duodiff_tpu_torch.training.losses.total_deediff_loss`, with the
    unweighted term under ``use_unweighted_loss``), and the metrics are its
    parts: ``train_loss``, ``regular_train_loss``, ``classifier_train_loss``,
    ``weighted_train_loss``, ``unweighted_loss``. Such a model takes no teacher.
    Its ``L_u_t``, a sum over the batch, is scaled on a data rank's rows by
    the global batch over the rows, so that the data group's mean of the
    ranks' losses, and of their gradients, is one process's.

    Distillation: with a ``teacher`` (in eval mode, operands packed) the
    loss is ``alpha * MSE(student, teacher) + (1 - alpha) * task``, the
    teacher run under no grad. ``train_step.loss_fn(batch, timesteps,
    noise)`` returns (loss, metrics) for injected draws.

    Classifier-free-guidance training: with ``label_dropout`` > 0 a
    Bernoulli(label_dropout) mask per sample replaces labels by
    ``null_label``. The mask comes from a generator of its own
    (:func:`drop_mask`), so the timesteps and the noise are those of a
    ``label_dropout=0`` run to the bit. ``loss_fn(..., drop=mask)`` injects it.

    ``rows = (lo, hi, total)``: the batch is rows lo:hi of a global batch of
    ``total``; the step draws the global batch's timesteps, noise and drop
    mask and keeps those rows. ``grid``: the gradients are averaged over its
    data group before the update (an FSDP model's chunks were, in its
    backward).

    The step in two parts, as the JAX trainer's one jitted, donated step
    keeps everything on the device: (a) the draws, eager, copied with the
    batch into static buffers; (b) the body, which reads and writes only
    static tensors: the buffers, the parameters and their gradients (each
    ``.grad`` made once and zeroed before every backward, never replaced),
    the optimizer's state, the EMA and the metrics (one static vector). On
    the run's :class:`~duodiff_tpu_torch.diffusion.graphs.StepGraphs`
    ``graphs`` the body is one step graph per kind of step, "update", and
    with accumulation "fold" (the host's window position picks it): a CUDA
    graph on the card, the body run eagerly on the CPU or when the graphs
    are not graphed. Without ``graphs`` the body runs eagerly on buffers of
    its own. After a replay the model's packed operands count as stale
    (``mark_weights_moved``): a replay writes the weights without Python,
    so their ``_version`` marks do not move.
    """
    names, params = map(list, zip(*model.named_parameters()))
    fsdp_state = getattr(model, "fsdp", None)
    chunked = frozenset() if fsdp_state is None else fsdp_state.names
    if label_dropout > 0.0 and (not has_labels or null_label is None):
        raise ValueError("label_dropout needs labels and a null_label")
    if model_kind not in ("uvit", "deediff_uvit"):
        raise ValueError(f"Unknown model kind {model_kind}")
    if model_kind == "deediff_uvit" and teacher is not None:
        raise ValueError("distillation targets a plain UViT student, not deediff_uvit")

    def global_rows(clean):
        """(lo, hi, total) of the batch: all of it without ``rows``."""
        return rows if rows is not None else (0, clean.shape[0], clean.shape[0])

    def draws(batch, step: int):
        clean = batch["image"]
        lo, hi, total = global_rows(clean)
        g = step_generator(seed, step, clean.device)
        timesteps = torch.randint(t_min, schedule.steps, (total,), generator=g,
                                  device=clean.device)[lo:hi]
        noise = torch.randn((total, *clean.shape[1:]), generator=g, device=clean.device,
                            dtype=torch.float32)[lo:hi]
        return timesteps, noise

    def drop_mask(batch, step: int):
        """The step's label-drop mask (B,) bool, or None without label_dropout."""
        if label_dropout <= 0.0:
            return None
        clean = batch["image"]
        lo, hi, total = global_rows(clean)
        g = step_generator(seed, step, clean.device, _LABEL_DROP_STREAM)
        return torch.rand((total,), generator=g, device=clean.device)[lo:hi] < label_dropout

    def loss_fn(batch, timesteps, noise, drop=None):
        clean = batch["image"].float()
        labels = batch.get("label") if has_labels else None
        if drop is not None:
            labels = torch.where(drop, torch.full_like(labels, null_label), labels)
        noisy = schedule.add_noise(clean, timesteps, noise)
        t = timesteps.float()
        if model_kind == "deediff_uvit":
            backbone, u, g = model(noisy, t, labels)
            parts = deediff_loss(backbone, u, g, parametrization=parametrization, noise=noise,
                                 clean=clean)
            # L_u_t sums over the batch: on a data rank's rows, scaled so that
            # the data group's mean is the global batch's sum
            lo, hi, total = global_rows(clean)
            parts = (parts[0], parts[1] * (total / (hi - lo)), *parts[2:])
            loss = total_deediff_loss(parts, use_unweighted_loss)
            return loss, {"train_loss": loss, "regular_train_loss": parts[0],
                          "classifier_train_loss": parts[1], "weighted_train_loss": parts[2],
                          "unweighted_loss": parts[3]}
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

    untrained = {}  # a zero gradient of each parameter that takes none, made once

    def grad_buffers() -> list:
        """One gradient tensor per parameter, at one address for the run:
        each trained parameter's ``.grad`` (zeros, made where it has none),
        the kept zeros of one that takes no gradient."""
        out = []
        for i, p in enumerate(params):
            if not p.requires_grad:
                out.append(untrained.setdefault(i, torch.zeros_like(p)))
                continue
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            out.append(p.grad)
        return out

    def backward(batch, timesteps, noise, drop=None) -> tuple[dict, list]:
        """Loss and gradients (one per parameter) for injected draws: the
        gradients are zeroed, and the backward adds into them in place."""
        model.train()
        grads = grad_buffers()
        torch._foreach_zero_(grads)
        loss, metrics = loss_fn(batch, timesteps, noise, drop)
        loss.backward()
        return metrics, grads

    def apply(state: TrainState, grads: list, update_now: bool) -> torch.Tensor:
        """The optimizer's device work on the gradients of every parameter
        (in ``model.named_parameters()`` order), then the EMA; returns the
        global norm of all of them. An optimizer over a subset gets the
        subset's."""
        opt_names = state.optimizer.names
        if opt_names == names:
            g_norm = state.optimizer.step_body(grads, update_now)
        else:
            g_norm = grid_norms(grads, names, grid, chunked)[1]
            by_name = dict(zip(names, grads))
            state.optimizer.step_body([by_name[n] for n in opt_names], update_now)
        state.update_ema()
        return g_norm

    def update(state: TrainState, grads: list) -> torch.Tensor:
        """One optimizer step, eager, on ``grads``, then the EMA; returns the
        global norm of all of them."""
        g_norm = apply(state, grads, state.optimizer.update_due)
        state.optimizer.advance()
        return g_norm

    run = {"graphs": graphs, "state": None, "buffers": None, "metrics": None}

    def stage(key: str, src: torch.Tensor) -> torch.Tensor:
        """``src`` in the run's static buffer of the input ``key`` (copied
        unless it is that buffer)."""
        buf = step_buffer(run["graphs"], key, src)
        if buf is not src:
            buf.copy_(src, non_blocking=True)
        return buf

    def body(state: TrainState, inputs: dict, update_now: bool) -> None:
        """The step on static tensors only: forward, loss, backward, (the
        data group's mean,) clipping, AdamW, EMA, the metrics."""
        batch = {k: inputs[k] for k in ("image", "label") if k in inputs}
        metrics, grads = backward(batch, inputs["timesteps"], inputs["noise"], inputs.get("drop"))
        if grid is not None:
            grid.data_mean_([g for n, g in zip(names, grads) if n not in chunked])
        metrics["grad_norm"] = apply(state, grads, update_now)
        values = torch.stack([v.detach().float().reshape(()) for v in metrics.values()])
        run["graphs"].buffer("metrics", values.shape).copy_(values)
        run["metrics"] = list(metrics)

    def train_step(state: TrainState, batch, step: int, timesteps=None, noise=None,
                   drop=None) -> dict:
        if timesteps is None:
            timesteps, noise = draws(batch, step)
            drop = drop_mask(batch, step)
        if run["graphs"] is None:
            run["graphs"] = StepGraphs(batch["image"].device, graphed=False)
        graphed = run["graphs"].graphed
        inputs = {"image": batch["image"], "timesteps": timesteps, "noise": noise}
        if has_labels and "label" in batch:
            inputs["label"] = batch["label"]
        if drop is not None:
            inputs["drop"] = drop
        inputs = {k: stage(k, v) for k, v in inputs.items()}
        if graphed and run["state"] is not None and (
                state is not run["state"] or inputs.keys() != run["buffers"].keys()
                or any(inputs[k] is not run["buffers"][k] for k in inputs)):
            raise ValueError("a graphed train step keeps the state and the batch shapes of its "
                             "first call")
        run["state"], run["buffers"] = state, inputs
        opt = state.optimizer
        kind = "update" if opt.update_due else "fold"
        run["graphs"].step(("train", kind), lambda: body(state, inputs, kind == "update"))
        opt.advance()
        if graphed and hasattr(model, "mark_weights_moved"):
            model.mark_weights_moved()
        values = run["graphs"].buffer("metrics", (len(run["metrics"]),)).clone()
        return dict(zip(run["metrics"], values.unbind()))

    train_step.loss_fn = loss_fn
    train_step.backward = backward
    train_step.update = update
    train_step.draws = draws
    train_step.drop_mask = drop_mask
    train_step.run = run
    return train_step
