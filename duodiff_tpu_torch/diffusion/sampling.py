"""Ancestral DDPM samplers (counterpart of ``duodiff_tpu/diffusion/sampling.py``).

The JAX package runs the reverse process as an on-device ``lax.scan``; here
it is a Python loop of eager steps. ``apply_fn(x, t_batch, y)`` is the
model; timesteps go in as a float32 (B,) tensor. Noise comes from an
explicit ``torch.Generator`` on the sampling device, or from an injected
``noise_table`` (steps, *x.shape) whose row t is used at step t (zero at
t == 0), which is how the tests drive the JAX and torch samplers with the
same noise.

Stateful mode (``ddpm_scan(state=...)``): ``apply_fn(state, x, t_batch, y,
t) -> (model_output, new_state)``, where ``t`` is the step as a Python int,
so a choice per step (block caching's anchor rule) is a host branch that
never waits for the device. The state threads from step to step and from
one segment to the next.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule


def ddpm_loop(
    apply_fn: Callable,
    schedule: NoiseSchedule,
    parametrization: str,
    x: torch.Tensor,
    generator: Optional[torch.Generator],
    ts: Iterable[int],
    y: Optional[torch.Tensor] = None,
    variance_mode: str = "beta_tilde",
    noise_table: Optional[torch.Tensor] = None,
    state=None,
):
    """The ancestral update over the descending timesteps ``ts``
    (``ddpm_scan``). With ``state`` the apply is stateful (module
    docstring) and the result is ``(x, state)``."""
    batch = x.shape[0]
    stateful = state is not None
    for t in ts:
        t = int(t)
        t_batch = torch.full((batch,), float(t), dtype=torch.float32, device=x.device)
        if stateful:
            model_output, state = apply_fn(state, x, t_batch, y, t)
        else:
            model_output = apply_fn(x, t_batch, y)
        if t == 0:  # no noise on the last step, whatever the table holds
            z = torch.zeros_like(x)
        elif noise_table is not None:
            z = noise_table[t]
        else:
            z = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
        x = schedule.step(parametrization, model_output, x, t, z, variance_mode)
    return (x, state) if stateful else x


def make_guided_apply(apply_fn: Callable, guidance_scale: float, null_label: int) -> Callable:
    """Classifier-free guidance: an ``apply_fn(x, t, y)`` computing

        out = out_null + w * (out_cond - out_null)

    with ONE forward at twice the batch (the conditional half first, the
    null-label half second), so it composes with :func:`ddpm_loop`,
    :class:`DDPMSampler` and :func:`duodiff_sample` unchanged. ``w = 1`` is
    the conditional model, ``w = 0`` the unconditional one. Any leading
    arguments pass through untouched; only the trailing (x, t, y) triple is
    doubled."""

    def guided(*args):
        *lead, x, t, y = args
        if y is None:
            raise ValueError("guidance needs class labels")
        b = x.shape[0]
        out = apply_fn(*lead, torch.cat([x, x]), torch.cat([t, t]),
                       torch.cat([y, torch.full_like(y, null_label)]))
        cond, uncond = out[:b], out[b:]
        return uncond + guidance_scale * (cond - uncond)

    return guided


def make_block_cached_apply(apply_anchor: Callable, apply_cached: Callable, every,
                            t_first: int) -> Callable:
    """Training-free block caching (the Delta-DiT / DeepCache family): on
    anchor steps run the full model and keep the centered region's residual
    (``apply_anchor(x, t_batch, y) -> (out, delta)``, UViT.forward_anchor);
    on the steps between, run only the outer blocks with that residual
    (``apply_cached(x, t_batch, y, delta) -> out``, UViT.forward_cached).

    Anchors: ``t % every == 0`` for an int period, or ``table[t]`` for a
    1-D boolean table indexed by t (a drift-derived schedule); in both
    forms also ``t == t_first``, the segment's first step, where no delta
    exists yet. Returns the stateful apply of :func:`ddpm_loop`, whose
    state is the delta (start it as zeros (B, L, D) in the compute dtype).
    """
    table = None
    if isinstance(every, (int, np.integer)):
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
    else:
        table = np.asarray(every)
        if table.ndim != 1 or table.dtype != np.bool_:
            raise ValueError(
                "anchor table must be a 1-D boolean array indexed by t, "
                f"got shape {table.shape} dtype {table.dtype}"
            )

    def apply(state, x, t_batch, y, t: int):
        anchor = (t % every == 0) if table is None else bool(table[t])
        if anchor or t == t_first:
            return apply_anchor(x, t_batch, y)
        return apply_cached(x, t_batch, y, state), state

    return apply


class DDPMSampler:
    """``init`` draws x_T; ``run(x, generator, t_start, t_end, y)`` advances
    t = t_start down to t_end inclusive, so callers can compose segments
    over different models (the DuoDiff handoff). The counterpart of
    ``ChunkedDDPMSampler`` without its chunking, a TPU compile-time device.

    With ``init_state_fn`` the sampler is stateful: ``apply_fn`` follows
    the stateful contract, ``init_state_fn(x)`` builds a segment's first
    state, and ``run(..., state=)`` returns ``(x, state)`` for the next
    segment."""

    def __init__(self, apply_fn: Callable, schedule: NoiseSchedule, *,
                 parametrization: str = "predict_noise",
                 variance_mode: str = "beta_tilde",
                 init_state_fn: Optional[Callable] = None):
        self.apply_fn = apply_fn
        self.schedule = schedule
        self.parametrization = parametrization
        self.variance_mode = variance_mode
        self.init_state_fn = init_state_fn

    def init(self, generator: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=generator,
                           device=generator.device, dtype=torch.float32)

    def run(self, x, generator, t_start: int, t_end: int = 0, y=None, state=None):
        if (self.init_state_fn is not None) != (state is not None):
            raise ValueError("a stateful sampler (init_state_fn) runs with state=, "
                             "a stateless one without")
        return ddpm_loop(
            self.apply_fn, self.schedule, self.parametrization, x, generator,
            range(t_start, t_end - 1, -1), y, self.variance_mode, state=state,
        )


def duodiff_sample(
    early_apply_fn: Callable,
    late_apply_fn: Callable,
    generator: Optional[torch.Generator],
    *,
    schedule: NoiseSchedule,
    shape: Sequence[int],
    t_switch: int,
    parametrization: str = "predict_noise",
    y: Optional[torch.Tensor] = None,
    x_init: Optional[torch.Tensor] = None,
    variance_mode: str = "beta_tilde",
    noise_table: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """DuoDiff: the shallow model runs the first ``t_switch`` (high-noise)
    steps t = T-1 .. T-t_switch, the full model the remaining ones."""
    steps = schedule.steps
    if x_init is None:
        x_init = torch.randn(tuple(shape), generator=generator,
                             device=generator.device, dtype=torch.float32)
    t_switch = min(max(int(t_switch), 0), steps)
    handoff = steps - t_switch
    x = ddpm_loop(early_apply_fn, schedule, parametrization, x_init, generator,
                  range(steps - 1, handoff - 1, -1), y, variance_mode, noise_table)
    return ddpm_loop(late_apply_fn, schedule, parametrization, x, generator,
                     range(handoff - 1, -1, -1), y, variance_mode, noise_table)
