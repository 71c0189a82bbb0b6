"""Ancestral DDPM samplers (counterpart of ``duodiff_tpu/diffusion/sampling.py``).

The JAX package runs the reverse process as an on-device ``lax.scan``; here
it is a Python loop of eager steps. ``apply_fn(x, t_batch, y)`` is the
model; timesteps go in as a float32 (B,) tensor. Noise comes from an
explicit ``torch.Generator`` on the sampling device, or from an injected
``noise_table`` (steps, *x.shape) whose row t is used at step t (zero at
t == 0), which is how the tests drive the JAX and torch samplers with the
same noise.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence

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
) -> torch.Tensor:
    """The ancestral update over the descending timesteps ``ts``
    (``ddpm_scan``)."""
    batch = x.shape[0]
    for t in ts:
        t = int(t)
        t_batch = torch.full((batch,), float(t), dtype=torch.float32, device=x.device)
        model_output = apply_fn(x, t_batch, y)
        if t == 0:  # no noise on the last step, whatever the table holds
            z = torch.zeros_like(x)
        elif noise_table is not None:
            z = noise_table[t]
        else:
            z = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
        x = schedule.step(parametrization, model_output, x, t, z, variance_mode)
    return x


class DDPMSampler:
    """``init`` draws x_T; ``run(x, generator, t_start, t_end, y)`` advances
    t = t_start down to t_end inclusive, so callers can compose segments
    over different models (the DuoDiff handoff). The counterpart of
    ``ChunkedDDPMSampler`` without its chunking, a TPU compile-time device."""

    def __init__(self, apply_fn: Callable, schedule: NoiseSchedule, *,
                 parametrization: str = "predict_noise",
                 variance_mode: str = "beta_tilde"):
        self.apply_fn = apply_fn
        self.schedule = schedule
        self.parametrization = parametrization
        self.variance_mode = variance_mode

    def init(self, generator: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=generator,
                           device=generator.device, dtype=torch.float32)

    def run(self, x, generator, t_start: int, t_end: int = 0, y=None) -> torch.Tensor:
        return ddpm_loop(
            self.apply_fn, self.schedule, self.parametrization, x, generator,
            range(t_start, t_end - 1, -1), y, self.variance_mode,
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
