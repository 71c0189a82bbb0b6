"""Training losses (counterpart of ``duodiff_tpu/training/losses.py``), in
fp32 whatever the forward's compute dtype."""

from __future__ import annotations

import torch

from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() - b.float()).square().mean()


def uvit_loss(prediction, *, parametrization: str, noise, clean, noisy, timesteps,
              schedule: NoiseSchedule) -> torch.Tensor:
    """MSE against the parametrization's target: epsilon (predict_noise),
    x_0 (predict_original) or the posterior mean of x_{t-1}
    (predict_previous)."""
    if parametrization == "predict_noise":
        target = noise
    elif parametrization == "predict_original":
        target = clean
    elif parametrization == "predict_previous":
        target = schedule.predict_previous_target(clean, noisy, timesteps)
    else:
        raise ValueError(f"Unknown parametrization type {parametrization}")
    return mse(prediction, target)
