"""Learning-rate schedule (counterpart of ``duodiff_tpu/training/lr.py``)."""

from __future__ import annotations

import math

import torch


def cosine_schedule_with_warmup(base_lr: float, num_warmup_steps: int,
                                num_training_steps: int):
    """lr(step) with diffusers' get_cosine_schedule_with_warmup semantics:
      step < warmup:  base_lr * step / max(1, warmup)
      else:           base_lr * max(0, 0.5 * (1 + cos(pi * progress)))
    where progress = (step - warmup) / max(1, total - warmup). ``step``
    counts the optimizer updates made before this one (0 for the first). It
    may be a 0-dim tensor (a count kept on the device): the result is then a
    float64 tensor of the same value, computed there."""

    def schedule(step):
        if isinstance(step, torch.Tensor):
            step = step.double()
            warm = base_lr * step / max(1.0, float(num_warmup_steps))
            progress = (step - num_warmup_steps) / max(
                1.0, float(num_training_steps - num_warmup_steps))
            cos = base_lr * torch.clamp(0.5 * (1.0 + torch.cos(math.pi * progress)), min=0.0)
            return torch.where(step < num_warmup_steps, warm, cos)
        if step < num_warmup_steps:
            return base_lr * step / max(1.0, float(num_warmup_steps))
        progress = (step - num_warmup_steps) / max(1.0, float(num_training_steps - num_warmup_steps))
        return base_lr * max(0.0, 0.5 * (1.0 + math.cos(math.pi * progress)))

    return schedule
