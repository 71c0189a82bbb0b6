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


def deediff_loss(backbone_output, classifier_outputs, ee_outputs, *, parametrization: str,
                 noise, clean) -> tuple:
    """The DeeDiff loss's four terms, in fp32: ``(L_simple, L_u_t, L_UAL_t,
    unweighted)``.

    - ``L_simple``: the backbone's MSE against the parametrization's target;
    - ``L_u_t``: each probe's output ``classifier_outputs`` (layers, B)
      regressed onto its head's pseudo-label ``u_t_hat = mean_CHW tanh|g_i -
      target|``, summed over (layers, B);
    - ``L_UAL_t``: each head's per-sample MSE ``L_n_t`` weighted by ``1 -
      u_t_hat``, the mean over the batch summed over the layers; the
      gradient flows through ``u_t_hat`` too, as in the reference;
    - ``unweighted``: ``L_n_t`` unweighted, the mean over the batch summed
      over the layers (added to the total only under
      ``--use_unweighted_loss``).

    ``ee_outputs`` are the heads' predictions (layers, B, H, W, C). Only
    ``predict_noise`` and ``predict_original`` have a per-head target."""
    if parametrization == "predict_noise":
        target = noise
    elif parametrization == "predict_original":
        target = clean
    else:
        raise ValueError(f"Unknown parametrization type {parametrization}")
    target = target.float()
    u = classifier_outputs.float()
    l_simple = mse(backbone_output, target)
    diff = ee_outputs.float() - target[None]
    u_t_hat = torch.tanh(diff.abs()).mean(dim=(-1, -2, -3))  # (layers, B)
    l_u_t = (u - u_t_hat).square().sum()
    l_n_t = diff.square().mean(dim=(-1, -2, -3))             # (layers, B)
    l_ual_t = ((1.0 - u_t_hat) * l_n_t).mean(1).sum()
    unweighted = l_n_t.mean(1).sum()
    return l_simple, l_u_t, l_ual_t, unweighted


def total_deediff_loss(parts, use_unweighted_loss: bool) -> torch.Tensor:
    """``L_simple + L_u_t + L_UAL_t``, plus the unweighted term when asked."""
    l_simple, l_u_t, l_ual_t, unweighted = parts
    total = l_simple + l_u_t + l_ual_t
    return total + unweighted if use_unweighted_loss else total
