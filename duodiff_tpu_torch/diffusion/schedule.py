"""DDPM noise schedule as precomputed fp32 tables
(counterpart of ``duodiff_tpu/diffusion/schedule.py``).

Linear betas in [1e-4, 0.02] over ``steps``; every per-timestep coefficient
of the reverse step and the three parametrizations is a float32 table on
the schedule's device, indexed with a Python int ``t``.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_bar: torch.Tensor
    alphas_bar_prev: torch.Tensor
    betas_tilde: torch.Tensor

    @classmethod
    def create(
        cls,
        beta_init: float = 1e-4,
        beta_final: float = 0.02,
        steps: int = 1000,
        *,
        device=None,
    ) -> "NoiseSchedule":
        f32 = torch.float32
        betas = torch.linspace(beta_init, beta_final, steps, dtype=f32)
        alphas = 1.0 - betas
        alphas_bar = torch.cumprod(alphas, 0)
        alphas_bar_prev = torch.cat([torch.ones(1, dtype=f32), alphas_bar[:-1]])
        betas_tilde = (1.0 - alphas_bar_prev) / (1.0 - alphas_bar) * betas
        tables = (betas, alphas, alphas_bar, alphas_bar_prev, betas_tilde)
        return cls(*(t.to(device) for t in tables))

    @property
    def steps(self) -> int:
        return self.betas.shape[0]

    def sigma_squared(self, variance_mode: str = "beta") -> torch.Tensor:
        if variance_mode == "beta":
            return self.betas
        if variance_mode == "beta_tilde":
            return self.betas_tilde
        raise ValueError("Invalid variance mode. Choose 'beta' or 'beta_tilde'.")

    def add_noise(self, x0: torch.Tensor, timesteps: torch.Tensor, noise: torch.Tensor):
        """Forward process q(x_t | x_0) with the noise passed in; timesteps
        (B,) int. Returns x_t shaped like x0."""
        alpha_bar_t = _bcast(self.alphas_bar[timesteps], x0.ndim)
        return torch.sqrt(alpha_bar_t) * x0 + torch.sqrt(1.0 - alpha_bar_t) * noise

    def predict_previous_target(self, clean, noisy, timesteps):
        """Posterior-mean regression target of the ``predict_previous``
        parametrization."""
        t = timesteps
        clean_coef = _bcast(
            torch.sqrt(self.alphas_bar_prev[t]) * self.betas[t] / (1.0 - self.alphas_bar[t]),
            clean.ndim,
        )
        noisy_coef = _bcast(
            torch.sqrt(self.alphas[t]) * (1.0 - self.alphas_bar_prev[t]) / (1.0 - self.alphas_bar[t]),
            clean.ndim,
        )
        return clean_coef * clean + noisy_coef * noisy

    def sigma(self, t: int, variance_mode: str = "beta_tilde") -> torch.Tensor:
        """Reverse-step noise scale sqrt(sigma^2_t)."""
        return torch.sqrt(self.sigma_squared(variance_mode)[t])

    def step_predict_noise(self, model_output, x, t, z, variance_mode="beta_tilde"):
        """x_{t-1} from predicted epsilon."""
        alpha_t = self.alphas[t]
        alpha_bar_t = self.alphas_bar[t]
        mean = torch.sqrt(1.0 / alpha_t) * (
            x - (1.0 - alpha_t) / torch.sqrt(1.0 - alpha_bar_t) * model_output
        )
        return mean + self.sigma(t, variance_mode) * z

    def step_predict_original(self, model_output, x, t, z, variance_mode="beta_tilde"):
        """x_{t-1} from predicted x_0 via the closed-form posterior mean."""
        alpha_t = self.alphas[t]
        alpha_bar_t = self.alphas_bar[t]
        alpha_bar_prev = self.alphas_bar_prev[t]
        beta_t = self.betas[t]
        mean = (
            torch.sqrt(alpha_bar_prev) * beta_t * model_output / (1.0 - alpha_bar_t)
            + torch.sqrt(alpha_t) * (1.0 - alpha_bar_prev) * x / (1.0 - alpha_bar_t)
        )
        return mean + self.sigma(t, variance_mode) * z

    def step_predict_previous(self, model_output, x, t, z, variance_mode="beta_tilde"):
        """x_{t-1} predicted directly."""
        del x
        return model_output + self.sigma(t, variance_mode) * z

    def step(self, parametrization: str, model_output, x, t, z,
             variance_mode: str = "beta_tilde"):
        if parametrization == "predict_noise":
            return self.step_predict_noise(model_output, x, t, z, variance_mode)
        if parametrization == "predict_original":
            return self.step_predict_original(model_output, x, t, z, variance_mode)
        if parametrization == "predict_previous":
            return self.step_predict_previous(model_output, x, t, z, variance_mode)
        raise ValueError(f"Invalid parametrization {parametrization}")


def _bcast(coeffs: torch.Tensor, ndim: int) -> torch.Tensor:
    """(B,) coefficients -> (B, 1, ..., 1) for broadcasting."""
    return coeffs.reshape(coeffs.shape[0], *((1,) * (ndim - 1)))
