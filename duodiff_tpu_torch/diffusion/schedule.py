"""DDPM noise schedule as precomputed fp32 tables
(counterpart of ``duodiff_tpu/diffusion/schedule.py``).

Linear betas in [1e-4, 0.02] over ``steps``; every per-timestep coefficient
of the reverse step and the three parametrizations is a float32 table on
the schedule's device. The reverse steps take ``t`` as a Python int, or as
a (B,) integer tensor of per-row timesteps (continuous batching, where
every slot of the batch is at its own step): each coefficient is then the
rows' table values shaped (B, 1, ..., 1), and each row's result is the
one the int form gives for its own t, to the bit.
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

    def _noise_term(self, x, t, z, variance_mode):
        return torch.sqrt(_at(self.sigma_squared(variance_mode), t, x)) * z

    def step_predict_noise(self, model_output, x, t, z, variance_mode="beta_tilde"):
        """x_{t-1} from predicted epsilon."""
        alpha_t = _at(self.alphas, t, x)
        alpha_bar_t = _at(self.alphas_bar, t, x)
        mean = torch.sqrt(1.0 / alpha_t) * (
            x - (1.0 - alpha_t) / torch.sqrt(1.0 - alpha_bar_t) * model_output
        )
        return mean + self._noise_term(x, t, z, variance_mode)

    def step_predict_original(self, model_output, x, t, z, variance_mode="beta_tilde"):
        """x_{t-1} from predicted x_0 via the closed-form posterior mean."""
        alpha_t = _at(self.alphas, t, x)
        alpha_bar_t = _at(self.alphas_bar, t, x)
        alpha_bar_prev = _at(self.alphas_bar_prev, t, x)
        beta_t = _at(self.betas, t, x)
        mean = (
            torch.sqrt(alpha_bar_prev) * beta_t * model_output / (1.0 - alpha_bar_t)
            + torch.sqrt(alpha_t) * (1.0 - alpha_bar_prev) * x / (1.0 - alpha_bar_t)
        )
        return mean + self._noise_term(x, t, z, variance_mode)

    def step_predict_previous(self, model_output, x, t, z, variance_mode="beta_tilde"):
        """x_{t-1} predicted directly."""
        return model_output + self._noise_term(x, t, z, variance_mode)

    def step(self, parametrization: str, model_output, x, t, z,
             variance_mode: str = "beta_tilde"):
        if parametrization == "predict_noise":
            return self.step_predict_noise(model_output, x, t, z, variance_mode)
        if parametrization == "predict_original":
            return self.step_predict_original(model_output, x, t, z, variance_mode)
        if parametrization == "predict_previous":
            return self.step_predict_previous(model_output, x, t, z, variance_mode)
        raise ValueError(f"Invalid parametrization {parametrization}")

    def ddim_step(self, model_output, x, t, s, z, eta: float = 0.0):
        """One DDIM step t -> s (s < t) from predicted epsilon, with
        sigma^2 = eta * beta_tilde_t:

            mean = sqrt(abar_s / abar_t) (x - sqrt(1 - abar_t) eps)
                   + sqrt(max(1 - abar_s - sigma^2, 0)) eps
            x_s  = mean + sqrt(sigma^2) z

        The reference adds ``sigma^2 * z``; like the JAX package this takes
        the standard ``sqrt(sigma^2) * z`` (the same at the default eta 0)."""
        abar_t = _at(self.alphas_bar, t, x)
        abar_s = _at(self.alphas_bar, s, x)
        sigma_sq = _at(self.betas_tilde, t, x) * eta
        mean = torch.sqrt(abar_s / abar_t) * (x - torch.sqrt(1.0 - abar_t) * model_output)
        mean = mean + torch.sqrt(torch.clamp(1.0 - abar_s - sigma_sq, min=0.0)) * model_output
        return mean + torch.sqrt(sigma_sq) * z


def _at(table: torch.Tensor, t, x: torch.Tensor) -> torch.Tensor:
    """``table[t]``: a 0-d tensor for an int ``t``; for a (B,) tensor of
    per-row timesteps the rows' values, shaped to broadcast over ``x``."""
    if isinstance(t, torch.Tensor) and t.ndim == 1:
        return _bcast(table[t], x.ndim)
    return table[t]


def _bcast(coeffs: torch.Tensor, ndim: int) -> torch.Tensor:
    """(B,) coefficients -> (B, 1, ..., 1) for broadcasting."""
    return coeffs.reshape(coeffs.shape[0], *((1,) * (ndim - 1)))
