"""duodiff_tpu_torch.diffusion.schedule against the JAX NoiseSchedule: the
fp32 tables and one reverse step for every parametrization and variance
mode (fp32, rtol 1e-5 with atol 1e-6 for coefficients that differ by an
ulp).

Table tolerances: torch's and XLA's fp32 linspace and cumprod round
differently by an ulp, so the tables agree to rtol 1e-6, except betas_tilde,
whose (1 - alphas_bar) denominator cancels at small t (alphas_bar ~ 0.9999)
and turns those ulps into relative differences up to ~1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duodiff_tpu.diffusion.schedule import NoiseSchedule as JaxSchedule
from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule

torch.set_num_threads(1)

TABLE_RTOL = {"betas": 1e-6, "alphas": 1e-6, "alphas_bar": 1e-6,
              "alphas_bar_prev": 1e-6, "betas_tilde": 2e-4}


@pytest.mark.parametrize("steps", [1000, 20])
def test_tables_match_jax(steps):
    want = JaxSchedule.create(steps=steps)
    got = NoiseSchedule.create(steps=steps)
    assert got.steps == want.steps == steps
    for name, rtol in TABLE_RTOL.items():
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=rtol, atol=0, err_msg=name)


@pytest.mark.parametrize("variance_mode", ["beta", "beta_tilde"])
@pytest.mark.parametrize(
    "parametrization", ["predict_noise", "predict_original", "predict_previous"]
)
def test_step_matches_jax(parametrization, variance_mode):
    rng = np.random.RandomState(0)
    shape = (2, 8, 8, 3)
    out, x, z = (rng.randn(*shape).astype(np.float32) for _ in range(3))
    jsched, tsched = JaxSchedule.create(), NoiseSchedule.create()
    for t in (999, 500, 1, 0):
        want = jsched.step(parametrization, jnp.asarray(out), jnp.asarray(x), t,
                           jnp.asarray(z), variance_mode)
        got = tsched.step(parametrization, torch.from_numpy(out),
                          torch.from_numpy(x), t, torch.from_numpy(z), variance_mode)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6, err_msg=f"t={t}")


def test_invalid_modes_raise():
    sched = NoiseSchedule.create(steps=10)
    x = torch.zeros(1, 2)
    with pytest.raises(ValueError):
        sched.sigma(3, "nope")
    with pytest.raises(ValueError):
        sched.step("predict_nothing", x, x, 3, x)
