"""The port's DDPM and DuoDiff samplers against the JAX ones, as whole
trajectories driven by one injected noise table (the two frameworks' RNG
streams cannot match), on JAX-initialised weights carried across; and the
sampling CLI on a tiny config.

Tolerance: fp32 throughout; the two models agree to ~1e-6 per forward and
the 20 ancestral steps add their update arithmetic, so the final samples
are held to rtol/atol 1e-4."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from duodiff_tpu.config import UViTConfig as JaxConfig
from duodiff_tpu.diffusion.sampling import ddpm_scan
from duodiff_tpu.diffusion.sampling import duodiff_sample as jax_duodiff_sample
from duodiff_tpu.diffusion.schedule import NoiseSchedule as JaxSchedule
from duodiff_tpu.models.uvit import init_uvit as jax_init_uvit
from duodiff_tpu_torch.config import UViTConfig
from duodiff_tpu_torch.diffusion.sampling import DDPMSampler, ddpm_loop, duodiff_sample
from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule
from duodiff_tpu_torch.models.uvit import UViT
from duodiff_tpu_torch.utils.convert import uvit_state_dict_from_jax

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
STEPS, T_SWITCH, BATCH = 20, 6, 2
SMALL = dict(img_size=16, patch_size=4, in_chans=3, embed_dim=64, num_heads=4,
             mlp_ratio=4)
TOL = 1e-4


def _models(depth, seed):
    """(JAX apply_fn with attn_impl="fused", the port's model), same weights."""
    kw = dict(SMALL, depth=depth)
    jmodel, params = jax_init_uvit(JaxConfig(**kw), jax.random.PRNGKey(seed),
                                   dtype=jnp.float32, attn_impl="fused")
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rng.randn(*a.shape).astype(np.float32), params)
    model = UViT(UViTConfig(**kw), dtype=torch.float32, attn_impl="fused")
    model.load_state_dict(uvit_state_dict_from_jax(params), strict=True)
    model.pack_for_kernels()
    return (lambda x, t, y: jmodel.apply({"params": params}, x, t, y)), model


def _noise():
    rng = np.random.RandomState(3)
    shape = (BATCH, 16, 16, 3)
    table = rng.randn(STEPS, *shape).astype(np.float32)
    table[0] = 0.0
    return rng.randn(*shape).astype(np.float32), table


def test_duodiff_trajectory_matches_jax():
    (j_early, t_early), (j_late, t_late) = _models(3, 0), _models(5, 1)
    x0, table = _noise()
    want = jax_duodiff_sample(
        j_early, j_late, jax.random.PRNGKey(0), schedule=JaxSchedule.create(steps=STEPS),
        shape=x0.shape, t_switch=T_SWITCH, x_init=jnp.asarray(x0),
        noise_table=jnp.asarray(table),
    )
    with torch.no_grad():
        got = duodiff_sample(
            t_early, t_late, None, schedule=NoiseSchedule.create(steps=STEPS),
            shape=x0.shape, t_switch=T_SWITCH, x_init=torch.from_numpy(x0),
            noise_table=torch.from_numpy(table),
        )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_dense_ddpm_trajectory_matches_jax():
    j_apply, model = _models(3, 2)
    x0, table = _noise()
    want, _ = ddpm_scan(
        j_apply, JaxSchedule.create(steps=STEPS), "predict_noise", jnp.asarray(x0),
        jax.random.PRNGKey(0), jnp.arange(STEPS - 1, -1, -1),
        noise_table=jnp.asarray(table),
    )
    with torch.no_grad():
        got = ddpm_loop(model, NoiseSchedule.create(steps=STEPS), "predict_noise",
                        torch.from_numpy(x0), None, range(STEPS - 1, -1, -1),
                        noise_table=torch.from_numpy(table))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_sampler_segments_compose():
    """Two run() segments over one generator equal one run over both."""
    sched = NoiseSchedule.create(steps=STEPS)
    apply = lambda x, t, y: 0.1 * x + 1e-3 * t[:, None, None, None]  # noqa: E731
    sampler = DDPMSampler(apply, sched)
    x = sampler.init(torch.Generator().manual_seed(0), (BATCH, 4, 4, 3))
    one = sampler.run(x, torch.Generator().manual_seed(1), STEPS - 1, 0)
    g = torch.Generator().manual_seed(1)
    two = sampler.run(sampler.run(x, g, STEPS - 1, T_SWITCH), g, T_SWITCH - 1, 0)
    assert torch.equal(one, two)


def test_sample_cli_writes_uint8_samples(tmp_path):
    config = tmp_path / "tiny.yaml"
    config.write_text("model_params:\n" + "".join(
        f"  {k}: {v}\n" for k, v in dict(SMALL, depth=3).items()))
    out = tmp_path / "out"
    subprocess.run(
        [sys.executable, "-m", "duodiff_tpu_torch.sample", "--device", "cpu",
         "--random_init", "--config_path", str(config), "--config_path_late",
         str(config), "--t_switch", "2", "--num_timesteps", "5", "--batch_size", "3",
         "--parametrization", "predict_noise", "--output_folder", str(out)],
        cwd=REPO, check=True, timeout=300, capture_output=True,
    )
    samples = np.load(out / "samples.npy")
    assert samples.shape == (3, 16, 16, 3) and samples.dtype == np.uint8
    assert (out / "statistics.txt").exists()
