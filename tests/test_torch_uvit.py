"""The port's UViT (duodiff_tpu_torch.models) against the JAX UViT on the
same weights: JAX parameters cross over through export_uvit, load with
strict=True, and the fp32 forward matches the JAX model with
attn_impl="fused" (its Pallas sublayer kernels in interpret mode on the
CPU) to 1e-4. Also the port's config reader, and that importing the port
pulls in no JAX, flax, PyYAML or Pillow."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duodiff_tpu.config import UViTConfig as JaxConfig
from duodiff_tpu.config import load_model_config as jax_load_model_config
from duodiff_tpu.models.uvit import init_uvit as jax_init_uvit
from duodiff_tpu.utils.torch_export import export_torch_checkpoint
from duodiff_tpu_torch.config import UViTConfig, load_model_config
from duodiff_tpu_torch.models.uvit import UViT, init_uvit
from duodiff_tpu_torch.utils.convert import uvit_state_dict_from_jax
from duodiff_tpu_torch.utils.model_loading import load_model

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(img_size=16, patch_size=4, in_chans=3, embed_dim=64, num_heads=4,
             mlp_ratio=4)
CONFIGS = {
    "depth5": dict(SMALL, depth=5),
    "depth3_qkvbias_timemlp": dict(SMALL, depth=3, qkv_bias=True, mlp_time_embed=True),
}


def _jax_pair(kw, seed=0):
    """(JAX fused model, its params with every leaf perturbed so biases and
    LayerNorm affines are not at their init values)."""
    model, params = jax_init_uvit(JaxConfig(**kw), jax.random.PRNGKey(seed),
                                  dtype=jnp.float32, attn_impl="fused")
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rng.randn(*a.shape).astype(np.float32), params)
    return model, params


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_state_dict_loads_strict(name):
    kw = CONFIGS[name]
    _, params = _jax_pair(kw)
    model = UViT(UViTConfig(**kw), dtype=torch.float32)
    state = uvit_state_dict_from_jax(params)
    model.load_state_dict(state, strict=True)
    for key, value in model.state_dict().items():
        assert value.dtype == torch.float32
        assert torch.equal(value, state[key]), key


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_jax_fused(name):
    kw = CONFIGS[name]
    jmodel, params = _jax_pair(kw)
    rng = np.random.RandomState(1)
    x = rng.randn(2, 16, 16, 3).astype(np.float32)
    t = np.array([3.0, 700.0], np.float32)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    model = UViT(UViTConfig(**kw), dtype=torch.float32, attn_impl="fused")
    model.load_state_dict(uvit_state_dict_from_jax(params), strict=True)
    model.pack_for_kernels()
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert got.shape == want.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_pth_checkpoint_loads_through_model_loading(tmp_path):
    kw = CONFIGS["depth5"]
    _, params = _jax_pair(kw)
    export_torch_checkpoint(params, tmp_path / "model.pth")
    config = tmp_path / "model.yaml"
    config.write_text("model_params:\n" + "".join(
        f"  {k}: {v}\n" for k, v in kw.items()))
    model, cfg = load_model(config, tmp_path / "model.pth", device="cpu",
                            dtype=torch.float32)
    assert cfg == UViTConfig(**kw)
    for key, value in uvit_state_dict_from_jax(params).items():
        assert torch.equal(model.state_dict()[key], value), key


def test_unpacked_model_refuses_to_run():
    """Outside training (eval mode, or no grad) the blocks read packed
    operands; in training mode with grad they read the live parameters."""
    model = init_uvit(UViTConfig(**CONFIGS["depth5"]), device="cpu",
                      generator=torch.Generator().manual_seed(0))
    x, t = torch.zeros(1, 16, 16, 3), torch.zeros(1)
    with pytest.raises(RuntimeError, match="pack_for_kernels"):
        model.eval()(x, t)
    with pytest.raises(RuntimeError, match="pack_for_kernels"), torch.no_grad():
        model.train()(x, t)
    assert model.train()(x, t).requires_grad


def test_random_init_is_seeded():
    cfg = UViTConfig(**CONFIGS["depth3_qkvbias_timemlp"])
    a, b = (init_uvit(cfg, device="cpu", generator=torch.Generator().manual_seed(7))
            for _ in range(2))
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    std = a.in_blocks[0].mlp["fc1"].weight.std().item()
    assert 0.015 < std < 0.025  # trunc-normal(0.02)


@pytest.mark.parametrize(
    "path", sorted(p.name for p in (REPO / "configs").glob("*.yaml")))
def test_config_reader_matches_jax(path):
    want, _ = jax_load_model_config(REPO / "configs" / path)
    assert dataclasses.asdict(load_model_config(REPO / "configs" / path)) == want.to_dict()


def test_config_reader_rejects_nested_values(tmp_path):
    bad = tmp_path / "bad.yaml"
    bad.write_text("model_params:\n  ch_mult:\n    - 1\n")
    with pytest.raises(ValueError):
        load_model_config(bad)


def test_port_imports_no_jax_yaml_or_pil():
    """Every module of the port, the block-caching, int8 and training ones
    included, imports without JAX, flax, PyYAML, Pillow or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import duodiff_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'duodiff_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = {'jax', 'jaxlib', 'flax', 'yaml', 'PIL', 'duodiff_tpu'}\n"
        "print(sorted({n.split('.')[0] for n in sys.modules} & bad))\n"
        "print(' '.join(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    bad, imported = out.stdout.strip().splitlines()
    assert bad == "[]", out.stdout + out.stderr
    for name in ("ops.block_int8", "diffusion.cache_schedule", "utils.int8_scales",
                 "diffusion.sampling", "sample", "train", "training.trainer",
                 "training.train_state", "training.losses", "training.lr",
                 "training.checkpointer", "data.sampler", "data.loader", "data.datasets",
                 "data.synthetic", "utils.train_utils"):
        assert f"duodiff_tpu_torch.{name}" in imported.split(), name
