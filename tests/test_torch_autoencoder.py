"""The port's frozen KL autoencoder (``duodiff_tpu_torch.models.autoencoder``)
against the JAX package's ``FrozenAutoencoderKL``, on the same weights: a
JAX ``init_autoencoder`` tree, perturbed so that biases and GroupNorm scales
matter, crossed over through ``utils/convert.py:export_autoencoder``. Also
the names against the JAX converter, ``load_autoencoder``'s refusals, and
the config reader and merge against the JAX package's on every committed
config.

Tolerances, each with its reason:
- fp32: |port - JAX| <= 1e-5 * max|JAX| + 1e-5 * |JAX| (the same
  convolutions in another summation order; measured ~1.3e-6 of the largest
  value on the tiny config);
- bf16: 5e-2 + 5e-2 * |JAX|, the JAX tests' bf16 bound: both round at the
  same points, but cuDNN / oneDNN add a conv's bias before rounding its
  output where XLA rounds twice, and an ulp there moves later GroupNorms;
- ``sample_latent`` on injected noise (JAX's own draw): 1e-6 relative, the
  same fp32 arithmetic;
- the name round trip: bit-equal.
"""

import dataclasses
from argparse import Namespace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duodiff_tpu.config import AutoencoderConfig as JaxAutoencoderConfig
from duodiff_tpu.config import load_config
from duodiff_tpu.config import merge_args_with_config as jax_merge
from duodiff_tpu.models.autoencoder import FrozenAutoencoderKL as JaxAutoencoder
from duodiff_tpu.models.autoencoder import init_autoencoder as jax_init_autoencoder
from duodiff_tpu.utils.torch_convert import convert_autoencoder_checkpoint
from duodiff_tpu_torch.config import (
    AutoencoderConfig,
    load_autoencoder_config,
    merge_args_with_config,
    read_model_params,
)
from duodiff_tpu_torch.models.autoencoder import FrozenAutoencoderKL, init_autoencoder
from duodiff_tpu_torch.utils.convert import export_autoencoder
from duodiff_tpu_torch.utils.model_loading import load_autoencoder

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
TINY = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=4, embed_dim=4, resolution=32)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# the list-valued block of tests/test_imagenet256_e2e.py
E2E_YAML = """model_params:
  img_size: 16
  patch_size: 2
  in_chans: 4
  embed_dim: 32
  depth: 3
  num_heads: 4
  mlp_ratio: 4
  qkv_bias: False
  mlp_time_embed: False
  num_classes: 3
  normalize_timesteps: False

autoencoder:
  autoencoder_checkpoint_path: {ae_path}
  ch: 32
  ch_mult: [1, 2]
  num_res_blocks: 1
  z_channels: 4
  embed_dim: 4
  resolution: 32
"""


def _jax_tree(cfg: dict, seed: int = 0, image_size: int = 32):
    """A JAX autoencoder tree as numpy, its zero biases and unit scales
    moved by 0.02 N(0, 1)."""
    _, params = jax_init_autoencoder(JaxAutoencoderConfig(**cfg), jax.random.PRNGKey(seed),
                                     image_size=image_size)
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rng.randn(*a.shape).astype(np.float32), params)


def _port(params, cfg: dict, dtype) -> FrozenAutoencoderKL:
    model = FrozenAutoencoderKL(AutoencoderConfig(**cfg), dtype=dtype)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           export_autoencoder(params).items()}, strict=True)
    return model.freeze()


def _apply(params, cfg: dict, dtype, method: str, *args):
    jmodel = JaxAutoencoder(config=JaxAutoencoderConfig(**cfg), dtype=dtype)
    return np.asarray(jmodel.apply({"params": params}, *args, method=getattr(jmodel, method)),
                      np.float32)


def _check(got: np.ndarray, want: np.ndarray, dtype_name: str) -> None:
    assert got.shape == want.shape
    if dtype_name == "float32":
        bound = 1e-5 * np.abs(want).max() + 1e-5 * np.abs(want)
    else:
        bound = 5e-2 + 5e-2 * np.abs(want)
    worst = (np.abs(got - want) - bound).max()
    assert worst <= 0, f"max |port - JAX| exceeds the bound by {worst}"


@pytest.fixture(scope="module")
def tiny():
    return _jax_tree(TINY)


@pytest.fixture(scope="module")
def default():
    return _jax_tree({}, seed=3)


def _images(seed=0, size=32):
    return np.random.RandomState(seed).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_encode_moments_matches_jax(tiny, dtype_name):
    jdt, tdt = DTYPES[dtype_name]
    x = _images()
    want = _apply(tiny, TINY, jdt, "encode_moments", jnp.asarray(x))
    with torch.no_grad():
        got = _port(tiny, TINY, tdt).encode_moments(torch.from_numpy(x))
    assert got.dtype == tdt and got.shape == (2, 16, 16, 8)
    _check(got.float().numpy(), want, dtype_name)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_sample_latent_matches_jax_on_injected_noise(tiny, dtype_name):
    """JAX's ``sample_latent`` with a key against the port's with JAX's
    normal draw of that key injected, on the same moments (wide logvars, so
    the clip at -30 and 20 acts)."""
    jdt, tdt = DTYPES[dtype_name]
    rng = np.random.RandomState(1)
    moments = rng.randn(2, 16, 16, 8).astype(np.float32)
    moments[..., 4:] *= 30.0
    key = jax.random.PRNGKey(7)
    want = _apply(tiny, TINY, jdt, "sample_latent", jnp.asarray(moments, jdt), key)
    noise = np.asarray(jax.random.normal(key, (2, 16, 16, 4), jnp.float32))
    with torch.no_grad():
        got = _port(tiny, TINY, tdt).sample_latent(torch.from_numpy(moments).to(tdt),
                                                    noise=torch.from_numpy(noise.copy()))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_encode_draws_from_the_generator(tiny, dtype_name):
    """``encode`` is ``sample_latent(encode_moments(x))`` with the noise drawn
    from the generator: equal generators give equal latents, others not."""
    _, tdt = DTYPES[dtype_name]
    model = _port(tiny, TINY, tdt)
    x = torch.from_numpy(_images(2))
    with torch.no_grad():
        a, b, c = (model.encode(x, torch.Generator().manual_seed(s)) for s in (1, 1, 2))
        noise = torch.randn((2, 16, 16, 4), generator=torch.Generator().manual_seed(1))
        by_hand = model.sample_latent(model.encode_moments(x), noise=noise)
    assert torch.equal(a, b) and not torch.equal(a, c) and torch.equal(a, by_hand)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_decode_matches_jax(tiny, dtype_name):
    jdt, tdt = DTYPES[dtype_name]
    z = np.random.RandomState(2).randn(2, 16, 16, 4).astype(np.float32) * 0.5
    want = _apply(tiny, TINY, jdt, "decode", jnp.asarray(z))
    with torch.no_grad():
        got = _port(tiny, TINY, tdt).decode(torch.from_numpy(z))
    assert got.dtype == torch.float32 and got.shape == (2, 32, 32, 3)
    _check(got.numpy(), want, dtype_name)


@pytest.mark.parametrize("method", ["encode_moments", "decode"])
def test_default_config_matches_jax_at_32(default, method):
    """The reference's configuration (ch 128, ch_mult (1, 2, 4, 4), two res
    blocks) at a 32 x 32 input, 4 x 4 latents, fp32."""
    params = default
    rng = np.random.RandomState(4)
    x = (rng.uniform(-1, 1, (1, 32, 32, 3)) if method == "encode_moments"
         else rng.randn(1, 4, 4, 4) * 0.5).astype(np.float32)
    want = _apply(params, {}, jnp.float32, method, jnp.asarray(x))
    with torch.no_grad():
        got = getattr(_port(params, {}, torch.float32), method)(torch.from_numpy(x)).numpy()
    assert got.shape == ((1, 4, 4, 8) if method == "encode_moments" else (1, 32, 32, 3))
    _check(got, want, "float32")


@pytest.mark.parametrize("which", ["tiny", "default"])
def test_names_round_trip_through_the_jax_converter(tmp_path, tiny, default, which):
    """A JAX tree through ``export_autoencoder`` and ``torch.save``, read by
    the JAX package's ``convert_autoencoder_checkpoint``: the same tree, to
    the bit. The port's module takes the same names strictly."""
    cfg, params = (TINY, tiny) if which == "tiny" else ({}, default)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in export_autoencoder(params).items()}
    assert set(sd) == set(FrozenAutoencoderKL(AutoencoderConfig(**cfg)).state_dict())
    torch.save(sd, tmp_path / "ae.pth")
    back = convert_autoencoder_checkpoint(tmp_path / "ae.pth", params)
    flat, tree = jax.tree_util.tree_flatten(params)
    back_flat, back_tree = jax.tree_util.tree_flatten(back)
    assert tree == back_tree
    for a, b in zip(flat, back_flat):
        assert np.asarray(b).dtype == np.float32 and np.array_equal(np.asarray(a), np.asarray(b))


def test_load_autoencoder_reads_reference_files(tmp_path, tiny):
    """A plain state dict and one under ``model_state_dict`` beside keys
    outside the autoencoder (a discriminator's, as the released file may
    hold) load to the same model, frozen, in the compute dtype."""
    sd = {k: torch.from_numpy(np.array(v)) for k, v in export_autoencoder(tiny).items()}
    torch.save(sd, tmp_path / "plain.pth")
    torch.save({"model_state_dict": {**sd, "loss.logvar": torch.zeros(())}},
               tmp_path / "wrapped.pth")
    cfg = AutoencoderConfig(**TINY)
    z = torch.from_numpy(np.random.RandomState(6).randn(1, 16, 16, 4).astype(np.float32))
    outs = []
    for name in ("plain", "wrapped"):
        model = load_autoencoder(tmp_path / f"{name}.pth", cfg, dtype=torch.bfloat16,
                                 device="cpu")
        assert not model.training and not any(p.requires_grad for p in model.parameters())
        assert model.decoder.conv_in.weight.dtype == torch.bfloat16
        assert model.decoder.norm_out.weight.dtype == torch.float32
        with torch.no_grad():
            outs.append(model.decode(z))
    assert torch.equal(*outs)


REFUSALS = {
    "directory": (ValueError, "Orbax checkpoint, which needs JAX"),
    "missing_file": (FileNotFoundError, "autoencoder_checkpoint_path"),
    "missing_key": (KeyError, "decoder.conv_out.bias"),
    "wrong_shape": (ValueError, "quant_conv.weight' has shape"),
    "unexpected_key": (KeyError, "encoder.down.0.attn.0.q.weight"),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_load_autoencoder_refusals(tmp_path, tiny, name):
    sd = {k: torch.from_numpy(np.array(v)) for k, v in export_autoencoder(tiny).items()}
    path = tmp_path / "ae.pth"
    if name == "directory":
        path.mkdir()
    elif name == "missing_key":
        del sd["decoder.conv_out.bias"]
    elif name == "wrong_shape":
        sd["quant_conv.weight"] = torch.zeros(8, 8, 1, 1)[:4]
    elif name == "unexpected_key":
        sd["encoder.down.0.attn.0.q.weight"] = torch.zeros(1)
    if name not in ("directory", "missing_file"):
        torch.save(sd, path)
    error, words = REFUSALS[name]
    with pytest.raises(error, match=words):
        load_autoencoder(path, AutoencoderConfig(**TINY), device="cpu")


def test_init_autoencoder_draws_from_the_generator():
    cfg = AutoencoderConfig(**TINY)
    a, b, c = (init_autoencoder(cfg, generator=torch.Generator().manual_seed(s)).state_dict()
               for s in (0, 0, 1))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder.conv_in.weight"], c["encoder.conv_in.weight"])
    assert torch.equal(a["encoder.conv_in.bias"], torch.zeros(32))
    assert torch.equal(a["encoder.norm_out.weight"], torch.ones(64))


def _config_files(tmp_path) -> list:
    e2e = tmp_path / "e2e.yaml"
    e2e.write_text(E2E_YAML.format(ae_path="./checkpoints/ae_tiny.pth"))
    return sorted(REPO.glob("configs/*.yaml")) + [e2e]


@pytest.mark.parametrize("name", sorted(p.name for p in REPO.glob("configs/*.yaml"))
                         + ["e2e_list_block"])
def test_config_reader_matches_jax(tmp_path, name):
    """The autoencoder block as ``AutoencoderConfig`` (None without one) and
    the model block, against JAX's ``from_dict(load_config(...))``."""
    path = {p.name: p for p in _config_files(tmp_path)}.get(name, tmp_path / "e2e.yaml")
    raw = load_config(path)
    want = (JaxAutoencoderConfig.from_dict(raw["autoencoder"]) if "autoencoder" in raw
            else None)
    got = load_autoencoder_config(path)
    if want is None:
        assert got is None
    else:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert read_model_params(path) == raw["model_params"]
    if name.endswith("imagenet256.yaml") or name.endswith("imagenet256_3.yaml"):
        assert got == AutoencoderConfig(
            autoencoder_checkpoint_path="./checkpoints/autoencoder/autoencoder_kl.pth")


@pytest.mark.parametrize("name", ["uvit_imagenet256.yaml", "e2e_list_block"])
def test_merge_overlays_the_autoencoder_block(tmp_path, name):
    """The merge puts both blocks on the namespace as JAX's does, except that
    where both name a key (the e2e block's ``embed_dim: 4``) the model's
    value stays: the JAX merge would turn the model's width into 4."""
    path = {p.name: p for p in _config_files(tmp_path)}.get(name, tmp_path / "e2e.yaml")
    got = merge_args_with_config(Namespace(embed_dim=512, seed=1), path)
    want = jax_merge(Namespace(embed_dim=512, seed=1), load_config(path))
    raw = load_config(path)
    clash = set(raw["model_params"]) & set(raw["autoencoder"])
    assert {k: v for k, v in vars(got).items() if k not in clash} == {
        k: (list(v) if isinstance(v, tuple) else v) for k, v in vars(want).items()
        if k not in clash}
    for key in clash:
        assert getattr(got, key) == raw["model_params"][key] != getattr(want, key)
    assert got.embed_dim == raw["model_params"]["embed_dim"]
