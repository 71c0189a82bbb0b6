"""Model configuration (counterpart of ``duodiff_tpu/config.py``).

The ``configs/*.yaml`` files keep their flat ``model_params:`` block of
scalars. The machine that runs the port on the card has no PyYAML, so
:func:`load_model_config` reads that block with a small reader of its own:
``key: value`` lines, values typed as bool, int, float or a quoted string.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional


@dataclasses.dataclass(frozen=True)
class UViTConfig:
    """U-ViT hyperparameters; the same fields as ``duodiff_tpu.config.UViTConfig``."""

    img_size: int = 32
    patch_size: int = 2
    in_chans: int = 3
    embed_dim: int = 512
    depth: int = 13
    num_heads: int = 8
    mlp_ratio: float = 4.0
    qkv_bias: bool = False
    mlp_time_embed: bool = False
    num_classes: int = -1
    normalize_timesteps: bool = True
    qk_scale: Optional[float] = None
    conv: bool = True
    skip: bool = True
    classifier_type: str = "attention_probe"

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def extras(self) -> int:
        """1 time token, +1 label token when class-conditional."""
        return 2 if self.num_classes > 0 else 1

    @property
    def patch_dim(self) -> int:
        return self.patch_size**2 * self.in_chans

    @classmethod
    def from_dict(cls, d: dict) -> "UViTConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


def flagship_config() -> UViTConfig:
    """The CelebA-64 U-ViT (``configs/uvit_celeba.yaml``)."""
    return UViTConfig(
        img_size=64, patch_size=4, in_chans=3, embed_dim=512, depth=13,
        num_heads=8, mlp_ratio=4, qkv_bias=False, mlp_time_embed=False,
        num_classes=-1, normalize_timesteps=True,
    )


def _scalar(text: str):
    """One YAML scalar as the config files write it."""
    if text in ("True", "true"):
        return True
    if text in ("False", "false"):
        return False
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    try:
        return int(text)
    except ValueError:
        return float(text)


def _config_lines(path) -> list[str]:
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"Config file {path} does not exist")
    lines = (raw.split("#", 1)[0].rstrip() for raw in path.read_text().splitlines())
    return [line for line in lines if line.strip()]


def read_model_params(path) -> dict:
    """The flat ``model_params:`` block of a config file, as a dict."""
    params: dict = {}
    in_block = False
    for line in _config_lines(path):
        if not line[0].isspace():  # a top-level key opens or closes a block
            in_block = line == "model_params:"
            continue
        if in_block:
            key, sep, value = line.strip().partition(":")
            if not sep or not value.strip():
                raise ValueError(f"{path}: not a 'key: scalar' line: {line!r}")
            params[key.strip()] = _scalar(value.strip())
    if not params:
        raise ValueError(f"{path}: no model_params block")
    return params


def load_model_config(path) -> UViTConfig:
    """Config file -> :class:`UViTConfig` (the ``model_params`` block)."""
    return UViTConfig.from_dict(read_model_params(path))


def refuse_latent_config(path) -> None:
    """Raise for a config with an ``autoencoder`` block (latent diffusion):
    its model works on autoencoder latents, and the autoencoder is not ported
    yet, so training could not encode its images and sampling would write
    undecoded latents as if they were images."""
    top = {line.rstrip(":").strip() for line in _config_lines(path) if not line[0].isspace()}
    if "autoencoder" in top:
        raise NotImplementedError(
            f"{path}: this is a latent-diffusion config, and its autoencoder (the encoder "
            "that training needs and the decoder that turns sampled latents into images) is "
            "not ported yet (ROADMAP item 8)")


def merge_args_with_config(args, path):
    """Overlay a config file's ``model_params`` onto an argparse namespace,
    the file winning (the JAX package's merge). A latent-diffusion config is
    refused (:func:`refuse_latent_config`)."""
    refuse_latent_config(path)
    args.__dict__.update(read_model_params(path))
    return args
