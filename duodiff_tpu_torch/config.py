"""Model configuration (counterpart of ``duodiff_tpu/config.py``).

The ``configs/*.yaml`` files keep a flat ``model_params:`` block and, for
latent diffusion, a flat ``autoencoder:`` block. The machine that runs the
port on the card has no PyYAML, so :func:`load_model_config` and
:func:`load_autoencoder_config` read those blocks with a small reader of
their own: ``key: value`` lines, values typed as bool, int, float, a quoted
or plain string, or a flow list of those (``ch_mult: [1, 2]``).
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


@dataclasses.dataclass(frozen=True)
class AutoencoderConfig:
    """The frozen KL autoencoder's block; the same fields and defaults as
    ``duodiff_tpu.config.AutoencoderConfig`` (the reference's
    ``get_autoencoder``: ch 128, ch_mult (1, 2, 4, 4), 2 res blocks, 4 latent
    channels, 256 x 256 images to 32 x 32 latents, scale 0.18215)."""

    autoencoder_checkpoint_path: str = ""
    ch: int = 128
    ch_mult: tuple = (1, 2, 4, 4)
    num_res_blocks: int = 2
    z_channels: int = 4
    embed_dim: int = 4
    resolution: int = 256
    in_channels: int = 3
    out_ch: int = 3
    scale_factor: float = 0.18215

    @classmethod
    def from_dict(cls, d: dict) -> "AutoencoderConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        known = {k: v for k, v in d.items() if k in fields}
        if "ch_mult" in known:
            known["ch_mult"] = tuple(known["ch_mult"])
        return cls(**known)


def flagship_config() -> UViTConfig:
    """The CelebA-64 U-ViT (``configs/uvit_celeba.yaml``)."""
    return UViTConfig(
        img_size=64, patch_size=4, in_chans=3, embed_dim=512, depth=13,
        num_heads=8, mlp_ratio=4, qkv_bias=False, mlp_time_embed=False,
        num_classes=-1, normalize_timesteps=True,
    )


# U-ViT-H/2 for latent ImageNet-256, the largest model of the U-ViT paper
# (github.com/baofff/U-ViT, configs/imagenet256_uvit_huge.py): D = 1152, 16
# heads of 72, hidden 4608, L = 256 patches + time and label tokens. Upstream's
# depth=28 counts the blocks around the mid block; this package counts every
# block (configs/uvit_imagenet256.yaml's 21 is upstream U-ViT-L/2's depth=20),
# so 29 here. DuoDiff's shallow model is the same at depth 3. No file under
# configs/ holds it: write_config writes one where it is wanted.
UVIT_H2_IMAGENET256 = {
    "img_size": 32, "patch_size": 2, "in_chans": 4, "embed_dim": 1152, "depth": 29,
    "num_heads": 16, "mlp_ratio": 4, "qkv_bias": False, "mlp_time_embed": False,
    "num_classes": 1001, "normalize_timesteps": False,
}


def write_config(path, model_params: dict, autoencoder_checkpoint_path=None) -> str:
    """Write a config file of the flat blocks :func:`read_block` reads: a
    ``model_params`` block and, for latent diffusion, an ``autoencoder``
    block naming the checkpoint (the autoencoder's other fields take their
    defaults). Returns the path as a string."""
    lines = ["model_params:", *(f"  {k}: {v}" for k, v in model_params.items())]
    if autoencoder_checkpoint_path is not None:
        lines += ["", "autoencoder:", f"  autoencoder_checkpoint_path: {autoencoder_checkpoint_path}"]
    Path(path).write_text("\n".join(lines) + "\n")
    return str(path)


def _scalar(text: str):
    """One YAML scalar as the config files write it: bool, int, float, a
    quoted string, or else the plain string (a path)."""
    if text in ("True", "true"):
        return True
    if text in ("False", "false"):
        return False
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    for kind in (int, float):
        try:
            return kind(text)
        except ValueError:
            pass
    return text


def _value(text: str):
    """A scalar, or a flow list of scalars (``[1, 2, 4]``) as a list."""
    if text.startswith("[") and text.endswith("]"):
        inner = text[1:-1].strip()
        return [_scalar(item.strip()) for item in inner.split(",")] if inner else []
    return _scalar(text)


def _config_lines(path) -> list[str]:
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"Config file {path} does not exist")
    lines = (raw.split("#", 1)[0].rstrip() for raw in path.read_text().splitlines())
    return [line for line in lines if line.strip()]


def read_block(path, name: str) -> Optional[dict]:
    """The flat top-level block ``name:`` of a config file as a dict, or None
    when the file has no such block."""
    params, in_block, found = {}, False, False
    for line in _config_lines(path):
        if not line[0].isspace():  # a top-level key opens or closes a block
            in_block = line == f"{name}:"
            found = found or in_block
            continue
        if in_block:
            key, sep, value = line.strip().partition(":")
            if not sep or not value.strip():
                raise ValueError(f"{path}: not a 'key: value' line: {line!r}")
            params[key.strip()] = _value(value.strip())
    return params if found else None


def read_model_params(path) -> dict:
    """The flat ``model_params:`` block of a config file, as a dict."""
    params = read_block(path, "model_params")
    if not params:
        raise ValueError(f"{path}: no model_params block")
    return params


def load_model_config(path) -> UViTConfig:
    """Config file -> :class:`UViTConfig` (the ``model_params`` block)."""
    return UViTConfig.from_dict(read_model_params(path))


def load_autoencoder_config(path) -> Optional[AutoencoderConfig]:
    """Config file -> its :class:`AutoencoderConfig` (the ``autoencoder``
    block, which marks a latent-diffusion model), or None without one."""
    block = read_block(path, "autoencoder")
    return None if block is None else AutoencoderConfig.from_dict(block)


def merge_args_with_config(args, path):
    """Overlay a config file's ``model_params`` and ``autoencoder`` block onto
    an argparse namespace, the file winning (the JAX package's merge). Where
    both blocks name a key (``embed_dim``), the model's value wins: the JAX
    merge lets the autoencoder's overwrite the model's width."""
    args.__dict__.update(read_block(path, "autoencoder") or {})
    args.__dict__.update(read_model_params(path))
    return args
