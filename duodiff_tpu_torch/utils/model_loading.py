"""Config + checkpoint -> model (counterpart of
``duodiff_tpu/utils/model_loading.py``).

Checkpoints are reference-format ``.pth`` files: a state dict, or
``{"model_state_dict": ...}`` as ``export_torch_checkpoint`` and the port's
trainer write, the latter with an ``ema_state_dict`` beside it when it ran
with ``--ema_decay``. Orbax checkpoint directories need JAX; convert them
with the JAX package first. :func:`load_backbone` fills an early-exit
model's backbone (``--load_backbone``); :func:`load_autoencoder` builds the
frozen KL autoencoder of a latent-diffusion config from a reference
``autoencoder_kl.pth``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import torch
from torch import nn

from duodiff_tpu_torch.config import AutoencoderConfig, UViTConfig, load_model_config
from duodiff_tpu_torch.models.autoencoder import FrozenAutoencoderKL
from duodiff_tpu_torch.models.early_exit import EarlyExitUViT, init_early_exit_uvit
from duodiff_tpu_torch.models.layers import INT8_IMPLS
from duodiff_tpu_torch.models.uvit import UViT, init_uvit
from duodiff_tpu_torch.training.checkpointer import CHECKPOINT_FILE
from duodiff_tpu_torch.utils.convert import early_exit_state_dict_from_reference
from duodiff_tpu_torch.utils.int8_scales import load_int8_scales, scales_dict_to_tuple


def load_model(
    config_path,
    checkpoint_path: Optional[str] = None,
    *,
    device,
    dtype=torch.bfloat16,
    seed: int = 0,
    attn_impl: str = "plain",
    gelu_approx: bool = False,
    int8_scales: Optional[str] = None,
    mlp_impl: str = "auto",
    use_ema: bool = False,
    early_exit: bool = False,
    grid=None,
) -> tuple[UViT | EarlyExitUViT, UViTConfig]:
    """Build the UViT a config file describes, with random weights from
    ``seed`` or the weights of ``checkpoint_path`` (loaded strictly), on
    ``device`` with compute dtype ``dtype``. ``int8_scales`` is a
    calibration JSON (``tools/calibrate_int8.py``): static MLP activation
    scales for the int8 sublayers, so it needs an int8 ``attn_impl``.
    ``use_ema`` loads the checkpoint's EMA shadow of the parameters in place
    of the live ones. ``early_exit`` builds the config's
    :class:`EarlyExitUViT` (its ``classifier_type`` names the probes) and
    loads a checkpoint under the reference's early-exit names, gathered into
    the port's stacks first. A latent-diffusion config builds its model on
    latents; its autoencoder is :func:`load_autoencoder`'s. With a ``grid``
    of tensor parallelism (``parallel/mesh.py``) the model keeps this rank's
    shard of the full weights (:meth:`UViT.shard_`)."""
    cfg = load_model_config(config_path)
    scales = None
    if int8_scales:
        if attn_impl not in INT8_IMPLS:
            raise ValueError(
                f"--int8_scales requires --attn_impl fused_int8 (got {attn_impl!r})"
            )
        scales = scales_dict_to_tuple(load_int8_scales(int8_scales), cfg.depth)
    init = init_early_exit_uvit if early_exit else init_uvit
    model = init(
        cfg, device="cpu", dtype=dtype,
        generator=torch.Generator().manual_seed(seed),
        attn_impl=attn_impl, gelu_approx=gelu_approx, int8_mlp_scales=scales,
        mlp_impl=mlp_impl,
    )
    if checkpoint_path:
        state = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
        if use_ema:
            if not isinstance(state.get("ema_state_dict"), dict):
                raise ValueError(f"{checkpoint_path} has no EMA params — the checkpoint was "
                                 "saved without --ema_decay")
            state = state["ema_state_dict"]
        else:
            state = state.get("model_state_dict", state)
        if early_exit:
            state = early_exit_state_dict_from_reference(state, cfg)
        model.load_state_dict(state, strict=True)
    if grid is not None:
        model.shard_(grid)
    return model.to(device), cfg


def load_backbone(path, backbone: nn.Module) -> None:
    """Fill ``backbone`` (an early-exit model's ``uvit``) from a
    reference-format ``.pth`` of a plain U-ViT (a state dict, or one under
    ``model_state_dict``), or from a checkpoint directory of the port's
    trainer, plain or early-exit (then its ``uvit.*`` keys). A missing,
    unexpected or mis-shaped key raises, naming it. A directory without the
    trainer's ``checkpoint.pth`` is taken for an Orbax checkpoint, which
    needs JAX: it is refused."""
    file = Path(path)
    if file.is_dir():
        if not (file / CHECKPOINT_FILE).exists():
            raise ValueError(
                f"--load_backbone {path}: a directory without {CHECKPOINT_FILE} is an Orbax "
                "checkpoint, which needs JAX; convert it to a .pth with the JAX package's "
                "duodiff_tpu.utils.torch_export.export_torch_checkpoint first")
        file = file / CHECKPOINT_FILE
    state = torch.load(file, map_location="cpu", weights_only=True)
    state = state.get("model_state_dict", state)
    if any(k.startswith("uvit.") for k in state):  # an early-exit checkpoint's backbone
        state = {k[len("uvit."):]: v for k, v in state.items() if k.startswith("uvit.")}
    want = backbone.state_dict()
    for name, t in want.items():
        if name not in state:
            raise KeyError(f"--load_backbone {path}: no {name!r}")
        if tuple(state[name].shape) != tuple(t.shape):
            raise ValueError(f"--load_backbone {path}: {name!r} has shape "
                             f"{tuple(state[name].shape)}, the model's is {tuple(t.shape)}")
    unexpected = sorted(set(state) - set(want))
    if unexpected:
        raise KeyError(f"--load_backbone {path}: keys the backbone does not have: "
                       f"{unexpected[:5]}")
    backbone.load_state_dict(state, strict=True)


AUTOENCODER_PREFIXES = ("encoder.", "decoder.", "quant_conv.", "post_quant_conv.")


def load_autoencoder(path, config: AutoencoderConfig, *, dtype=torch.bfloat16,
                     device) -> FrozenAutoencoderKL:
    """The frozen KL autoencoder ``config`` describes, with the weights of
    the reference-format ``.pth`` at ``path`` (a state dict, or one under
    ``model_state_dict``), on ``device`` with compute dtype ``dtype`` (bf16,
    the JAX package's default). Keys outside the autoencoder's four parts are
    ignored, as the JAX converter ignores them; a missing or mis-shaped key
    raises, naming it. A directory (an Orbax checkpoint) needs JAX and is
    refused, and so is a missing file."""
    file = Path(path)
    if file.is_dir():
        raise ValueError(
            f"autoencoder checkpoint {path} is a directory, an Orbax checkpoint, which needs "
            "JAX; cross its tree over with duodiff_tpu_torch.utils.convert.export_autoencoder "
            "and save the state dict as a .pth")
    if not file.exists():
        raise FileNotFoundError(
            f"the config's autoencoder_checkpoint_path {path!r} does not exist: latent "
            "diffusion needs the autoencoder_kl.pth of the config's autoencoder block")
    state = torch.load(file, map_location="cpu", weights_only=True)
    state = state.get("model_state_dict", state)
    state = {k: v for k, v in state.items() if k.startswith(AUTOENCODER_PREFIXES)}
    model = FrozenAutoencoderKL(config, dtype=dtype)
    for name, t in model.state_dict().items():
        if name not in state:
            raise KeyError(f"autoencoder checkpoint {path}: no {name!r}")
        if tuple(state[name].shape) != tuple(t.shape):
            raise ValueError(f"autoencoder checkpoint {path}: {name!r} has shape "
                             f"{tuple(state[name].shape)}, the model's is {tuple(t.shape)}")
    unexpected = sorted(set(state) - set(model.state_dict()))
    if unexpected:
        raise KeyError(f"autoencoder checkpoint {path}: keys the autoencoder does not have: "
                       f"{unexpected[:5]}")
    model.load_state_dict({k: v.float() for k, v in state.items()}, strict=True)
    return model.to(device).freeze()
