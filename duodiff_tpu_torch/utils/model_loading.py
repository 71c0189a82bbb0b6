"""Config + checkpoint -> model (counterpart of
``duodiff_tpu/utils/model_loading.py``).

Checkpoints are reference-format ``.pth`` files: a state dict, or
``{"model_state_dict": ...}`` as ``export_torch_checkpoint`` writes. Orbax
checkpoint directories need JAX; convert them with the JAX package first.
"""

from __future__ import annotations

from typing import Optional

import torch

from duodiff_tpu_torch.config import UViTConfig, load_model_config
from duodiff_tpu_torch.models.uvit import UViT, init_uvit


def load_model(
    config_path,
    checkpoint_path: Optional[str] = None,
    *,
    device,
    dtype=torch.bfloat16,
    seed: int = 0,
    attn_impl: str = "plain",
    gelu_approx: bool = False,
) -> tuple[UViT, UViTConfig]:
    """Build the UViT a config file describes, with random weights from
    ``seed`` or the weights of ``checkpoint_path`` (loaded strictly), on
    ``device`` with compute dtype ``dtype``."""
    cfg = load_model_config(config_path)
    model = init_uvit(
        cfg, device="cpu", dtype=dtype,
        generator=torch.Generator().manual_seed(seed),
        attn_impl=attn_impl, gelu_approx=gelu_approx,
    )
    if checkpoint_path:
        state = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
        state = state.get("model_state_dict", state)
        model.load_state_dict(state, strict=True)
    return model.to(device), cfg
