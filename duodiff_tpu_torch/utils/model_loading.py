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
from duodiff_tpu_torch.models.layers import INT8_IMPLS
from duodiff_tpu_torch.models.uvit import UViT, init_uvit
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
) -> tuple[UViT, UViTConfig]:
    """Build the UViT a config file describes, with random weights from
    ``seed`` or the weights of ``checkpoint_path`` (loaded strictly), on
    ``device`` with compute dtype ``dtype``. ``int8_scales`` is a
    calibration JSON (``tools/calibrate_int8.py``): static MLP activation
    scales for the int8 sublayers, so it needs an int8 ``attn_impl``."""
    cfg = load_model_config(config_path)
    scales = None
    if int8_scales:
        if attn_impl not in INT8_IMPLS:
            raise ValueError(
                f"--int8_scales requires --attn_impl fused_int8 (got {attn_impl!r})"
            )
        scales = scales_dict_to_tuple(load_int8_scales(int8_scales), cfg.depth)
    model = init_uvit(
        cfg, device="cpu", dtype=dtype,
        generator=torch.Generator().manual_seed(seed),
        attn_impl=attn_impl, gelu_approx=gelu_approx, int8_mlp_scales=scales,
        mlp_impl=mlp_impl,
    )
    if checkpoint_path:
        state = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
        state = state.get("model_state_dict", state)
        model.load_state_dict(state, strict=True)
    return model.to(device), cfg
