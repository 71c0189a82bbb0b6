"""JAX parameter tree -> the port's state dict.

The port's parameters carry the names and shapes that
``duodiff_tpu.utils.torch_export.export_uvit`` emits, so the conversion is
that exporter plus ``torch.from_numpy``. The JAX package is imported inside
the function: only code that holds a JAX tree (the CPU tests) reaches it.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def uvit_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """A JAX UViT parameter tree (numpy or jax leaves) -> fp32 state dict."""
    from duodiff_tpu.utils.torch_export import export_uvit

    return {
        name: torch.from_numpy(np.ascontiguousarray(value))
        for name, value in export_uvit(params).items()
    }
