"""Static int8 MLP activation scales (counterpart of the JSON half of
``duodiff_tpu/utils/int8_calib.py``).

A scales file, as ``tools/calibrate_int8.py`` writes it, holds
``{"blocks": {block_name: [sx, sh]}, "meta": {...}}``: per block the
calibrated amax of the post-LayerNorm (``sx``) and post-GELU (``sh``)
activations of its MLP sublayer. JSON only: the JAX module cannot be
imported where the port runs (its package imports JAX).
"""

from __future__ import annotations

import json
from typing import Dict, Tuple


def load_int8_scales(path) -> Dict[str, Tuple[float, float]]:
    """Scales file -> {block_name: (sx, sh)}."""
    with open(path) as f:
        data = json.load(f)
    return {k: (float(v[0]), float(v[1])) for k, v in data["blocks"].items()}


def scales_dict_to_tuple(scales: Dict[str, Tuple[float, float]], depth: int) -> tuple:
    """{block_name: (sx, sh)} -> block-execution-order tuple for
    ``UViT(int8_mlp_scales=...)`` (in_0..in_{k-1}, mid, out_0..out_{k-1})."""
    k = depth // 2
    names = (
        [f"in_blocks_{i}" for i in range(k)]
        + ["mid_block"]
        + [f"out_blocks_{i}" for i in range(k)]
    )
    missing = [n for n in names if n not in scales]
    if missing:
        raise ValueError(
            f"int8 scales file is missing blocks {missing} "
            f"(has {sorted(scales)}) — calibrated for a different depth?"
        )
    return tuple(tuple(scales[n]) for n in names)
