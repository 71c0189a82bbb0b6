"""JAX parameter tree -> the port's state dict.

The port's parameters carry the reference's state-dict names and shapes,
those the JAX package's ``export_uvit`` emits. :func:`export_uvit` here is
the port's own copy of that mapping, on a nested mapping of numpy (or
numpy-convertible) arrays, so the conversion needs nothing of the JAX
package:

- Dense kernel (in, out) -> Linear weight (out, in);
- flattened-patch matmul kernel (p*p*C, D), rows ordered (p1, p2, C) ->
  Conv2d patch embedding (D, C, p, p);
- final 3x3 conv HWIO -> OIHW;
- attention parameters stored in the "heads" layout (qkv kernel
  (D, 3, H, Dh), bias (3, H, Dh), proj kernel (H, Dh, D)) are flattened
  back to the packed layout first, by reshapes.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _linear(out: dict, node: Mapping, prefix: str) -> None:
    out[f"{prefix}.weight"] = _np(node["kernel"]).T
    if "bias" in node:
        out[f"{prefix}.bias"] = _np(node["bias"])


def _norm(out: dict, node: Mapping, prefix: str) -> None:
    out[f"{prefix}.weight"] = _np(node["scale"])
    out[f"{prefix}.bias"] = _np(node["bias"])


def _packed_attention(attn: Mapping) -> dict:
    """A block's attention parameters in the packed layout: qkv kernel
    (D, 3D) with bias (3D,), proj kernel (D, D)."""
    qkv, proj = dict(attn["qkv"]), dict(attn["proj"])
    kernel = _np(qkv["kernel"])
    if kernel.ndim == 4:  # (D, 3, H, Dh)
        d = kernel.shape[0]
        qkv["kernel"] = kernel.reshape(d, 3 * d)
        if "bias" in qkv:
            qkv["bias"] = _np(qkv["bias"]).reshape(3 * d)
    kernel = _np(proj["kernel"])
    if kernel.ndim == 3:  # (H, Dh, D)
        proj["kernel"] = kernel.reshape(kernel.shape[2], kernel.shape[2])
    return {"qkv": qkv, "proj": proj}


def _block(out: dict, node: Mapping, prefix: str) -> None:
    attn = _packed_attention(node["attn"])
    _norm(out, node["norm1"], f"{prefix}.norm1")
    _linear(out, attn["qkv"], f"{prefix}.attn.qkv")
    _linear(out, attn["proj"], f"{prefix}.attn.proj")
    _norm(out, node["norm2"], f"{prefix}.norm2")
    _linear(out, node["mlp"]["fc1"], f"{prefix}.mlp.fc1")
    _linear(out, node["mlp"]["fc2"], f"{prefix}.mlp.fc2")
    if "skip_linear" in node:
        _linear(out, node["skip_linear"], f"{prefix}.skip_linear")


def export_uvit(params: Mapping, in_chans: Optional[int] = None) -> dict[str, np.ndarray]:
    """A JAX UViT parameter tree -> the reference's state-dict names, fp32
    numpy. ``in_chans`` is needed only for a model without the final conv,
    where the patch kernel alone does not give it."""
    sd: dict[str, np.ndarray] = {}
    kernel = _np(params["patch_embed"]["proj"]["kernel"])
    d = kernel.shape[1]
    final = params.get("final_layer")
    if final is not None:
        in_chans = _np(final["kernel"]).shape[3]
    elif in_chans is None:
        raise ValueError("conv=False model: pass in_chans= (not derivable from params)")
    p = int(round((kernel.shape[0] // in_chans) ** 0.5))
    if p * p * in_chans != kernel.shape[0]:
        raise ValueError(f"patch kernel rows {kernel.shape[0]} != p*p*{in_chans}")
    sd["patch_embed.proj.weight"] = kernel.reshape(p, p, in_chans, d).transpose(3, 2, 0, 1)
    sd["patch_embed.proj.bias"] = _np(params["patch_embed"]["proj"]["bias"])
    if "time_embed" in params:
        _linear(sd, params["time_embed"]["fc1"], "time_embed.0")
        _linear(sd, params["time_embed"]["fc2"], "time_embed.2")
    if "label_emb" in params:
        sd["label_emb.weight"] = _np(params["label_emb"]["embedding"])
    sd["pos_embed"] = _np(params["pos_embed"])
    i = 0
    while f"in_blocks_{i}" in params:
        _block(sd, params[f"in_blocks_{i}"], f"in_blocks.{i}")
        i += 1
    _block(sd, params["mid_block"], "mid_block")
    i = 0
    while f"out_blocks_{i}" in params:
        _block(sd, params[f"out_blocks_{i}"], f"out_blocks.{i}")
        i += 1
    _norm(sd, params["norm"], "norm")
    _linear(sd, params["decoder_pred"], "decoder_pred")
    if final is not None:
        sd["final_layer.weight"] = _np(final["kernel"]).transpose(3, 2, 0, 1)
        sd["final_layer.bias"] = _np(final["bias"])
    return sd


def uvit_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """A JAX UViT parameter tree (numpy or jax leaves) -> fp32 state dict."""
    return {
        name: torch.from_numpy(np.array(value, dtype=np.float32, order="C"))  # a copy
        for name, value in export_uvit(params).items()
    }


_BLOCK_PARAM_ORDER = ("ln1_s", "ln1_b", "wqkv", "bqkv", "wp", "bp", "ln2_s", "ln2_b", "w1", "b1",
                      "w2", "b2")


def block_params_from_jax(p: Mapping) -> tuple:
    """The 12 torch-layout parameters of one block, in the order
    :class:`duodiff_tpu_torch.ops.block.FusedBlockFn` takes them, from
    JAX-layout arrays under the names above: the four kernels (in, out)
    become weights (out, in), vectors stay; ``bqkv`` may be None."""
    def one(name):
        a = p[name]
        if a is None:
            return None
        a = _np(a)
        return torch.from_numpy(np.ascontiguousarray(a.T if a.ndim == 2 else a)).float()

    return tuple(one(name) for name in _BLOCK_PARAM_ORDER)
