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

import re
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


# --- the early-exit U-ViT ------------------------------------------------------


def _conv(out: dict, node: Mapping, prefix: str) -> None:
    out[f"{prefix}.weight"] = _np(node["kernel"]).transpose(3, 2, 0, 1)
    out[f"{prefix}.bias"] = _np(node["bias"])


def _unstack(tree, depth: int) -> list:
    """A tree of arrays stacked on a leading axis -> ``depth`` trees of slices."""
    def one(node, i):
        if isinstance(node, Mapping):
            return {k: one(v, i) for k, v in node.items()}
        return _np(node)[i]

    return [one(tree, i) for i in range(depth)]


def head_names(depth: int) -> list[str]:
    """The reference's output-head names in probe-point order."""
    k = depth // 2
    return ([f"in_blocks_heads.{i}" for i in range(k)] + ["mid_block_head"]
            + [f"out_blocks_heads.{i}" for i in range(depth - k - 1)])


def export_early_exit_uvit(params: Mapping, in_chans: Optional[int] = None
                           ) -> dict[str, np.ndarray]:
    """A JAX EarlyExitUViT tree ({uvit, heads, probes}, heads and per-layer
    probes stacked on a leading depth axis, per-timestep probes as tables)
    -> the reference's state-dict names, fp32 numpy: ``uvit.*``, one
    ``in_blocks_heads.{i}`` / ``mid_block_head`` / ``out_blocks_heads.{i}``
    a head, and ``matrix.{i}`` a per-layer probe, ``matrix.{t}`` /
    ``matrix.{i}, {t}`` a per-timestep one."""
    sd = {f"uvit.{k}": v for k, v in export_uvit(params["uvit"], in_chans).items()}
    heads = params["heads"]
    depth = int(np.shape(heads["norm"]["scale"])[0])
    for name, head in zip(head_names(depth), _unstack(heads, depth)):
        _norm(sd, head["norm"], f"{name}.norm")
        _linear(sd, head["decoder_pred"], f"{name}.decoder_pred")
        _conv(sd, head["final_layer"], f"{name}.final_layer")
    probes = params["probes"]
    if "classifier" in probes:  # MLPProbe, stacked
        for i, probe in enumerate(_unstack(probes, depth)):
            _linear(sd, probe["classifier"], f"matrix.{i}.classifier.0")
    elif "q" in probes:  # AttentionProbe, stacked
        for i, probe in enumerate(_unstack(probes, depth)):
            sd[f"matrix.{i}.q"] = probe["q"]
            _linear(sd, probe["weight_kv"], f"matrix.{i}.weight_kv")
            _linear(sd, probe["cls_fc1"], f"matrix.{i}.classification.0")
            _linear(sd, probe["cls_fc2"], f"matrix.{i}.classification.2")
    elif "weight" in probes:  # per-timestep tables
        w, b = _np(probes["weight"]), _np(probes["bias"])
        if w.ndim == 3:  # (depth, T, D)
            for i in range(w.shape[0]):
                for t in range(w.shape[1]):
                    sd[f"matrix.{i}, {t}.classifier.0.weight"] = w[i, t][None]
                    sd[f"matrix.{i}, {t}.classifier.0.bias"] = b[i, t]
        else:  # (T, D)
            for t in range(w.shape[0]):
                sd[f"matrix.{t}.classifier.0.weight"] = w[t][None]
                sd[f"matrix.{t}.classifier.0.bias"] = b[t]
    else:
        raise ValueError(f"unrecognized probe tree keys: {list(probes)}")
    return sd


def _take(sd: dict, name: str):
    """Remove and return ``sd[name]`` as an fp32 tensor; a missing name raises
    KeyError naming it."""
    if name not in sd:
        raise KeyError(f"early-exit state dict has no {name!r}")
    return torch.as_tensor(sd.pop(name)).float()


def early_exit_state_dict_from_reference(state: Mapping, config) -> dict[str, torch.Tensor]:
    """A state dict under the reference's EarlyExitUViT names -> the port's
    (:class:`duodiff_tpu_torch.models.early_exit.EarlyExitUViT`): the
    ``uvit.*`` keys as they are, the per-head and per-probe modules gathered
    into their stacks, the per-timestep modules (1,000 or depth x 1,000 of
    them) into their tables. Keys that fit none of these are passed through
    untouched, so a strict ``load_state_dict`` names them."""
    from duodiff_tpu_torch.models.early_exit import PROBE_TIMESTEPS

    sd = dict(state)
    depth = config.depth
    out = {k: sd.pop(k) for k in [k for k in sd if k.startswith("uvit.")]}

    def stack(fmt, suffix, count=depth, reshape=None):
        rows = [_take(sd, fmt.format(i) + suffix) for i in range(count)]
        return torch.stack([r if reshape is None else r.reshape(reshape) for r in rows])

    names = head_names(depth)
    parts = {"norm_weight": ".norm.weight", "norm_bias": ".norm.bias",
             "decoder_weight": ".decoder_pred.weight", "decoder_bias": ".decoder_pred.bias",
             "conv_weight": ".final_layer.weight", "conv_bias": ".final_layer.bias"}
    for key, suffix in parts.items():
        out[f"heads.{key}"] = torch.stack([_take(sd, name + suffix) for name in names])
    kind, d = config.classifier_type, config.embed_dim
    if kind == "mlp_probe_per_layer":
        out["probes.weight"] = stack("matrix.{}", ".classifier.0.weight", reshape=(d,))
        out["probes.bias"] = stack("matrix.{}", ".classifier.0.bias", reshape=())
    elif kind == "attention_probe":
        out["probes.q"] = stack("matrix.{}", ".q", reshape=(d,))
        out["probes.kv_weight"] = stack("matrix.{}", ".weight_kv.weight")
        out["probes.kv_bias"] = stack("matrix.{}", ".weight_kv.bias")
        out["probes.fc1_weight"] = stack("matrix.{}", ".classification.0.weight")
        out["probes.fc1_bias"] = stack("matrix.{}", ".classification.0.bias")
        out["probes.fc2_weight"] = stack("matrix.{}", ".classification.2.weight", reshape=(d,))
        out["probes.fc2_bias"] = stack("matrix.{}", ".classification.2.bias", reshape=())
    elif kind == "mlp_probe_per_timestep":
        out["probes.weight"] = stack("matrix.{}", ".classifier.0.weight", PROBE_TIMESTEPS, (d,))
        out["probes.bias"] = stack("matrix.{}", ".classifier.0.bias", PROBE_TIMESTEPS, ())
    elif kind == "mlp_probe_per_layer_per_timestep":
        for key, suffix, shape in (("weight", ".classifier.0.weight", (d,)),
                                   ("bias", ".classifier.0.bias", ())):
            out[f"probes.{key}"] = torch.stack([
                stack(f"matrix.{i}, {{}}", suffix, PROBE_TIMESTEPS, shape) for i in range(depth)])
    else:
        raise ValueError(f"Unknown classifier type: {kind}")
    out.update(sd)  # whatever is left: unexpected keys for the strict load
    return out


def early_exit_state_dict_to_reference(state: Mapping, config) -> dict[str, torch.Tensor]:
    """The inverse of :func:`early_exit_state_dict_from_reference`: the
    port's EarlyExitUViT state dict (its stacks and tables) -> the
    reference's names and shapes, those :func:`export_early_exit_uvit` emits
    (``in_blocks_heads.{i}``, ``mid_block_head``, ``out_blocks_heads.{i}``
    and ``matrix.{i}`` / ``matrix.{t}`` / ``matrix.{i}, {t}``), fp32 on the
    CPU. The ``uvit.*`` keys pass as they are; any other key raises."""
    from duodiff_tpu_torch.models.early_exit import PROBE_TIMESTEPS

    sd = {k: v.detach().float().cpu() for k, v in state.items()}
    out = {k: sd.pop(k) for k in [k for k in sd if k.startswith("uvit.")]}
    depth, d = config.depth, config.embed_dim
    heads = {key: sd.pop(f"heads.{key}") for key in
             ("norm_weight", "norm_bias", "decoder_weight", "decoder_bias", "conv_weight",
              "conv_bias")}
    for i, name in enumerate(head_names(depth)):
        out[f"{name}.norm.weight"] = heads["norm_weight"][i]
        out[f"{name}.norm.bias"] = heads["norm_bias"][i]
        out[f"{name}.decoder_pred.weight"] = heads["decoder_weight"][i]
        out[f"{name}.decoder_pred.bias"] = heads["decoder_bias"][i]
        out[f"{name}.final_layer.weight"] = heads["conv_weight"][i]
        out[f"{name}.final_layer.bias"] = heads["conv_bias"][i]
    kind = config.classifier_type

    def probe(key):
        return sd.pop(f"probes.{key}")

    if kind == "mlp_probe_per_layer":
        w, b = probe("weight"), probe("bias")
        for i in range(depth):
            out[f"matrix.{i}.classifier.0.weight"] = w[i].reshape(1, d)
            out[f"matrix.{i}.classifier.0.bias"] = b[i].reshape(1)
    elif kind == "attention_probe":
        p = {key: probe(key) for key in ("q", "kv_weight", "kv_bias", "fc1_weight", "fc1_bias",
                                         "fc2_weight", "fc2_bias")}
        for i in range(depth):
            out[f"matrix.{i}.q"] = p["q"][i].reshape(1, 1, 1, d)
            out[f"matrix.{i}.weight_kv.weight"] = p["kv_weight"][i]
            out[f"matrix.{i}.weight_kv.bias"] = p["kv_bias"][i]
            out[f"matrix.{i}.classification.0.weight"] = p["fc1_weight"][i]
            out[f"matrix.{i}.classification.0.bias"] = p["fc1_bias"][i]
            out[f"matrix.{i}.classification.2.weight"] = p["fc2_weight"][i].reshape(1, d)
            out[f"matrix.{i}.classification.2.bias"] = p["fc2_bias"][i].reshape(1)
    elif kind in ("mlp_probe_per_timestep", "mlp_probe_per_layer_per_timestep"):
        w, b = probe("weight"), probe("bias")
        tables = ([(f"matrix.{i}, {{}}", w[i], b[i]) for i in range(depth)]
                  if kind == "mlp_probe_per_layer_per_timestep" else [("matrix.{}", w, b)])
        for fmt, wt, bt in tables:
            for t in range(PROBE_TIMESTEPS):
                out[f"{fmt.format(t)}.classifier.0.weight"] = wt[t].reshape(1, d)
                out[f"{fmt.format(t)}.classifier.0.bias"] = bt[t].reshape(1)
    else:
        raise ValueError(f"Unknown classifier type: {kind}")
    if sd:
        raise KeyError(f"not an early-exit state dict of this config: {sorted(sd)}")
    return out


def early_exit_state_dict_from_jax(params: Mapping, config) -> dict[str, torch.Tensor]:
    """A JAX EarlyExitUViT tree -> the port's fp32 state dict."""
    sd = {name: torch.from_numpy(np.array(value, dtype=np.float32, order="C"))  # a copy
          for name, value in export_early_exit_uvit(params).items()}
    return early_exit_state_dict_from_reference(sd, config)


# --- the frozen KL autoencoder -------------------------------------------------


def _ae_resnet_block(out: dict, node: Mapping, prefix: str) -> None:
    for name in ("norm1", "norm2"):
        _norm(out, node[name], f"{prefix}.{name}")
    for name in ("conv1", "conv2", "nin_shortcut"):
        if name in node:
            _conv(out, node[name], f"{prefix}.{name}")


def _ae_coder(out: dict, node: Mapping, side: str) -> None:
    """A JAX encoder or decoder tree, flat names (``down_{i}_block_{j}``,
    ``up_{i}_upsample``) -> ``{side}.down.{i}.block.{j}`` and so on."""
    group = "down" if side == "encoder" else "up"
    for name, child in node.items():
        if name in ("conv_in", "conv_out"):
            _conv(out, child, f"{side}.{name}")
        elif name == "norm_out":
            _norm(out, child, f"{side}.norm_out")
        elif name in ("mid_block_1", "mid_block_2"):
            _ae_resnet_block(out, child, f"{side}.mid.{name[4:]}")
        elif name == "mid_attn_1":
            _norm(out, child["norm"], f"{side}.mid.attn_1.norm")
            for conv in ("q", "k", "v", "proj_out"):
                _conv(out, child[conv], f"{side}.mid.attn_1.{conv}")
        else:  # {group}_{i}_block_{j} / {group}_{i}_{down,up}sample
            parts = name.split("_")
            if parts[0] != group:
                raise KeyError(f"unexpected autoencoder parameter {side}/{name}")
            if parts[2] == "block":
                _ae_resnet_block(out, child, f"{side}.{group}.{parts[1]}.block.{parts[3]}")
            else:
                _conv(out, child["conv"], f"{side}.{group}.{parts[1]}.{parts[2]}.conv")


def export_autoencoder(params: Mapping) -> dict[str, np.ndarray]:
    """A JAX ``FrozenAutoencoderKL`` parameter tree -> the reference's
    state-dict names, fp32 numpy: conv kernels HWIO -> OIHW, GroupNorm
    ``scale`` -> ``weight``. The inverse of the JAX package's
    ``convert_autoencoder_checkpoint``."""
    sd: dict[str, np.ndarray] = {}
    _ae_coder(sd, params["encoder"], "encoder")
    _ae_coder(sd, params["decoder"], "decoder")
    _conv(sd, params["quant_conv"], "quant_conv")
    _conv(sd, params["post_quant_conv"], "post_quant_conv")
    return sd


_INCEPTION_BN = {"bn_scale": "weight", "bn_bias": "bias", "bn_mean": "running_mean",
                 "bn_var": "running_var"}


def export_inception(params: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """A JAX ``InceptionV3Features`` parameter tree -> pytorch-fid's
    state-dict names, fp32 numpy: each ``BasicConv2d`` node's conv kernel
    HWIO -> ``conv.weight`` OIHW, ``bn_scale`` / ``bn_bias`` / ``bn_mean``
    / ``bn_var`` -> ``bn.weight`` / ``bias`` / ``running_mean`` /
    ``running_var``. The inverse of the JAX package's
    ``convert_inception_weights``."""
    sd: dict[str, np.ndarray] = {}
    for name, node in params.items():
        key = f"{prefix}.{name}" if prefix else name
        if "conv" in node:
            sd[f"{key}.conv.weight"] = _np(node["conv"]["kernel"]).transpose(3, 2, 0, 1)
            for jax_name, torch_name in _INCEPTION_BN.items():
                sd[f"{key}.bn.{torch_name}"] = _np(node[jax_name])
        else:
            sd.update(export_inception(node, key))
    return sd


# --- tensor-parallel shards (counterpart of parallel/mesh.py:param_sharding_rules) ----------

# the block tensors a model group shards, by name within the block: the q, k
# and v rows of whole heads ("qkv"), the matching columns of proj and fc2
# ("cols"), and fc1's rows of the hidden columns ("rows"); everything else
# is replicated
_BLOCK_PREFIX = re.compile(r"(?:^|\.)(?:in_blocks\.\d+|mid_block|out_blocks\.\d+)\.(.+)$")
BLOCK_SHARD_KINDS = {"attn.qkv.weight": "qkv", "attn.qkv.bias": "qkv", "attn.proj.weight": "cols",
                     "mlp.fc1.weight": "rows", "mlp.fc1.bias": "rows", "mlp.fc2.weight": "cols"}
# the rest of _TP_RULES and _TP_RULES_STACKED, by the name's last parts: the
# time embedding's fc1 rows (column-parallel; its bias stays whole, as JAX
# keeps it) and fc2 columns (row-parallel); the heads' decoder over D
# (row-parallel, "deep": dim 2 of the stack); the attention probes' kv rows,
# the k and the v halves each cut ("kv"), and cls_fc1's rows and bias and
# cls_fc2's weight over D ("cols": dim 1 of the stack)
_OTHER_SHARD_KINDS = {"time_embed.0.weight": "rows", "time_embed.2.weight": "cols",
                      "heads.decoder_weight": "deep", "probes.kv_weight": "kv",
                      "probes.kv_bias": "kv", "probes.fc1_weight": "cols",
                      "probes.fc1_bias": "cols", "probes.fc2_weight": "cols"}
_OTHER_PREFIX = re.compile(r"(?:^|\.)(" + "|".join(re.escape(k) for k in _OTHER_SHARD_KINDS)
                           + r")$")
# kind -> (the dim it cuts, the runs along that dim each cut into shards)
_KIND_DIMS = {"rows": (0, 1), "cols": (1, 1), "deep": (2, 1), "qkv": (0, 3), "kv": (1, 2)}


def shard_kind(name: str) -> Optional[str]:
    """How tensor parallelism cuts the state-dict entry ``name``: a kind of
    ``_KIND_DIMS``, or None (replicated)."""
    m = _BLOCK_PREFIX.search(name)
    if m is not None:
        return BLOCK_SHARD_KINDS.get(m.group(1))
    m = _OTHER_PREFIX.search(name)
    return None if m is None else _OTHER_SHARD_KINDS[m.group(1)]


def shard_tensor(kind: str, t: torch.Tensor, rank: int, shards: int) -> torch.Tensor:
    """Shard ``rank`` of ``shards`` of a full tensor of a kind of
    :func:`shard_kind` (a contiguous copy): along the kind's dim, each of
    its runs (q, k and v of "qkv"; k and v of "kv") cut into ``shards``
    pieces, this rank's piece of each."""
    dim, runs = _KIND_DIMS[kind]
    lead, n, rest = t.shape[:dim], t.shape[dim], t.shape[dim + 1:]
    part = t.reshape(*lead, runs, shards, n // (runs * shards), *rest).select(dim + 1, rank)
    return part.reshape(*lead, -1, *rest).clone()


def full_shape(kind: str, shape, shards: int) -> tuple:
    """The full tensor's shape from one of its ``shards`` shards' ``shape``."""
    dim = _KIND_DIMS[kind][0]
    return (*shape[:dim], shape[dim] * shards, *shape[dim + 1:])


def unshard_tensor(kind: str, parts: list) -> torch.Tensor:
    """The full tensor from its shards, in rank order (the inverse of
    :func:`shard_tensor`)."""
    dim, runs = _KIND_DIMS[kind]
    p0 = parts[0]
    lead, n, rest = p0.shape[:dim], p0.shape[dim], p0.shape[dim + 1:]
    split = [p.reshape(*lead, runs, n // runs, *rest) for p in parts]
    return torch.cat(split, dim=dim + 1).reshape(*lead, -1, *rest)


def shard_state_dict(full: Mapping, grid, fsdp_shapes: Optional[Mapping] = None) -> dict:
    """This rank's shard of a full state dict (or of a dict of optimizer
    moments under the same names): the tensor-parallel shard under the
    grid's model group, then, for the names of ``fsdp_shapes`` (the FSDP
    leaves, :mod:`duodiff_tpu_torch.parallel.fsdp`), this data rank's flat
    chunk of that. The dict as it is on a grid of one. A checkpoint always
    holds the full one."""
    out = dict(full)
    if grid.model > 1:
        out = {k: (v if shard_kind(k) is None
                   else shard_tensor(shard_kind(k), v, grid.model_rank, grid.model))
               for k, v in out.items()}
    for k in fsdp_shapes or ():
        if k in out:
            out[k] = out[k].reshape(grid.data, -1)[grid.data_rank].clone()
    return out


def gather_state_dict(shard: Mapping, grid, fsdp_shapes: Optional[Mapping] = None) -> dict:
    """The full state dict from every rank's :func:`shard_state_dict`, on the
    CPU, on every active rank (every one must call it, with the same names
    in the same order); the dict as it is on a grid of one. A leaf of
    ``fsdp_shapes`` (name -> its tensor-parallel shard's shape) is first put
    together from its data group's chunks."""
    fsdp_shapes = fsdp_shapes or {}
    if grid.model <= 1 and not fsdp_shapes:
        return dict(shard)
    out = {}
    for k, v in shard.items():
        v = v.detach().cpu()
        kind = shard_kind(k) if grid.model > 1 else None
        if kind is None and k not in fsdp_shapes:
            out[k] = v
            continue
        parts = grid.gather_host(v)  # rank d * model + m holds (data rank d, model rank m)
        if k in fsdp_shapes:
            parts = [torch.cat(parts[m::grid.model]).reshape(fsdp_shapes[k])
                     for m in range(grid.model)]
        else:
            row = grid.data_rank * grid.model
            parts = parts[row:row + grid.model]
        out[k] = parts[0] if kind is None else unshard_tensor(kind, parts)
    return out
