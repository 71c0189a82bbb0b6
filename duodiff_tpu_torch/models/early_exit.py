"""The DeeDiff / AdaDiff early-exit U-ViT (counterpart of
``duodiff_tpu/models/early_exit.py``).

A U-ViT with an uncertainty probe and an output head at each of its
``depth`` probe points. Probe point ``i`` is the input of block ``i``,
counted in-blocks 0..k-1, mid block k, out-blocks k+1..2k, so point 0 is
the embedded tokens alone. :meth:`EarlyExitUViT.forward` returns
``(backbone (B, H, W, C) fp32, u (depth, B) fp32, g (depth, B, H, W, C)
fp32)``: the backbone's prediction, every probe's predicted error and every
head's prediction.

As in the JAX package the heads and the per-layer probes hold their
parameters stacked on a leading ``depth`` axis, and the per-timestep probes
are gatherable tables, (T, D) or (depth, T, D) with T = 1000, indexed per
sample by the raw integer timestep clipped to [0, 999]. The reference's
state-dict names (``in_blocks_heads.{i}``, ``matrix.{i}``, ``matrix.{t}``,
``matrix.{i}, {t}``, ...) are gathered into these stacks on load
(:func:`duodiff_tpu_torch.utils.convert.early_exit_state_dict_from_reference`).

The heads and probes are what the JAX package computes in XLA, outside any
Pallas kernel, so they are plain PyTorch here: the heads' decoder is one
batched product over the stacked weights and their 3x3 convolutions one
grouped convolution. The blocks go through the UViT's blocks and so through
its ``attn_impl``.

Under tensor parallelism (:meth:`EarlyExitUViT.shard_`) the heads and the
attention probes are sharded by JAX's ``_TP_RULES_STACKED``: the heads'
decoder row-parallel over D (its partial summed over the model group
before the bias and the convolution), the probes' kv and cls_fc1
column-parallel (each of k and v cut over D) and cls_fc2 row-parallel. The
per-layer MLP probes and the per-timestep tables stay whole, as JAX keeps
them. Every output is the summed one, the same on each rank.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from duodiff_tpu_torch.config import UViTConfig
from duodiff_tpu_torch.models.layers import unpatchify
from duodiff_tpu_torch.models.uvit import UViT, _init_params, _trunc_normal_
from duodiff_tpu_torch.ops.attention import xla_attention
from duodiff_tpu_torch.parallel import fsdp
from duodiff_tpu_torch.parallel.tp_fused import gather_shards, replicated, sum_over_shards
from duodiff_tpu_torch.utils.convert import shard_kind, shard_tensor

CLASSIFIER_TYPES = (
    "attention_probe",
    "mlp_probe_per_layer",
    "mlp_probe_per_timestep",
    "mlp_probe_per_layer_per_timestep",
)
PER_LAYER_PROBES = ("attention_probe", "mlp_probe_per_layer")
# rows of the per-timestep probe tables (the reference's hard-coded registries)
PROBE_TIMESTEPS = 1000


def _linear(x, weight, bias, dtype):
    """flax ``nn.Dense(dtype=dtype)`` on a weight (out, in) and bias (out,)."""
    return torch.matmul(x.to(dtype), weight.to(dtype).t()) + bias.to(dtype)


@torch.no_grad()
def _shard_params(module: nn.Module, prefix: str, grid) -> None:
    """Keep this rank's tensor-parallel shard of every parameter of
    ``module`` that ``convert.shard_kind`` cuts (named ``prefix.<name>``)."""
    for name, p in list(module.named_parameters(recurse=False)):
        kind = shard_kind(f"{prefix}.{name}")
        if kind is not None:
            setattr(module, name, nn.Parameter(shard_tensor(kind, p.data, grid.model_rank,
                                                            grid.model)))


def _cols(grid, n: int) -> slice:
    """This model rank's slice of n / mp columns a rank."""
    return slice(grid.model_rank * n, (grid.model_rank + 1) * n)


class OutputHeads(nn.Module):
    """The ``depth`` output heads, each the U-ViT's tail (reference
    OutputHead): fp32 LayerNorm (eps 1e-5) -> Linear(D -> patch_dim) in the
    compute dtype -> drop the extra tokens -> unpatchify -> 3x3 SAME conv in
    the compute dtype -> fp32."""

    def __init__(self, depth: int, dim: int, patch_dim: int, in_chans: int, extras: int):
        super().__init__()
        self.extras = extras
        self.in_chans = in_chans
        self.grid = None  # the process grid when the decoder is row-parallel
        self.norm_weight = nn.Parameter(torch.ones(depth, dim))
        self.norm_bias = nn.Parameter(torch.zeros(depth, dim))
        self.decoder_weight = nn.Parameter(torch.zeros(depth, patch_dim, dim))
        self.decoder_bias = nn.Parameter(torch.zeros(depth, patch_dim))
        self.conv_weight = nn.Parameter(torch.zeros(depth, in_chans, in_chans, 3, 3))
        self.conv_bias = nn.Parameter(torch.zeros(depth, in_chans))

    def forward(self, hs: Sequence[torch.Tensor], dtype,
                heads: Optional[Sequence[int]] = None) -> torch.Tensor:
        """Heads ``heads`` (all by default) on their probe points' tokens
        ``hs`` (each (B, L, D)) -> (n, B, H, W, C) fp32. The LayerNorm goes
        head by head, in fp32 with fp32 scale and bias (CUDA's ``layer_norm``
        takes no bf16 input beside fp32 parameters), rounded once to the
        compute dtype; so no fp32 copy of all of ``hs`` is made."""
        sel = slice(None) if heads is None else list(heads)
        if heads is not None and sel == list(range(sel[0], sel[-1] + 1)):
            # a run of heads as a slice, a view: a list index is copied from
            # the host, which a CUDA graph cannot capture
            sel = slice(sel[0], sel[-1] + 1)
        n = len(hs)
        b, l, d = hs[0].shape
        w, bias = self.norm_weight[sel], self.norm_bias[sel]
        normed = torch.empty((n, b, l, d), dtype=dtype, device=hs[0].device)
        for i, h in enumerate(hs):
            normed[i] = F.layer_norm(h.float(), (d,), w[i], bias[i], 1e-5)
        w = self.decoder_weight[sel].to(dtype).transpose(1, 2)
        if self.grid is None:
            y = torch.matmul(normed.view(n, b * l, d), w)
        else:  # the rank's D / mp of the contraction, summed over the model group
            part = replicated(normed, self.grid)[..., _cols(self.grid, w.shape[1])]
            y = sum_over_shards(torch.matmul(part.reshape(n, b * l, -1), w), self.grid)
        y = y + self.decoder_bias[sel].to(dtype)[:, None]
        img = unpatchify(y.view(n * b, l, -1)[:, self.extras:], self.in_chans)
        c, hh, ww = self.in_chans, img.shape[1], img.shape[2]
        # the n heads' images side by side on the channel axis, one grouped conv
        img = img.view(n, b, hh, ww, c).permute(1, 0, 4, 2, 3).reshape(b, n * c, hh, ww)
        conv = F.conv2d(img, self.conv_weight[sel].to(dtype).reshape(n * c, c, 3, 3),
                        padding=1, groups=n)
        conv = conv + self.conv_bias[sel].to(dtype).reshape(n * c)[:, None, None]
        return conv.view(b, n, c, hh, ww).permute(1, 0, 3, 4, 2).float()


class MLPProbes(nn.Module):
    """Per-layer probes (reference MLPProbe): Linear(D -> 1) in the compute
    dtype -> fp32 sigmoid -> mean over tokens."""

    def __init__(self, depth: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(depth, dim))
        self.bias = nn.Parameter(torch.zeros(depth))

    def forward(self, hs, t_idx, dtype, slots=None) -> torch.Tensor:
        slots = range(len(hs)) if slots is None else slots
        out = []
        for s, h in zip(slots, hs):
            u = torch.matmul(h.to(dtype), self.weight[s].to(dtype)) + self.bias[s].to(dtype)
            out.append(torch.sigmoid(u.float()).mean(1))
        return torch.stack(out)


class AttentionProbes(nn.Module):
    """Per-layer probes (reference AttentionProbe): drop token 0, attend a
    learned query (one head, zero-initialised) over the rest, then
    Linear -> SiLU -> Linear(-> 1). No sigmoid on the output, a reference
    quirk kept. The single-query attention is plain PyTorch, as JAX's is
    XLA."""

    def __init__(self, depth: int, dim: int):
        super().__init__()
        self.grid = None  # the process grid when kv, cls_fc1 and cls_fc2 are shards
        self.q = nn.Parameter(torch.zeros(depth, dim))
        self.kv_weight = nn.Parameter(torch.zeros(depth, 2 * dim, dim))
        self.kv_bias = nn.Parameter(torch.zeros(depth, 2 * dim))
        self.fc1_weight = nn.Parameter(torch.zeros(depth, dim, dim))
        self.fc1_bias = nn.Parameter(torch.zeros(depth, dim))
        self.fc2_weight = nn.Parameter(torch.zeros(depth, dim))
        self.fc2_bias = nn.Parameter(torch.zeros(depth))

    def forward(self, hs, t_idx, dtype, slots=None) -> torch.Tensor:
        slots = range(len(hs)) if slots is None else slots
        if self.grid is not None:
            return torch.stack([self._shard_forward(h, s, dtype) for s, h in zip(slots, hs)])
        out = []
        for s, h in zip(slots, hs):
            x = h[:, 1:]
            b, _, d = x.shape
            kv = _linear(x, self.kv_weight[s], self.kv_bias[s], dtype)
            k, v = kv[:, None, :, :d], kv[:, None, :, d:]
            q = self.q[s].to(k.dtype).expand(b, 1, 1, d)
            o = xla_attention(q, k, v).reshape(b, 1, d).to(dtype)
            o = F.silu(_linear(o, self.fc1_weight[s], self.fc1_bias[s], dtype))
            o = torch.matmul(o, self.fc2_weight[s].to(dtype)) + self.fc2_bias[s].to(dtype)
            out.append(o.float()[:, 0])
        return torch.stack(out)

    def _shard_forward(self, h, s: int, dtype) -> torch.Tensor:
        """Probe ``s`` on a tensor-parallel shard: k and v of the rank's D /
        mp columns, the logits' partial dot products summed over the model
        group, the attention's output columns put together (one all-gather),
        cls_fc1's columns, cls_fc2's rows summed over the group."""
        grid = self.grid
        x = replicated(h[:, 1:], grid)
        b, _, d = x.shape
        kv = _linear(x, self.kv_weight[s], self.kv_bias[s], dtype)
        a = kv.shape[-1] // 2
        k, v = kv[..., :a].float(), kv[..., a:]
        q = replicated(self.q[s], grid)[_cols(grid, a)].to(kv.dtype).float()
        logits = sum_over_shards(torch.matmul(k, q)[:, None, :], grid) / math.sqrt(d)
        weights = replicated(torch.softmax(logits, dim=-1), grid)
        o = torch.matmul(weights.to(v.dtype).float(), v.float()).to(dtype)  # (B, 1, A)
        o = gather_shards(o, grid, -1)
        o = F.silu(_linear(o, self.fc1_weight[s], self.fc1_bias[s], dtype))
        o = sum_over_shards(torch.matmul(o, self.fc2_weight[s].to(dtype)), grid)
        return (o + self.fc2_bias[s].to(dtype)).float()[:, 0]


class TimestepProbeTable(nn.Module):
    """Per-timestep probes (reference ``matrix.{t}`` / ``matrix.{i}, {t}``)
    as tables: weight (T, D) or (depth, T, D), bias (T,) or (depth, T),
    gathered per sample by its timestep; fp32 logits, sigmoid, mean over
    tokens. The logits go layer by layer, so no fp32 copy of all of ``hs``
    is made."""

    def __init__(self, depth: int, dim: int, per_layer: bool):
        super().__init__()
        lead = (depth, PROBE_TIMESTEPS) if per_layer else (PROBE_TIMESTEPS,)
        self.per_layer = per_layer
        self.weight = nn.Parameter(torch.zeros(*lead, dim))
        self.bias = nn.Parameter(torch.zeros(*lead))

    def forward(self, hs, t_idx, dtype, slots=None) -> torch.Tensor:
        slots = range(len(hs)) if slots is None else slots
        out = []
        for s, h in zip(slots, hs):
            w = self.weight[s] if self.per_layer else self.weight
            bias = self.bias[s] if self.per_layer else self.bias
            logits = torch.einsum("bld,bd->bl", h.float(), w[t_idx].float())
            out.append(torch.sigmoid(logits + bias[t_idx][:, None]).mean(1))
        return torch.stack(out)


def make_probes(config: UViTConfig) -> nn.Module:
    kind = config.classifier_type
    if kind not in CLASSIFIER_TYPES:
        raise ValueError(f"Unknown classifier type: {kind}")
    d, depth = config.embed_dim, config.depth
    if kind == "attention_probe":
        return AttentionProbes(depth, d)
    if kind == "mlp_probe_per_layer":
        return MLPProbes(depth, d)
    return TimestepProbeTable(depth, d, per_layer=kind == "mlp_probe_per_layer_per_timestep")


class EarlyExitUViT(nn.Module):
    """A :class:`UViT` (``self.uvit``, its blocks and ``attn_impl``) with an
    output head and an uncertainty probe at every probe point. Beside the
    dense :meth:`forward`, the truncated forwards of the static-exit and
    adaptive samplers run blocks 0..exit_layer-1 and head ``exit_layer``
    (at ``exit_layer == depth`` the whole backbone and its own decoder).
    ``use_checkpoint`` is the backbone's (:class:`UViT`): in training each
    block runs again in the backward instead of keeping its activations."""

    def __init__(self, config: UViTConfig, *, dtype=torch.bfloat16, attn_impl: str = "plain",
                 gelu_approx: bool = False, int8_mlp_scales: Optional[tuple] = None,
                 mlp_impl: str = "auto", use_checkpoint: bool = False):
        super().__init__()
        self.config = config
        probes = make_probes(config)  # refuses an unknown classifier type first
        self.uvit = UViT(config, dtype=dtype, attn_impl=attn_impl, gelu_approx=gelu_approx,
                         int8_mlp_scales=int8_mlp_scales, mlp_impl=mlp_impl,
                         use_checkpoint=use_checkpoint)
        self.heads = OutputHeads(config.depth, config.embed_dim, config.patch_dim,
                                 config.in_chans, config.extras)
        self.probes = probes

    @property
    def dtype(self):
        return self.uvit.dtype

    def blocks(self):
        return self.uvit.blocks()

    def shard_(self, grid) -> "EarlyExitUViT":
        """Make the backbone a tensor-parallel shard (:meth:`UViT.shard_`),
        and the heads' decoder and the attention probes by JAX's
        ``_TP_RULES_STACKED`` (the module docstring)."""
        self.uvit.shard_(grid)
        if grid.model <= 1:
            return self
        for prefix, mod in (("heads", self.heads), ("probes", self.probes)):
            _shard_params(mod, prefix, grid)
            if hasattr(mod, "grid"):
                mod.grid = grid
        return self

    def pack_for_kernels(self) -> None:
        self.uvit.pack_for_kernels()

    def mark_weights_moved(self) -> None:
        self.uvit.mark_weights_moved()

    def block_names(self) -> list[str]:
        return self.uvit.block_names()

    def forward_calib(self, x, timesteps, y=None):
        """The int8 calibration forward: the backbone's
        (:meth:`UViT.forward_calib`), whose prediction the calibration
        trajectory steps on. The heads and probes read the blocks and change
        none of them, so the statistics are those of the full forward; the
        sites carry the backbone's block names, as in the JAX package."""
        return self.uvit.forward_calib(x, timesteps, y)

    @staticmethod
    def probe_index(timesteps: torch.Tensor) -> torch.Tensor:
        """The per-timestep tables' row of each sample: the raw timestep cast
        to an integer (toward zero, as JAX's astype) and clipped to [0, 999]."""
        return timesteps.to(torch.int32).clamp(0, PROBE_TIMESTEPS - 1).long()

    def _prefix(self, x, timesteps, y, exit_layer: int, taps=()):
        """The U-Net traversal up to probe point ``exit_layer``: blocks
        0..exit_layer-1, skips popped as they pair. Returns the tokens there
        and ``{slot: tokens at probe point slot}`` for the slots in ``taps``."""
        uvit = self.uvit
        k = len(uvit.in_blocks)
        h = uvit.embed_tokens(x, timesteps, y)
        tapped, skips = {}, []
        for i, blk in enumerate(uvit.blocks()):
            if i in taps:
                tapped[i] = h
            if i == exit_layer:
                break
            if i < k:
                h = uvit._run_block(blk, h)
                skips.append(h)
            elif i == k:
                h = uvit._run_block(blk, h)
            else:
                h = uvit._run_block(blk, h, skips.pop())
        return h, tapped

    def _exit(self, h, exit_layer: int):
        """Head ``exit_layer`` on its probe point's tokens, or the backbone's
        decoder at ``exit_layer == depth``."""
        if exit_layer == self.config.depth:
            return self.uvit.decode_tokens(h)
        return self.heads([h], self.dtype, heads=[exit_layer])[0]

    def check_exit(self, exit_layer: int) -> int:
        depth = self.config.depth
        if not 0 <= int(exit_layer) <= depth:
            raise ValueError(f"exit_layer must be in [0, {depth}], got {exit_layer}")
        return int(exit_layer)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                y: Optional[torch.Tensor] = None):
        depth = self.config.depth
        with fsdp.root(self):
            h, tapped = self._prefix(x, timesteps, y, depth, taps=range(depth))
            hs = [tapped[i] for i in range(depth)]
            backbone = self.uvit.decode_tokens(h)
            u = self.probes(hs, self.probe_index(timesteps), self.dtype)
            return backbone, u, self.heads(hs, self.dtype)

    def forward_truncated(self, x, timesteps, y=None, *, exit_layer: int):
        """Blocks 0..exit_layer-1 and head ``exit_layer``: equals ``g[exit_layer]``
        of :meth:`forward` (the backbone at ``exit_layer == depth``)."""
        e = self.check_exit(exit_layer)
        return self._exit(self._prefix(x, timesteps, y, e)[0], e)

    def cache_prefix(self, exit_layer: int, n_outer: int) -> int:
        """Out-blocks a truncated backbone runs (``exit_layer - k - 1``), after
        checking that the cached region (in_blocks[n_outer:], mid,
        out_blocks[:k - n_outer]) lies inside the truncation."""
        k = self.config.depth // 2
        e = self.check_exit(exit_layer)
        if not 1 <= n_outer <= k:
            raise ValueError(f"n_outer must be in [1, {k}], got {n_outer}")
        if e <= 2 * k - n_outer:
            raise ValueError(
                f"exit_layer {e} exits inside the cached region for n_outer={n_outer} (needs "
                f"exit_layer > {2 * k - n_outer}); use cache_outer_for() to pick a valid "
                "n_outer or run the bucket uncached")
        return e - k - 1

    def forward_truncated_anchor(self, x, timesteps, y=None, *, exit_layer: int, n_outer: int):
        """:meth:`forward_truncated` that also returns the cached region's
        residual (``UViT.forward_anchor``): ``(prediction, delta)``."""
        n_out = self.cache_prefix(exit_layer, n_outer)
        h, delta = self.uvit.anchor_tokens(x, timesteps, y, n_outer=n_outer, n_out=n_out)
        return self._exit(h, exit_layer), delta

    def forward_truncated_cached(self, x, timesteps, y=None, *, exit_layer: int, n_outer: int,
                                 delta):
        """The outer blocks of the truncated backbone around ``x + delta``
        (``UViT.forward_cached``), then head ``exit_layer``."""
        n_out = self.cache_prefix(exit_layer, n_outer)
        h = self.uvit.cached_tokens(x, timesteps, y, n_outer=n_outer, delta=delta, n_out=n_out)
        return self._exit(h, exit_layer)

    def forward_probed(self, x, timesteps, y=None, *, exit_layer: int, slots: Sequence[int]):
        """:meth:`forward_truncated` that also evaluates the probes of
        ``slots`` (each at most ``min(exit_layer, depth - 1)``) on their probe
        points along the way: ``(prediction, u (len(slots), B) fp32)``."""
        e = self.check_exit(exit_layer)
        h, tapped = self._prefix(x, timesteps, y, e, taps=set(slots))
        u = self.probes([tapped[s] for s in slots], self.probe_index(timesteps), self.dtype,
                        slots=slots)
        return self._exit(h, e), u


@torch.no_grad()
def _init_heads_and_probes(model: EarlyExitUViT, generator: torch.Generator) -> None:
    """The JAX package's initialisers: head LayerNorms ones / zeros, decoder
    trunc-normal(0.02), flax's lecun-normal for the convs and the probes'
    Dense kernels, zero biases, the attention probes' query zeros, and the
    per-timestep tables U(-1/sqrt(D), 1/sqrt(D))."""
    heads, probes = model.heads, model.probes
    _trunc_normal_(heads.decoder_weight, 0.02, generator)
    c = model.config.in_chans
    _trunc_normal_(heads.conv_weight, (9 * c) ** -0.5, generator)
    d = model.config.embed_dim
    if isinstance(probes, MLPProbes):
        _trunc_normal_(probes.weight, d**-0.5, generator)
    elif isinstance(probes, AttentionProbes):
        for w in (probes.kv_weight, probes.fc1_weight, probes.fc2_weight):
            _trunc_normal_(w, d**-0.5, generator)
    else:
        bound = d**-0.5
        for p in (probes.weight, probes.bias):
            p.uniform_(-bound, bound, generator=generator)


def init_early_exit_uvit(config: UViTConfig, *, device, dtype=torch.bfloat16,
                         generator: torch.Generator, attn_impl: str = "plain",
                         gelu_approx: bool = False, int8_mlp_scales: Optional[tuple] = None,
                         mlp_impl: str = "auto", use_checkpoint: bool = False) -> EarlyExitUViT:
    """An EarlyExitUViT with random fp32 weights drawn on the CPU from
    ``generator``, then moved to ``device``. ``dtype`` is the compute dtype."""
    model = EarlyExitUViT(config, dtype=dtype, attn_impl=attn_impl, gelu_approx=gelu_approx,
                          int8_mlp_scales=int8_mlp_scales, mlp_impl=mlp_impl,
                          use_checkpoint=use_checkpoint)
    _init_params(model.uvit, generator)
    _init_heads_and_probes(model, generator)
    return model.to(device)
