"""U-ViT building blocks (counterpart of ``duodiff_tpu/models/layers.py``).

Images are NHWC and tokens (B, L, D), as in the JAX package. Parameters are
fp32 and keep the reference's state-dict names and shapes; activations run
in the model's compute dtype (bf16 for sampling). Where the JAX package
uses ``nn.Dense(dtype=...)``, :func:`dense` casts both operands to the
compute dtype and adds the bias in it, as flax does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from duodiff_tpu_torch.ops.attention import multi_head_attention
from duodiff_tpu_torch.ops.block import (
    FusedAttnSublayerFn,
    FusedMlpSublayerFn,
    attn_operands,
    attn_sublayer_plain,
    fused_attn_sublayer,
    fused_mlp_sublayer,
    mlp_operands,
    mlp_sublayer_plain,
    pack_attn,
    pack_mlp,
)
from duodiff_tpu_torch.ops.block_int8 import (
    attn_sublayer_int8_plain,
    fused_attn_sublayer_int8,
    fused_mlp_sublayer_int8,
    mlp_sublayer_int8_calib,
    mlp_sublayer_int8_plain,
    pack_attn_int8,
    pack_mlp_int8,
)
from duodiff_tpu_torch.parallel.tp_fused import (
    replicated,
    sum_over_shards,
    tp_attn_sublayer,
    tp_attn_sublayer_train,
    tp_mlp_sublayer,
    tp_mlp_sublayer_train,
)
from duodiff_tpu_torch.utils.convert import BLOCK_SHARD_KINDS, shard_tensor

INT8_IMPLS = ("fused_int8", "plain_int8")
# the unfused block: separate LayerNorm, projections and attention dispatch
# (xla: plain attention; pallas: the attention kernels K9 / K10;
# pallas_plain: their plain versions)
UNFUSED_IMPLS = ("xla", "pallas", "pallas_plain")
ATTN_IMPLS = ("fused", "plain", *UNFUSED_IMPLS, *INT8_IMPLS)
# the unfused block's MLP: "auto" the plain one, "fused" the sublayer kernel (K2 / K7)
MLP_IMPLS = ("auto", "fused")
# attn_impl -> (attention sublayer, MLP sublayer)
_SUBLAYERS = {
    "fused": (fused_attn_sublayer, fused_mlp_sublayer),
    "plain": (attn_sublayer_plain, mlp_sublayer_plain),
    "fused_int8": (fused_attn_sublayer_int8, fused_mlp_sublayer_int8),
    "plain_int8": (attn_sublayer_int8_plain, mlp_sublayer_int8_plain),
}


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: int = 10000):
    """Sinusoidal embeddings, cos-first; (B,) -> (B, dim) float32."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half
    )
    args = timesteps.float()[:, None] * freqs[None]
    embedding = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        embedding = torch.cat([embedding, torch.zeros_like(embedding[:, :1])], dim=-1)
    return embedding


def patchify(imgs: torch.Tensor, patch_size: int) -> torch.Tensor:
    """NHWC image -> (B, h*w, p*p*C) tokens, each patch ordered (p1, p2, C)."""
    b, hh, ww, c = imgs.shape
    p = patch_size
    h, w = hh // p, ww // p
    x = imgs.reshape(b, h, p, w, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * w, p * p * c)


def unpatchify(x: torch.Tensor, channels: int = 3) -> torch.Tensor:
    """(B, L, p*p*C) tokens -> NHWC image."""
    b, num_patches, patch_dim = x.shape
    p = int((patch_dim // channels) ** 0.5)
    h = w = int(num_patches**0.5)
    if h * w != num_patches or p * p * channels != patch_dim:
        raise ValueError(f"tokens {tuple(x.shape)} do not form a square image")
    x = x.reshape(b, h, w, p, p, channels).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * p, w * p, channels)


def dense(x: torch.Tensor, linear: nn.Linear, dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)`` on a torch Linear's parameters."""
    y = torch.matmul(x.to(dtype), linear.weight.to(dtype).t())
    return y if linear.bias is None else y + linear.bias.to(dtype)


def flax_layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """flax ``nn.LayerNorm(epsilon=1e-5, dtype=float32)`` on a torch
    LayerNorm's parameters: fp32 statistics with the fast variance
    E[x^2] - E[x]^2; returns fp32."""
    xv = x.float()
    mean = xv.mean(-1, keepdim=True)
    var = torch.clamp(xv.square().mean(-1, keepdim=True) - mean.square(), min=0.0)
    return (xv - mean) * (torch.rsqrt(var + norm.eps) * norm.weight) + norm.bias


class PatchEmbed(nn.Module):
    """Patchify + one matmul. The weight keeps the reference's conv shape
    (D, C, p, p); as a (p*p*C, D) matmul weight it is
    ``w.permute(2, 3, 1, 0).reshape(p*p*C, D)``."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        w = self.proj.weight.permute(2, 3, 1, 0).reshape(-1, self.proj.out_channels)
        y = torch.matmul(patchify(x.to(dtype), self.patch_size), w.to(dtype))
        return y + self.proj.bias.to(dtype)


class TimeEmbed(nn.Sequential):
    """Linear-SiLU-Linear over the sinusoidal embedding (state-dict names
    ``time_embed.0`` / ``time_embed.2``); empty, the identity, when
    ``mlp_time_embed`` is False. :meth:`shard_` makes it a tensor-parallel
    shard by JAX's rules: fc1's rows of the 4D hidden columns
    (column-parallel; its bias stays whole, as JAX keeps it, and the rank
    reads its slice), fc2's matching columns (row-parallel), one sum over
    the model group before fc2's bias."""

    def __init__(self, embed_dim: int, mlp_time_embed: bool):
        layers = []
        if mlp_time_embed:
            layers = [nn.Linear(embed_dim, 4 * embed_dim), nn.SiLU(),
                      nn.Linear(4 * embed_dim, embed_dim)]
        super().__init__(*layers)
        self.grid = None

    @torch.no_grad()
    def shard_(self, grid) -> None:
        if grid.model <= 1 or len(self) == 0:
            return
        for name in ("0.weight", "2.weight"):
            mod = self.get_submodule(name[0])
            kind = "rows" if name[0] == "0" else "cols"
            mod.weight = nn.Parameter(shard_tensor(kind, mod.weight.data, grid.model_rank,
                                                   grid.model))
        self.grid = grid

    def forward(self, emb: torch.Tensor, dtype) -> torch.Tensor:
        if len(self) == 0:
            return emb
        if self.grid is None:
            return dense(F.silu(dense(emb, self[0], dtype)), self[2], dtype)
        fc1, fc2, grid = self[0], self[2], self.grid
        n = fc1.weight.shape[0]
        bias = replicated(fc1.bias, grid)[grid.model_rank * n:(grid.model_rank + 1) * n]
        h = torch.matmul(replicated(emb.to(dtype), grid), fc1.weight.to(dtype).t())
        h = F.silu(h + bias.to(dtype))
        partial = torch.matmul(h, fc2.weight.to(dtype).t())
        return sum_over_shards(partial, grid) + fc2.bias.to(dtype)


class Block(nn.Module):
    """Pre-norm transformer block with an optional long-skip input:

      x = skip_linear(cat(x, skip))     # out-blocks only
      x = x + attn(norm1(x))            # K1
      x = x + mlp(norm2(x))             # K2

    ``attn_impl="fused"`` runs the two sublayer wrappers (the CUDA kernels
    on a CUDA tensor), ``"plain"`` their plain PyTorch versions;
    ``"fused_int8"`` and ``"plain_int8"`` are the same pair for the W8A8
    sublayers (sampling only; the int8 weights are quantized once, at
    pack time). All read the operands :meth:`pack` prepared, once per
    model; a forward that finds a parameter changed since then (an optimizer
    step, ``load_state_dict``, ``.to(device)``) packs again first, so it
    never computes with weights the model no longer has.
    ``int8_mlp_scales=(sx, sh)``, the block's calibrated post-LN and
    post-GELU amax, switches its int8 MLP to static activation scales.

    In training mode with grad enabled the block reads its live parameters
    instead: ``"fused"`` runs the autograd Functions that pair K1 and K2
    with their backward kernels K6 and K7 (bf16 only), ``"plain"`` runs
    autograd through the plain versions; the int8 impls have no backward.

    ``"xla"``, ``"pallas"`` and ``"pallas_plain"`` run the unfused block of
    the JAX package instead (``x + attn(LN(x))`` then ``x + mlp(LN(x))``,
    each residual added in the compute dtype): LayerNorm with fp32
    statistics cast to the compute dtype, q, k and v as three products
    landing in (B, H, L, Dh), :func:`multi_head_attention` (for ``"pallas"``
    the attention kernels K9 and K10), the head merge and the out
    projection, then the plain MLP. These products are plain matmuls, as
    the JAX package leaves them to XLA. The unfused block reads the live
    parameters in training and in eval, and autograd differentiates it.
    ``mlp_impl="fused"`` pairs it with the fused MLP sublayer (K2, and K7 in
    training) in place of the plain MLP.

    :meth:`shard_` makes the block a tensor-parallel shard (the JAX
    ``Block``'s TP branch, ``layers.py:414-440``, and GSPMD's form of the
    unfused block): it keeps the q, k and v columns of its model rank's H /
    mp heads, the matching proj rows, and hidden / mp columns of fc1 with
    the matching fc2 rows, under the same names
    (:func:`~duodiff_tpu_torch.utils.convert.shard_tensor`). ``"fused"``
    then runs :mod:`duodiff_tpu_torch.parallel.tp_fused`: the shard forms of
    the fused kernels, one sum over the model group a sublayer (on a CPU
    tensor their wrappers run the plain versions). The unfused impls run
    their block on the shard: the LayerNorm in fp32 on the whole x, q, k and
    v of the local heads, the attention (K9 / K10 for ``"pallas"``) on
    (B, H / mp, L, Dh), proj on the local rows, one sum of the partial over
    the model group, then the bias; fc1 on the local columns, the GELU, fc2
    on the local rows, one sum, the bias. ``"plain"`` and the int8 impls
    have no shard form and are refused.

    Under FSDP (:mod:`duodiff_tpu_torch.parallel.fsdp`) ``fsdp_unit``
    gathers the block's weights around each forward, which then reads them
    live, in eval as in training (no packed operands: the gathered weights
    are new tensors each time); inside ``fsdp.full_params`` the block holds
    its whole weights and packs as a whole model does.
    """

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, skip: bool = False,
                 gelu_approx: bool = False, attn_impl: str = "plain",
                 int8_mlp_scales: Optional[tuple] = None, mlp_impl: str = "auto"):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {attn_impl!r}")
        if mlp_impl not in MLP_IMPLS:
            raise ValueError(f"mlp_impl must be one of {MLP_IMPLS}, got {mlp_impl!r}")
        if int8_mlp_scales is not None and attn_impl not in INT8_IMPLS:
            raise ValueError(f"int8_mlp_scales need an int8 attn_impl, got {attn_impl!r}")
        self.num_heads = num_heads
        self.gelu_approx = gelu_approx
        self.attn_impl = attn_impl
        self.mlp_impl = mlp_impl
        self.int8_mlp_scales = int8_mlp_scales
        self.skip_linear = nn.Linear(2 * dim, dim) if skip else None
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = nn.ModuleDict({
            "qkv": nn.Linear(dim, 3 * dim, bias=qkv_bias),
            "proj": nn.Linear(dim, dim),
        })
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        hidden = int(dim * mlp_ratio)
        self.mlp = nn.ModuleDict({
            "fc1": nn.Linear(dim, hidden),
            "fc2": nn.Linear(hidden, dim),
        })
        self._packed = None
        self._packed_dtype = None
        self._packed_marks = None
        self.grid = None  # the process grid when the block is a tensor-parallel shard
        self.fsdp_unit = None  # its FSDP leaves (parallel/fsdp.py), or None

    def _param_marks(self) -> list:
        """(version, address) of every parameter :meth:`pack` reads, from the
        host alone: an in-place update bumps the version, a replaced or moved
        tensor has another address. (An in-place write through ``p.data``
        bumps no version and goes unseen, and so does a CUDA graph's replay:
        ``UViT.mark_weights_moved`` clears the marks after one.)"""
        mods = (self.norm1, self.attn["qkv"], self.attn["proj"], self.norm2,
                self.mlp["fc1"], self.mlp["fc2"])
        return [(0 if p.is_inference() else p._version, p.data_ptr())
                for m in mods for p in (m.weight, m.bias) if p is not None]

    @torch.no_grad()
    def pack(self, dtype) -> None:
        """Prepare the sublayers' operands from the current parameters: bf16
        (``dtype``) weights, or int8 codes with fp32 scales for the int8
        impls. ``attn_impl`` may later switch within its family (fused and
        plain read the same operands), not across it."""
        self._packed_dtype = dtype
        if self.fsdp_unit is not None and not self.fsdp_unit.whole:
            self._packed = None  # the forward reads the gathered weights live
            return
        qkv, proj = self.attn["qkv"], self.attn["proj"]
        fc1, fc2 = self.mlp["fc1"], self.mlp["fc2"]
        self._packed_marks = self._param_marks()
        if self.attn_impl in INT8_IMPLS:
            self._packed = (
                pack_attn_int8(self.norm1, qkv, proj, num_heads=self.num_heads),
                pack_mlp_int8(self.norm2, fc1, fc2, static_scales=self.int8_mlp_scales),
            )
        else:
            self._packed = (
                pack_attn(self.norm1, qkv, proj, num_heads=self.num_heads, dtype=dtype),
                pack_mlp(self.norm2, fc1, fc2, dtype=dtype),
            )

    @torch.no_grad()
    def shard_(self, grid) -> None:
        """Keep only this rank's shard of the heads and hidden columns (the
        grid's model rank of ``grid.model``), in place; nothing when the grid
        has no tensor parallelism."""
        mp = grid.model
        if mp <= 1:
            return
        if self.attn_impl in INT8_IMPLS:
            raise ValueError(f"attn_impl {self.attn_impl!r} does not combine with "
                             "--model_parallel: the int8 kernels have no tensor-parallel shard "
                             "form")
        if self.attn_impl not in ("fused", *UNFUSED_IMPLS):
            raise ValueError(f"attn_impl {self.attn_impl!r} has no tensor-parallel form: "
                             "--model_parallel runs 'fused' and the unfused blocks ('pallas', "
                             "'xla')")
        hidden = self.mlp["fc1"].out_features
        if self.num_heads % mp or hidden % mp or (hidden // mp) % 8:
            raise ValueError(f"--model_parallel {mp} must divide the {self.num_heads} heads and "
                             f"the {hidden} hidden columns into slices of a multiple of 8")
        for name, kind in BLOCK_SHARD_KINDS.items():
            path, attr = name.rsplit(".", 1)
            mod = self.get_submodule(path)
            t = getattr(mod, attr)
            if t is not None:
                setattr(mod, attr, nn.Parameter(shard_tensor(kind, t.data, grid.model_rank, mp)))
        self.num_heads //= mp
        self.grid = grid
        self._packed = None

    def _check_packed(self) -> None:
        if self._packed is None:
            raise RuntimeError("Block operands are not packed: call UViT.pack_for_kernels()")
        if self._packed_marks != self._param_marks():
            self.pack(self._packed_dtype)  # a parameter changed since packing

    def _tp_forward(self, x: torch.Tensor, training: bool) -> torch.Tensor:
        """The two sublayers of a tensor-parallel shard."""
        grid, heads = self.grid, self.num_heads
        if not training:
            (*attn, bp), (*mlp, b2) = self._packed
            zero = torch.zeros_like(bp)
            x = tp_attn_sublayer(x, (*attn, zero), bp, num_heads=heads, grid=grid)
            return tp_mlp_sublayer(x, (*mlp, zero), b2, gelu_approx=self.gelu_approx, grid=grid)
        if x.is_cuda:
            self._check_bf16(x, "attn_impl 'fused'")
        norm1, qkv, proj = self.norm1, self.attn["qkv"], self.attn["proj"]
        x = tp_attn_sublayer_train(x.contiguous(), norm1.weight, norm1.bias, qkv.weight,
                                   qkv.bias, proj.weight, proj.bias, num_heads=heads, grid=grid)
        return tp_mlp_sublayer_train(x, *self._mlp_params(), gelu_approx=self.gelu_approx,
                                     grid=grid)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None):
        unit = self.fsdp_unit
        if unit is not None and not unit.whole:
            with unit.use():
                return self._forward(x, skip, live=True)
        return self._forward(x, skip, live=self.training and torch.is_grad_enabled())

    def _forward(self, x, skip, live: bool):
        """The block; ``live``: read the parameters, not the packed operands
        (training, or the gathered weights of an FSDP block)."""
        unfused = self.attn_impl in UNFUSED_IMPLS
        if not live and (not unfused or self.mlp_impl == "fused"):
            self._check_packed()
        if self.skip_linear is not None:
            x = dense(torch.cat([x, skip], dim=-1), self.skip_linear, x.dtype)
        if unfused:
            x = x + self._attention(x).to(x.dtype)
            if self.mlp_impl == "fused":
                return self._fused_mlp(x, live)
            return x + self._mlp(x).to(x.dtype)
        if self.grid is not None:
            return self._tp_forward(x, live)
        if live:
            return self._train_forward(x)
        attn_ops, mlp_ops = self._packed
        attn, mlp = _SUBLAYERS[self.attn_impl]
        x = attn(x, *attn_ops, num_heads=self.num_heads)
        return mlp(x, *mlp_ops, gelu_approx=self.gelu_approx)

    def forward_calib(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None):
        """The calibration forward of an int8 block (the JAX ``Block`` with
        ``int8_calibrate=True``): the attention sublayer with dynamic scales
        (K11 on a CUDA tensor for ``fused_int8``, its plain version else),
        then :func:`mlp_sublayer_int8_calib`. Returns ``(x, amax, rows)``:
        amax (2,) the post-LN and post-GELU amax of the MLP sublayer, rows
        (2, B*L) their per-row amaxes, fp32 on x's device. The block must
        have no static scales: they are what the calibration makes."""
        if self.attn_impl not in INT8_IMPLS or self.int8_mlp_scales is not None:
            raise ValueError("the calibration forward takes an int8 block with dynamic scales, "
                             f"got attn_impl {self.attn_impl!r}, int8_mlp_scales "
                             f"{self.int8_mlp_scales}")
        self._check_packed()
        if self.skip_linear is not None:
            x = dense(torch.cat([x, skip], dim=-1), self.skip_linear, x.dtype)
        attn_ops, mlp_ops = self._packed
        x = _SUBLAYERS[self.attn_impl][0](x, *attn_ops, num_heads=self.num_heads)
        x, xn_amax, h_amax, (xn_rows, h_rows) = mlp_sublayer_int8_calib(
            x, *mlp_ops[:-1], gelu_approx=self.gelu_approx, with_rows=True)
        return (x, torch.stack([xn_amax, h_amax]),
                torch.stack([xn_rows.reshape(-1), h_rows.reshape(-1)]))

    def _attention(self, x: torch.Tensor) -> torch.Tensor:
        """attn(LN(x)) of the unfused block, (B, L, D) in x's dtype; on a
        tensor-parallel shard its local heads, then the sum over the model
        group."""
        dt = x.dtype
        b, l, _ = x.shape
        qkv = self.attn["qkv"]
        xn = self._shard_input(flax_layer_norm(x, self.norm1).to(dt))
        w = qkv.weight.to(dt)  # (3A, D): q, k and v rows, each head-major
        a = w.shape[0] // 3
        heads = []
        for i in range(3):
            t = torch.matmul(xn, w[i * a:(i + 1) * a].t())
            if qkv.bias is not None:
                t = t + qkv.bias[i * a:(i + 1) * a].to(dt)
            heads.append(t.reshape(b, l, self.num_heads, -1).transpose(1, 2).contiguous())
        out = multi_head_attention(*heads, impl=self.attn_impl).to(dt)  # (B, H, L, Dh)
        return self._shard_output(out.transpose(1, 2).reshape(b, l, a), self.attn["proj"])

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        """mlp(LN(x)) of the unfused block, in x's dtype (the local hidden
        columns and the sum over the model group on a shard)."""
        dt = x.dtype
        xn = self._shard_input(flax_layer_norm(x, self.norm2).to(dt))
        hidden = dense(xn, self.mlp["fc1"], dt)
        hidden = F.gelu(hidden, approximate="tanh" if self.gelu_approx else "none")
        return self._shard_output(hidden, self.mlp["fc2"])

    def _shard_input(self, xn: torch.Tensor) -> torch.Tensor:
        """The normed input of a sublayer; on a shard, its gradient summed
        over the model group (the shards' products each give a part)."""
        return xn if self.grid is None else replicated(xn, self.grid)

    def _shard_output(self, h: torch.Tensor, linear: nn.Linear) -> torch.Tensor:
        """The sublayer's out projection: on a shard, the local rows' partial
        summed over the model group before the bias."""
        if self.grid is None:
            return dense(h, linear, h.dtype)
        partial = torch.matmul(h, linear.weight.to(h.dtype).t())
        return sum_over_shards(partial, self.grid) + linear.bias.to(h.dtype)

    def _mlp_params(self):
        norm2, fc1, fc2 = self.norm2, self.mlp["fc1"], self.mlp["fc2"]
        return norm2.weight, norm2.bias, fc1.weight, fc1.bias, fc2.weight, fc2.bias

    def _check_bf16(self, x: torch.Tensor, what: str) -> None:
        if x.dtype != torch.bfloat16:
            raise ValueError(
                f"{what} trains in bf16 only (the backward kernels take bf16), got "
                f"{x.dtype}: pass --use_amp, or train with attn_impl 'plain'"
            )

    def _fused_mlp(self, x: torch.Tensor, live: bool) -> torch.Tensor:
        """The fused MLP sublayer after an unfused attention (mlp_impl
        "fused"); its shard form on a tensor-parallel shard."""
        if not live:
            if self.grid is not None:
                *mlp, b2 = self._packed[1]
                return tp_mlp_sublayer(x, (*mlp, torch.zeros_like(b2)), b2,
                                       gelu_approx=self.gelu_approx, grid=self.grid)
            return fused_mlp_sublayer(x, *self._packed[1], gelu_approx=self.gelu_approx)
        self._check_bf16(x, "mlp_impl 'fused'")
        if self.grid is not None:
            return tp_mlp_sublayer_train(x.contiguous(), *self._mlp_params(),
                                         gelu_approx=self.gelu_approx, grid=self.grid)
        return FusedMlpSublayerFn.apply(x.contiguous(), *self._mlp_params(), self.gelu_approx, 1e-5)

    def _train_forward(self, x: torch.Tensor) -> torch.Tensor:
        """The two sublayers on the live parameters, differentiable."""
        norm1, qkv, proj = self.norm1, self.attn["qkv"], self.attn["proj"]
        attn_params = (norm1.weight, norm1.bias, qkv.weight, qkv.bias, proj.weight, proj.bias)
        mlp_params = self._mlp_params()
        if self.attn_impl == "fused":
            self._check_bf16(x, "attn_impl 'fused'")
            x = FusedAttnSublayerFn.apply(x.contiguous(), *attn_params, self.num_heads, 1e-5)
            return FusedMlpSublayerFn.apply(x, *mlp_params, self.gelu_approx, 1e-5)
        if self.attn_impl == "plain":
            x = attn_sublayer_plain(x, *attn_operands(*attn_params, num_heads=self.num_heads,
                                                      dtype=x.dtype), num_heads=self.num_heads)
            return mlp_sublayer_plain(x, *mlp_operands(*mlp_params, dtype=x.dtype),
                                      gelu_approx=self.gelu_approx)
        raise ValueError(f"attn_impl {self.attn_impl!r} has no backward: train with "
                         "'fused' or 'plain'")
