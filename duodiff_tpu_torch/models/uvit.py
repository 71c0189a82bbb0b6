"""U-ViT backbone (counterpart of ``duodiff_tpu/models/uvit.py``).

  patch_embed -> [label_emb?, time_token, patches] + pos_embed
  -> depth//2 in_blocks (collect long skips) -> mid_block
  -> depth//2 out_blocks (consume skips via Linear(concat))
  -> LayerNorm -> decoder_pred -> drop extra tokens -> unpatchify -> 3x3 conv

Parameters are fp32 under the reference's state-dict names (those
``duodiff_tpu_torch.utils.convert.export_uvit`` emits), so a JAX parameter
tree or a reference ``.pth`` loads with ``strict=True``. Activations run in
``dtype``. Call :meth:`UViT.pack_for_kernels` after the weights are final
and on their device, before the first forward.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from duodiff_tpu_torch.config import UViTConfig
from duodiff_tpu_torch.models.layers import (
    Block,
    PatchEmbed,
    TimeEmbed,
    dense,
    flax_layer_norm,
    timestep_embedding,
    unpatchify,
)


class UViT(nn.Module):
    """U-ViT denoiser: forward(x (B, H, W, C), timesteps (B,), y=None) ->
    (B, H, W, C) float32 prediction under the training parametrization.

    ``int8_mlp_scales`` (int8 attn_impl only): one (sx, sh) pair per block
    in execution order (in_0..in_{k-1}, mid, out_0..out_{k-1}), the static
    MLP activation scales of a calibration file
    (:func:`duodiff_tpu_torch.utils.int8_scales.scales_dict_to_tuple`).

    ``use_checkpoint`` (the JAX package's ``nn.remat(Block)``): in training
    :meth:`forward` keeps only each block's inputs and runs the block again
    in the backward, so a step trades one more forward of every block for
    the activations the blocks would save. No block draws random numbers,
    so the second run repeats the first to the bit."""

    def __init__(self, config: UViTConfig, *, dtype=torch.bfloat16,
                 attn_impl: str = "plain", gelu_approx: bool = False,
                 int8_mlp_scales: Optional[tuple] = None, mlp_impl: str = "auto",
                 use_checkpoint: bool = False):
        super().__init__()
        cfg = config
        d = cfg.embed_dim
        k = cfg.depth // 2
        sc = int8_mlp_scales
        if sc is not None and len(sc) != 2 * k + 1:
            raise ValueError(f"int8_mlp_scales has {len(sc)} entries, need {2 * k + 1}")
        self.config = cfg
        self.dtype = dtype
        self.use_checkpoint = use_checkpoint
        self.patch_embed = PatchEmbed(cfg.patch_size, cfg.in_chans, d)
        self.time_embed = TimeEmbed(d, cfg.mlp_time_embed)
        self.label_emb = nn.Embedding(cfg.num_classes, d) if cfg.num_classes > 0 else None
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.extras + cfg.num_patches, d))
        common = dict(
            dim=d, num_heads=cfg.num_heads, mlp_ratio=cfg.mlp_ratio,
            qkv_bias=cfg.qkv_bias, gelu_approx=gelu_approx, attn_impl=attn_impl,
            mlp_impl=mlp_impl,
        )

        def blk(i: int, **kw) -> Block:
            scales = None if sc is None else tuple(sc[i])
            return Block(**common, int8_mlp_scales=scales, **kw)

        self.in_blocks = nn.ModuleList([blk(i) for i in range(k)])
        self.mid_block = blk(k)
        self.out_blocks = nn.ModuleList([blk(k + 1 + i, skip=cfg.skip) for i in range(k)])
        self.norm = nn.LayerNorm(d, eps=1e-5)
        self.decoder_pred = nn.Linear(d, cfg.patch_dim)
        self.final_layer = (
            nn.Conv2d(cfg.in_chans, cfg.in_chans, 3, padding=1) if cfg.conv else None
        )

    def blocks(self) -> list[Block]:
        return [*self.in_blocks, self.mid_block, *self.out_blocks]

    @torch.no_grad()
    def pack_for_kernels(self) -> None:
        """Pack every block's sublayer operands once (weights transposed,
        softmax scale folded, cast to the compute dtype)."""
        for blk in self.blocks():
            blk.pack(self.dtype)

    def embed_tokens(self, x, timesteps, y=None):
        """Patchify + time/label tokens + positional embedding."""
        cfg = self.config
        dt = self.dtype
        if cfg.normalize_timesteps:
            timesteps = timesteps.float() / 1000.0
        x = self.patch_embed(x, dt)
        time_token = self.time_embed(timestep_embedding(timesteps, cfg.embed_dim), dt)
        x = torch.cat([time_token[:, None, :].to(dt), x], dim=1)
        if self.label_emb is not None:
            if y is None:
                raise ValueError("class-conditional model requires labels")
            x = torch.cat([self.label_emb(y)[:, None, :].to(dt), x], dim=1)
        return x + self.pos_embed.to(dt)

    def decode_tokens(self, x):
        """Final norm + linear decoder + unpatchify + 3x3 conv."""
        cfg = self.config
        dt = self.dtype
        x = dense(flax_layer_norm(x, self.norm), self.decoder_pred, dt)
        x = unpatchify(x[:, cfg.extras:, :], cfg.in_chans)
        if self.final_layer is not None:
            # NHWC SAME 3x3 conv in the compute dtype, bias added after
            conv = F.conv2d(x.permute(0, 3, 1, 2), self.final_layer.weight.to(dt), padding=1)
            conv = conv + self.final_layer.bias.to(dt)[:, None, None]
            x = conv.permute(0, 2, 3, 1)
        return x.float()

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self._forward(x, timesteps, y, self._run_block)

    def _forward(self, x, timesteps, y, run):
        """The U-Net traversal, each block through ``run(blk, x, skip=None)``."""
        x = self.embed_tokens(x, timesteps, y)
        skips = []
        for blk in self.in_blocks:
            x = run(blk, x)
            skips.append(x)
        x = run(self.mid_block, x)
        for blk in self.out_blocks:
            x = run(blk, x, skips.pop())
        return self.decode_tokens(x)

    def block_names(self) -> list[str]:
        """The JAX block names, in :meth:`blocks`' order: in_blocks_i,
        mid_block, out_blocks_i (the keys of an int8 scales file)."""
        k = self.config.depth // 2
        return ([f"in_blocks_{i}" for i in range(k)] + ["mid_block"]
                + [f"out_blocks_{i}" for i in range(k)])

    def forward_calib(self, x, timesteps, y=None):
        """The int8 calibration forward (``UViT(int8_calibrate=True)`` applied
        with ``mutable=["int8_calib"]``): every block runs
        :meth:`Block.forward_calib`. Returns ``(prediction, stats)``, stats
        ``{block name: (amax (2,), rows (2, B*L))}`` on the device."""
        names = iter(self.block_names())
        stats = {}

        def run(blk, x, skip=None):
            x, amax, rows = blk.forward_calib(x, skip)
            stats[next(names)] = (amax, rows)
            return x

        return self._forward(x, timesteps, y, run), stats

    def _run_block(self, blk: Block, x, skip=None):
        """The block, behind a checkpoint when training with ``use_checkpoint``."""
        if self.use_checkpoint and self.training and torch.is_grad_enabled():
            return checkpoint(blk, x, skip, use_reentrant=False)
        return blk(x, skip)

    def _check_n_outer(self, n_outer: int) -> int:
        k = self.config.depth // 2
        if not 0 <= n_outer <= k:
            raise ValueError(f"n_outer must be in [0, {k}], got {n_outer}")
        return k

    def forward_anchor(self, x, timesteps, y=None, *, n_outer: int):
        """Full forward that also returns the residual of the centered
        ``depth - 2*n_outer`` blocks (in_blocks[n_outer:], mid_block,
        out_blocks[:k - n_outer]) for block caching: ``(prediction,
        delta)`` with ``delta = tokens_out - tokens_in`` of that region,
        (B, L, D) in the compute dtype. Long skips pushed inside the region
        are consumed inside it, so the region reduces to that one residual.
        ``prediction`` equals :meth:`forward`."""
        k = self._check_n_outer(n_outer)
        x = self.embed_tokens(x, timesteps, y)
        skips = []
        for blk in self.in_blocks[:n_outer]:
            x = blk(x)
            skips.append(x)
        region_in = x
        inner_skips = []
        for blk in self.in_blocks[n_outer:]:
            x = blk(x)
            inner_skips.append(x)
        x = self.mid_block(x)
        for blk in self.out_blocks[:k - n_outer]:
            x = blk(x, inner_skips.pop())
        delta = x - region_in
        for blk in self.out_blocks[k - n_outer:]:
            x = blk(x, skips.pop())
        return self.decode_tokens(x), delta

    def forward_cached(self, x, timesteps, y=None, *, n_outer: int, delta):
        """Forward that runs only the ``2*n_outer`` outer blocks (plus embed
        and decode) and replaces the centered region by ``x + delta``, a
        residual :meth:`forward_anchor` returned."""
        k = self._check_n_outer(n_outer)
        x = self.embed_tokens(x, timesteps, y)
        skips = []
        for blk in self.in_blocks[:n_outer]:
            x = blk(x)
            skips.append(x)
        x = x + delta.to(x.dtype)
        for blk in self.out_blocks[k - n_outer:]:
            x = blk(x, skips.pop())
        return self.decode_tokens(x)


def _trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator):
    """flax ``truncated_normal(stddev)``: cut at two standard deviations of
    the underlying normal, rescaled so the result has ``std``."""
    s = std / 0.87962566103423978
    return nn.init.trunc_normal_(t, std=s, a=-2 * s, b=2 * s, generator=generator)


@torch.no_grad()
def _init_params(model: UViT, generator: torch.Generator) -> None:
    """The JAX package's initialisers: trunc-normal(0.02) for linear and
    patch-embed weights and pos_embed, zero biases, LayerNorm ones/zeros,
    flax's lecun-normal for the 3x3 conv and normal(D^-0.5) for labels."""
    for name, mod in model.named_modules():
        if isinstance(mod, nn.LayerNorm):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, (nn.Linear, nn.Conv2d)):
            if name == "final_layer":
                fan_in = mod.weight[0].numel()
                _trunc_normal_(mod.weight, fan_in**-0.5, generator)
            else:
                _trunc_normal_(mod.weight, 0.02, generator)
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.Embedding):
            nn.init.normal_(mod.weight, std=mod.embedding_dim**-0.5, generator=generator)
    _trunc_normal_(model.pos_embed, 0.02, generator)


def init_uvit(config: UViTConfig, *, device, dtype=torch.bfloat16,
              generator: torch.Generator, attn_impl: str = "plain",
              gelu_approx: bool = False, int8_mlp_scales: Optional[tuple] = None,
              mlp_impl: str = "auto", use_checkpoint: bool = False) -> UViT:
    """A UViT with random fp32 weights drawn on the CPU from ``generator``
    (a CPU generator, so the weights do not depend on ``device``), then
    moved to ``device``. ``dtype`` is the compute dtype."""
    model = UViT(config, dtype=dtype, attn_impl=attn_impl, gelu_approx=gelu_approx,
                 int8_mlp_scales=int8_mlp_scales, mlp_impl=mlp_impl,
                 use_checkpoint=use_checkpoint)
    _init_params(model, generator)
    return model.to(device)
