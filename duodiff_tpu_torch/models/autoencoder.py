"""Frozen KL autoencoder (counterpart of ``duodiff_tpu/models/autoencoder.py``).

Encodes 256 x 256 x 3 images into 32 x 32 x 4 latents (times 0.18215) for
latent ImageNet-256, and decodes them back. The modules carry the reference's
state-dict names (``encoder.down.{i}.block.{j}.norm1``,
``encoder.mid.attn_1.q``, ``decoder.up.{i}.upsample.conv``, ``quant_conv``,
...), those ``duodiff_tpu/utils/torch_convert.py`` reads, so a reference
``autoencoder_kl.pth`` loads by name. Only the configuration the reference
uses is built: no attention inside the pyramid, double_z, one mid attention
block a side.

Tensors come and go as NHWC, as the sampler's do. The convolutions run on
the NCHW view of the NHWC data, which is the ``channels_last`` memory format,
with ``channels_last`` weights, so cuDNN needs no layout transform; every
other operation works on the NHWC view. The JAX package's rounding points
hold in the bf16 mode: GroupNorm(32, eps 1e-6) and swish in fp32, cast to the
compute dtype only at a convolution's input; residual sums in the compute
dtype; in the mid attention the q k^T logits and the softmax in fp32, the
weights cast to the compute dtype, the weighted sum accumulated in fp32 and
then cast. :meth:`FrozenAutoencoderKL.decode` returns fp32. An fp32 model
runs its convolutions without TF32 on the card.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from duodiff_tpu_torch.config import AutoencoderConfig

GROUPS, GN_EPS = 32, 1e-6
LOGVAR_MIN, LOGVAR_MAX = -30.0, 20.0


def _conv(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype, stride: int = 1,
          padding: int | None = None) -> torch.Tensor:
    """``conv`` on NHWC ``x`` cast to ``dtype`` (through its NCHW view);
    NHWC out. ``padding`` defaults to SAME for an odd kernel."""
    k = conv.kernel_size[0]
    y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), conv.weight.to(dtype),
                 conv.bias.to(dtype), stride=stride, padding=k // 2 if padding is None else padding)
    return y.permute(0, 2, 3, 1)


def group_norm(x: torch.Tensor, norm: nn.GroupNorm, swish: bool) -> torch.Tensor:
    """GroupNorm(32, eps 1e-6) of NHWC ``x`` in fp32, with its fp32 scale and
    bias, then swish if asked; fp32 out. Statistics over (H, W) and the
    channels of a group."""
    b, h, w, c = x.shape
    v = x.float().reshape(b, h * w, GROUPS, c // GROUPS)
    var, mean = torch.var_mean(v, dim=(1, 3), keepdim=True, correction=0)
    scale = torch.rsqrt(var + GN_EPS) * norm.weight.view(1, 1, GROUPS, -1)
    y = torch.addcmul(norm.bias.view(1, 1, GROUPS, -1) - mean * scale, v, scale)
    if swish:
        y = F.silu(y, inplace=True)
    return y.reshape(b, h, w, c)


class ResnetBlock(nn.Module):
    """GroupNorm -> swish -> conv3x3, twice, with a 1x1 shortcut where the
    channels change."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(GROUPS, in_channels, eps=GN_EPS)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3)
        self.norm2 = nn.GroupNorm(GROUPS, out_channels, eps=GN_EPS)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3)
        if in_channels != out_channels:
            self.nin_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h = _conv(group_norm(x, self.norm1, swish=True), self.conv1, dtype)
        h = _conv(group_norm(h, self.norm2, swish=True), self.conv2, dtype)
        if hasattr(self, "nin_shortcut"):
            x = _conv(x, self.nin_shortcut, dtype)
        return x.to(dtype) + h


class AttnBlock(nn.Module):
    """One-head self-attention over the H * W positions, with 1x1-conv
    projections."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = nn.GroupNorm(GROUPS, channels, eps=GN_EPS)
        self.q = nn.Conv2d(channels, channels, 1)
        self.k = nn.Conv2d(channels, channels, 1)
        self.v = nn.Conv2d(channels, channels, 1)
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        b, h, w, c = x.shape
        hn = group_norm(x, self.norm, swish=False)
        q, k, v = (_conv(hn, conv, dtype).reshape(b, h * w, c) for conv in (self.q, self.k, self.v))
        # fp32 products of the compute-dtype values: the logits and the
        # weighted sum accumulate in fp32, as JAX's preferred_element_type asks
        logits = torch.bmm(q.float(), k.float().transpose(1, 2)) * (c ** -0.5)
        weights = torch.softmax(logits, dim=-1).to(dtype)
        out = torch.bmm(weights.float(), v.float()).to(dtype).reshape(b, h, w, c)
        return x.to(dtype) + _conv(out, self.proj_out, dtype)


class Downsample(nn.Module):
    """Pad right and bottom by one, then a stride-2 conv3x3."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return _conv(F.pad(x.to(dtype), (0, 0, 0, 1, 0, 1)), self.conv, dtype, stride=2,
                     padding=0)


class Upsample(nn.Module):
    """Nearest x2, then a conv3x3."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        b, h, w, c = x.shape
        x = x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)
        return _conv(x, self.conv, dtype)


class _Level(nn.Module):
    """One level of the pyramid: its ResNet blocks and its resampler."""

    def __init__(self, blocks: list, resample: Optional[nn.Module], kind: str):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        if resample is not None:
            setattr(self, kind, resample)


class _Mid(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.block_1 = ResnetBlock(channels, channels)
        self.attn_1 = AttnBlock(channels)
        self.block_2 = ResnetBlock(channels, channels)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return self.block_2(self.attn_1(self.block_1(x, dtype), dtype), dtype)


class Encoder(nn.Module):
    """conv_in, the downsampling ResNet pyramid, the mid blocks, GroupNorm,
    swish and conv_out to 2 * z_channels moments."""

    def __init__(self, cfg: AutoencoderConfig):
        super().__init__()
        self.conv_in = nn.Conv2d(cfg.in_channels, cfg.ch, 3)
        levels, c = [], cfg.ch
        for i, mult in enumerate(cfg.ch_mult):
            blocks = []
            for _ in range(cfg.num_res_blocks):
                blocks.append(ResnetBlock(c, cfg.ch * mult))
                c = cfg.ch * mult
            last = i == len(cfg.ch_mult) - 1
            levels.append(_Level(blocks, None if last else Downsample(c), "downsample"))
        self.down = nn.ModuleList(levels)
        self.mid = _Mid(c)
        self.norm_out = nn.GroupNorm(GROUPS, c, eps=GN_EPS)
        self.conv_out = nn.Conv2d(c, 2 * cfg.z_channels, 3)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h = _conv(x, self.conv_in, dtype)
        for level in self.down:
            for blk in level.block:
                h = blk(h, dtype)
            if hasattr(level, "downsample"):
                h = level.downsample(h, dtype)
        h = self.mid(h, dtype)
        return _conv(group_norm(h, self.norm_out, swish=True), self.conv_out, dtype)


class Decoder(nn.Module):
    """conv_in, the mid blocks, the upsampling ResNet pyramid
    (num_res_blocks + 1 blocks a level), GroupNorm, swish and conv_out."""

    def __init__(self, cfg: AutoencoderConfig):
        super().__init__()
        c = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = nn.Conv2d(cfg.z_channels, c, 3)
        self.mid = _Mid(c)
        levels = [None] * len(cfg.ch_mult)
        for i in reversed(range(len(cfg.ch_mult))):
            blocks = []
            for _ in range(cfg.num_res_blocks + 1):
                blocks.append(ResnetBlock(c, cfg.ch * cfg.ch_mult[i]))
                c = cfg.ch * cfg.ch_mult[i]
            levels[i] = _Level(blocks, Upsample(c) if i else None, "upsample")
        self.up = nn.ModuleList(levels)
        self.norm_out = nn.GroupNorm(GROUPS, c, eps=GN_EPS)
        self.conv_out = nn.Conv2d(c, cfg.out_ch, 3)

    def forward(self, z: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h = self.mid(_conv(z, self.conv_in, dtype), dtype)
        for level in reversed(self.up):
            for blk in level.block:
                h = blk(h, dtype)
            if hasattr(level, "upsample"):
                h = level.upsample(h, dtype)
        return _conv(group_norm(h, self.norm_out, swish=True), self.conv_out, dtype)


@contextlib.contextmanager
def _ieee_fp32_convs(active: bool):
    """cuDNN without TF32 while ``active``: fp32 convolutions stay fp32."""
    if not active:
        yield
        return
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


class FrozenAutoencoderKL(nn.Module):
    """``encode``: x -> reparameterised z * scale_factor; ``decode``: z /
    scale_factor -> image. Parameters are fp32 until :meth:`freeze` casts
    the convolutions' to the compute dtype ``dtype``; GroupNorm keeps fp32."""

    def __init__(self, config: AutoencoderConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config, self.dtype = config, dtype
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = nn.Conv2d(2 * config.z_channels, 2 * config.embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(config.embed_dim, config.z_channels, 1)

    @torch.no_grad()
    def freeze(self) -> "FrozenAutoencoderKL":
        """Eval mode, no gradients, the convolutions' weights and biases in
        the compute dtype and their weights channels_last, once."""
        self.eval().requires_grad_(False)
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                mod.weight.data = mod.weight.data.to(
                    self.dtype, memory_format=torch.channels_last)
                mod.bias.data = mod.bias.data.to(self.dtype)
        return self

    def _fp32_on_card(self, x: torch.Tensor):
        return _ieee_fp32_convs(self.dtype == torch.float32 and x.is_cuda)

    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) images -> (B, H/f, W/f, 2 * embed_dim) moments in the
        compute dtype."""
        with self._fp32_on_card(x):
            return _conv(self.encoder(x, self.dtype), self.quant_conv, self.dtype)

    def sample_latent(self, moments: torch.Tensor, generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mean + exp(logvar / 2) * noise, times scale_factor, in fp32; logvar
        clipped to [-30, 20]. The noise is drawn from ``generator`` unless
        given."""
        mean, logvar = moments.float().chunk(2, dim=-1)
        std = torch.exp(0.5 * logvar.clamp(LOGVAR_MIN, LOGVAR_MAX))
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                                dtype=torch.float32)
        return self.config.scale_factor * (mean + std * noise)

    def encode(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, 256, 256, 3) images -> (B, 32, 32, 4) latents, fp32."""
        return self.sample_latent(self.encode_moments(x), generator, noise)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(B, 32, 32, 4) latents -> (B, 256, 256, 3) images, fp32."""
        z = z / self.config.scale_factor
        with self._fp32_on_card(z):
            h = _conv(z, self.post_quant_conv, self.dtype)
            return self.decoder(h, self.dtype).float()


@torch.no_grad()
def init_autoencoder(config: Optional[AutoencoderConfig] = None, *,
                     generator: torch.Generator, dtype: torch.dtype = torch.float32
                     ) -> FrozenAutoencoderKL:
    """An autoencoder with random fp32 weights on the CPU, drawn from
    ``generator`` with the JAX package's initialisers: flax's lecun-normal
    for every conv weight, zero biases, GroupNorm ones and zeros."""
    model = FrozenAutoencoderKL(config or AutoencoderConfig(), dtype=dtype)
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            std = mod.weight[0].numel() ** -0.5 / 0.87962566103423978
            nn.init.trunc_normal_(mod.weight, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.GroupNorm):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
    return model
