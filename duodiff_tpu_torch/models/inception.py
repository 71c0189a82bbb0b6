"""InceptionV3 feature extractor for FID (counterpart of
``duodiff_tpu/models/inception.py``), plain PyTorch.

The graph is pytorch-fid's FIDInceptionV3, the torchvision Inception-v3
with the FID pooling variants: a 3x3 average pool with
``count_include_pad=False`` in the A, C and E_1 blocks, a 3x3 stride-1 max
pool in E_2 (``Mixed_7c``), VALID stride-2 max pools, and a global mean at
the end. Module and attribute names are pytorch-fid's
(``Mixed_5b.branch1x1.conv.weight``, ``...bn.running_mean``), so a
``pt_inception`` or torchvision ``.pth`` loads by name
(:func:`load_inception`).

Layout and precision: NHWC in, (B, 2048) out, the convolutions on a
channels_last view in fp32. Each ``BasicConv2d`` is a conv without bias,
then frozen BatchNorm(eps 1e-3) in the JAX package's explicit form ``(x -
mean) * rsqrt(var + 1e-3) * scale + bias``, then ReLU. The forward turns
cuDNN's TF32 off while it runs, whatever the caller set: seeded random
weights leave activations of ~1e-4 after 94 layers, and 10-bit products
would move what FD-rand measures.

Input contract (:func:`preprocess`): float images in [0, 1] of at most 299
x 299, resized bilinearly with half-pixel centres to 299 x 299, then mapped
to [-1, 1]. Larger images are refused (the JAX package antialiases them).
"""

from __future__ import annotations

from pathlib import Path

import torch
import torch.nn.functional as F
from torch import nn

from duodiff_tpu_torch.models.autoencoder import _ieee_fp32_convs

INCEPTION_SIZE = 299
BN_EPS = 1e-3
# what a pytorch-fid or torchvision state dict holds that the extractor does
# not use: the classifier head, the auxiliary classifier, BatchNorm's counter
IGNORED_PREFIXES = ("fc.", "AuxLogits.")
IGNORED_SUFFIX = ".num_batches_tracked"


class FrozenBatchNorm(nn.Module):
    """Inference BatchNorm with pytorch-fid's names, all four as buffers."""

    def __init__(self, channels: int):
        super().__init__()
        for name, fill in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0),
                           ("running_var", 1.0)):
            self.register_buffer(name, torch.full((channels,), fill))

    def forward(self, x):
        def c(t):
            return t.view(1, -1, 1, 1)
        return (x - c(self.running_mean)) * torch.rsqrt(c(self.running_var) + BN_EPS) \
            * c(self.weight) + c(self.bias)


class BasicConv2d(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel_size, stride: int = 1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel_size, stride=stride, padding=padding,
                              bias=False)
        self.bn = FrozenBatchNorm(out_ch)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 64, 1)
        self.branch5x5_1 = BasicConv2d(in_ch, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(in_ch, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, bd, self.branch_pool(_avg_pool(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    def __init__(self, in_ch: int, pool: str):
        super().__init__()
        self.pool = pool  # "avg" (Mixed_7b, E_1) or "max" (Mixed_7c, E_2)
        self.branch1x1 = BasicConv2d(in_ch, 320, 1)
        self.branch3x3_1 = BasicConv2d(in_ch, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = _avg_pool(x) if self.pool == "avg" else F.max_pool2d(x, 3, stride=1, padding=1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


class InceptionV3Features(nn.Module):
    """pool3 (2048-d) features of (B, 299, 299, 3) NHWC images in [-1, 1]."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, pool_features=32)
        self.Mixed_5c = InceptionA(256, pool_features=64)
        self.Mixed_5d = InceptionA(288, pool_features=64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, channels_7x7=128)
        self.Mixed_6c = InceptionC(768, channels_7x7=160)
        self.Mixed_6d = InceptionC(768, channels_7x7=160)
        self.Mixed_6e = InceptionC(768, channels_7x7=192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, pool="avg")
        self.Mixed_7c = InceptionE(2048, pool="max")
        self.to(memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float().permute(0, 3, 1, 2)  # the NHWC data as a channels_last NCHW view
        with _ieee_fp32_convs(x.device.type == "cuda"):
            x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
            x = F.max_pool2d(x, 3, stride=2)
            x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
            x = F.max_pool2d(x, 3, stride=2)
            for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b",
                         "Mixed_6c", "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
                x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


def preprocess(images01: torch.Tensor) -> torch.Tensor:
    """[0, 1] float NHWC of at most 299 x 299 -> 299 x 299 NHWC in [-1, 1].

    Larger images are refused: ``jax.image.resize`` antialiases where it
    shrinks, and ``F.interpolate(antialias=True)`` departs from it by up to
    2.4e-5 at 320 -> 299, past the 1e-5 the port holds it to. Growing (and
    299 itself) is plain bilinear with half-pixel centres on both sides."""
    h, w = images01.shape[1:3]
    if h > INCEPTION_SIZE or w > INCEPTION_SIZE:
        raise ValueError(f"Inception preprocessing takes images of at most {INCEPTION_SIZE} x "
                         f"{INCEPTION_SIZE}, got {h} x {w}: the port does not shrink images")
    x = F.interpolate(images01.float().permute(0, 3, 1, 2), size=(INCEPTION_SIZE,) * 2,
                      mode="bilinear", align_corners=False)
    return (2.0 * x - 1.0).permute(0, 2, 3, 1)


@torch.no_grad()
def init_inception(generator: torch.Generator) -> InceptionV3Features:
    """The extractor with flax's initialisers, drawn on the CPU from
    ``generator`` in module order: every conv kernel lecun-normal (a normal
    cut at two standard deviations, std sqrt(1 / fan_in) / 0.8796..., fan_in
    = kh * kw * c_in), BatchNorm scale 1, bias 0, mean 0, var 1. The draw
    is the port's own, not JAX's."""
    model = InceptionV3Features()
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            std = mod.weight[0].numel() ** -0.5 / 0.87962566103423978
            nn.init.trunc_normal_(mod.weight, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
    return model.eval()


def load_inception(path: str, device) -> InceptionV3Features:
    """The extractor with the weights of a pytorch-fid or torchvision
    ``.pth`` (a state dict, or one under ``state_dict``) on ``device``;
    ``fc.*``, ``AuxLogits.*`` and BatchNorm's counters are ignored. A
    missing or mis-shaped key raises, naming it. ``"random-init"`` gives
    seed-0 random weights: only for exercising the FID plumbing, the
    numbers mean nothing."""
    if path == "random-init":
        return init_inception(torch.Generator().manual_seed(0)).to(device)
    if not Path(path).exists():
        raise FileNotFoundError(
            f"Inception weights not found at {path}. FID needs the canonical pt_inception "
            "(pytorch-fid) or torchvision inception_v3 .pth; download is not possible in this "
            "environment — provide the file via --inception_weights.")
    state = torch.load(path, map_location="cpu", weights_only=True)
    state = state.get("state_dict", state)
    state = {k: v for k, v in state.items()
             if not k.startswith(IGNORED_PREFIXES) and not k.endswith(IGNORED_SUFFIX)}
    model = InceptionV3Features().eval()
    for name, t in model.state_dict().items():
        if name not in state:
            raise KeyError(f"Inception weights {path}: no {name!r}")
        if tuple(state[name].shape) != tuple(t.shape):
            raise ValueError(f"Inception weights {path}: {name!r} has shape "
                             f"{tuple(state[name].shape)}, the extractor's is {tuple(t.shape)}")
    model.load_state_dict({k: state[k].float() for k in model.state_dict()}, strict=True)
    return model.to(device=device, memory_format=torch.channels_last)
