"""The fused sublayers of a U-ViT block, the whole-block kernel and their
backwards (counterpart of ``duodiff_tpu/ops/pallas_block.py``).

- :func:`fused_attn_sublayer`: ``y = x + proj(SDPA(qkv(LN(x)))) + b_proj``
  (K1, ``csrc/attn_sublayer.cu``; the Pallas ``_kernel_v2``);
- :func:`fused_mlp_sublayer`: ``y = x + fc2(gelu(fc1(LN(x)) + b1)) + b2``
  (K2, ``csrc/mlp_sublayer.cu``; the Pallas ``_mlp_kernel``);
- :func:`fused_attn_sublayer_bwd` (K6, ``csrc/attn_sublayer_bwd.cu``; the
  Pallas ``_attn_bwd_kernel``) and :func:`fused_mlp_sublayer_bwd` (K7,
  ``csrc/mlp_sublayer_bwd.cu``; the Pallas ``_mlp_bwd_kernel``), paired
  with K1 and K2 in the autograd Functions :class:`FusedAttnSublayerFn`
  and :class:`FusedMlpSublayerFn` for training;
- :func:`fused_mlp_sublayer_bwd_split` (K8, ``csrc/mlp_sublayer_bwd_split.cu``;
  the Pallas ``_mlp_bwd_partial_kernel``): K7's gradients in scratch bounded
  by ``splits``, which :class:`FusedMlpSublayerFn` takes when the environment
  variable ``DUODIFF_MLP_BWD_SPLIT`` is ``1`` (:func:`mlp_sublayer_bwd`);
- :func:`fused_block` (K5, ``csrc/fused_block.cu``; the Pallas
  ``_block_kernel``): a whole block with the intermediate residual stream
  kept in fp32, and :class:`FusedBlockFn`, its trainable form with the
  chained backward (K1 to recompute, the MLP backward, then K6);
- ``fused_attn_sublayer(..., variant="v1")`` (K1-v1,
  ``csrc/attn_sublayer_v1.cu``; the Pallas ``_kernel``): the per-head form
  of K1 on the unscaled packing of :func:`pack_attn_v1`.

K1, K2, K6 and K7 also have the tensor-parallel shard form, ``residual=False``
(the Pallas kernels' ``residual=False`` with ``head_dim`` passed, which
``duodiff_tpu/parallel/tp_fused.py`` runs): a shard of the heads (A = H_loc *
Dh < D) or of the hidden columns, the ``x +`` left out of the forward and the
``+ dy`` out of dx, which ``duodiff_tpu_torch/parallel/tp_fused.py`` adds once
after the sum over the shards. Their launches count in ``.launches_shard``,
apart from the square form's ``.launches``. K5, K1-v1 and K8 are square only,
as in the JAX package.

Each wrapper takes the plain PyTorch version (:func:`attn_sublayer_plain`,
:func:`mlp_sublayer_plain`, :func:`attn_sublayer_bwd_plain`,
:func:`mlp_sublayer_bwd_plain`, :func:`mlp_sublayer_bwd_split_plain`,
:func:`block_plain`, :func:`attn_sublayer_v1_plain`) for a tensor on the CPU. For a CUDA tensor
it launches its kernel or raises; it counts its launches in ``.launches``.

Both take packed operands (:func:`pack_attn`, :func:`pack_mlp`): weights
transposed to (in, out) and cast to the activation dtype, the softmax scale
folded into the q columns of the qkv weight and bias before the cast (as the
Pallas wrapper does), biases and LayerNorm affine in fp32. Numerics follow
the Pallas kernels: LayerNorm two-pass in fp32, matmuls on operands in the
activation dtype with fp32 accumulation, fp32 softmax normalised after the
value product, residual and bias added in fp32, one rounding to the
activation dtype at each point where the Pallas kernel rounds.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

# what the CUDA kernels take: bf16 activations, a head width the attention
# cores are built for (HEAD_WIDTHS: 64, every config of the repository, and
# 72, U-ViT-H's; the library reports them, duodiff_attn_head_width), a
# 16-byte aligned row of every operand (widths multiple of 8), rows of at
# most ROW_MAX_WIDTH for the LayerNorm passes that hold a row in a warp's
# registers (the LayerNorm + quant of K11 / K12, the LayerNorm backward of
# K6 / K7 / K8), and a sequence the attention cores can hold, the limit the
# library reports for each width: the forward core (K1, K1-v1, K5, K9, K11,
# K15's bf16 form; duodiff_attn_core_max_len) and the backward core (K6,
# K10; duodiff_attn_bwd_core_max_len) keep 16 whole fp32 score rows a warp in
# registers up to L = 272 and walk the keys in blocks past it, up to 16,384;
# the int8 chain of K15 (duodiff_sdpa_int8_max_len, head width 64 only)
# keeps the rows in registers and stops at 272. A block's shared memory is
# held to the 227 KB opt-in limit less a margin of 256 bytes. Checked on the
# card at D = 512 with 8 heads and L = 257, at D = 768 with 12 heads,
# D = 1024 with 16 and D = 1152 with 16 heads of 72, each at L = 258, and at
# D = 512 with 8 heads at L = 1025 (chip_smoke.py phases 2, 21 and 22)
HEAD_WIDTHS = (64, 72)
ROW_MAX_WIDTH = 2048
_MAX_SMEM_BYTES = 227 * 1024 - 256


def _widths_text(widths) -> str:
    return " or ".join(str(w) for w in widths)


def head_width(a: int, num_heads: int, what: str) -> int:
    """A / num_heads, the head width of an attention sublayer whose A = H * Dh
    columns hold ``num_heads`` heads, if it is one of HEAD_WIDTHS; else raise,
    naming them."""
    dh, rem = divmod(a, num_heads)
    if rem or dh not in HEAD_WIDTHS:
        raise ValueError(f"{what} takes head width {_widths_text(HEAD_WIDTHS)}: A={a} is not "
                         f"{num_heads} heads of one of them")
    return dh


def _check_seq_len(lib, l: int, dh: int, backward: bool = False, int8: bool = False) -> None:
    """Raise unless the attention core (its backward, or K15's int8 core,
    whose width 64 the caller holds) takes length l at head width dh, as the
    library reports: the longest length for the width, 0 for a width it
    does not take."""
    if backward:
        limit, what = lib.duodiff_attn_bwd_core_max_len(dh), "attention backward core"
    elif int8:
        limit, what = lib.duodiff_sdpa_int8_max_len(), "int8 attention core"
    else:
        limit, what = lib.duodiff_attn_core_max_len(dh), "attention core"
    if limit == 0:
        raise ValueError(f"the {what} takes head width "
                         f"{_widths_text(library_head_widths(lib))}, got {dh}")
    if l > limit:
        raise ValueError(f"sequence length {l} does not fit the {what} (at most {limit}) at "
                         f"head width {dh}")


def library_head_widths(lib) -> tuple:
    """The head widths the built attention cores take, as the library
    reports them (duodiff_attn_head_width)."""
    widths, i = [], 0
    while w := lib.duodiff_attn_head_width(i):
        widths.append(w)
        i += 1
    return tuple(widths)


def check_row_width(d: int, what: str = "D") -> None:
    """Raise unless the LayerNorm passes that hold a row in a warp's
    registers take rows of width d."""
    if d % 8 or d > ROW_MAX_WIDTH:
        raise ValueError(f"{what} must be a multiple of 8 and at most {ROW_MAX_WIDTH} (the "
                         f"LayerNorm passes hold a row in a warp's registers), got {d}")


def attn_operands(ln_w, ln_b, qkv_w, qkv_b, proj_w, proj_b, *, num_heads: int, dtype):
    """The packed K1 operands (ln_scale, ln_bias, wqkv (D, 3A), bqkv (3A,) or
    None, wp (A, D), bp (D,)) from torch-layout parameters, differentiably
    (the plain training path runs autograd through them)."""
    a = proj_w.shape[1]
    scale = float(a // num_heads) ** -0.5
    w = qkv_w.float().t()
    wqkv = torch.cat([w[:, :a] * scale, w[:, a:]], dim=1).to(dtype).contiguous()
    bqkv = None
    if qkv_b is not None:
        b = qkv_b.float()
        bqkv = torch.cat([b[:a] * scale, b[a:]]).contiguous()
    return (ln_w.float().contiguous(), ln_b.float().contiguous(), wqkv, bqkv,
            proj_w.t().to(dtype).contiguous(), proj_b.float().contiguous())


def attn_operands_v1(ln_w, ln_b, qkv_w, qkv_b, proj_w, proj_b, *, dtype):
    """The packed K1-v1 operands (ln_scale, ln_bias, wqkv (3, D, A), bqkv
    (3, A) or None, wp (A, D), bp (D,)): block i of wqkv is the (D, A) weight
    of q, k or v, WITHOUT the softmax scale, which the v1 kernel applies to
    the fp32 scores. The shape tells the packing from :func:`attn_operands`'s
    (D, 3A) with the scale folded in; either variant refuses the other's."""
    a, d = proj_w.shape[1], qkv_w.shape[1]
    wqkv = qkv_w.reshape(3, a, d).transpose(1, 2).to(dtype).contiguous()
    bqkv = None if qkv_b is None else qkv_b.float().reshape(3, a).contiguous()
    return (ln_w.float().contiguous(), ln_b.float().contiguous(), wqkv, bqkv,
            proj_w.t().to(dtype).contiguous(), proj_b.float().contiguous())


def mlp_operands(ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, *, dtype):
    """The packed K2 operands (ln_scale, ln_bias, w1 (D, 4D), b1, w2 (4D, D),
    b2) from torch-layout parameters, differentiably."""
    return (ln_w.float().contiguous(), ln_b.float().contiguous(),
            fc1_w.t().to(dtype).contiguous(), fc1_b.float().contiguous(),
            fc2_w.t().to(dtype).contiguous(), fc2_b.float().contiguous())


def _detached(ops):
    return tuple(None if t is None else t.detach() for t in ops)


def pack_attn(norm, qkv, proj, *, num_heads: int, dtype):
    """:func:`attn_operands` of torch LayerNorm and Linear modules, detached."""
    return _detached(attn_operands(norm.weight, norm.bias, qkv.weight, qkv.bias, proj.weight,
                                   proj.bias, num_heads=num_heads, dtype=dtype))


def pack_attn_v1(norm, qkv, proj, *, dtype):
    """:func:`attn_operands_v1` of torch LayerNorm and Linear modules, detached."""
    return _detached(attn_operands_v1(norm.weight, norm.bias, qkv.weight, qkv.bias,
                                      proj.weight, proj.bias, dtype=dtype))


def pack_mlp(norm, fc1, fc2, *, dtype):
    """:func:`mlp_operands` of torch LayerNorm and Linear modules, detached."""
    return _detached(mlp_operands(norm.weight, norm.bias, fc1.weight, fc1.bias, fc2.weight,
                                  fc2.bias, dtype=dtype))


def _ln_fwd(xv, scale, bias, eps):
    """fp32 two-pass LayerNorm pieces (pallas_block._ln_fwd): (x_hat, rstd, xn)."""
    mean = xv.mean(-1, keepdim=True)
    var = (xv - mean).square().mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    x_hat = (xv - mean) * rstd
    return x_hat, rstd, x_hat * scale + bias


def _layer_norm(xv, scale, bias, eps):
    return _ln_fwd(xv, scale, bias, eps)[2]


def _ln_bwd_dx(dxn, x_hat, rstd, gamma):
    """dL/dx of the LayerNorm from dL/dxn, fp32 (pallas_block._ln_bwd_dx)."""
    dxh = dxn * gamma
    m1 = dxh.mean(-1, keepdim=True)
    m2 = (dxh * x_hat).mean(-1, keepdim=True)
    return rstd * (dxh - m1 - x_hat * m2)


def attention_core_plain(qkv, num_heads: int, dtype):
    """The SDPA core of K1 and K11 on a packed (B, L, 3A) qkv whose values
    are ``dtype``-rounded and whose q is pre-scaled: fp32 scores, e rounded
    to ``dtype`` for the value product, fp32 denominator applied after it;
    returns the merged heads (B, L, A) in ``dtype``."""
    b, l, three_a = qkv.shape
    a = three_a // 3
    qkv = qkv.float()
    q, k, v = (qkv[..., i * a:(i + 1) * a].reshape(b, l, num_heads, a // num_heads)
               for i in range(3))
    s = torch.einsum("blhe,bmhe->bhlm", q, k)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    denom = e.sum(-1, keepdim=True)
    o = torch.einsum("bhlm,bmhe->blhe", e.to(dtype).float(), v)
    return (o / denom.transpose(1, 2)).to(dtype).reshape(b, l, a)


def attn_sublayer_plain(x, ln_scale, ln_bias, wqkv, bqkv, wp, bp, *,
                        num_heads: int, eps: float = 1e-5, residual: bool = True):
    """Plain PyTorch K1 (pallas_block._attn_sublayer_reference with the
    scale pre-folded into ``wqkv``); ``residual=False`` returns the shard's
    partial ``proj + bp`` without ``x +``."""
    dt = x.dtype
    xv = x.float()
    xn = _layer_norm(xv, ln_scale.float(), ln_bias.float(), eps).to(dt)
    qkv = torch.matmul(xn.float(), wqkv.float())
    if bqkv is not None:
        qkv = qkv + bqkv.float()
    merged = attention_core_plain(qkv.to(dt), num_heads, dt)
    proj = torch.matmul(merged.float(), wp.float())
    if residual:
        proj = proj + xv
    return (proj + bp.float()).to(dt)


def _check_packing(variant: str, x, wqkv, bqkv, wp) -> None:
    """Refuse the other variant's packed qkv weight: v2 reads (D, 3A) with
    the softmax scale folded into q, v1 (3, D, A) without it, so taking one
    for the other would scale the scores twice or not at all."""
    if variant not in ("v1", "v2"):
        raise ValueError(f"variant must be 'v1' or 'v2', got {variant!r}")
    d, a = x.shape[-1], wp.shape[0]
    want = (3, d, a) if variant == "v1" else (d, 3 * a)
    if tuple(wqkv.shape) != want:
        other = "pack_attn (scale folded into q)" if variant == "v1" else "pack_attn_v1 (unscaled)"
        raise ValueError(
            f"variant {variant!r} takes a packed qkv weight of shape {want}, got "
            f"{tuple(wqkv.shape)}: operands of {other} belong to the other variant")
    if variant == "v1":
        if a != d:
            raise ValueError("variant 'v1' supports only the square residual form: "
                             f"A={a}, D={d}")
        if bqkv is not None and tuple(bqkv.shape) != (3, a):
            raise ValueError(f"variant 'v1' takes bqkv of shape {(3, a)}, got {tuple(bqkv.shape)}")


def attn_sublayer_v1_plain(x, ln_scale, ln_bias, wqkv, bqkv, wp, bp, *,
                           num_heads: int, eps: float = 1e-5):
    """Plain PyTorch K1-v1 (pallas_block._kernel) on the operands of
    :func:`pack_attn_v1`: q, k and v rounded to x's dtype per head from the
    unscaled weight, fp32 scores times the scale, p = softmax rounded after
    the division, each head's output rounded, and the proj products summed
    over heads in fp32 onto x + b_proj."""
    _check_packing("v1", x, wqkv, bqkv, wp)
    dt = x.dtype
    b, l, d = x.shape
    dh = d // num_heads
    xv = x.float()
    xn = _layer_norm(xv, ln_scale.float(), ln_bias.float(), eps).to(dt)
    qkv = torch.matmul(xn.float()[None], wqkv.float()[:, None])  # (3, B, L, A)
    if bqkv is not None:
        qkv = qkv + bqkv.float()[:, None, None, :]
    q, k, v = (t.reshape(b, l, num_heads, dh) for t in qkv.to(dt).float())
    s = torch.einsum("blhe,bmhe->bhlm", q, k) * float(dh) ** -0.5
    p = torch.softmax(s, dim=-1).to(dt).float()
    merged = torch.einsum("bhlm,bmhe->blhe", p, v).to(dt).reshape(b, l, d)
    proj = torch.matmul(merged.float(), wp.float())
    return (proj + (xv + bp.float())).to(dt)


def block_plain(x, ln1_scale, ln1_bias, wqkv, bqkv, wp, bp, ln2_scale, ln2_bias, w1, b1, w2,
                b2, *, num_heads: int, gelu_approx: bool = False, eps: float = 1e-5):
    """Plain PyTorch K5 (pallas_block._block_kernel) on the operands of
    :func:`pack_attn` and :func:`pack_mlp`: the two sublayers with the
    intermediate u = x + proj + b_proj kept in fp32 through the second
    LayerNorm and the last residual add, where :func:`attn_sublayer_plain`
    then :func:`mlp_sublayer_plain` round it to x's dtype in between."""
    _check_packing("v2", x, wqkv, bqkv, wp)
    dt = x.dtype
    xv = x.float()
    xn = _layer_norm(xv, ln1_scale.float(), ln1_bias.float(), eps).to(dt)
    qkv = torch.matmul(xn.float(), wqkv.float())
    if bqkv is not None:
        qkv = qkv + bqkv.float()
    merged = attention_core_plain(qkv.to(dt), num_heads, dt)
    u = xv + torch.matmul(merged.float(), wp.float()) + bp.float()
    un = _layer_norm(u, ln2_scale.float(), ln2_bias.float(), eps).to(dt)
    hidden = torch.matmul(un.float(), w1.float()) + b1.float()
    hidden = F.gelu(hidden, approximate="tanh" if gelu_approx else "none").to(dt)
    out = torch.matmul(hidden.float(), w2.float())
    return (u + out + b2.float()).to(dt)


def mlp_sublayer_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, *,
                       gelu_approx: bool = False, eps: float = 1e-5, residual: bool = True):
    """Plain PyTorch K2 (pallas_block._mlp_reference); ``residual=False``
    returns the hidden slice's partial ``fc2 + b2`` without ``x +``."""
    dt = x.dtype
    xv = x.float()
    xn = _layer_norm(xv, ln_scale.float(), ln_bias.float(), eps).to(dt)
    hidden = torch.matmul(xn.float(), w1.float()) + b1.float()
    hidden = F.gelu(hidden, approximate="tanh" if gelu_approx else "none").to(dt)
    out = torch.matmul(hidden.float(), w2.float())
    if residual:
        out = out + xv
    return (out + b2.float()).to(dt)


def _rows(t):
    """(B, L, N) -> (B*L, N)."""
    return t.reshape(-1, t.shape[-1])


def attn_sublayer_bwd_plain(x, dy, ln_s, ln_b, wqkv, bqkv, wp, *, num_heads: int,
                            eps: float = 1e-5, residual: bool = True):
    """Plain PyTorch K6 (pallas_block._attn_bwd_kernel): the gradients of
    K1 for the UNSCALED qkv weight ``wqkv`` (D, 3A), the scale applied to q
    inside. Returns (dx, dgamma, dbeta, dWqkv (D, 3A), dbqkv (3A,) or None,
    dWp (A, D), dbp (D,)): dx in x's dtype, the rest fp32. Rounds to the
    activation dtype where the Pallas kernel does: xn, qkv, dm, bf16(e),
    bf16(do * r), dsp, bf16(qsc * r) and the dq / dk / dv heads; fp32
    elsewhere. ``residual=False`` (a shard's) leaves the ``+ dy`` out of dx."""
    dt = x.dtype
    b, l, d = x.shape
    a = wp.shape[0]
    dh = a // num_heads
    scale = float(dh) ** -0.5
    gamma = ln_s.float()
    x_hat, rstd, xn = _ln_fwd(x.float(), gamma, ln_b.float(), eps)
    xn = xn.to(dt).float()
    wq, wpf = wqkv.to(dt).float(), wp.to(dt).float()
    qkv = xn @ wq
    if bqkv is not None:
        qkv = qkv + bqkv.float()
    qkv = qkv.to(dt).float()
    dyf = dy.to(dt).float()
    dm = (dyf @ wpf.t()).to(dt).float()

    def heads(t):  # (B, L, A) -> (B, H, L, Dh)
        return t.reshape(b, l, num_heads, dh).transpose(1, 2)

    def merge(t):
        return t.transpose(1, 2).reshape(b, l, a)

    q, k, v = (heads(qkv[..., i * a:(i + 1) * a]) for i in range(3))
    do = heads(dm)
    qsc = (q * scale).to(dt).float()
    s = qsc @ k.transpose(-1, -2)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    r = 1.0 / e.sum(-1, keepdim=True)
    eb = e.to(dt).float()
    merged = ((eb @ v) * r).to(dt).float()
    dv = (eb.transpose(-1, -2) @ (do * r).to(dt).float()).to(dt)
    dp = do @ v.transpose(-1, -2)
    c = (dp * e).sum(-1, keepdim=True) * r
    dsp = (e * (dp - c)).to(dt).float()
    dq = ((dsp @ k) * (r * scale)).to(dt)
    dk = (dsp.transpose(-1, -2) @ (qsc * r).to(dt).float()).to(dt)
    dqkv = torch.cat([merge(dq), merge(dk), merge(dv)], dim=-1).float()
    dwp = _rows(merge(merged)).t() @ _rows(dyf)
    dwqkv = _rows(xn).t() @ _rows(dqkv)
    dbqkv = dqkv.sum((0, 1)) if bqkv is not None else None
    dxn = dqkv @ wq.t()
    dx = _ln_bwd_dx(dxn, x_hat, rstd, gamma)
    dx = (dx + dyf if residual else dx).to(dt)
    return (dx, (dxn * x_hat).sum((0, 1)), dxn.sum((0, 1)), dwqkv, dbqkv, dwp,
            dyf.sum((0, 1)))


def gelu_grad(h, approx: bool):
    """d gelu(h) / dh in fp32 (pallas_block._gelu_grad, exact erf)."""
    if approx:
        c, a = 0.7978845608028654, 0.044715
        t = torch.tanh(c * (h + a * h * h * h))
        return 0.5 * (1.0 + t) + 0.5 * h * (1.0 - t * t) * c * (1.0 + 3.0 * a * h * h)
    phi = torch.exp(-0.5 * h * h) * 0.3989422804014327
    return 0.5 * (1.0 + torch.erf(h * 2.0 ** -0.5)) + h * phi


def mlp_sublayer_bwd_plain(x, dy, ln_s, ln_b, w1, b1, w2, *, gelu_approx: bool = False,
                           eps: float = 1e-5, residual: bool = True):
    """Plain PyTorch K7 (pallas_block._mlp_bwd_kernel): the gradients of K2.
    Returns (dx, dgamma, dbeta, dW1 (D, Hd), db1, dW2 (Hd, D), db2): dx in
    x's dtype, the rest fp32. Rounds xn, gelu(h_pre) and dh * gelu'(h_pre)
    to the activation dtype, as the Pallas kernel does; db1 sums the
    unrounded fp32 dh * gelu'(h_pre). ``residual=False`` (a shard's) leaves
    the ``+ dy`` out of dx."""
    dt = x.dtype
    gamma = ln_s.float()
    x_hat, rstd, xn = _ln_fwd(x.float(), gamma, ln_b.float(), eps)
    xn = xn.to(dt).float()
    w1f, w2f = w1.to(dt).float(), w2.to(dt).float()
    dyf = dy.to(dt).float()
    h_pre = xn @ w1f + b1.float()
    hgb = F.gelu(h_pre, approximate="tanh" if gelu_approx else "none").to(dt).float()
    dhp = (dyf @ w2f.t()) * gelu_grad(h_pre, gelu_approx)
    dhpb = dhp.to(dt).float()
    dxn = dhpb @ w1f.t()
    dx = _ln_bwd_dx(dxn, x_hat, rstd, gamma)
    dx = (dx + dyf if residual else dx).to(dt)
    return (dx, (dxn * x_hat).sum((0, 1)), dxn.sum((0, 1)), _rows(xn).t() @ _rows(dhpb),
            dhp.sum((0, 1)), _rows(hgb).t() @ _rows(dyf), dyf.sum((0, 1)))


def _check_splits(hidden: int, splits: int) -> int:
    """The slice width hidden / splits of the plain version (16-byte rows);
    the kernel takes the same ``splits``, as row chunks."""
    if splits < 1 or hidden % splits or (hidden // splits) % 8:
        raise ValueError(f"splits must divide the hidden width {hidden} into slices that are "
                         f"multiples of 8, got {splits}")
    return hidden // splits


def mlp_sublayer_bwd_split_plain(x, dy, ln_s, ln_b, w1, b1, w2, *, splits: int,
                                 gelu_approx: bool = False, eps: float = 1e-5):
    """Plain PyTorch K8 (pallas_block._mlp_sublayer_bwd_split): what
    :func:`mlp_sublayer_bwd_plain` returns, computed as JAX computes it,
    slice by slice of the hidden width. Per slice: h_pre on w1[:, s],
    gelu(h_pre) and dh * gelu'(h_pre) rounded to x's dtype before the
    weight-gradient products, and an fp32 dxn partial; the partials are added
    in slice order, then the LayerNorm backward, its + dy and db2 happen once.
    The kernel cuts the rows instead (:func:`fused_mlp_sublayer_bwd_split`):
    the same roundings, fp32 sums in another order."""
    dt = x.dtype
    hs = _check_splits(w1.shape[1], splits)
    gamma = ln_s.float()
    x_hat, rstd, xn = _ln_fwd(x.float(), gamma, ln_b.float(), eps)
    xn = xn.to(dt).float()
    w1f, w2f = w1.to(dt).float(), w2.to(dt).float()
    dyf = dy.to(dt).float()
    dxn = None
    dw1, db1, dw2 = [], [], []
    for lo in range(0, splits * hs, hs):
        w1s = w1f[:, lo:lo + hs]
        h_pre = xn @ w1s + b1.float()[lo:lo + hs]
        hgb = F.gelu(h_pre, approximate="tanh" if gelu_approx else "none").to(dt).float()
        dhp = (dyf @ w2f[lo:lo + hs].t()) * gelu_grad(h_pre, gelu_approx)
        dhpb = dhp.to(dt).float()
        dw2.append(_rows(hgb).t() @ _rows(dyf))
        db1.append(dhp.sum((0, 1)))
        dw1.append(_rows(xn).t() @ _rows(dhpb))
        part = dhpb @ w1s.t()
        dxn = part if dxn is None else dxn + part
    dx = (dyf + _ln_bwd_dx(dxn, x_hat, rstd, gamma)).to(dt)
    return (dx, (dxn * x_hat).sum((0, 1)), dxn.sum((0, 1)), torch.cat(dw1, dim=1),
            torch.cat(db1), torch.cat(dw2, dim=0), dyf.sum((0, 1)))


def _count(wrapper, residual: bool) -> None:
    """One launch of ``wrapper``'s kernel, in its square form's counter or
    its shard form's."""
    if residual:
        wrapper.launches += 1
    else:
        wrapper.launches_shard += 1


def _check(name, t, shape, dtype, device):
    if t.device.type != "cuda":
        raise ValueError(f"{name} is on {t.device}: the kernels take CUDA tensors")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on_error(lib, name: str, err: int) -> None:
    if err:
        msg = lib.duodiff_error_string(err).decode()
        raise RuntimeError(f"{name} failed: CUDA error {err} ({msg})")


def _attn_dims(x, wp, num_heads: int, residual: bool = True):
    """(B, L, D, A, Dh) of an attention sublayer the kernels take: the
    square form A == D, or with ``residual=False`` a shard's A < D, each
    with A = num_heads * Dh for a head width Dh of HEAD_WIDTHS."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, L, D), got {tuple(x.shape)}")
    b, l, d = x.shape
    a = wp.shape[0]
    form = "the square form A == D" if residual else "the shard form A <= D"
    if a != d if residual else a > d:
        raise ValueError(f"the kernel takes {form}: A={a}, D={d}, num_heads={num_heads}")
    dh = head_width(a, num_heads, f"the kernel's {form[4:]}")
    if d % 8:
        raise ValueError(f"D must be a multiple of 8, got {d}")
    return b, l, d, a, dh


def _attn_sublayer_cuda(x, ln_scale, ln_bias, wqkv, bqkv, wp, bp, *,
                        num_heads: int, eps: float, variant: str = "v2",
                        residual: bool = True):
    """Check the operands and launch K1 (the LayerNorm, qkv GEMM, attention
    core and proj GEMM launches of csrc/attn_sublayer.cu; with
    ``residual=False`` its shard form) or, for variant "v1", K1-v1 (the
    LayerNorm, three q / k / v GEMMs, normalise-first attention core and
    proj GEMM launches of csrc/attn_sublayer_v1.cu)."""
    from duodiff_tpu_torch.ops._build import load_library

    b, l, d, a, dh = _attn_dims(x, wp, num_heads, residual)
    v1 = variant == "v1"
    dev, bf16, f32 = x.device, torch.bfloat16, torch.float32
    _check("x", x, (b, l, d), bf16, dev)
    _check("ln_scale", ln_scale, (d,), f32, dev)
    _check("ln_bias", ln_bias, (d,), f32, dev)
    _check("wqkv", wqkv, (3, d, a) if v1 else (d, 3 * a), bf16, dev)
    if bqkv is not None:
        _check("bqkv", bqkv, (3, a) if v1 else (3 * a,), f32, dev)
    _check("wp", wp, (a, d), bf16, dev)
    _check("bp", bp, (d,), f32, dev)
    lib = load_library()
    _check_seq_len(lib, l, dh)
    xn = torch.empty_like(x)
    # v2 packs q, k, v per row (B, L, 3A); v1 keeps them apart, (3, B, L, A)
    qkv = torch.empty((3, b, l, a) if v1 else (b, l, 3 * a), dtype=bf16, device=dev)
    merged = torch.empty((b, l, a), dtype=bf16, device=dev)
    y = torch.empty_like(x)
    ptrs = (_ptr(x), _ptr(ln_scale), _ptr(ln_bias), _ptr(wqkv), _ptr(bqkv), _ptr(wp), _ptr(bp),
            _ptr(xn), _ptr(qkv), _ptr(merged), _ptr(y))
    stream = torch.cuda.current_stream(dev).cuda_stream
    if v1:
        err = lib.duodiff_attn_sublayer_v1(*ptrs, b, l, d, num_heads, dh, eps, stream)
    else:
        err = lib.duodiff_attn_sublayer(*ptrs, b, l, d, num_heads, dh, int(residual), eps,
                                        stream)
    _raise_on_error(lib, f"attention sublayer kernel ({variant})", err)
    return y


def _fused_block_cuda(x, ln1_scale, ln1_bias, wqkv, bqkv, wp, bp, ln2_scale, ln2_bias, w1, b1,
                      w2, b2, *, num_heads: int, gelu_approx: bool, eps: float):
    """Check the operands and launch K5 (csrc/fused_block.cu): K1's and K2's
    launches with the intermediate residual stream in an fp32 scratch."""
    from duodiff_tpu_torch.ops._build import load_library

    b, l, d, a, dh = _attn_dims(x, wp, num_heads)
    hid = w1.shape[1]
    if hid % 8:
        raise ValueError(f"the hidden width must be a multiple of 8, got {hid}")
    dev, bf16, f32 = x.device, torch.bfloat16, torch.float32
    _check("x", x, (b, l, d), bf16, dev)
    for name, t in (("ln1_scale", ln1_scale), ("ln1_bias", ln1_bias), ("bp", bp),
                    ("ln2_scale", ln2_scale), ("ln2_bias", ln2_bias), ("b2", b2)):
        _check(name, t, (d,), f32, dev)
    _check("wqkv", wqkv, (d, 3 * a), bf16, dev)
    if bqkv is not None:
        _check("bqkv", bqkv, (3 * a,), f32, dev)
    _check("wp", wp, (a, d), bf16, dev)
    _check("w1", w1, (d, hid), bf16, dev)
    _check("b1", b1, (hid,), f32, dev)
    _check("w2", w2, (hid, d), bf16, dev)
    lib = load_library()
    _check_seq_len(lib, l, dh)
    xn = torch.empty_like(x)
    qkv = torch.empty((b, l, 3 * a), dtype=bf16, device=dev)
    merged = torch.empty((b, l, a), dtype=bf16, device=dev)
    u = torch.empty((b, l, d), dtype=f32, device=dev)
    hidden = torch.empty((b, l, hid), dtype=bf16, device=dev)
    y = torch.empty_like(x)
    err = lib.duodiff_fused_block(
        _ptr(x), _ptr(ln1_scale), _ptr(ln1_bias), _ptr(wqkv), _ptr(bqkv), _ptr(wp), _ptr(bp),
        _ptr(ln2_scale), _ptr(ln2_bias), _ptr(w1), _ptr(b1), _ptr(w2), _ptr(b2),
        _ptr(xn), _ptr(qkv), _ptr(merged), _ptr(u), _ptr(hidden), _ptr(y),
        b, l, d, num_heads, dh, hid, 2 if gelu_approx else 1, eps,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on_error(lib, "whole-block kernel", err)
    return y


def _mlp_sublayer_cuda(x, ln_scale, ln_bias, w1, b1, w2, b2, *,
                       gelu_approx: bool, eps: float, residual: bool = True):
    """Check the operands and launch K2 (the LayerNorm, fc1 GEMM and fc2 GEMM
    launches of csrc/mlp_sublayer.cu; with ``residual=False`` its shard form)."""
    from duodiff_tpu_torch.ops._build import load_library

    if x.dim() != 3:
        raise ValueError(f"x must be (B, L, D), got {tuple(x.shape)}")
    b, l, d = x.shape
    hid = w1.shape[1]
    if d % 8 or hid % 8:
        raise ValueError(f"D and the hidden width must be multiples of 8: {d}, {hid}")
    dev, bf16, f32 = x.device, torch.bfloat16, torch.float32
    _check("x", x, (b, l, d), bf16, dev)
    _check("ln_scale", ln_scale, (d,), f32, dev)
    _check("ln_bias", ln_bias, (d,), f32, dev)
    _check("w1", w1, (d, hid), bf16, dev)
    _check("b1", b1, (hid,), f32, dev)
    _check("w2", w2, (hid, d), bf16, dev)
    _check("b2", b2, (d,), f32, dev)
    lib = load_library()
    xn = torch.empty_like(x)
    hidden = torch.empty((b, l, hid), dtype=bf16, device=dev)
    y = torch.empty_like(x)
    err = lib.duodiff_mlp_sublayer(
        _ptr(x), _ptr(ln_scale), _ptr(ln_bias), _ptr(w1), _ptr(b1), _ptr(w2),
        _ptr(b2), _ptr(xn), _ptr(hidden), _ptr(y), b * l, d, hid,
        2 if gelu_approx else 1, int(residual), eps, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on_error(lib, "MLP sublayer kernel", err)
    return y


def _attn_sublayer_bwd_cuda(x, dy, ln_s, ln_b, wqkv, bqkv, wp, *, num_heads: int, eps: float,
                            residual: bool = True):
    """Check the operands and launch K6 (csrc/attn_sublayer_bwd.cu, with
    ``residual=False`` its shard form) with one scratch workspace; returns
    what :func:`attn_sublayer_bwd_plain` does."""
    from duodiff_tpu_torch.ops._build import load_library

    b, l, d, a, dh = _attn_dims(x, wp, num_heads, residual)
    check_row_width(d)
    dev, bf16, f32 = x.device, torch.bfloat16, torch.float32
    _check("x", x, (b, l, d), bf16, dev)
    _check("dy", dy, (b, l, d), bf16, dev)
    _check("ln_scale", ln_s, (d,), f32, dev)
    _check("ln_bias", ln_b, (d,), f32, dev)
    _check("wqkv", wqkv, (d, 3 * a), bf16, dev)
    if bqkv is not None:
        _check("bqkv", bqkv, (3 * a,), f32, dev)
    _check("wp", wp, (a, d), bf16, dev)
    lib = load_library()
    _check_seq_len(lib, l, dh, backward=True)
    ws = torch.empty(lib.duodiff_attn_sublayer_bwd_workspace(b, l, d, num_heads, dh),
                     dtype=torch.uint8, device=dev)
    dx = torch.empty_like(x)
    dg, db, dbp = (torch.empty(d, dtype=f32, device=dev) for _ in range(3))
    dwqkv = torch.empty((d, 3 * a), dtype=f32, device=dev)
    dbqkv = None if bqkv is None else torch.empty(3 * a, dtype=f32, device=dev)
    dwp = torch.empty((a, d), dtype=f32, device=dev)
    err = lib.duodiff_attn_sublayer_bwd(
        _ptr(x), _ptr(dy), _ptr(ln_s), _ptr(ln_b), _ptr(wqkv), _ptr(bqkv), _ptr(wp),
        _ptr(dx), _ptr(dg), _ptr(db), _ptr(dwqkv), _ptr(dbqkv), _ptr(dwp), _ptr(dbp),
        _ptr(ws), b, l, d, num_heads, dh, int(residual), eps,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on_error(lib, "attention sublayer backward kernel", err)
    return dx, dg, db, dwqkv, dbqkv, dwp, dbp


def _mlp_bwd_dims(x, dy, ln_s, ln_b, w1, b1, w2):
    """Check the operands of an MLP sublayer backward; returns (B, L, D, hidden)."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, L, D), got {tuple(x.shape)}")
    b, l, d = x.shape
    hid = w1.shape[1]
    if d % 8 or hid % 8:
        raise ValueError(f"D and the hidden width must be multiples of 8: {d}, {hid}")
    check_row_width(d)
    dev, bf16, f32 = x.device, torch.bfloat16, torch.float32
    _check("x", x, (b, l, d), bf16, dev)
    _check("dy", dy, (b, l, d), bf16, dev)
    _check("ln_scale", ln_s, (d,), f32, dev)
    _check("ln_bias", ln_b, (d,), f32, dev)
    _check("w1", w1, (d, hid), bf16, dev)
    _check("b1", b1, (hid,), f32, dev)
    _check("w2", w2, (hid, d), bf16, dev)
    return b, l, d, hid


def _mlp_sublayer_bwd_cuda(x, dy, ln_s, ln_b, w1, b1, w2, *, gelu_approx: bool, eps: float,
                           residual: bool = True):
    """Check the operands and launch K7 (csrc/mlp_sublayer_bwd.cu, with
    ``residual=False`` its shard form) with one scratch workspace; returns
    what :func:`mlp_sublayer_bwd_plain` does."""
    from duodiff_tpu_torch.ops._build import load_library

    b, l, d, hid = _mlp_bwd_dims(x, dy, ln_s, ln_b, w1, b1, w2)
    dev, f32 = x.device, torch.float32
    lib = load_library()
    ws = torch.empty(lib.duodiff_mlp_sublayer_bwd_workspace(b * l, d, hid), dtype=torch.uint8,
                     device=dev)
    dx = torch.empty_like(x)
    dg, db, db2 = (torch.empty(d, dtype=f32, device=dev) for _ in range(3))
    dw1 = torch.empty((d, hid), dtype=f32, device=dev)
    db1 = torch.empty(hid, dtype=f32, device=dev)
    dw2 = torch.empty((hid, d), dtype=f32, device=dev)
    err = lib.duodiff_mlp_sublayer_bwd(
        _ptr(x), _ptr(dy), _ptr(ln_s), _ptr(ln_b), _ptr(w1), _ptr(b1), _ptr(w2),
        _ptr(dx), _ptr(dg), _ptr(db), _ptr(dw1), _ptr(db1), _ptr(dw2), _ptr(db2),
        _ptr(ws), b * l, d, hid, 2 if gelu_approx else 1, int(residual), eps,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on_error(lib, "MLP sublayer backward kernel", err)
    return dx, dg, db, dw1, db1, dw2, db2


def _mlp_sublayer_bwd_split_cuda(x, dy, ln_s, ln_b, w1, b1, w2, *, splits: int,
                                 gelu_approx: bool, eps: float):
    """Check the operands and launch K8 (csrc/mlp_sublayer_bwd_split.cu) with
    one scratch workspace, whose size follows ``splits``; returns what
    :func:`mlp_sublayer_bwd_split_plain` does."""
    from duodiff_tpu_torch.ops._build import load_library

    _check_splits(w1.shape[1], splits)
    b, l, d, hid = _mlp_bwd_dims(x, dy, ln_s, ln_b, w1, b1, w2)
    dev, f32 = x.device, torch.float32
    lib = load_library()
    ws = torch.empty(lib.duodiff_mlp_sublayer_bwd_split_workspace(b * l, d, hid, splits),
                     dtype=torch.uint8, device=dev)
    dx = torch.empty_like(x)
    dg, db, db2 = (torch.empty(d, dtype=f32, device=dev) for _ in range(3))
    dw1 = torch.empty((d, hid), dtype=f32, device=dev)
    db1 = torch.empty(hid, dtype=f32, device=dev)
    dw2 = torch.empty((hid, d), dtype=f32, device=dev)
    err = lib.duodiff_mlp_sublayer_bwd_split(
        _ptr(x), _ptr(dy), _ptr(ln_s), _ptr(ln_b), _ptr(w1), _ptr(b1), _ptr(w2),
        _ptr(dx), _ptr(dg), _ptr(db), _ptr(dw1), _ptr(db1), _ptr(dw2), _ptr(db2),
        _ptr(ws), b * l, d, hid, splits, 2 if gelu_approx else 1, eps,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on_error(lib, "split MLP sublayer backward kernel", err)
    return dx, dg, db, dw1, db1, dw2, db2


def fused_attn_sublayer(x, ln_scale, ln_bias, wqkv, bqkv, wp, bp, *,
                        num_heads: int, eps: float = 1e-5, variant: str = "v2",
                        residual: bool = True):
    """K1 on packed operands; x (B, L, D). ``variant="v2"`` (default) is the
    full-width form on :func:`pack_attn`'s operands, ``"v1"`` the per-head
    form (K1-v1) on :func:`pack_attn_v1`'s; each refuses the other's packing.
    ``residual=False`` is v2's tensor-parallel shard form: ``num_heads``
    local heads (A = num_heads * Dh <= D) and the partial ``proj + bp``
    without ``x +``; its launches count in ``.launches_shard``. v1 has the
    square residual form only, as in the JAX package; its launches count in
    ``.launches_v1``."""
    _check_packing(variant, x, wqkv, bqkv, wp)
    if variant == "v1" and not residual:
        raise ValueError("variant 'v1' supports only the square residual form")
    if variant == "v1":
        if x.device.type == "cpu":
            return attn_sublayer_v1_plain(x, ln_scale, ln_bias, wqkv, bqkv, wp, bp,
                                          num_heads=num_heads, eps=eps)
        y = _attn_sublayer_cuda(x, ln_scale, ln_bias, wqkv, bqkv, wp, bp,
                                num_heads=num_heads, eps=eps, variant="v1")
        fused_attn_sublayer.launches_v1 += 1
        return y
    if x.device.type == "cpu":
        return attn_sublayer_plain(x, ln_scale, ln_bias, wqkv, bqkv, wp, bp,
                                   num_heads=num_heads, eps=eps, residual=residual)
    y = _attn_sublayer_cuda(x, ln_scale, ln_bias, wqkv, bqkv, wp, bp,
                            num_heads=num_heads, eps=eps, residual=residual)
    _count(fused_attn_sublayer, residual)
    return y


def fused_block(x, ln1_scale, ln1_bias, wqkv, bqkv, wp, bp, ln2_scale, ln2_bias, w1, b1, w2,
                b2, *, num_heads: int, gelu_approx: bool = False, eps: float = 1e-5):
    """K5: a whole block on the operands of :func:`pack_attn` followed by
    those of :func:`pack_mlp` (:func:`block_plain`); x (B, L, D)."""
    ops = (ln1_scale, ln1_bias, wqkv, bqkv, wp, bp, ln2_scale, ln2_bias, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return block_plain(x, *ops, num_heads=num_heads, gelu_approx=gelu_approx, eps=eps)
    y = _fused_block_cuda(x, *ops, num_heads=num_heads, gelu_approx=gelu_approx, eps=eps)
    fused_block.launches += 1
    return y


def fused_mlp_sublayer(x, ln_scale, ln_bias, w1, b1, w2, b2, *,
                       gelu_approx: bool = False, eps: float = 1e-5, residual: bool = True):
    """K2 on packed operands (:func:`pack_mlp`); x (B, L, D). ``residual=False``
    is the shard form on a slice of the hidden columns: the partial ``fc2 +
    b2`` without ``x +``, counted in ``.launches_shard``."""
    if x.device.type == "cpu":
        return mlp_sublayer_plain(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                  gelu_approx=gelu_approx, eps=eps, residual=residual)
    y = _mlp_sublayer_cuda(x, ln_scale, ln_bias, w1, b1, w2, b2,
                           gelu_approx=gelu_approx, eps=eps, residual=residual)
    _count(fused_mlp_sublayer, residual)
    return y


def fused_attn_sublayer_bwd(x, dy, ln_s, ln_b, wqkv, bqkv, wp, *, num_heads: int,
                            eps: float = 1e-5, residual: bool = True):
    """K6: the gradients of K1 (:func:`attn_sublayer_bwd_plain`); wqkv
    (D, 3A) unscaled, wp (A, D), both in x's dtype. ``residual=False`` is
    the shard form (dx without ``+ dy``), counted in ``.launches_shard``."""
    if x.device.type == "cpu":
        return attn_sublayer_bwd_plain(x, dy, ln_s, ln_b, wqkv, bqkv, wp,
                                       num_heads=num_heads, eps=eps, residual=residual)
    grads = _attn_sublayer_bwd_cuda(x, dy, ln_s, ln_b, wqkv, bqkv, wp,
                                    num_heads=num_heads, eps=eps, residual=residual)
    _count(fused_attn_sublayer_bwd, residual)
    return grads


def fused_mlp_sublayer_bwd(x, dy, ln_s, ln_b, w1, b1, w2, *, gelu_approx: bool = False,
                           eps: float = 1e-5, residual: bool = True):
    """K7: the gradients of K2 (:func:`mlp_sublayer_bwd_plain`); w1 (D, Hd)
    and w2 (Hd, D) in x's dtype. ``residual=False`` is the shard form (dx
    without ``+ dy``), counted in ``.launches_shard``."""
    if x.device.type == "cpu":
        return mlp_sublayer_bwd_plain(x, dy, ln_s, ln_b, w1, b1, w2,
                                      gelu_approx=gelu_approx, eps=eps, residual=residual)
    grads = _mlp_sublayer_bwd_cuda(x, dy, ln_s, ln_b, w1, b1, w2,
                                   gelu_approx=gelu_approx, eps=eps, residual=residual)
    _count(fused_mlp_sublayer_bwd, residual)
    return grads


def fused_mlp_sublayer_bwd_split(x, dy, ln_s, ln_b, w1, b1, w2, *, splits: int,
                                 gelu_approx: bool = False, eps: float = 1e-5):
    """K8: the gradients of K2 (those of K7) in scratch bounded by
    ``splits``; operands as K7's. ``splits`` cuts the hidden width into
    slices in the plain version (:func:`mlp_sublayer_bwd_split_plain`, the
    Pallas kernel's order, which a TPU's VMEM set) and the rows into as many
    chunks of whole 128-row tiles on the card, each chunk through K7's
    sequence over the whole hidden width: hgb and dhp take (rows / splits) x
    hidden bf16 there, as one hidden slice of all rows does. The roundings
    are the same; the fp32 weight gradients are summed over the chunks in
    order."""
    if x.device.type == "cpu":
        return mlp_sublayer_bwd_split_plain(x, dy, ln_s, ln_b, w1, b1, w2, splits=splits,
                                            gelu_approx=gelu_approx, eps=eps)
    grads = _mlp_sublayer_bwd_split_cuda(x, dy, ln_s, ln_b, w1, b1, w2, splits=splits,
                                         gelu_approx=gelu_approx, eps=eps)
    fused_mlp_sublayer_bwd_split.launches += 1
    return grads


fused_attn_sublayer.launches = 0
fused_attn_sublayer.launches_v1 = 0
fused_attn_sublayer.launches_shard = 0
fused_mlp_sublayer.launches = 0
fused_mlp_sublayer.launches_shard = 0
fused_block.launches = 0
fused_attn_sublayer_bwd.launches = 0
fused_attn_sublayer_bwd.launches_shard = 0
fused_mlp_sublayer_bwd.launches = 0
fused_mlp_sublayer_bwd.launches_shard = 0
fused_mlp_sublayer_bwd_split.launches = 0


def mlp_bwd_split_config(hidden: int) -> int:
    """The ``splits`` K8 takes (hidden slices in the plain version, row
    chunks on the card): the first of 4, 8, 2 that cuts
    ``hidden`` into slices of a multiple of 8 columns, unless the environment
    variable ``DUODIFF_MLP_BWD_SPLIT_CFG`` names one. The JAX package's
    ``"splits,row_target,hidden_chunk"`` form is accepted; only ``splits``
    means something here, and an override that does not divide ``hidden``
    is passed over, as there."""
    def fits(s: int) -> bool:
        return s > 1 and hidden % s == 0 and (hidden // s) % 8 == 0

    override = os.environ.get("DUODIFF_MLP_BWD_SPLIT_CFG")
    if override:
        s = int(override.split(",")[0])
        if fits(s):
            return s
    for s in (4, 8, 2):
        if fits(s):
            return s
    raise ValueError(f"no split of the hidden width {hidden} into 4, 8 or 2 slices of a "
                     "multiple of 8 columns")


def mlp_sublayer_bwd(x, dy, ln_s, ln_b, w1, b1, w2, *, gelu_approx: bool = False,
                     eps: float = 1e-5, residual: bool = True):
    """The MLP sublayer's backward as training takes it (the counterpart of
    pallas_block._mlp_sublayer_bwd): K8 when the environment variable
    ``DUODIFF_MLP_BWD_SPLIT`` is ``1`` (read at call time), else K7. K7 has
    no limit on the width here, so the variable alone decides. The shard
    form (``residual=False``, tensor parallelism) is K7's whatever the
    variable says: K8 is square only, as JAX takes the split only when
    ``residual`` is true."""
    if not residual:
        return fused_mlp_sublayer_bwd(x, dy, ln_s, ln_b, w1, b1, w2, gelu_approx=gelu_approx,
                                      eps=eps, residual=False)
    if os.environ.get("DUODIFF_MLP_BWD_SPLIT") == "1":
        return fused_mlp_sublayer_bwd_split(x, dy, ln_s, ln_b, w1, b1, w2,
                                            splits=mlp_bwd_split_config(w1.shape[1]),
                                            gelu_approx=gelu_approx, eps=eps)
    return fused_mlp_sublayer_bwd(x, dy, ln_s, ln_b, w1, b1, w2, gelu_approx=gelu_approx,
                                  eps=eps)


class FusedAttnSublayerFn(torch.autograd.Function):
    """K1 forward, K6 backward, on the live torch-layout parameters: the
    counterpart of pallas_block.fused_attn_sublayer_trainable. The forward
    packs the operands as :func:`pack_attn` does (scale folded into q); the
    backward takes the unscaled qkv weight in x's dtype, as K6 does, and
    returns fp32 parameter gradients in torch layout. ``residual=False``
    runs both shard forms on a shard's local heads (``num_heads`` of them):
    the forward's partial and a dx without ``+ dy``
    (``duodiff_tpu_torch/parallel/tp_fused.py`` sums them over the shards)."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, qkv_w, qkv_b, proj_w, proj_b, num_heads, eps,
                residual=True):
        ops = _detached(attn_operands(ln_w, ln_b, qkv_w, qkv_b, proj_w, proj_b,
                                      num_heads=num_heads, dtype=x.dtype))
        ctx.save_for_backward(x, ln_w, ln_b, qkv_w, qkv_b, proj_w)
        ctx.num_heads, ctx.eps, ctx.residual = num_heads, eps, residual
        return fused_attn_sublayer(x, *ops, num_heads=num_heads, eps=eps, residual=residual)

    @staticmethod
    def backward(ctx, dy):
        x, ln_w, ln_b, qkv_w, qkv_b, proj_w = ctx.saved_tensors
        dt = x.dtype
        dx, dg, db, dwqkv, dbqkv, dwp, dbp = fused_attn_sublayer_bwd(
            x, dy.to(dt).contiguous(), ln_w.float().contiguous(), ln_b.float().contiguous(),
            qkv_w.t().to(dt).contiguous(),
            None if qkv_b is None else qkv_b.float().contiguous(),
            proj_w.t().to(dt).contiguous(), num_heads=ctx.num_heads, eps=ctx.eps,
            residual=ctx.residual,
        )
        return dx, dg, db, dwqkv.t(), dbqkv, dwp.t(), dbp, None, None, None


class FusedMlpSublayerFn(torch.autograd.Function):
    """K2 forward, K7 or K8 backward (:func:`mlp_sublayer_bwd`), on the live
    torch-layout parameters: the counterpart of
    pallas_block.fused_mlp_sublayer_trainable. ``residual=False`` runs the
    shard forms of K2 and K7 on a slice of the hidden columns."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, gelu_approx, eps,
                residual=True):
        ops = _detached(mlp_operands(ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, dtype=x.dtype))
        ctx.save_for_backward(x, ln_w, ln_b, fc1_w, fc1_b, fc2_w)
        ctx.gelu_approx, ctx.eps, ctx.residual = gelu_approx, eps, residual
        return fused_mlp_sublayer(x, *ops, gelu_approx=gelu_approx, eps=eps, residual=residual)

    @staticmethod
    def backward(ctx, dy):
        x, ln_w, ln_b, fc1_w, fc1_b, fc2_w = ctx.saved_tensors
        dt = x.dtype
        dx, dg, db, dw1, db1, dw2, db2 = mlp_sublayer_bwd(
            x, dy.to(dt).contiguous(), ln_w.float().contiguous(), ln_b.float().contiguous(),
            fc1_w.t().to(dt).contiguous(), fc1_b.float().contiguous(),
            fc2_w.t().to(dt).contiguous(), gelu_approx=ctx.gelu_approx, eps=ctx.eps,
            residual=ctx.residual,
        )
        return dx, dg, db, dw1.t(), db1, dw2.t(), db2, None, None, None


class FusedBlockFn(torch.autograd.Function):
    """K5 forward with the chained backward, on the live torch-layout
    parameters: the counterpart of pallas_block.fused_block_trainable. The
    backward recomputes the attention sublayer's output u with K1 (rounded
    to x's dtype, as there), takes the MLP sublayer's gradients at u
    (:func:`mlp_sublayer_bwd`: K7 or K8), casts du to x's dtype and runs K6."""

    @staticmethod
    def forward(ctx, x, ln1_w, ln1_b, qkv_w, qkv_b, proj_w, proj_b, ln2_w, ln2_b, fc1_w, fc1_b,
                fc2_w, fc2_b, num_heads, gelu_approx, eps):
        attn = _detached(attn_operands(ln1_w, ln1_b, qkv_w, qkv_b, proj_w, proj_b,
                                       num_heads=num_heads, dtype=x.dtype))
        mlp = _detached(mlp_operands(ln2_w, ln2_b, fc1_w, fc1_b, fc2_w, fc2_b, dtype=x.dtype))
        ctx.save_for_backward(x, ln1_w, ln1_b, qkv_w, qkv_b, proj_w, proj_b, ln2_w, ln2_b, fc1_w,
                              fc1_b, fc2_w)
        ctx.num_heads, ctx.gelu_approx, ctx.eps = num_heads, gelu_approx, eps
        return fused_block(x, *attn, *mlp, num_heads=num_heads, gelu_approx=gelu_approx, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        (x, ln1_w, ln1_b, qkv_w, qkv_b, proj_w, proj_b, ln2_w, ln2_b, fc1_w, fc1_b,
         fc2_w) = ctx.saved_tensors
        dt = x.dtype
        heads, eps = ctx.num_heads, ctx.eps
        attn = _detached(attn_operands(ln1_w, ln1_b, qkv_w, qkv_b, proj_w, proj_b,
                                       num_heads=heads, dtype=dt))
        u = fused_attn_sublayer(x, *attn, num_heads=heads, eps=eps)
        du, dg2, db2, dw1, dfb1, dw2, dfb2 = mlp_sublayer_bwd(
            u, dy.to(dt).contiguous(), ln2_w.float().contiguous(), ln2_b.float().contiguous(),
            fc1_w.t().to(dt).contiguous(), fc1_b.float().contiguous(),
            fc2_w.t().to(dt).contiguous(), gelu_approx=ctx.gelu_approx, eps=eps,
        )
        dx, dg1, db1, dwqkv, dbqkv, dwp, dbp = fused_attn_sublayer_bwd(
            x, du.to(dt).contiguous(), ln1_w.float().contiguous(), ln1_b.float().contiguous(),
            qkv_w.t().to(dt).contiguous(),
            None if qkv_b is None else qkv_b.float().contiguous(),
            proj_w.t().to(dt).contiguous(), num_heads=heads, eps=eps,
        )
        return (dx, dg1, db1, dwqkv.t(), dbqkv, dwp.t(), dbp, dg2, db2, dw1.t(), dfb1, dw2.t(),
                dfb2, None, None, None)
