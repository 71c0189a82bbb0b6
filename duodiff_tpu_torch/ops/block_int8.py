"""The W8A8 twins of the two fused sublayers (counterpart of
``duodiff_tpu/ops/pallas_block_int8.py``), for sampling only.

- :func:`fused_attn_sublayer_int8`: K1 with int8 qkv and proj projections,
  activation scales dynamic per row or static (K11,
  ``csrc/attn_sublayer_int8.cu``; the Pallas ``_kernel_v2_int8``; with
  ``inv`` the static twin of ``tools/probe_int8_static.py``, K14);
- :func:`fused_mlp_sublayer_int8`: K2 with int8 fc1 and fc2, activation
  scales dynamic per row or static per block (K12,
  ``csrc/mlp_sublayer_int8.cu``; the Pallas ``_mlp_kernel_int8``).

Scheme, as in the JAX package: weights symmetric per output channel,
quantized once at pack time (:func:`pack_attn_int8`, :func:`pack_mlp_int8`);
activations symmetric per row, quantized from fp32 right after the
LayerNorm, the GELU and the merged heads; the int32 product dequantized as
``acc * (row_scale * col_scale)``. The softmax scale goes into the q column
scales (fp32), never into the int8 codes. With static MLP scales the row
factors ``sx/127``, ``sh/127`` are folded into the column scales and the
activations quantize with ``inv = [127/sx, 127/sh]``. The attention sublayer
takes static scales the same way (``inv = [127/sx, 127/sm]`` for the
LayerNorm output and the merged heads, :func:`static_inv`); the model never
passes them, as the JAX ``Block`` never does: they are an argument of the op.

Packed int8 weights are (out, in), the torch ``Linear.weight`` layout: K
contiguous, the only layout the card's int8 ``wgmma`` takes for either
operand.

Each wrapper takes the plain PyTorch version (:func:`attn_sublayer_int8_plain`,
:func:`mlp_sublayer_int8_plain`) for a tensor on the CPU. For a CUDA tensor
it launches its kernel or raises; it counts its launches in ``.launches``
and, by mode, in ``.launches_dynamic`` / ``.launches_static``. The plain
versions compute the int8 products exactly, as XLA's int32 ``dot_general``
does: in float64, which holds every partial sum of int8 products at these
widths exactly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from duodiff_tpu_torch.ops.block import (
    ROW_MAX_WIDTH,
    _check,
    _check_seq_len,
    _layer_norm,
    _ptr,
    _raise_on_error,
    attention_core_plain,
    head_width,
)


def quantize_weight_int8(w: torch.Tensor, extra_col_scale=None):
    """Symmetric per-output-channel int8 quantization of a (K, N) kernel
    (the JAX layout, (in, out)): returns (w8 int8 (K, N), col_scale fp32
    (N,)) with ``w ~= w8 * col_scale``. ``extra_col_scale`` (scalar or (N,))
    is folded into the returned scale only, never into the codes."""
    w = w.float()
    amax = w.abs().amax(0)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    w8 = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    if extra_col_scale is not None:
        scale = scale * extra_col_scale
    return w8, scale


def _quant_rows(x: torch.Tensor):
    """Symmetric per-row int8 quantization of an fp32 activation: returns
    (x8 int8, row_scale fp32 (..., 1)) with ``x ~= x8 * row_scale``.
    Multiplies by the reciprocal; round half to even, clip to +-127."""
    amax = x.abs().amax(-1, keepdim=True)
    # a true division (the ``127.0 / t`` operator takes a reciprocal first),
    # with no host-made tensor, which a CUDA graph could not capture
    inv = torch.where(amax > 0, torch.full_like(amax, 127.0) / amax, torch.ones_like(amax))
    x8 = torch.clamp(torch.round(x * inv), -127, 127).to(torch.int8)
    return x8, amax / 127.0


def _quant_rows_static(x: torch.Tensor, inv_scale: torch.Tensor):
    """Static-scale int8 quantization: one multiply, round and clip."""
    return torch.clamp(torch.round(x * inv_scale), -127, 127).to(torch.int8)


def _int8_matmul(a8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """Exact ``a8 @ w8.T`` of int8 (..., K) and (N, K), as fp32 (the int32
    accumulator rounded to fp32). float64 holds every partial sum exactly
    (|sum| <= K * 127**2, far below 2**53), so the order does not matter."""
    return torch.matmul(a8.double(), w8.double().t()).float()


def static_inv(scales, device=None) -> torch.Tensor:
    """``[127/s0, 127/s1]`` as an fp32 (2,) tensor for two calibrated amax
    values, each a true fp32 division. The caller folds ``s/127`` into the
    matching column scales."""
    s = torch.tensor([float(v) for v in scales], dtype=torch.float32, device=device)
    if s.shape != (2,) or not bool((s > 0).all()):
        raise ValueError(f"static int8 scales must be two values > 0, got {scales}")
    return s.new_tensor(127.0) / s


def pack_attn_int8(norm, qkv, proj, *, num_heads: int):
    """(ln_scale, ln_bias, wqkv8 (3A, D) int8, sqkv (3A,), bqkv (3A,) or
    None, wp8 (D, A) int8, sp (D,), bp (D,)) from torch-layout modules
    (``_prep_attn_int8``): the softmax scale folded into the q column
    scales and the q bias, fp32."""
    a = proj.weight.shape[1]
    scale = float(a // num_heads) ** -0.5
    w = qkv.weight.detach()
    col_extra = torch.cat([torch.full((a,), scale, device=w.device),
                           torch.ones(2 * a, device=w.device)])
    wqkv8, sqkv = quantize_weight_int8(w.t(), extra_col_scale=col_extra)
    wp8, sp = quantize_weight_int8(proj.weight.detach().t())
    bqkv = None
    if qkv.bias is not None:
        b = qkv.bias.detach().float()
        bqkv = torch.cat([b[:a] * scale, b[a:]]).contiguous()
    return (
        norm.weight.detach().float().contiguous(),
        norm.bias.detach().float().contiguous(),
        wqkv8.t().contiguous(), sqkv.contiguous(), bqkv,
        wp8.t().contiguous(), sp.contiguous(),
        proj.bias.detach().float().contiguous(),
    )


def pack_mlp_int8(norm, fc1, fc2, *, static_scales=None):
    """(ln_scale, ln_bias, w1_8 (4D, D) int8, s1 (4D,), b1, w2_8 (D, 4D)
    int8, s2 (D,), b2, inv) from torch-layout modules. ``static_scales=(sx,
    sh)``, the block's calibrated post-LN and post-GELU amax, folds
    ``sx/127`` into s1 and ``sh/127`` into s2 and gives ``inv = [127/sx,
    127/sh]`` (fp32, (2,)); without it ``inv`` is None (dynamic per-row
    scales)."""
    w1_8, s1 = quantize_weight_int8(fc1.weight.detach().t())
    w2_8, s2 = quantize_weight_int8(fc2.weight.detach().t())
    inv = None
    if static_scales is not None:
        inv = static_inv(static_scales, s1.device)
        sx, sh = (torch.tensor(float(v), dtype=torch.float32, device=s1.device)
                  for v in static_scales)
        s1 = s1 * (sx / 127.0)
        s2 = s2 * (sh / 127.0)
    return (
        norm.weight.detach().float().contiguous(),
        norm.bias.detach().float().contiguous(),
        w1_8.t().contiguous(), s1.contiguous(), fc1.bias.detach().float().contiguous(),
        w2_8.t().contiguous(), s2.contiguous(), fc2.bias.detach().float().contiguous(),
        inv,
    )


def attn_sublayer_int8_plain(x, ln_scale, ln_bias, wqkv8, sqkv, bqkv, wp8, sp, bp, inv=None,
                             *, num_heads: int, eps: float = 1e-5):
    """Plain PyTorch K11 (pallas_block_int8._attn_sublayer_int8_reference).
    ``inv = [127/sx, 127/sm]`` (:func:`static_inv`) is K14's static form
    (tools/probe_int8_static.py ``_attn_kernel_static``): the LayerNorm output
    and the merged heads quantize with one scale each, and ``sqkv`` / ``sp``
    come with ``sx/127`` / ``sm/127`` folded in."""
    dt = x.dtype
    xv = x.float()
    xn = _layer_norm(xv, ln_scale.float(), ln_bias.float(), eps)
    if inv is None:
        x8, rs = _quant_rows(xn)
        rs_qkv = rs * sqkv
    else:
        x8, rs_qkv = _quant_rows_static(xn, inv[0]), sqkv
    qkv = _int8_matmul(x8, wqkv8) * rs_qkv
    if bqkv is not None:
        qkv = qkv + bqkv
    merged = attention_core_plain(qkv.to(dt), num_heads, dt).float()
    if inv is None:
        m8, mrs = _quant_rows(merged)
        rs_p = mrs * sp
    else:
        m8, rs_p = _quant_rows_static(merged, inv[1]), sp
    proj = _int8_matmul(m8, wp8) * rs_p
    return (xv + proj + bp).to(dt)


def _mlp_int8(x, ln_scale, ln_bias, w1_8, s1, b1, w2_8, s2, b2, inv, gelu_approx, eps):
    """Plain K12 and what it quantizes: (out, xn, h, rs, hrs), the row scales
    None with static scales."""
    dt = x.dtype
    xv = x.float()
    xn = _layer_norm(xv, ln_scale.float(), ln_bias.float(), eps)
    rs = hrs = None
    if inv is None:
        x8, rs = _quant_rows(xn)
        rs1 = rs * s1
    else:
        x8, rs1 = _quant_rows_static(xn, inv[0]), s1
    h = _int8_matmul(x8, w1_8) * rs1
    h = F.gelu(h + b1, approximate="tanh" if gelu_approx else "none")
    if inv is None:
        h8, hrs = _quant_rows(h)
        rs2 = hrs * s2
    else:
        h8, rs2 = _quant_rows_static(h, inv[1]), s2
    out = _int8_matmul(h8, w2_8) * rs2
    return (xv + out + b2).to(dt), xn, h, rs, hrs


def mlp_sublayer_int8_plain(x, ln_scale, ln_bias, w1_8, s1, b1, w2_8, s2, b2, inv=None,
                            *, gelu_approx: bool = False, eps: float = 1e-5):
    """Plain PyTorch K12 (pallas_block_int8._mlp_int8_reference); ``inv``
    as :func:`pack_mlp_int8` returns it (None: dynamic per-row scales)."""
    return _mlp_int8(x, ln_scale, ln_bias, w1_8, s1, b1, w2_8, s2, b2, inv, gelu_approx, eps)[0]


def mlp_sublayer_int8_calib(x, ln_scale, ln_bias, w1_8, s1, b1, w2_8, s2, b2, *,
                            gelu_approx: bool = False, eps: float = 1e-5,
                            with_rows: bool = False):
    """The dynamic-int8 MLP sublayer of the calibration forward
    (pallas_block_int8.mlp_sublayer_int8_calib): :func:`mlp_sublayer_int8_plain`
    with per-row scales, which also returns the activation amax at the two
    static-quant sites, ``(out, xn_amax, h_amax)``: xn the post-LN input, h
    the post-GELU hidden, fp32 0-d tensors. ``with_rows=True`` appends the
    per-row amaxes ``(xn_rows (B, L), h_rows (B, L))``, the row scales times
    127 as the JAX package takes them. Plain PyTorch on any device: the JAX
    package runs it in XLA, no kernel. Operands as :func:`pack_mlp_int8`
    gives them without static scales."""
    out, xn, h, rs, hrs = _mlp_int8(x, ln_scale, ln_bias, w1_8, s1, b1, w2_8, s2, b2, None,
                                    gelu_approx, eps)
    amaxes = (out, xn.abs().amax(), h.abs().amax())
    if with_rows:
        return (*amaxes, (rs[..., 0] * 127.0, hrs[..., 0] * 127.0))
    return amaxes


def _attn_sublayer_int8_cuda(x, ln_scale, ln_bias, wqkv8, sqkv, bqkv, wp8, sp, bp, inv=None, *,
                             num_heads: int, eps: float):
    """Check the operands and launch K11 (the LayerNorm + row quant, int8
    qkv GEMM, attention core, row quant and int8 proj GEMM launches of
    csrc/attn_sublayer_int8.cu); with ``inv`` both quantizations are static
    and no row scale is kept."""
    from duodiff_tpu_torch.ops._build import load_library

    if x.dim() != 3:
        raise ValueError(f"x must be (B, L, D), got {tuple(x.shape)}")
    b, l, d = x.shape
    a = wp8.shape[1]
    if a != d:
        raise ValueError(f"the kernel takes the square form A == D: A={a}, D={d}, "
                         f"num_heads={num_heads}")
    dh = head_width(a, num_heads, "the kernel's square form A == D")
    if d % 16 or d > ROW_MAX_WIDTH:
        raise ValueError(f"D must be a multiple of 16 and at most {ROW_MAX_WIDTH}, got {d}")
    dev, bf16, f32, i8 = x.device, torch.bfloat16, torch.float32, torch.int8
    _check("x", x, (b, l, d), bf16, dev)
    _check("ln_scale", ln_scale, (d,), f32, dev)
    _check("ln_bias", ln_bias, (d,), f32, dev)
    _check("wqkv8", wqkv8, (3 * a, d), i8, dev)
    _check("sqkv", sqkv, (3 * a,), f32, dev)
    if bqkv is not None:
        _check("bqkv", bqkv, (3 * a,), f32, dev)
    _check("wp8", wp8, (d, a), i8, dev)
    _check("sp", sp, (d,), f32, dev)
    _check("bp", bp, (d,), f32, dev)
    if inv is not None:
        _check("inv", inv, (2,), f32, dev)
    lib = load_library()
    _check_seq_len(lib, l, dh)
    m = b * l
    x8 = torch.empty((m, d), dtype=i8, device=dev)  # reused for the merged heads
    rs = torch.empty((m,), dtype=f32, device=dev) if inv is None else None
    qkv = torch.empty((m, 3 * a), dtype=bf16, device=dev)
    merged = torch.empty((m, a), dtype=bf16, device=dev)
    y = torch.empty_like(x)
    err = lib.duodiff_attn_sublayer_int8(
        _ptr(x), _ptr(ln_scale), _ptr(ln_bias), _ptr(wqkv8), _ptr(sqkv), _ptr(bqkv),
        _ptr(wp8), _ptr(sp), _ptr(bp), _ptr(inv), _ptr(x8), _ptr(rs), _ptr(qkv), _ptr(merged),
        _ptr(y), b, l, d, num_heads, dh, eps, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on_error(lib, "int8 attention sublayer kernel", err)
    return y


def _mlp_sublayer_int8_cuda(x, ln_scale, ln_bias, w1_8, s1, b1, w2_8, s2, b2, inv, *,
                            gelu_approx: bool, eps: float):
    """Check the operands and launch K12 (csrc/mlp_sublayer_int8.cu): the
    LayerNorm + quant, int8 fc1 GEMM with bias and GELU, and int8 fc2 GEMM
    with the fp32 residual; in dynamic mode a row-quant launch between the
    GEMMs (a row of the fp32 hidden spans several GEMM column tiles), in
    static mode the fc1 epilogue quantizes directly."""
    from duodiff_tpu_torch.ops._build import load_library

    if x.dim() != 3:
        raise ValueError(f"x must be (B, L, D), got {tuple(x.shape)}")
    b, l, d = x.shape
    hid = w1_8.shape[0]
    if d % 16 or hid % 16 or d > ROW_MAX_WIDTH:
        raise ValueError(f"D and the hidden width must be multiples of 16, D at most "
                         f"{ROW_MAX_WIDTH}: {d}, {hid}")
    dev, bf16, f32, i8 = x.device, torch.bfloat16, torch.float32, torch.int8
    _check("x", x, (b, l, d), bf16, dev)
    _check("ln_scale", ln_scale, (d,), f32, dev)
    _check("ln_bias", ln_bias, (d,), f32, dev)
    _check("w1_8", w1_8, (hid, d), i8, dev)
    _check("s1", s1, (hid,), f32, dev)
    _check("b1", b1, (hid,), f32, dev)
    _check("w2_8", w2_8, (d, hid), i8, dev)
    _check("s2", s2, (d,), f32, dev)
    _check("b2", b2, (d,), f32, dev)
    if inv is not None:
        _check("inv", inv, (2,), f32, dev)
    lib = load_library()
    m = b * l
    x8 = torch.empty((m, d), dtype=i8, device=dev)
    h8 = torch.empty((m, hid), dtype=i8, device=dev)
    rs = hidden = hrs = None
    if inv is None:
        rs = torch.empty((m,), dtype=f32, device=dev)
        hidden = torch.empty((m, hid), dtype=f32, device=dev)
        hrs = torch.empty((m,), dtype=f32, device=dev)
    y = torch.empty_like(x)
    err = lib.duodiff_mlp_sublayer_int8(
        _ptr(x), _ptr(ln_scale), _ptr(ln_bias), _ptr(w1_8), _ptr(s1), _ptr(b1),
        _ptr(w2_8), _ptr(s2), _ptr(b2), _ptr(inv), _ptr(x8), _ptr(rs), _ptr(hidden),
        _ptr(h8), _ptr(hrs), _ptr(y), m, d, hid, 2 if gelu_approx else 1, eps,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on_error(lib, "int8 MLP sublayer kernel", err)
    return y


def fused_attn_sublayer_int8(x, ln_scale, ln_bias, wqkv8, sqkv, bqkv, wp8, sp, bp, inv=None,
                             *, num_heads: int, eps: float = 1e-5):
    """K11 on packed operands (:func:`pack_attn_int8`); x (B, L, D). ``inv``
    (:func:`static_inv`) switches both activation quantizations to static
    scales (K14's static form)."""
    if x.device.type == "cpu":
        return attn_sublayer_int8_plain(x, ln_scale, ln_bias, wqkv8, sqkv, bqkv, wp8, sp,
                                        bp, inv, num_heads=num_heads, eps=eps)
    y = _attn_sublayer_int8_cuda(x, ln_scale, ln_bias, wqkv8, sqkv, bqkv, wp8, sp, bp, inv,
                                 num_heads=num_heads, eps=eps)
    _count(fused_attn_sublayer_int8, inv)
    return y


def fused_mlp_sublayer_int8(x, ln_scale, ln_bias, w1_8, s1, b1, w2_8, s2, b2, inv=None,
                            *, gelu_approx: bool = False, eps: float = 1e-5):
    """K12 on packed operands (:func:`pack_mlp_int8`); x (B, L, D)."""
    if x.device.type == "cpu":
        return mlp_sublayer_int8_plain(x, ln_scale, ln_bias, w1_8, s1, b1, w2_8, s2, b2,
                                       inv, gelu_approx=gelu_approx, eps=eps)
    y = _mlp_sublayer_int8_cuda(x, ln_scale, ln_bias, w1_8, s1, b1, w2_8, s2, b2, inv,
                                gelu_approx=gelu_approx, eps=eps)
    _count(fused_mlp_sublayer_int8, inv)
    return y


def _count(wrapper, inv) -> None:
    """One launch of ``wrapper``'s kernel, dynamic or static by ``inv``."""
    wrapper.launches += 1
    if inv is None:
        wrapper.launches_dynamic += 1
    else:
        wrapper.launches_static += 1


def reset_launch_counts() -> None:
    """Set the int8 wrappers' launch counters to 0."""
    for wrapper in (fused_attn_sublayer_int8, fused_mlp_sublayer_int8):
        wrapper.launches = wrapper.launches_dynamic = wrapper.launches_static = 0


reset_launch_counts()
