"""The GEMMs of the block kernels on their own, for measuring them:

- :func:`gemm_bf16` (``csrc/gemm.cuh``, through the entry
  ``csrc/gemm_bf16.cu``): ``C = cast(gelu?(A @ B + residual? + bias?))``, A
  (M, K) and B (K, N) bf16, fp32 sums, then the residual (bf16 or fp32), the
  fp32 bias and GELU (exact or tanh) in fp32, one rounding to C's type (bf16
  or fp32): the epilogue order of the Pallas projections in
  ``duodiff_tpu/ops/pallas_block.py`` (``_kernel_v2``, ``_mlp_kernel``);
- :func:`gemm_int8` (``csrc/gemm_int8.cuh``, through the entry
  ``csrc/gemm_int8_entry.cu``): the W8A8 projections of
  ``duodiff_tpu/ops/pallas_block_int8.py``, A (M, K) and B (N, K) int8, the
  exact int32 product dequantized as ``float(acc) * (row_scale * col_scale)``,
  then by epilogue the bf16 residual, the fp32 bias, GELU, one rounding to
  bf16, fp32 or int8 codes;
- :func:`ln_quant_rows` (``csrc/quant.cuh``, same entry): the LayerNorm +
  int8 row quant pass in front of both W8A8 sublayers;
- :func:`gemm_t` (``csrc/gemm_t.cuh`` over ``csrc/gemm.cuh``, through the
  entry ``csrc/gemm_t_entry.cu``): the backward products of K6, K7 and K8, a
  weight gradient ``a^T b`` (a stored (K, M), b (K, N), fp32, split over
  the K rows and summed in split order) or ``a b^T`` (b stored (N, K)) into
  bf16 or fp32, or added to an fp32 ``out``; the contractions of
  ``_attn_bwd_kernel`` and ``_mlp_bwd_kernel`` in
  ``duodiff_tpu/ops/pallas_block.py``;
- :func:`mlp_bwd_hidden` (``csrc/mlp_bwd_hidden.cuh``, same entry): the MLP
  backward's hidden stage, hgb = bf16(gelu(xn W1 + b1)), dhp = bf16(dy W2^T
  * gelu'(xn W1 + b1)) and db1, the column sums of the unrounded dhp.

No model calls them: the sublayer kernels of ``ops/block.py`` and
``ops/block_int8.py`` run the same device code inside their own launches, and
``chip_smoke.py`` phase 2 holds and times them here against their plain
versions. For a CPU tensor a wrapper takes the plain version; for a CUDA
tensor it launches the kernel or raises, and counts the launch in
``.launches``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from duodiff_tpu_torch.ops.block import (
    ROW_MAX_WIDTH,
    _check,
    _layer_norm,
    _ptr,
    _raise_on_error,
    gelu_grad,
)
from duodiff_tpu_torch.ops.block_int8 import _int8_matmul, _quant_rows, _quant_rows_static

GELU_MODES = {"none": 0, "erf": 1, "tanh": 2}
# the int8 GEMM's epilogues: (C entry mode, output type)
INT8_EPILOGUES = {"bias": (0, torch.bfloat16), "residual": (1, torch.bfloat16),
                  "gelu_f32": (2, torch.float32), "gelu_quant": (3, torch.int8)}


def gemm_bf16_plain(a, b, bias=None, residual=None, *, gelu: str = "none",
                    out_dtype=torch.bfloat16):
    """Plain PyTorch: fp32 product of the bf16 operands, then residual, bias
    and GELU in fp32, one rounding to ``out_dtype``."""
    if gelu not in GELU_MODES:
        raise ValueError(f"gelu must be one of {sorted(GELU_MODES)}, got {gelu!r}")
    acc = torch.matmul(a.float(), b.float())
    if residual is not None:
        acc = acc + residual.float()
    if bias is not None:
        acc = acc + bias.float()
    if gelu != "none":
        acc = F.gelu(acc, approximate="tanh" if gelu == "tanh" else "none")
    return acc.to(out_dtype)


def _gemm_bf16_cuda(a, b, bias, residual, *, gelu: str, out_dtype):
    from duodiff_tpu_torch.ops._build import load_library

    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"a (M, K) and b (K, N) do not chain: {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    if n % 8 or k % 8:
        raise ValueError(f"N and K must be multiples of 8, got N={n}, K={k}")
    if gelu not in GELU_MODES:
        raise ValueError(f"gelu must be one of {sorted(GELU_MODES)}, got {gelu!r}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype must be bfloat16 or float32, got {out_dtype}")
    dev = a.device
    _check("a", a, (m, k), torch.bfloat16, dev)
    _check("b", b, (k, n), torch.bfloat16, dev)
    if bias is not None:
        _check("bias", bias, (n,), torch.float32, dev)
    if residual is not None:
        if residual.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"residual must be bfloat16 or float32, got {residual.dtype}")
        _check("residual", residual, (m, n), residual.dtype, dev)
    lib = load_library()
    c = torch.empty((m, n), dtype=out_dtype, device=dev)
    err = lib.duodiff_gemm_bf16(
        _ptr(a), _ptr(b), _ptr(c), _ptr(bias), _ptr(residual), m, n, k, GELU_MODES[gelu],
        int(residual is not None and residual.dtype == torch.float32),
        int(out_dtype == torch.float32), torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on_error(lib, "bf16 GEMM kernel", err)
    return c


def gemm_bf16(a, b, bias=None, residual=None, *, gelu: str = "none", out_dtype=torch.bfloat16):
    """``cast(gelu?(a @ b + residual? + bias?))`` through the kernel of
    ``csrc/gemm.cuh``, or its plain version on the CPU."""
    if a.device.type == "cpu":
        return gemm_bf16_plain(a, b, bias, residual, gelu=gelu, out_dtype=out_dtype)
    out = _gemm_bf16_cuda(a, b, bias, residual, gelu=gelu, out_dtype=out_dtype)
    gemm_bf16.launches += 1
    return out


gemm_bf16.launches = 0


def _check_int8_epilogue(epilogue: str, gelu: str, residual, quant_inv) -> None:
    if epilogue not in INT8_EPILOGUES:
        raise ValueError(f"epilogue must be one of {sorted(INT8_EPILOGUES)}, got {epilogue!r}")
    if gelu not in GELU_MODES:
        raise ValueError(f"gelu must be one of {sorted(GELU_MODES)}, got {gelu!r}")
    if (residual is not None) != (epilogue == "residual"):
        raise ValueError("a residual is taken by the 'residual' epilogue, and only by it")
    if (quant_inv is not None) != (epilogue == "gelu_quant"):
        raise ValueError("quant_inv is taken by the 'gelu_quant' epilogue, and only by it")


def gemm_int8_plain(a8, b8, col_scale, row_scale=None, bias=None, residual=None, quant_inv=None,
                    *, epilogue: str = "bias", gelu: str = "none"):
    """Plain PyTorch: the exact product of int8 a8 (M, K) and b8 (N, K) as
    fp32, times the (row x col) scale product (the column scale alone without
    row scales), then the residual, then the bias, each an fp32 rounding;
    GELU in fp32 for the ``gelu_*`` epilogues; one rounding at the end to
    bf16, fp32 or int8 codes ``clip(rint(v * quant_inv[0]), +-127)``."""
    _check_int8_epilogue(epilogue, gelu, residual, quant_inv)
    scale = col_scale if row_scale is None else row_scale[:, None] * col_scale
    v = _int8_matmul(a8, b8) * scale
    if residual is not None:
        v = residual.float() + v
    if bias is not None:
        v = v + bias
    if epilogue in ("bias", "residual"):
        return v.to(torch.bfloat16)
    if gelu != "none":
        v = F.gelu(v, approximate="tanh" if gelu == "tanh" else "none")
    return v if epilogue == "gelu_f32" else _quant_rows_static(v, quant_inv[0])


def _gemm_int8_cuda(a8, b8, col_scale, row_scale, bias, residual, quant_inv, *, epilogue: str,
                    gelu: str):
    from duodiff_tpu_torch.ops._build import load_library

    _check_int8_epilogue(epilogue, gelu, residual, quant_inv)
    if a8.dim() != 2 or b8.dim() != 2 or a8.shape[1] != b8.shape[1]:
        raise ValueError(f"a8 (M, K) and b8 (N, K) do not chain: {tuple(a8.shape)}, "
                         f"{tuple(b8.shape)}")
    m, k = a8.shape
    n = b8.shape[0]
    mode, out_dtype = INT8_EPILOGUES[epilogue]
    if k % 16 or n % (16 if out_dtype == torch.int8 else 8):
        raise ValueError(f"K must be a multiple of 16 and N of 8 (of 16 for int8 codes), got "
                         f"N={n}, K={k}")
    dev, f32 = a8.device, torch.float32
    _check("a8", a8, (m, k), torch.int8, dev)
    _check("b8", b8, (n, k), torch.int8, dev)
    _check("col_scale", col_scale, (n,), f32, dev)
    if row_scale is not None:
        _check("row_scale", row_scale, (m,), f32, dev)
    if bias is not None:
        _check("bias", bias, (n,), f32, dev)
    if residual is not None:
        _check("residual", residual, (m, n), torch.bfloat16, dev)
    if quant_inv is not None:
        _check("quant_inv", quant_inv, tuple(quant_inv.shape), f32, dev)
        if quant_inv.dim() != 1 or quant_inv.numel() == 0:
            raise ValueError(f"quant_inv must be a non-empty vector, got {tuple(quant_inv.shape)}")
    lib = load_library()
    c = torch.empty((m, n), dtype=out_dtype, device=dev)
    err = lib.duodiff_gemm_int8(
        _ptr(a8), _ptr(b8), _ptr(c), _ptr(row_scale), _ptr(col_scale), _ptr(bias), _ptr(residual),
        _ptr(quant_inv), m, n, k, mode, GELU_MODES[gelu],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on_error(lib, "int8 GEMM kernel", err)
    return c


def gemm_int8(a8, b8, col_scale, row_scale=None, bias=None, residual=None, quant_inv=None, *,
              epilogue: str = "bias", gelu: str = "none"):
    """The W8A8 projection ``a8 @ b8.T`` with its dequant epilogue
    (:func:`gemm_int8_plain`) through the kernel of ``csrc/gemm_int8.cuh``,
    or its plain version on the CPU."""
    if a8.device.type == "cpu":
        return gemm_int8_plain(a8, b8, col_scale, row_scale, bias, residual, quant_inv,
                               epilogue=epilogue, gelu=gelu)
    out = _gemm_int8_cuda(a8, b8, col_scale, row_scale, bias, residual, quant_inv,
                          epilogue=epilogue, gelu=gelu)
    gemm_int8.launches += 1
    return out


gemm_int8.launches = 0


def ln_quant_rows_plain(x, gamma, beta, inv=None, *, eps: float = 1e-5):
    """Plain PyTorch: the fp32 LayerNorm of x (M, D), then int8 codes per row
    (dynamic: (x8, row_scale (M,))) or with one scale ``inv`` ((x8, None))."""
    xn = _layer_norm(x.float(), gamma.float(), beta.float(), eps)
    if inv is not None:
        return _quant_rows_static(xn, inv), None
    x8, rs = _quant_rows(xn)
    return x8, rs[:, 0]


def _ln_quant_rows_cuda(x, gamma, beta, inv, *, eps: float, first: bool):
    from duodiff_tpu_torch.ops._build import load_library

    if x.dim() != 2:
        raise ValueError(f"x must be (M, D), got {tuple(x.shape)}")
    m, d = x.shape
    if d % 8 or d > ROW_MAX_WIDTH:
        raise ValueError(f"D must be a multiple of 8 and at most {ROW_MAX_WIDTH}, got {d}")
    dev, f32 = x.device, torch.float32
    _check("x", x, (m, d), torch.bfloat16, dev)
    _check("gamma", gamma, (d,), f32, dev)
    _check("beta", beta, (d,), f32, dev)
    if inv is not None:
        _check("inv", inv, tuple(inv.shape), f32, dev)
        if inv.numel() == 0:
            raise ValueError("inv must hold at least one value")
    lib = load_library()
    x8 = torch.empty((m, d), dtype=torch.int8, device=dev)
    rs = torch.empty((m,), dtype=f32, device=dev) if inv is None else None
    err = lib.duodiff_ln_quant_rows(_ptr(x), _ptr(gamma), _ptr(beta), _ptr(x8), _ptr(rs),
                                    _ptr(inv), m, d, eps, int(first),
                                    torch.cuda.current_stream(dev).cuda_stream)
    _raise_on_error(lib, "LayerNorm + quant kernel", err)
    return x8, rs


def ln_quant_rows(x, gamma, beta, inv=None, *, eps: float = 1e-5, first: bool = False):
    """The LayerNorm + row quant pass of K11 and K12 on a bf16 (M, D) x:
    (x8, row_scale or None) through ``csrc/quant.cuh``, or its plain version
    on the CPU. ``first=True`` runs the pass's first form (four reads of the
    row), kept on the card only to hold the one-read form equal to it to the
    bit. ``inv`` is a fp32 vector whose first value quantizes every row."""
    if x.device.type == "cpu":
        return ln_quant_rows_plain(x, gamma, beta, None if inv is None else inv[0], eps=eps)
    out = _ln_quant_rows_cuda(x, gamma, beta, inv, eps=eps, first=first)
    ln_quant_rows.launches += 1
    return out


ln_quant_rows.launches = 0


def _aligned(name, t) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned (the TMA loads and row vectors)")


def _gemm_t_dims(a, b, trans_a: bool):
    """(M, N, K) of ``a^T b`` (trans_a: a (K, M), b (K, N)) or ``a b^T`` (a
    (M, K), b (N, K)), with the refusals of the kernel's launcher."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"a and b must be matrices, got {tuple(a.shape)}, {tuple(b.shape)}")
    if trans_a:
        k, m = a.shape
        kb, n = b.shape
    else:
        m, k = a.shape
        n, kb = b.shape
    if k != kb:
        raise ValueError(f"a and b do not chain over K: {tuple(a.shape)}, {tuple(b.shape)} "
                         f"(trans_a={trans_a})")
    if n % 8:
        raise ValueError(f"N must be a multiple of 8, got {n}")
    if trans_a and m % 8:
        raise ValueError(f"M must be a multiple of 8 when a is stored (K, M), got {m}")
    if not trans_a and k % 8:
        raise ValueError(f"K must be a multiple of 8 when both operands are read along K, "
                         f"got {k}")
    return m, n, k


def gemm_t_plain(a, b, *, trans_a: bool, out_dtype=torch.float32, out=None):
    """Plain PyTorch: the fp32 product of the bf16 operands, ``a^T b`` with
    trans_a (a (K, M), b (K, N); fp32 out) or ``a b^T`` (a (M, K), b (N, K))
    rounded once to ``out_dtype``; with ``out`` (fp32 (M, N)), ``out + a b^T``
    written into ``out``, which is returned."""
    if trans_a and (out_dtype != torch.float32 or out is not None):
        raise ValueError("a weight gradient (trans_a) is an fp32 product, never added to out")
    acc = a.float().t() @ b.float() if trans_a else a.float() @ b.float().t()
    if out is not None:
        return out.add_(acc)
    return acc.to(out_dtype)


def _gemm_t_cuda(a, b, *, trans_a: bool, out_dtype, out, splits: int):
    from duodiff_tpu_torch.ops._build import load_library

    m, n, k = _gemm_t_dims(a, b, trans_a)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype must be bfloat16 or float32, got {out_dtype}")
    if trans_a and (out_dtype != torch.float32 or out is not None):
        raise ValueError("a weight gradient (trans_a) is an fp32 product, never added to out")
    if out is not None and out_dtype != torch.float32:
        raise ValueError("out is added to in fp32")
    _aligned("a", a)
    _aligned("b", b)
    dev = a.device
    _check("a", a, tuple(a.shape), torch.bfloat16, dev)
    _check("b", b, tuple(b.shape), torch.bfloat16, dev)
    if out is not None:
        _aligned("out", out)
        _check("out", out, (m, n), torch.float32, dev)
    lib = load_library()
    flags = None
    if trans_a:
        form = 0
        flags = torch.empty(lib.duodiff_gemm_t_flag_bytes(m, n), dtype=torch.uint8, device=dev)
    else:
        form = 3 if out is not None else (1 if out_dtype == torch.float32 else 2)
    c = out if out is not None else torch.empty((m, n), dtype=out_dtype, device=dev)
    err = lib.duodiff_gemm_t(_ptr(a), _ptr(b), _ptr(c), _ptr(flags), m, n, k, form, splits,
                             torch.cuda.current_stream(dev).cuda_stream)
    _raise_on_error(lib, "backward GEMM kernel", err)
    return c


def gemm_t(a, b, *, trans_a: bool, out_dtype=torch.float32, out=None, splits: int = 0):
    """A backward product (:func:`gemm_t_plain`) through the kernel of
    ``csrc/gemm.cuh`` in the form ``csrc/gemm_t.cuh`` launches, or its plain
    version on the CPU. ``splits`` (trans_a only) forces the number of row
    splits; 0 takes the launcher's choice for the card."""
    if a.device.type == "cpu":
        _gemm_t_dims(a, b, trans_a)
        return gemm_t_plain(a, b, trans_a=trans_a, out_dtype=out_dtype, out=out)
    c = _gemm_t_cuda(a, b, trans_a=trans_a, out_dtype=out_dtype, out=out, splits=splits)
    gemm_t.launches += 1
    return c


gemm_t.launches = 0


def mlp_bwd_hidden_plain(xn, w1, b1, dy, w2, *, gelu: str = "erf"):
    """Plain PyTorch: h = xn W1 + b1 in fp32, (bf16(gelu(h)), bf16(dy W2^T *
    gelu'(h)), the column sums of the unrounded dy W2^T * gelu'(h)), as
    :func:`duodiff_tpu_torch.ops.block.mlp_sublayer_bwd_plain` computes them."""
    if gelu not in ("erf", "tanh"):
        raise ValueError(f"gelu must be 'erf' or 'tanh', got {gelu!r}")
    h = xn.float() @ w1.float() + b1.float()
    hgb = F.gelu(h, approximate="tanh" if gelu == "tanh" else "none").to(torch.bfloat16)
    dhp = (dy.float() @ w2.float().t()) * gelu_grad(h, gelu == "tanh")
    return hgb, dhp.to(torch.bfloat16), dhp.sum(0)


def _mlp_bwd_hidden_cuda(xn, w1, b1, dy, w2, *, gelu: str):
    from duodiff_tpu_torch.ops._build import load_library

    if gelu not in ("erf", "tanh"):
        raise ValueError(f"gelu must be 'erf' or 'tanh', got {gelu!r}")
    if xn.dim() != 2 or w1.dim() != 2:
        raise ValueError(f"xn (M, D) and w1 (D, Hd) must be matrices, got {tuple(xn.shape)}, "
                         f"{tuple(w1.shape)}")
    m, d = xn.shape
    hid = w1.shape[1]
    if d % 8 or hid % 8:
        raise ValueError(f"D and the hidden width must be multiples of 8, got {d}, {hid}")
    for name, t in (("xn", xn), ("w1", w1), ("b1", b1), ("dy", dy), ("w2", w2)):
        _aligned(name, t)
    dev, bf16, f32 = xn.device, torch.bfloat16, torch.float32
    _check("xn", xn, (m, d), bf16, dev)
    _check("w1", w1, (d, hid), bf16, dev)
    _check("b1", b1, (hid,), f32, dev)
    _check("dy", dy, (m, d), bf16, dev)
    _check("w2", w2, (hid, d), bf16, dev)
    lib = load_library()
    hgb = torch.empty((m, hid), dtype=bf16, device=dev)
    dhp = torch.empty((m, hid), dtype=bf16, device=dev)
    db1 = torch.empty((hid,), dtype=f32, device=dev)
    part = torch.empty(lib.duodiff_mlp_bwd_hidden_part_bytes(m, hid), dtype=torch.uint8,
                       device=dev)
    err = lib.duodiff_mlp_bwd_hidden(_ptr(xn), _ptr(w1), _ptr(b1), _ptr(dy), _ptr(w2), _ptr(hgb),
                                     _ptr(dhp), _ptr(db1), _ptr(part), m, d, hid,
                                     GELU_MODES[gelu], torch.cuda.current_stream(dev).cuda_stream)
    _raise_on_error(lib, "MLP backward hidden-stage kernel", err)
    return hgb, dhp, db1


def mlp_bwd_hidden(xn, w1, b1, dy, w2, *, gelu: str = "erf"):
    """The MLP backward's hidden stage (:func:`mlp_bwd_hidden_plain`) through
    the kernel of ``csrc/mlp_bwd_hidden.cuh``, or its plain version on the
    CPU: (hgb, dhp, db1)."""
    if xn.device.type == "cpu":
        return mlp_bwd_hidden_plain(xn, w1, b1, dy, w2, gelu=gelu)
    out = _mlp_bwd_hidden_cuda(xn, w1, b1, dy, w2, gelu=gelu)
    mlp_bwd_hidden.launches += 1
    return out


mlp_bwd_hidden.launches = 0
