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
  int8 row quant pass in front of both W8A8 sublayers.

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

from duodiff_tpu_torch.ops.block import _check, _layer_norm, _ptr, _raise_on_error
from duodiff_tpu_torch.ops.block_int8 import (
    LN_QUANT_MAX_WIDTH,
    _int8_matmul,
    _quant_rows,
    _quant_rows_static,
)

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
    if d % 8 or d > LN_QUANT_MAX_WIDTH:
        raise ValueError(f"D must be a multiple of 8 and at most {LN_QUANT_MAX_WIDTH}, got {d}")
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
