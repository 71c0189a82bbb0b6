"""The bf16 GEMM of the block kernels on its own (``csrc/gemm.cuh``, reached
through the measurement entry ``csrc/gemm_bf16.cu``):

    C = cast(gelu?(A @ B + residual? + bias?)),

A (M, K) and B (K, N) bf16, fp32 sums, then the residual (bf16 or fp32),
the fp32 bias and GELU (exact or tanh) in fp32, one rounding to C's type
(bf16 or fp32). It is the epilogue order of the Pallas projections in
``duodiff_tpu/ops/pallas_block.py`` (``_kernel_v2``, ``_mlp_kernel``). No
model calls :func:`gemm_bf16`: the sublayer kernels of ``ops/block.py`` run
the same device code inside their own launches, and ``chip_smoke.py`` phase
2 times it here against :func:`gemm_bf16_plain`. For a CPU tensor the
wrapper takes the plain version; for a CUDA tensor it launches the kernel
or raises, and counts the launch in ``.launches``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from duodiff_tpu_torch.ops.block import _check, _ptr, _raise_on_error

GELU_MODES = {"none": 0, "erf": 1, "tanh": 2}


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
