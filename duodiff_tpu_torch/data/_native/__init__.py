"""Native (C++) batch assembly (counterpart of ``duodiff_tpu/data/_native``).

``batch_assembler.cpp`` beside this file, the port's own copy, is built with
g++ at first use into ``duodiff_tpu_torch/build/`` (again when its source or
flags change: the library's name carries their hash) and bound with ctypes.
:func:`get_assembler` returns None where g++ is missing or fails, and the
loader then takes its numpy path, which gives the same bits
(:func:`duodiff_tpu_torch.data.loader.assemble_numpy`). Each call of the
native assembler counts one in ``assemble_batch.assemblies``, as the kernel
wrappers count their launches.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().with_name("batch_assembler.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-ffp-contract=off")


def _build_library() -> Optional[Path]:
    """The shared library, built if it is not there yet; None when g++ is
    missing or fails."""
    tag = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"batch_assembler_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.{os.getpid()}.tmp")  # concurrent builders never share one
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)], check=True,
                       capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)
    return out


@functools.cache
def _library():
    path = _build_library()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.assemble_batch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
        ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
    ]
    lib.assemble_batch.restype = None
    return lib


def assemble_batch(images, scale: float, offset: float, out: np.ndarray,
                   n_threads: int = 4) -> None:
    """``out[i] = fma(images[i], float32(scale), float32(offset))`` in one
    native pass: ``images`` a list of C-contiguous uint8 arrays of one shape,
    ``out`` a C-contiguous float32 array (len(images), *that shape)."""
    lib = _library()
    if lib is None:
        raise RuntimeError("the native batch assembler could not be built (g++ missing or "
                           "failing)")
    n = len(images)
    if out.dtype != np.float32 or not out.flags.c_contiguous or out.shape[0] != n:
        raise ValueError(f"out must be a C-contiguous float32 array of {n} rows, got "
                         f"{out.dtype} {out.shape}")
    for img in images:
        if img.dtype != np.uint8 or not img.flags.c_contiguous or img.shape != out.shape[1:]:
            raise ValueError(f"every image must be a C-contiguous uint8 array of shape "
                             f"{out.shape[1:]}, got {img.dtype} {img.shape}")
    hwc = int(np.prod(out.shape[1:]))
    ptrs = (ctypes.c_void_p * n)(*[img.ctypes.data for img in images])
    lib.assemble_batch(ptrs, n, hwc, ctypes.c_float(scale), ctypes.c_float(offset),
                       out.ctypes.data, int(n_threads))
    assemble_batch.assemblies += 1


assemble_batch.assemblies = 0


def get_assembler():
    """:func:`assemble_batch`, or None when the library cannot be built (the
    JAX package's contract)."""
    return assemble_batch if _library() is not None else None
