"""Build and load the CUDA kernels of ``duodiff_tpu_torch/csrc``.

Every ``csrc/*.cu`` is compiled by its own ``nvcc``, all started together,
and the objects are linked into one shared library with a plain C
interface, loaded with ``ctypes``. The build runs at first use, into
``duodiff_tpu_torch/build/``, and again whenever a source's content
changes (the library's name carries a hash of the sources and flags).
Importing this module needs neither ``nvcc`` nor a GPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_FLOAT = ctypes.c_float
# C entry -> (argtypes, restype); every pointer and the stream as c_void_p
_SIGNATURES = {
    "duodiff_attn_sublayer": ([_PTR] * 11 + [_INT] * 4 + [_FLOAT, _PTR], _INT),
    "duodiff_mlp_sublayer": ([_PTR] * 10 + [_INT] * 4 + [_FLOAT, _PTR], _INT),
    "duodiff_attn_sublayer_int8": ([_PTR] * 15 + [_INT] * 4 + [_FLOAT, _PTR], _INT),
    "duodiff_mlp_sublayer_int8": ([_PTR] * 16 + [_INT] * 4 + [_FLOAT, _PTR], _INT),
    "duodiff_attn_sublayer_bwd": ([_PTR] * 15 + [_INT] * 4 + [_FLOAT, _PTR], _INT),
    "duodiff_mlp_sublayer_bwd": ([_PTR] * 15 + [_INT] * 4 + [_FLOAT, _PTR], _INT),
    "duodiff_attn_sublayer_v1": ([_PTR] * 11 + [_INT] * 4 + [_FLOAT, _PTR], _INT),
    "duodiff_fused_block": ([_PTR] * 19 + [_INT] * 6 + [_FLOAT, _PTR], _INT),
    "duodiff_mlp_sublayer_bwd_split": ([_PTR] * 15 + [_INT] * 5 + [_FLOAT, _PTR], _INT),
    "duodiff_flash_attention": ([_PTR] * 4 + [_INT] * 3 + [_PTR], _INT),
    "duodiff_flash_attention_bwd": ([_PTR] * 8 + [_INT] * 3 + [_PTR], _INT),
    "duodiff_sdpa_chain_bf16": ([_PTR] * 4 + [_INT] * 3 + [_PTR], _INT),
    "duodiff_sdpa_chain_int8": ([_PTR] * 4 + [_INT] * 3 + [_PTR], _INT),
    "duodiff_sdpa_int8_smem_bytes": ([_INT], _INT),
    "duodiff_flash_attention_bwd_stats": ([_INT] * 3, ctypes.c_size_t),
    "duodiff_attn_sublayer_bwd_workspace": ([_INT] * 4, ctypes.c_size_t),
    "duodiff_mlp_sublayer_bwd_workspace": ([_INT] * 3, ctypes.c_size_t),
    "duodiff_mlp_sublayer_bwd_split_workspace": ([_INT] * 4, ctypes.c_size_t),
    "duodiff_attn_core_smem_bytes": ([_INT], _INT),
    "duodiff_attn_bwd_core_smem_bytes": ([_INT], _INT),
    "duodiff_error_string": ([_INT], ctypes.c_char_p),
}


def _sources() -> list[Path]:
    return sorted(p for p in CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    """Where the library for the current sources lives once built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libduodiff_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found is None and Path("/usr/local/cuda/bin/nvcc").exists():
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "are built from duodiff_tpu_torch/csrc with the CUDA toolkit"
        )
    return found


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands concurrently; raise with the first failure's output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outputs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outputs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n{' '.join(cmd)}\n{out}")


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    units = [p for p in _sources() if p.suffix == ".cu"]
    objs = [BUILD_DIR / f"{tag}.{p.stem}.o" for p in units]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)]
                  for p, o in zip(units, objs)])
        _run_all([[nvcc, "-shared", "-o", str(tmp), *(str(o) for o in objs)]])
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built kernels, with every C entry's signature declared."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib
