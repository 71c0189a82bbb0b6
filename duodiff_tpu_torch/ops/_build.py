"""Build and load the CUDA kernels of ``duodiff_tpu_torch/csrc``.

Every ``csrc/*.cu`` is compiled by its own ``nvcc``, all started together,
and the objects are linked into one shared library with a plain C
interface, loaded with ``ctypes``. The build runs at first use, into
``duodiff_tpu_torch/build/``, and again whenever a source's content
changes (the library's name carries a hash of the sources and flags).
ptxas reports every kernel's registers and spills (``-Xptxas -v``) into a
text file beside the library, which :func:`kernel_resources` reads.
Importing this module needs neither ``nvcc`` nor a GPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_FLOAT = ctypes.c_float
# C entry -> (argtypes, restype); every pointer and the stream as c_void_p
_SIGNATURES = {
    "duodiff_attn_sublayer": ([_PTR] * 11 + [_INT] * 6 + [_FLOAT, _PTR], _INT),
    "duodiff_mlp_sublayer": ([_PTR] * 10 + [_INT] * 5 + [_FLOAT, _PTR], _INT),
    "duodiff_attn_sublayer_int8": ([_PTR] * 15 + [_INT] * 5 + [_FLOAT, _PTR], _INT),
    "duodiff_mlp_sublayer_int8": ([_PTR] * 16 + [_INT] * 4 + [_FLOAT, _PTR], _INT),
    "duodiff_attn_sublayer_bwd": ([_PTR] * 15 + [_INT] * 6 + [_FLOAT, _PTR], _INT),
    "duodiff_mlp_sublayer_bwd": ([_PTR] * 15 + [_INT] * 5 + [_FLOAT, _PTR], _INT),
    "duodiff_attn_sublayer_v1": ([_PTR] * 11 + [_INT] * 5 + [_FLOAT, _PTR], _INT),
    "duodiff_fused_block": ([_PTR] * 19 + [_INT] * 7 + [_FLOAT, _PTR], _INT),
    "duodiff_mlp_sublayer_bwd_split": ([_PTR] * 15 + [_INT] * 5 + [_FLOAT, _PTR], _INT),
    "duodiff_flash_attention": ([_PTR] * 4 + [_INT] * 4 + [_PTR], _INT),
    "duodiff_flash_attention_bwd": ([_PTR] * 8 + [_INT] * 4 + [_PTR], _INT),
    "duodiff_sdpa_chain_bf16": ([_PTR] * 4 + [_INT] * 4 + [_PTR], _INT),
    "duodiff_sdpa_chain_int8": ([_PTR] * 4 + [_INT] * 3 + [_PTR], _INT),
    "duodiff_sdpa_int8_smem_bytes": ([_INT], _INT),
    "duodiff_sdpa_int8_max_len": ([], _INT),
    "duodiff_sdpa_int8_warps": ([], _INT),
    "duodiff_sdpa_int8_blocks_per_sm": ([_INT], _INT),
    "duodiff_flash_attention_bwd_stats": ([_INT] * 3, ctypes.c_size_t),
    "duodiff_attn_sublayer_bwd_workspace": ([_INT] * 5, ctypes.c_size_t),
    "duodiff_mlp_sublayer_bwd_workspace": ([_INT] * 3, ctypes.c_size_t),
    "duodiff_mlp_sublayer_bwd_split_workspace": ([_INT] * 4, ctypes.c_size_t),
    "duodiff_mlp_sublayer_bwd_split_chunk_rows": ([_INT] * 2, _INT),
    "duodiff_attn_core_warps": ([_INT], _INT),
    "duodiff_attn_core_form": ([_PTR] * 4 + [_INT] * 6 + [_FLOAT, _PTR], _INT),
    "duodiff_attn_core_registers_max_len": ([], _INT),
    "duodiff_attn_core_smem_bytes": ([_INT] * 2, _INT),
    "duodiff_attn_bwd_core_smem_bytes": ([_INT] * 3, _INT),
    "duodiff_attn_core_blocks_per_sm": ([_INT] * 2, _INT),
    "duodiff_attn_bwd_core_warps": ([_INT] * 2, _INT),
    "duodiff_attn_bwd_core_form": ([_PTR] * 9 + [_INT] * 5 + [_PTR], _INT),
    "duodiff_attn_bwd_core_blocks_per_sm": ([_INT] * 3, _INT),
    "duodiff_gemm_bf16": ([_PTR] * 5 + [_INT] * 6 + [_PTR], _INT),
    "duodiff_gemm_bf16_threads": ([], _INT),
    "duodiff_gemm_bf16_stages": ([], _INT),
    "duodiff_gemm_bf16_smem_bytes": ([], _INT),
    "duodiff_gemm_bf16_blocks_per_sm": ([], _INT),
    "duodiff_gemm_int8": ([_PTR] * 8 + [_INT] * 5 + [_PTR], _INT),
    "duodiff_gemm_int8_threads": ([], _INT),
    "duodiff_gemm_int8_stages": ([], _INT),
    "duodiff_gemm_int8_smem_bytes": ([], _INT),
    "duodiff_gemm_int8_blocks_per_sm": ([], _INT),
    "duodiff_ln_quant_rows": ([_PTR] * 6 + [_INT] * 2 + [_FLOAT, _INT, _PTR], _INT),
    "duodiff_gemm_t": ([_PTR] * 4 + [_INT] * 5 + [_PTR], _INT),
    "duodiff_gemm_t_splits": ([_INT] * 3, _INT),
    "duodiff_gemm_t_flag_bytes": ([_INT] * 2, ctypes.c_size_t),
    "duodiff_gemm_t_layout": ([_PTR], _INT),
    "duodiff_mlp_bwd_hidden": ([_PTR] * 9 + [_INT] * 4 + [_PTR], _INT),
    "duodiff_mlp_bwd_hidden_part_bytes": ([_INT] * 2, ctypes.c_size_t),
    "duodiff_attn_head_width": ([_INT], _INT),
    "duodiff_attn_core_max_len": ([_INT], _INT),
    "duodiff_attn_bwd_core_max_len": ([_INT], _INT),
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


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands concurrently; raise with the first failure's output,
    else return every command's output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outputs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outputs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n{' '.join(cmd)}\n{out}")
    return outputs


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
        reports = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)]
                            for p, o in zip(units, objs)])
        _resources_path(out).write_text(
            "".join(f"== {p.stem}\n{text}\n" for p, text in zip(units, reports)))
        _run_all([[nvcc, "-shared", "-o", str(tmp), *(str(o) for o in objs)]])
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)
    return out


def _resources_path(lib: Path) -> Path:
    return lib.with_suffix(".ptxas.txt")


def _report_section(unit: str) -> str:
    text = _resources_path(build()).read_text()
    return text.split(f"== {unit}\n", 1)[1].split("\n== ", 1)[0]


def ptxas_warnings(unit: str) -> list[str]:
    """The warning lines of the compiler's report on ``csrc/<unit>.cu`` (for
    instance a ``wgmma`` that ptxas had to serialise)."""
    return [line.strip() for line in _report_section(unit).splitlines()
            if "warning" in line.lower() or "Performance Loss" in line]


def kernel_resources(unit: str) -> list[dict]:
    """What ptxas reported for each kernel of ``csrc/<unit>.cu`` when the
    library was built: ``entry`` (the mangled name), ``registers`` a thread,
    ``spill_stores`` / ``spill_loads`` / ``stack`` in bytes."""
    section = _report_section(unit)
    records = []
    for part in section.split("Compiling entry function '")[1:]:
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", part)
        used = re.search(r"Used (\d+) registers", part)
        records.append({"entry": part.split("'", 1)[0], "registers": int(used.group(1)),
                        "stack": int(spill.group(1)), "spill_stores": int(spill.group(2)),
                        "spill_loads": int(spill.group(3))})
    return records


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built kernels, with every C entry's signature declared."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib
