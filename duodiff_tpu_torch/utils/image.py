"""Image saving (counterpart of ``duodiff_tpu/utils/image.py``) with a PNG
writer of its own on the standard library's ``zlib`` and ``struct``: 8-bit
RGB, RGBA (a latent model's 4 channels, as TensorBoard shows them) or
greyscale, no interlace, every scanline with filter type 0, one IDAT
chunk. It writes the pixels Pillow writes for the same array; the bytes of
the file may differ (Pillow picks filters and a compression level).
"""

from __future__ import annotations

import math
import struct
import zlib
from pathlib import Path

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# channels -> PNG colour type (greyscale, truecolour, truecolour with alpha)
_COLOR_TYPES = {1: 0, 3: 2, 4: 6}


def to_uint8(img01: np.ndarray) -> np.ndarray:
    img01 = np.nan_to_num(img01, nan=0.0, posinf=1.0, neginf=0.0)
    return (np.clip(img01, 0.0, 1.0) * 255.0).round().astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    """Length, type, data and the CRC-32 of type and data."""
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def encode_png(arr: np.ndarray) -> bytes:
    """A uint8 (H, W), (H, W, 1), (H, W, 3) or (H, W, 4) array as the bytes of
    a PNG file."""
    arr = np.asarray(arr)
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[-1] not in _COLOR_TYPES:
        raise ValueError(f"a PNG takes uint8 (H, W), (H, W, 1), (H, W, 3) or (H, W, 4), got "
                         f"{arr.dtype} {arr.shape}")
    h, w, c = arr.shape
    rows = np.zeros((h, 1 + w * c), dtype=np.uint8)  # a filter-type byte (0) before each row
    rows[:, 1:] = arr.reshape(h, w * c)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _chunk(b"IEND", b""))


def save_image(img01: np.ndarray, path) -> None:
    """img01: (H, W, C) float in [0, 1], C = 1, 3 or 4."""
    Path(path).write_bytes(encode_png(to_uint8(np.asarray(img01))))


def make_grid(samples: np.ndarray) -> np.ndarray:
    """(N, H, W, C) in [0, 1] -> the square grid image, row-major, black where
    the last row is not full."""
    n, h, w, c = samples.shape
    grid_size = math.ceil(math.sqrt(n))
    grid = np.zeros((grid_size * h, grid_size * w, c), dtype=np.float32)
    for idx in range(n):
        row, col = divmod(idx, grid_size)
        grid[row * h:(row + 1) * h, col * w:(col + 1) * w] = np.clip(samples[idx], 0, 1)
    return grid


def save_samples(samples: np.ndarray, output_folder, timestep: int = 1000,
                 with_grid: bool = True) -> None:
    """Write each sample as ``{i}.png`` (``{i}_{timestep}.png`` for an
    intermediate, any ``timestep`` but 1000) and the grid as ``grid_image.png``."""
    output_folder = Path(output_folder)
    output_folder.mkdir(parents=True, exist_ok=True)
    samples = np.asarray(samples)
    for i, s in enumerate(samples):
        name = f"{i}_{timestep}.png" if timestep != 1000 else f"{i}.png"
        save_image(s, output_folder / name)
    if with_grid:
        save_image(make_grid(samples), output_folder / "grid_image.png")
