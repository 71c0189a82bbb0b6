"""Image saving (counterpart of ``duodiff_tpu/utils/image.py``) with a PNG
writer of its own on the standard library's ``zlib`` and ``struct``: 8-bit
RGB, RGBA (a latent model's 4 channels, as TensorBoard shows them) or
greyscale, no interlace, every scanline with filter type 0, one IDAT
chunk. It writes the pixels Pillow writes for the same array; the bytes of
the file may differ (Pillow picks filters and a compression level).

The reader (:func:`decode_png`, :func:`read_png`) takes what the writer and
Pillow write: greyscale (1, 2, 4 or 8 bits), greyscale with alpha, RGB,
RGBA and palette images (1, 2, 4 or 8 bits), non-interlaced, with any of
the five scanline filters in any row. 16-bit and interlaced files are
refused. :func:`to_rgb` is Pillow's ``convert("RGB")``: greyscale
repeated, alpha dropped, a palette looked up.
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


# colour type -> samples a pixel (greyscale, truecolour, palette, greyscale
# with alpha, truecolour with alpha)
_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _unfilter(data: bytes, h: int, stride: int, bpp: int, name: str) -> np.ndarray:
    """Undo the scanline filters of ``h`` rows of ``stride`` bytes, each row
    after its filter-type byte: (h, stride) uint8. None, Sub and Up are
    vectorised; Average and Paeth walk the row, one byte at a time."""
    if len(data) < h * (stride + 1):
        raise ValueError(f"{name}: image data is truncated")
    raw = np.frombuffer(data, np.uint8, count=h * (stride + 1)).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for r in range(h):
        kind, line = int(raw[r, 0]), raw[r, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # Sub: a running sum of each byte lane, modulo 256
            pad = (-stride) % bpp
            lanes = np.concatenate([line, np.zeros(pad, np.uint8)]).reshape(-1, bpp)
            cur = (np.cumsum(lanes, axis=0, dtype=np.uint64) % 256).astype(np.uint8).ravel()
            cur = cur[:stride]
        elif kind == 2:  # Up
            cur = line + prior
        elif kind in (3, 4):
            cur = bytearray(line.tobytes())
            up = prior.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:  # Average
                    cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
                else:  # Paeth
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                    cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"{name}: unknown scanline filter type {kind} in row {r}")
        out[r] = cur
        prior = out[r]
    return out


def decode_png(data: bytes, name: str = "PNG data") -> dict:
    """The bytes of a PNG file -> ``{"pixels": uint8 (H, W, C), "color_type":
    the PNG colour type, "bit_depth", "palette": uint8 (n, 3) or None}``.
    ``pixels`` holds palette indices for a palette image, and greyscale
    values of fewer than 8 bits scaled to 0..255, as Pillow loads them.
    ``name`` names the file in every refusal."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos, header, palette, idat = 8, None, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if color not in _SAMPLES:
        raise ValueError(f"{name}: unknown PNG colour type {color}")
    if depth == 16:
        raise ValueError(f"{name}: 16-bit PNG files are not supported (8 bits a sample or fewer)")
    if depth != 8 and not (color in (0, 3) and depth in (1, 2, 4)):
        raise ValueError(f"{name}: bit depth {depth} with colour type {color} is not a PNG "
                         "this reader takes")
    if interlace:
        raise ValueError(f"{name}: interlaced PNG files are not supported")
    if color == 3 and palette is None:
        raise ValueError(f"{name}: a palette image without a PLTE chunk")
    samples = _SAMPLES[color]
    stride = (w * samples * depth + 7) // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, stride, max(1, samples * depth // 8),
                     name)
    if depth < 8:
        bits = np.unpackbits(rows, axis=1)[:, :w * depth].reshape(h, w, depth)
        rows = (bits * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(
            -1, dtype=np.uint8)
        if color == 0:
            rows = rows * np.uint8(255 // ((1 << depth) - 1))
    return {"pixels": rows.reshape(h, w, samples), "color_type": color, "bit_depth": depth,
            "palette": palette}


def to_rgb(png: dict) -> np.ndarray:
    """A decoded PNG (:func:`decode_png`) as uint8 (H, W, 3), as Pillow's
    ``convert("RGB")`` gives it."""
    px, color = png["pixels"], png["color_type"]
    if color == 3:
        index = px[..., 0]
        if int(index.max(initial=0)) >= len(png["palette"]):
            raise ValueError("a palette index lies past the PLTE chunk")
        return png["palette"][index]
    if color in (0, 4):
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def read_png(path) -> np.ndarray:
    """A PNG file as uint8 (H, W, 3), ``Image.open(path).convert("RGB")``."""
    return to_rgb(decode_png(Path(path).read_bytes(), str(path)))


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
