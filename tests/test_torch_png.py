"""The port's PNG reader (``duodiff_tpu_torch/utils/image.py``: ``decode_png``,
``read_png``, ``to_rgb``) against Pillow, which the port's machine lacks.

Pillow writes greyscale, greyscale with alpha, RGB, RGBA, palette (8, 4 and
2 bits) and 1-bit images with its own adaptive choice of scanline filter;
files built here carry each filter type 0-4 in every row, and a mix. The
reader's RGB must equal ``Image.open(p).convert("RGB")`` exactly, the
port's writer's files must round-trip, and 16-bit and interlaced files are
refused by name.
"""

import io
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from duodiff_tpu_torch.utils.image import (
    PNG_SIGNATURE,
    decode_png,
    encode_png,
    read_png,
    save_image,
    to_rgb,
)

torch.set_num_threads(1)


def _images():
    rng = np.random.RandomState(0)
    noisy = rng.randint(0, 256, (23, 37, 3), dtype=np.uint8)
    ramp = np.stack([(np.add.outer(np.arange(40), 3 * np.arange(33)) % 256).astype(np.uint8)] * 3,
                    -1)
    ramp[..., 1] //= 2
    return {"noisy": noisy, "ramp": ramp}


MODES = {
    "RGB": lambda a: Image.fromarray(a),
    "RGBA": lambda a: Image.fromarray(np.concatenate([a, a[..., :1] // 3], -1)),
    "L": lambda a: Image.fromarray(a).convert("L"),
    "LA": lambda a: Image.fromarray(a).convert("LA"),
    "P": lambda a: Image.fromarray(a).convert("P"),
    "P4bit": lambda a: Image.fromarray(a).quantize(12),
    "P2bit": lambda a: Image.fromarray(a).quantize(4),
    "1": lambda a: Image.fromarray(a).convert("1"),
}


def _pillow_png(img) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


@pytest.mark.parametrize("image", sorted(_images()))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_pillow_files_read_as_pillow_reads_them(mode, image, tmp_path):
    data = _pillow_png(MODES[mode](_images()[image]))
    path = tmp_path / "x.png"
    path.write_bytes(data)
    want = np.asarray(Image.open(path).convert("RGB"))
    got = read_png(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filtered_png(arr: np.ndarray, filters, color_type: int = 2) -> bytes:
    """A PNG of uint8 (H, W, C) with ``filters[r % len(filters)]`` on row r,
    filtered by the spec (the encoder side of each filter)."""
    h, w, c = arr.shape
    rows, prior = [], np.zeros(w * c, np.int64)
    for r in range(h):
        cur = arr[r].reshape(-1).astype(np.int64)
        kind = filters[r % len(filters)]
        out = np.empty_like(cur)
        for i in range(len(cur)):
            a = cur[i - c] if i >= c else 0
            b = prior[i]
            up_left = prior[i - c] if i >= c else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, up_left))[kind]
            out[i] = (cur[i] - pred) % 256
        rows.append(bytes([kind]) + out.astype(np.uint8).tobytes())
        prior = cur
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(b"".join(rows))) + _chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
@pytest.mark.parametrize("channels", [3, 4])
def test_every_scanline_filter(filters, channels, tmp_path):
    rng = np.random.RandomState(len(filters) * 7 + channels)
    arr = rng.randint(0, 256, (11, 9, channels), dtype=np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(_filtered_png(arr, filters, color_type={3: 2, 4: 6}[channels]))
    np.testing.assert_array_equal(decode_png(path.read_bytes())["pixels"], arr)
    np.testing.assert_array_equal(read_png(path), np.asarray(Image.open(path).convert("RGB")))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_the_writers_files_round_trip(channels, tmp_path):
    rng = np.random.RandomState(channels)
    arr = rng.randint(0, 256, (13, 17, channels), dtype=np.uint8)
    png = decode_png(encode_png(arr))
    np.testing.assert_array_equal(png["pixels"], arr)
    img01 = rng.rand(8, 8, 3).astype(np.float32)
    save_image(img01, tmp_path / "s.png")
    np.testing.assert_array_equal(read_png(tmp_path / "s.png"),
                                  np.asarray(Image.open(tmp_path / "s.png").convert("RGB")))


def test_to_rgb_follows_pillow_convert():
    grey = {"pixels": np.array([[[7], [200]]], np.uint8), "color_type": 0, "bit_depth": 8,
            "palette": None}
    np.testing.assert_array_equal(to_rgb(grey), [[[7, 7, 7], [200, 200, 200]]])
    pal = {"pixels": np.array([[[1], [0]]], np.uint8), "color_type": 3, "bit_depth": 8,
           "palette": np.array([[1, 2, 3], [4, 5, 6]], np.uint8)}
    np.testing.assert_array_equal(to_rgb(pal), [[[4, 5, 6], [1, 2, 3]]])


@pytest.mark.parametrize("case", ["16bit", "interlaced"])
def test_refusals_name_the_file(case, tmp_path):
    arr = np.zeros((4, 4, 3), np.uint8)
    if case == "16bit":
        data = _pillow_png(Image.fromarray(np.full((4, 4), 40000, np.uint16)))
        match = "16-bit"
    else:
        data = bytearray(_filtered_png(arr, (0,)))
        data[8 + 8 + 12] = 1  # IHDR's interlace byte (the CRC is not read)
        data = bytes(data)
        match = "interlaced"
    path = tmp_path / f"{case}.png"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=match) as info:
        read_png(path)
    assert str(path) in str(info.value)
