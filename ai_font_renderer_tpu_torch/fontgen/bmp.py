"""BMP codec: 24-bit BGR BITMAPINFOHEADER, top-down rows.

Own copy of the JAX package's codec (ai_font_renderer_tpu/fontgen/bmp.py),
byte for byte the same files: 14-byte file header, 40-byte DIB header,
negative height for top-down rows, rows padded to 4 bytes, BGR order. The
reader also takes bottom-up 24-bit and 8-bit grayscale files.
"""

from __future__ import annotations

import os
import struct

import numpy as np


def encode_bmp(gray: np.ndarray) -> bytes:
    """Encode a float [H, W] (0..1, 1 = white) or uint8 array as 24-bit BMP."""
    if gray.dtype != np.uint8:
        gray = np.clip(np.asarray(gray, np.float64) * 255.0, 0, 255).round().astype(
            np.uint8
        )
    h, w = gray.shape
    row_size = (w * 3 + 3) // 4 * 4
    data_size = row_size * h
    file_size = 14 + 40 + data_size

    header = struct.pack(
        "<2sIHHI" "IiiHHIIiiII",
        b"BM",
        file_size,
        0,
        0,
        54,  # pixel data offset
        40,  # DIB header size
        w,
        -h,  # negative height: top-down rows
        1,  # planes
        24,  # bits per pixel
        0,  # compression
        data_size,
        0,
        0,
        0,
        0,
    )
    rows = np.zeros((h, row_size), np.uint8)
    bgr = np.repeat(gray[:, :, None], 3, axis=2)  # grayscale -> B=G=R
    rows[:, : w * 3] = bgr.reshape(h, w * 3)
    return header + rows.tobytes()


def write_bmp(path: str, gray: np.ndarray) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_bmp(gray))


def read_bmp(path_or_bytes) -> np.ndarray:
    """Decode a BMP to float32 [H, W] grayscale in 0..1 (1 = white).

    Color pixels convert with the ITU-R 601 luma weights PIL uses for
    mode 'L'.
    """
    if isinstance(path_or_bytes, (bytes, bytearray)):
        b = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            b = f.read()
    if b[:2] != b"BM":
        raise ValueError("not a BMP file")
    pixel_offset = struct.unpack_from("<I", b, 10)[0]
    dib_size = struct.unpack_from("<I", b, 14)[0]
    if dib_size < 40:
        raise ValueError(f"unsupported DIB header size {dib_size}")
    w = struct.unpack_from("<i", b, 18)[0]
    h = struct.unpack_from("<i", b, 22)[0]
    bpp = struct.unpack_from("<H", b, 28)[0]
    compression = struct.unpack_from("<I", b, 30)[0]
    if compression != 0:
        raise ValueError(f"unsupported BMP compression {compression}")
    top_down = h < 0
    h = abs(h)

    if bpp == 24:
        row_size = (w * 3 + 3) // 4 * 4
        raw = np.frombuffer(b, np.uint8, row_size * h, pixel_offset)
        rows = raw.reshape(h, row_size)[:, : w * 3].reshape(h, w, 3)
        bgr = rows.astype(np.float32)
        gray = 0.299 * bgr[:, :, 2] + 0.587 * bgr[:, :, 1] + 0.114 * bgr[:, :, 0]
        gray = np.round(gray)
    elif bpp == 8:
        row_size = (w + 3) // 4 * 4
        raw = np.frombuffer(b, np.uint8, row_size * h, pixel_offset)
        gray = raw.reshape(h, row_size)[:, :w].astype(np.float32)
    else:
        raise ValueError(f"unsupported BMP bit depth {bpp}")
    if not top_down:
        gray = gray[::-1]
    return np.ascontiguousarray(gray / 255.0, dtype=np.float32)
