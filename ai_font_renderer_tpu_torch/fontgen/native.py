"""ctypes bridge to the native C++ batch rasterizer and corpus generator.

The port's copy of ai_font_renderer_tpu/fontgen/native.py, with its own
copies of ``native/rasterizer.cpp`` and ``native/corpus.cpp``. Each source
is compiled with ``g++`` at first use into the package's ``_build/``
directory (listed in ``.gitignore``), named by a hash of the source, and
never beside the sources. Without a compiler the pure-Python rasterizer in
:mod:`.raster` and the Python corpus path take over, as in the JAX package.
This is host code: the atlas bake rasterizes some 16k glyph variants, which
takes minutes in Python and under a second natively.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL | None] = {}

_NATIVE_DIR = Path(__file__).resolve().parent / "native"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

# The JAX package's flags, so both packages rasterize bit-identically.
_CXXFLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")


def _build_and_load(name: str) -> ctypes.CDLL | None:
    """Compile native/<name>.cpp (cached by content) and dlopen it; None
    when no compiler is available."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        src = _NATIVE_DIR / f"{name}.cpp"
        digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
        so = BUILD_DIR / f"lib{name}-{digest}.so"
        try:
            if not so.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run(
                    ["g++", *_CXXFLAGS, str(src), "-o", str(tmp)],
                    check=True,
                    capture_output=True,
                )
                os.replace(tmp, so)
            _LIBS[name] = ctypes.CDLL(str(so))
        except (subprocess.CalledProcessError, OSError):
            _LIBS[name] = None
        return _LIBS[name]


def _load() -> ctypes.CDLL | None:
    lib = _build_and_load("rasterizer")
    if lib is not None and not hasattr(lib, "_configured"):
        lib.rasterize_batch.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.rasterize_batch.restype = None
        lib._configured = True
    return lib


def corpus_available() -> bool:
    return _build_and_load("corpus") is not None


def generate_corpus_grids(
    num_samples: int,
    base_seed: int,
    min_len: int,
    max_len: int,
    advance_px: float,
    max_width: int,
    n_lines: int,
    n_slots: int,
    max_chars: int,
) -> tuple[np.ndarray, np.ndarray] | None:
    """Native LCG corpus + monospace grid layout; None if no toolchain.

    Bit-exact twin of textgen.generate_corpus + layout.encode_codes/
    encode_grids (the tests hold them against each other).
    """
    lib = _build_and_load("corpus")
    if lib is None:
        return None
    if not hasattr(lib, "_configured"):
        lib.generate_corpus_grids.argtypes = [
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_double,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int16),
        ]
        lib.generate_corpus_grids.restype = None
        lib._configured = True
    codes = np.zeros((num_samples, max_chars), np.int32)
    grids = np.zeros((num_samples, n_lines, n_slots), np.int16)
    lib.generate_corpus_grids(
        num_samples,
        base_seed,
        min_len,
        max_len,
        advance_px,
        max_width,
        n_lines,
        n_slots,
        max_chars,
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        grids.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
    )
    return codes, grids


def rasterize_batch(
    segments: np.ndarray, item_offsets: np.ndarray, width: int, height: int
) -> np.ndarray:
    """Rasterize a batch of segment lists into coverage images.

    Args:
      segments: float32 [M, 4] device-space (x0, y0, x1, y1), y-down.
      item_offsets: int64 [N+1]; item i owns segments[offsets[i]:offsets[i+1]].
      width, height: output raster size per item.

    Returns:
      float32 [N, height, width] coverage in [0, 1].
    """
    segments = np.ascontiguousarray(segments, np.float32)
    item_offsets = np.ascontiguousarray(item_offsets, np.int64)
    n = len(item_offsets) - 1
    out = np.zeros((n, height, width), np.float32)
    lib = _load()
    if lib is None:
        from .raster import rasterize_segments

        for i in range(n):
            segs = segments[item_offsets[i] : item_offsets[i + 1]]
            out[i] = rasterize_segments(segs, width, height)
        return out
    lib.rasterize_batch(
        segments.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        item_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        width,
        height,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out
