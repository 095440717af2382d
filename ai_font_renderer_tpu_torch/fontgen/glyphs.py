"""Per-glyph raster + SDF targets for the implicit-model families.

The port's own copy of ai_font_renderer_tpu/fontgen/glyphs.py: host numpy
over the port's TTF parser and native rasterizer. Its distance transform
takes the exact minimum by brute force over every glyph of a chunk at once
(the JAX package walks each row's lower envelope in Python); both give the
same distances.

Supports the extended configs (BASELINE.json): coordinate-conditioned
implicit glyph MLPs (SIREN), the multi-font-conditioned model, and the
SDF-head model. Produces, per charset glyph:

  * coverage rasters at an arbitrary cell resolution (e.g. 64x64) via the
    same analytic rasterizer as the sheet pipeline;
  * signed distance fields computed with an exact two-pass Euclidean
    distance transform on the coverage bitmap:
    positive outside ink, negative inside, in pixel units.
"""

from __future__ import annotations

import numpy as np

from . import native
from .raster import flatten_glyph
from .ttf import TrueTypeFont


def unicode_charset(font_path: str, limit: int | None = None) -> str:
    """Every printable codepoint the font maps, as a string.

    "Printable" excludes control/format/surrogate/private-use/unassigned
    categories; the result drives the full-Unicode SDF atlas configs.
    """
    import unicodedata

    font = TrueTypeFont.load(font_path)
    out = []
    for cp in sorted(font._cmap):
        if cp < 0x20 or 0xD800 <= cp <= 0xDFFF or cp > 0x10FFFF:
            continue
        ch = chr(cp)
        if unicodedata.category(ch) in ("Cc", "Cf", "Cs", "Co", "Cn"):
            continue
        out.append(ch)
        if limit and len(out) >= limit:
            break
    return "".join(out)


def rasterize_charset(
    font_path: str,
    charset: str,
    cell: int = 64,
    fill: float = 0.85,
) -> np.ndarray:
    """Rasterize every charset glyph centered in a [cell, cell] box.

    ``fill`` scales the em so ascender-to-descender spans that fraction of
    the cell. Returns float32 [len(charset), cell, cell] coverage.
    """
    font = TrueTypeFont.load(font_path)
    # Scale so the font's full ascent+descent span fits `fill * cell`.
    span_units = max(font.ascent - font.descent, 1)
    px_size = fill * cell * font.units_per_em / span_units
    scale = px_size / font.units_per_em
    # Baseline placed so the ascender line sits at the top margin.
    top_margin = 0.5 * (cell - fill * cell)
    baseline = top_margin + font.ascent * scale

    segs_all, offsets = [], [0]
    total = 0
    for ch in charset:
        gid = font.glyph_id(ord(ch))
        segs = flatten_glyph(font.glyph(gid), scale)
        adv = font.advance(gid) * scale
        x_off = 0.5 * (cell - adv)
        if len(segs):
            dev = np.empty_like(segs)
            dev[:, 0] = segs[:, 0] + x_off
            dev[:, 1] = baseline - segs[:, 1]
            dev[:, 2] = segs[:, 2] + x_off
            dev[:, 3] = baseline - segs[:, 3]
            segs_all.append(dev)
            total += len(dev)
        offsets.append(total)
    segments = (
        np.concatenate(segs_all) if segs_all else np.zeros((0, 4), np.float32)
    )
    return native.rasterize_batch(
        segments, np.asarray(offsets, np.int64), cell, cell
    )


def _min_plus_rows(f: np.ndarray) -> np.ndarray:
    """1D squared distance transform along the last axis of ``f``:
    d[..., q] = min_p f[..., p] + (q - p)^2, the exact minimum by brute
    force over all p (the lower envelope Felzenszwalb-Huttenlocher walk
    finds the same minimum), vectorized over every leading axis."""
    n = f.shape[-1]
    i = np.arange(n, dtype=np.float64)
    d2 = (i[:, None] - i[None, :]) ** 2  # [q, p]
    return (d2 + f[..., None, :]).min(-1)


def _edt_2d(binary: np.ndarray) -> np.ndarray:
    """Exact Euclidean distance (pixels) to the nearest True cell of each
    [h, w] image of ``binary`` [..., h, w]: two separable passes."""
    INF = 1e12
    f = _min_plus_rows(np.where(binary, 0.0, INF))
    f = _min_plus_rows(np.swapaxes(f, -1, -2))
    return np.sqrt(np.swapaxes(f, -1, -2))


def _coverage_to_sdf(coverage: np.ndarray, threshold: float) -> np.ndarray:
    """:func:`coverage_to_sdf` of each [h, w] image of ``coverage``
    [B, h, w] at once."""
    inside = coverage >= threshold
    d_out = _edt_2d(inside)  # distance to ink, for outside pixels
    d_in = _edt_2d(~inside)  # distance to background, for inside pixels
    sdf = np.where(inside, -(d_in - 0.5), d_out - 0.5)
    # AA-aware boundary refinement: where coverage is fractional, the true
    # edge sits at (0.5 - coverage) pixels from the pixel center.
    frac = (coverage > 0.02) & (coverage < 0.98)
    sdf = np.where(frac, 0.5 - coverage, sdf).astype(np.float32)
    empty = ~inside.any(axis=(-1, -2))
    sdf[empty] = np.float32(coverage.shape[-2])
    return sdf


def coverage_to_sdf(coverage: np.ndarray, threshold: float = 0.5) -> np.ndarray:
    """Coverage bitmap -> signed distance field (pixels; + outside ink).

    Uses the exact EDT both ways and subtracts, with a half-pixel coverage
    correction at the boundary from the antialiased edge values.
    """
    return _coverage_to_sdf(coverage[None], threshold)[0]


def sdf_charset(
    font_path: str, charset: str, cell: int = 64, fill: float = 0.85
) -> np.ndarray:
    """[len(charset), cell, cell] signed distance fields."""
    cov = rasterize_charset(font_path, charset, cell, fill)
    chunk = max(1, 2**22 // cell**3)  # [chunk, cell, cell, cell] f64 a pass: 32 MiB
    parts = [_coverage_to_sdf(cov[s : s + chunk], 0.5) for s in range(0, len(cov), chunk)]
    return np.concatenate(parts) if parts else np.zeros((0, cell, cell), np.float32)
