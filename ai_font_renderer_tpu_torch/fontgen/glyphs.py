"""Per-glyph raster + SDF targets for the implicit-model families.

The port's own copy of ai_font_renderer_tpu/fontgen/glyphs.py, code
unchanged: host numpy over the port's TTF parser and native rasterizer.

Supports the extended configs (BASELINE.json): coordinate-conditioned
implicit glyph MLPs (SIREN), the multi-font-conditioned model, and the
SDF-head model. Produces, per charset glyph:

  * coverage rasters at an arbitrary cell resolution (e.g. 64x64) via the
    same analytic rasterizer as the sheet pipeline;
  * signed distance fields computed with an exact two-pass Euclidean
    distance transform (Felzenszwalb-Huttenlocher) on the coverage bitmap:
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


def _edt_1d(f: np.ndarray) -> np.ndarray:
    """Felzenszwalb-Huttenlocher 1D squared distance transform."""
    n = len(f)
    d = np.empty(n)
    v = np.zeros(n, np.int64)
    z = np.empty(n + 1)
    k = 0
    v[0] = 0
    z[0], z[1] = -np.inf, np.inf
    for q in range(1, n):
        while True:
            p = v[k]
            s = ((f[q] + q * q) - (f[p] + p * p)) / (2 * q - 2 * p)
            if s <= z[k]:
                k -= 1
            else:
                break
        k += 1
        v[k] = q
        z[k], z[k + 1] = s, np.inf
    k = 0
    for q in range(n):
        while z[k + 1] < q:
            k += 1
        p = v[k]
        d[q] = (q - p) ** 2 + f[p]
    return d


def _edt_2d(binary: np.ndarray) -> np.ndarray:
    """Exact Euclidean distance (pixels) to the nearest True cell."""
    INF = 1e12
    h, w = binary.shape
    f = np.where(binary, 0.0, INF)
    for y in range(h):
        f[y] = _edt_1d(f[y])
    for x in range(w):
        f[:, x] = _edt_1d(f[:, x])
    return np.sqrt(f)


def coverage_to_sdf(coverage: np.ndarray, threshold: float = 0.5) -> np.ndarray:
    """Coverage bitmap -> signed distance field (pixels; + outside ink).

    Uses the exact EDT both ways and subtracts, with a half-pixel coverage
    correction at the boundary from the antialiased edge values.
    """
    inside = coverage >= threshold
    if not inside.any():
        return np.full(coverage.shape, np.float32(coverage.shape[0]))
    d_out = _edt_2d(inside)  # distance to ink, for outside pixels
    d_in = _edt_2d(~inside)  # distance to background, for inside pixels
    sdf = np.where(inside, -(d_in - 0.5), d_out - 0.5)
    # AA-aware boundary refinement: where coverage is fractional, the true
    # edge sits at (0.5 - coverage) pixels from the pixel center.
    frac = (coverage > 0.02) & (coverage < 0.98)
    sdf = np.where(frac, 0.5 - coverage, sdf)
    return sdf.astype(np.float32)


def sdf_charset(
    font_path: str, charset: str, cell: int = 64, fill: float = 0.85
) -> np.ndarray:
    """[len(charset), cell, cell] signed distance fields."""
    cov = rasterize_charset(font_path, charset, cell, fill)
    return np.stack([coverage_to_sdf(c) for c in cov])
