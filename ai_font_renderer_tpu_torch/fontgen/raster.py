"""Analytic anti-aliased glyph rasterization.

First-party replacement for the Cairo rasterizer behind node-canvas in the
reference (generate_font.ts:100-141 renders text through canvas 2D). The
algorithm is the classic signed-area *accumulation* rasterizer: every outline
segment deposits signed per-cell area deltas into an accumulation buffer, and
a prefix sum along each scanline yields exact analytic coverage — arbitrary
float coordinates, no supersampling, smooth AA.

Two implementations share the same contract:
  * this module — reference pure-Python/numpy version (used in tests and as
    fallback);
  * ``native/rasterizer.cpp`` — the repo's native C++ component, batched over
    thousands of glyph variants (see ``native.py``).

Coverage convention: 0.0 = no ink, 1.0 = fully covered. Device coordinates
are y-down (pixel row 0 at the top), matching the sheet layout.

The port's own copy of ai_font_renderer_tpu/fontgen/raster.py, code unchanged,
so both packages build the same corpus and glyphs.
"""

from __future__ import annotations

import math

import numpy as np

from .ttf import Glyph


def flatten_glyph(glyph: Glyph, scale: float, tol: float = 0.1) -> np.ndarray:
    """Flatten a glyph's quadratic-bezier contours into line segments.

    Returns float32 array [N, 4] of (x0, y0, x1, y1) in *pixel* units,
    y-up relative to the baseline (callers translate/flip into device space).
    TrueType semantics: consecutive off-curve points imply on-curve midpoints.
    """
    segs: list[tuple[float, float, float, float]] = []
    for contour in glyph.contours:
        pts = [(x * scale, y * scale, on) for (x, y, on) in contour]
        if len(pts) < 2:
            continue
        # Expand implied on-curve midpoints between consecutive off points.
        expanded: list[tuple[float, float, bool]] = []
        n = len(pts)
        for i in range(n):
            x, y, on = pts[i]
            expanded.append((x, y, on))
            nx, ny, non = pts[(i + 1) % n]
            if not on and not non:
                expanded.append(((x + nx) / 2, (y + ny) / 2, True))
        # Rotate so we start on-curve (a fully off-curve contour is impossible
        # after midpoint insertion unless it had a single point).
        start = next((i for i, p in enumerate(expanded) if p[2]), None)
        if start is None:
            continue
        expanded = expanded[start:] + expanded[:start]
        expanded.append(expanded[0])

        i = 0
        while i < len(expanded) - 1:
            x0, y0, _ = expanded[i]
            x1, y1, on1 = expanded[i + 1]
            if on1:
                segs.append((x0, y0, x1, y1))
                i += 1
            else:
                # Quadratic: on(i) -> off(i+1) -> on(i+2).
                x2, y2, _ = expanded[i + 2]
                _flatten_quad(segs, x0, y0, x1, y1, x2, y2, tol)
                i += 2
    if not segs:
        return np.zeros((0, 4), np.float32)
    return np.asarray(segs, np.float32)


def _flatten_quad(segs, x0, y0, cx, cy, x1, y1, tol):
    """Subdivide one quadratic bezier into line segments within ``tol`` px."""
    # Max deviation of a quadratic from its chord is |mid - chord_mid| / 2.
    dx = x0 - 2 * cx + x1
    dy = y0 - 2 * cy + y1
    dev = math.hypot(dx, dy) / 4.0
    n = max(1, math.ceil(math.sqrt(dev / max(tol, 1e-6))))
    px, py = x0, y0
    for k in range(1, n + 1):
        t = k / n
        mt = 1 - t
        qx = mt * mt * x0 + 2 * mt * t * cx + t * t * x1
        qy = mt * mt * y0 + 2 * mt * t * cy + t * t * y1
        segs.append((px, py, qx, qy))
        px, py = qx, qy


def accumulate(acc: np.ndarray, x0: float, y0: float, x1: float, y1: float) -> None:
    """Deposit one segment's signed area deltas into ``acc`` [h, w+1].

    Device coords, y-down. Winding direction encoded in the sign (downward
    segments positive). Pure-Python hot loop — the C++ rasterizer implements
    the identical math.
    """
    h, w1 = acc.shape
    w = w1 - 1
    if y0 == y1:
        return
    if y0 < y1:
        sign = 1.0
    else:
        sign = -1.0
        x0, y0, x1, y1 = x1, y1, x0, y0
    dxdy = (x1 - x0) / (y1 - y0)
    y_top = max(0.0, y0)
    y_bot = min(float(h), y1)
    if y_top >= y_bot:
        return
    iy0 = int(math.floor(y_top))
    iy1 = int(math.ceil(y_bot))
    for iy in range(iy0, iy1):
        ya = max(y_top, float(iy))
        yb = min(y_bot, float(iy + 1))
        dy = yb - ya
        if dy <= 0:
            continue
        xa = x0 + (ya - y0) * dxdy
        xb = x0 + (yb - y0) * dxdy
        if xa > xb:
            xa, xb = xb, xa
        # Clip horizontally: everything left of 0 contributes full height at
        # column 0; right of w contributes nothing new past the last column.
        if xb <= 0.0:
            acc[iy, 0] += sign * dy
            continue
        if xa >= w:
            continue
        if xa < 0.0:
            # Portion left of x=0 contributes at column 0.
            frac = (0.0 - xa) / (xb - xa) if xb > xa else 1.0
            acc[iy, 0] += sign * dy * frac
            dy *= 1.0 - frac
            xa = 0.0
        if xb > w:
            frac = (xb - float(w)) / (xb - xa) if xb > xa else 0.0
            # Portion right of x=w never enters any visible cell.
            dy *= 1.0 - frac
            xb = float(w)
        if dy <= 0:
            continue
        ix0 = int(math.floor(xa))
        ix1 = int(math.floor(xb))
        if ix0 == ix1:
            # Entire crossing inside one cell: trapezoid area split between
            # this cell and the running total to its right.
            xm = (xa + xb) / 2 - ix0
            acc[iy, ix0] += sign * dy * (1.0 - xm)
            acc[iy, ix0 + 1] += sign * dy * xm
        else:
            inv_dx = 1.0 / (xb - xa)
            # First cell.
            xe = ix0 + 1.0
            dy_first = dy * (xe - xa) * inv_dx
            xm = (xa + xe) / 2 - ix0
            acc[iy, ix0] += sign * dy_first * (1.0 - xm)
            acc[iy, ix0 + 1] += sign * dy_first * xm
            # Middle cells: uniform crossing.
            dy_cell = dy * inv_dx  # per unit x
            for ix in range(ix0 + 1, ix1):
                acc[iy, ix] += sign * dy_cell * 0.5
                acc[iy, ix + 1] += sign * dy_cell * 0.5
            # Last cell.
            dy_last = dy * (xb - ix1) * inv_dx
            if dy_last > 0:
                xm = (ix1 + xb) / 2 - ix1
                acc[iy, ix1] += sign * dy_last * (1.0 - xm)
                acc[iy, ix1 + 1] += sign * dy_last * xm


def rasterize_segments(segments: np.ndarray, width: int, height: int) -> np.ndarray:
    """Rasterize device-space segments [N,4] into coverage [height, width]."""
    acc = np.zeros((height, width + 1), np.float64)
    for x0, y0, x1, y1 in np.asarray(segments, np.float64):
        accumulate(acc, x0, y0, x1, y1)
    cov = np.abs(np.cumsum(acc[:, :-1], axis=1))
    return np.minimum(cov, 1.0).astype(np.float32)


def rasterize_glyph(
    glyph: Glyph,
    scale: float,
    width: int,
    height: int,
    origin_x: float,
    baseline_y: float,
    tol: float = 0.1,
) -> np.ndarray:
    """Rasterize one glyph: pen origin at (origin_x, baseline_y), y-down device.

    ``scale`` = px_size / units_per_em. Returns coverage [height, width].
    """
    segs = flatten_glyph(glyph, scale, tol)
    if len(segs) == 0:
        return np.zeros((height, width), np.float32)
    dev = np.empty_like(segs)
    dev[:, 0] = segs[:, 0] + origin_x
    dev[:, 1] = baseline_y - segs[:, 1]
    dev[:, 2] = segs[:, 2] + origin_x
    dev[:, 3] = baseline_y - segs[:, 3]
    return rasterize_segments(dev, width, height)
