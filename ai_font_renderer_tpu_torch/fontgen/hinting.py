"""Light (vertical) hinting emulation: FreeType-style grid fitting.

The reference's ground truth comes from Cairo behind node-canvas
(generate_font.ts:100-141), which our analytic rasterizer matches: unhinted
outlines at exact fractional positions — that contract is golden-locked and
untouched here. FreeType's default rendering (the independent oracle in the
fidelity study, tools/fidelity_study.py) instead GRID-FITS vertically while
preserving horizontal geometry (measured: column ink profiles agree to ~2%
while row profiles shift by full pixels).

Calibrated against FreeType 2.14 renders of both bundled fonts at 12px
(per-glyph row-profile probes, see RESULTS.md):

  * the pen baseline rounds to a pixel row, half-down (13.50 -> 13,
    13.51 -> 14);
  * "blue zone" edges EXPAND to the enclosing grid line: cap/x-height/
    ascender tops ceil (FiraCode cap 8.48px -> 9, x-height 6.49 -> 7,
    ascender 9.24 -> 10), baseline/descender bottoms floor
    (descender -2.63 -> -3);
  * outline extremes within ~0.45px of a zone belong to it (an O's
    overshoot apex 8.63 lands on the cap's 9; a t's 8.09 top joins the cap
    zone), FreeType's blue-capture behavior;
  * internal horizontal stem edges (an H or E crossbar) round to the
    NEAREST grid line (H crossbar 3.95..4.95 -> 4..5, one crisp row);
  * everything between snapped edges interpolates piecewise-linearly
    (stem verticals stretch slightly; x is untouched).

Edge direction comes from the TrueType winding convention in the flattened
outline (y-up): a horizontal segment with dx > 0 has ink below (a top
edge); dx < 0 has ink above (a bottom edge).

Used by ``ShapedRenderer(hinted=True)`` for fidelity comparisons against
FreeType; never by the training pipeline.

The port's own copy of ai_font_renderer_tpu/fontgen/hinting.py, code unchanged,
so both packages grid-fit the same outlines.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .ttf import TrueTypeFont

# Outline y within this of a blue zone belongs to it (FreeType's
# blue-capture / overshoot-suppression range, px).
ZONE_RANGE_PX = 0.45
# A y-cluster of near-horizontal segments must carry at least this much
# total |dx| to count as a stem edge (filters bezier-apex slivers).
MIN_EDGE_WEIGHT = 0.5
# Segments with |dy| below this are horizontal edge candidates.
FLAT_DY = 0.08


def _outline_extreme(font: TrueTypeFont, ch: str, top: bool) -> float | None:
    """Max (top) or min (bottom) outline y of ``ch`` in font units."""
    gid = font.glyph_id(ord(ch))
    glyph = font.glyph(gid)
    ys = [y for contour in glyph.contours for (_, y, _) in contour]
    if not ys:
        return None
    return float(max(ys) if top else min(ys))


@dataclass(frozen=True)
class BlueZones:
    """Vertical control heights (px, y-up from baseline) -> snapped rows."""

    zones: tuple[tuple[float, float], ...]  # (height_px, snapped_px), sorted

    @classmethod
    def from_font(cls, font: TrueTypeFont, scale: float) -> "BlueZones":
        """Measure blues from reference glyphs (how FreeType's autofitter
        builds them): caps top (H), x-height (x), ascender (b), descender
        (p), baseline. Tops snap up, bottoms snap down (expansion)."""
        raw: list[tuple[float, bool]] = [(0.0, False)]  # baseline: bottom
        for ch, top in (("H", True), ("x", True), ("b", True), ("p", False)):
            v = _outline_extreme(font, ch, top)
            if v is not None:
                raw.append((v * scale, top))
        zs: list[tuple[float, float]] = []
        for z, top in sorted(raw):
            snapped = float(np.ceil(z) if top else np.floor(z))
            if not zs or abs(z - zs[-1][0]) > 0.75:
                zs.append((z, snapped))
        return cls(tuple(zs))

    def capture(self, y: float) -> float | None:
        """Snapped position if ``y`` lies in a zone's capture range."""
        for z, snapped in self.zones:
            if abs(y - z) <= ZONE_RANGE_PX:
                return snapped
        return None


def _edge_clusters(segs: np.ndarray) -> list[tuple[float, float]]:
    """Weighted y-clusters of horizontal stem edges -> [(y, weight)]."""
    flat = segs[np.abs(segs[:, 3] - segs[:, 1]) < FLAT_DY]
    if len(flat) == 0:
        return []
    ys = 0.5 * (flat[:, 1] + flat[:, 3])
    ws = np.abs(flat[:, 2] - flat[:, 0])
    order = np.argsort(ys)
    clusters: list[list[float]] = []  # [y_sum_weighted, weight]
    for y, w in zip(ys[order], ws[order]):
        if clusters and abs(y - clusters[-1][0] / clusters[-1][1]) < 0.3:
            clusters[-1][0] += y * w
            clusters[-1][1] += w
        else:
            clusters.append([y * w, w])
    return [(s / w, w) for s, w in clusters if w >= MIN_EDGE_WEIGHT]


def hint_segments(segs: np.ndarray, zones: BlueZones) -> np.ndarray:
    """Grid-fit flattened segments [N, 4] (px, y-up, baseline 0) in y."""
    if len(segs) == 0:
        return segs
    segs = np.asarray(segs, np.float64)
    ys = np.concatenate([segs[:, 1], segs[:, 3]])

    # Control points: stem-edge clusters plus the outline extremes (curved
    # apexes produce no flat cluster but still expand into their zone).
    points: dict[float, float] = {}
    for y, _ in _edge_clusters(segs):
        snapped = zones.capture(y)
        points[y] = snapped if snapped is not None else float(np.ceil(y - 0.5))
    for y, top in ((float(ys.max()), True), (float(ys.min()), False)):
        if not any(abs(y - cy) < 0.3 for cy in points):
            snapped = zones.capture(y)
            if snapped is None:
                snapped = float(np.ceil(y) if top else np.floor(y))
            points[y] = snapped

    if not points:
        return segs.astype(np.float32)
    cp = sorted(points.items())
    xp = np.array([c[0] for c in cp])
    fp = np.array([c[1] for c in cp])
    fp = np.maximum.accumulate(fp)  # monotonic guard for degenerate snaps

    def remap(y):
        out = np.interp(y, xp, fp)
        below = y < xp[0]
        out[below] = y[below] + (fp[0] - xp[0])
        above = y > xp[-1]
        out[above] = y[above] + (fp[-1] - xp[-1])
        return out

    out = segs.copy()
    out[:, 1] = remap(segs[:, 1])
    out[:, 3] = remap(segs[:, 3])
    return out.astype(np.float32)
