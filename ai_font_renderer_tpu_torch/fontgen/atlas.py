"""Glyph atlas baking: TTF -> phase-variant coverage tensors.

The port's own copy of ai_font_renderer_tpu/fontgen/atlas.py. Each charset
glyph is rasterized once per (line, slot) subpixel phase -- the fractional
parts of the pen position ``slot * advance`` and the baseline
``(line+1) * line_height`` -- into a small atlas tensor; whole sheets are
then synthesized on the device from it by two static einsums
(``sheets.py``). For FiraCode at 12 px the advance is 96/13 px and the
line height 72/5 px, so the phase set is finite and the cells are exact
for every grid position.

Bakes are cached under ``.cache/torch_atlas/`` at the repository root, a
directory of the port's own: it never reads an atlas the JAX package
cached.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass

import numpy as np

from ..config import PRINTABLE_ASCII, SheetSpec
from . import native
from .layout import AdvanceTable
from .raster import flatten_glyph
from .ttf import TrueTypeFont

_CACHE_VERSION = 2


@dataclass
class GlyphAtlas:
    """Baked per-(line, slot, char) coverage cells plus placement geometry."""

    table: np.ndarray  # float32 [n_lines, n_slots, n_chars, cell_h, cell_w]
    charset: str
    spec: SheetSpec
    advance_px: float
    advances_px: np.ndarray  # [n_chars] per-char advances (== advance_px here)
    cell_h: int
    cell_w: int
    ascent_rows: int  # baseline sits at row ascent_rows + frac(baseline_y)
    bearing_x: int  # pen sits at col bearing_x + frac(pen_x)
    x0: np.ndarray  # int32 [n_slots] device column of each cell's left edge
    y0: np.ndarray  # int32 [n_lines] device row of each cell's top edge

    @property
    def n_lines(self) -> int:
        return self.table.shape[0]

    @property
    def n_slots(self) -> int:
        return self.table.shape[1]

    @property
    def n_chars(self) -> int:
        return self.table.shape[2]

    def advance_table(self) -> AdvanceTable:
        return AdvanceTable(self.charset, self.advances_px)


def _font_hash(font_path: str) -> str:
    with open(font_path, "rb") as f:
        return hashlib.sha1(f.read()).hexdigest()[:12]


def _cache_key(font_path: str, spec: SheetSpec, charset: str) -> str:
    payload = json.dumps(
        {
            "v": _CACHE_VERSION,
            "font": _font_hash(font_path),
            "spec": [
                spec.width,
                spec.height,
                spec.font_size,
                spec.line_height_factor,
                spec.padding,
            ],
            "charset": charset,
        },
        sort_keys=True,
    )
    return hashlib.sha1(payload.encode()).hexdigest()[:16]


def bake_atlas(
    font_path: str,
    spec: SheetSpec | None = None,
    charset: str = PRINTABLE_ASCII,
    cache_dir: str | None = None,
) -> GlyphAtlas:
    """Bake the phase-variant glyph atlas for a monospace font.

    Results are cached on disk keyed by (font bytes, sheet spec, charset);
    a warm bake is a single npz load.
    """
    spec = spec or SheetSpec()
    if cache_dir is None:
        cache_dir = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(__file__))),
            ".cache",
            "torch_atlas",
        )
    key = _cache_key(font_path, spec, charset)
    cache_path = os.path.join(cache_dir, f"{key}.npz")
    if os.path.exists(cache_path):
        z = np.load(cache_path, allow_pickle=False)
        return GlyphAtlas(
            table=z["table"],
            charset=str(z["charset"]),
            spec=spec,
            advance_px=float(z["advance_px"]),
            advances_px=z["advances_px"],
            cell_h=int(z["cell_h"]),
            cell_w=int(z["cell_w"]),
            ascent_rows=int(z["ascent_rows"]),
            bearing_x=int(z["bearing_x"]),
            x0=z["x0"],
            y0=z["y0"],
        )

    font = TrueTypeFont.load(font_path)
    scale = spec.font_size / font.units_per_em
    gids = [font.glyph_id(ord(c)) for c in charset]
    advances_px = np.array([font.advance(g) * scale for g in gids])
    if not np.allclose(advances_px, advances_px[0]):
        raise ValueError(
            "bake_atlas requires a monospace font (fixed-grid synthesis); "
            f"got advances {sorted(set(np.round(advances_px, 3)))} px. "
            "Use fontgen.proportional for variable-width fonts."
        )
    adv = float(advances_px[0])

    # Flatten every glyph once (pen at origin, y-up pixel units) and record
    # per-glyph bounds to derive the shared cell geometry.
    flat: list[np.ndarray] = []
    xmin = ymin = np.inf
    xmax = ymax = -np.inf
    for gid in gids:
        segs = flatten_glyph(font.glyph(gid), scale)
        flat.append(segs)
        if len(segs):
            xs = np.concatenate([segs[:, 0], segs[:, 2]])
            ys = np.concatenate([segs[:, 1], segs[:, 3]])
            xmin, xmax = min(xmin, xs.min()), max(xmax, xs.max())
            ymin, ymax = min(ymin, ys.min()), max(ymax, ys.max())
    if not np.isfinite(xmin):  # charset with no ink at all
        xmin = ymin = 0.0
        xmax = ymax = 1.0
    if len(flat[0]) and float(np.abs(flat[0]).sum()) > 0:
        raise ValueError("charset[0] must be an ink-free glyph (blank cell)")

    ascent_rows = int(np.ceil(ymax))
    descent_rows = int(np.ceil(max(-ymin, 0.0))) + 1
    cell_h = ascent_rows + descent_rows
    bearing_x = int(np.ceil(max(-xmin, 0.0)))
    cell_w = bearing_x + int(np.ceil(xmax)) + 1

    # Grid geometry: slot j pen at padding + j*adv, line l baseline at
    # (l+1)*line_height (generate_font.ts:125-130). Keep every cell that can
    # intersect the sheet.
    lh = spec.line_height
    n_slots = 0
    while int(np.floor(spec.padding + n_slots * adv)) - bearing_x < spec.width:
        n_slots += 1
    n_lines = 0
    while int(np.floor((n_lines + 1) * lh)) - ascent_rows < spec.height:
        n_lines += 1

    x_pen = spec.padding + np.arange(n_slots) * adv
    y_base = (np.arange(n_lines) + 1) * lh
    x0 = np.floor(x_pen).astype(np.int32) - bearing_x
    y0 = np.floor(y_base).astype(np.int32) - ascent_rows
    fx = x_pen - np.floor(x_pen)
    fy = y_base - np.floor(y_base)

    # Batch all (line, slot, char) variants into one native rasterizer call.
    # Each variant is the glyph's flattened segments translated to its cell-
    # local pen position; the y-axis flips from font-space (up) to device
    # space (down).
    base = []
    base_counts = []
    for segs in flat:
        if len(segs):
            dev = np.empty_like(segs)
            dev[:, 0] = segs[:, 0]
            dev[:, 1] = -segs[:, 1]
            dev[:, 2] = segs[:, 2]
            dev[:, 3] = -segs[:, 3]
        else:
            dev = segs
        base.append(dev)
        base_counts.append(len(segs))
    base_all = (
        np.concatenate([s for s in base if len(s)], axis=0)
        if any(base_counts)
        else np.zeros((0, 4), np.float32)
    )
    counts = np.asarray(base_counts, np.int64)
    m = int(counts.sum())

    n_variants = n_lines * n_slots
    segments = np.tile(base_all, (n_variants, 1))
    shift = np.empty((n_variants, 2), np.float32)
    for l in range(n_lines):
        for j in range(n_slots):
            shift[l * n_slots + j] = (bearing_x + fx[j], ascent_rows + fy[l])
    shift_rep = np.repeat(shift, m, axis=0)
    segments[:, 0] += shift_rep[:, 0]
    segments[:, 1] += shift_rep[:, 1]
    segments[:, 2] += shift_rep[:, 0]
    segments[:, 3] += shift_rep[:, 1]

    per_variant_offsets = np.concatenate([[0], np.cumsum(counts)])
    item_offsets = np.concatenate(
        [per_variant_offsets[:-1] + v * m for v in range(n_variants)]
        + [[n_variants * m]]
    ).astype(np.int64)

    covs = native.rasterize_batch(segments, item_offsets, cell_w, cell_h)
    table = covs.reshape(n_lines, n_slots, len(charset), cell_h, cell_w)

    os.makedirs(cache_dir, exist_ok=True)
    # Written aside and renamed, so a concurrent reader never sees half a file.
    tmp_path = f"{cache_path}.{os.getpid()}.tmp.npz"
    np.savez_compressed(
        tmp_path,
        table=table,
        charset=charset,
        advance_px=adv,
        advances_px=advances_px,
        cell_h=cell_h,
        cell_w=cell_w,
        ascent_rows=ascent_rows,
        bearing_x=bearing_x,
        x0=x0,
        y0=y0,
    )
    os.replace(tmp_path, cache_path)
    return GlyphAtlas(
        table=table,
        charset=charset,
        spec=spec,
        advance_px=adv,
        advances_px=advances_px,
        cell_h=cell_h,
        cell_w=cell_w,
        ascent_rows=ascent_rows,
        bearing_x=bearing_x,
        x0=x0,
        y0=y0,
    )
