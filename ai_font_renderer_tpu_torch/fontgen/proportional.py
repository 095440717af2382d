"""Proportional-font layout and synthesis on the device (e.g. Montserrat).

The port of ai_font_renderer_tpu/fontgen/proportional.py. The monospace
path (atlas.py/sheets.py) uses a fixed column grid. For a proportional
font the pen position depends on the text; the static einsum structure is
kept by folding the shift into the atlas variant:

    pen cell left edge  =  G*k + r,   r in [0, G)

with coarse stride ``G = floor(min advance + most negative kern)``. The
integer residual ``r`` and the subpixel phase (``Q`` levels) are baked into
the variant (the cell grows by G), so every glyph lands on a static coarse
grid of stride G, at most one glyph a slot, and synthesis is a gather and
two einsums, as in the monospace path. The pen walk adds GPOS pair kerning
(fontgen/kerning.py) to the advances, as HarfBuzz does for a plain run.

The atlas bake, the layout, the placement operators and the numpy oracle
:func:`synthesize_prop_host` are copies of the JAX package's code.
:func:`synthesize_prop_sheets` is the device synthesis: a torch gather and
two f32 einsums with TF32 off (``device.resolve_device``), whose u8 sheets
equal the oracle's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import PRINTABLE_ASCII, SheetSpec
from ..device import resolve_device
from . import native
from .layout import wrap_text, AdvanceTable
from .raster import flatten_glyph
from .ttf import TrueTypeFont


@dataclass
class PropAtlas:
    """Variant-indexed glyph cells on a coarse placement grid."""

    table: np.ndarray  # f32 [V, cell_h, cell_w]; index 0 is blank
    charset: str
    spec: SheetSpec
    advances_px: np.ndarray  # [n_chars]
    inked: np.ndarray  # bool [n_chars] — has outline ink
    ink_index: np.ndarray  # int [n_chars] — dense index among inked chars
    kerning: object  # KerningTable or None
    n_lines: int
    n_slots: int  # coarse slots of stride G
    stride: int  # G
    q_subpixel: int  # Q
    cell_h: int
    cell_w: int  # includes +G residual headroom
    ascent_rows: int
    bearing_x: int
    y0: np.ndarray  # [n_lines] cell top row per line

    def advance_table(self) -> AdvanceTable:
        return AdvanceTable(self.charset, self.advances_px, self.kerning)

    def variant(self, char_idx: int, line: int, r: int, q: int) -> int:
        """Flat variant id for (charset index, line, residual, phase)."""
        if not self.inked[char_idx]:
            return 0
        ii = int(self.ink_index[char_idx])
        return 1 + ((ii * self.n_lines + line) * self.stride + r) * self.q_subpixel + q


def bake_prop_atlas(
    font_path: str,
    spec: SheetSpec | None = None,
    charset: str = PRINTABLE_ASCII,
    q_subpixel: int = 8,
    use_kerning: bool = True,
) -> PropAtlas:
    """Bake the proportional-font variant atlas (GPOS kerning included)."""
    from .kerning import KerningTable

    spec = spec or SheetSpec()
    kerning = (
        KerningTable(font_path, charset, spec.font_size) if use_kerning else None
    )
    font = TrueTypeFont.load(font_path)
    scale = spec.font_size / font.units_per_em
    gids = [font.glyph_id(ord(c)) for c in charset]
    advances_px = np.array([font.advance(g) * scale for g in gids])

    flat = [flatten_glyph(font.glyph(g), scale) for g in gids]
    inked = np.array([len(s) > 0 for s in flat])
    ink_index = np.cumsum(inked) - 1

    xs = np.concatenate(
        [np.concatenate([s[:, 0], s[:, 2]]) for s in flat if len(s)]
    )
    ys = np.concatenate(
        [np.concatenate([s[:, 1], s[:, 3]]) for s in flat if len(s)]
    )
    ascent_rows = int(np.ceil(ys.max()))
    descent_rows = int(np.ceil(max(-ys.min(), 0.0))) + 1
    bearing_x = int(np.ceil(max(-xs.min(), 0.0)))
    # Coarse stride must not exceed the smallest possible pen step so each
    # coarse slot holds at most one glyph — including kerned pairs, which
    # shrink the step.
    min_kern = min(kerning.pairs_px.values(), default=0.0) if kerning else 0.0
    G = max(1, int(np.floor(advances_px.min() + min(min_kern, 0.0))))
    cell_h = ascent_rows + descent_rows
    cell_w = bearing_x + int(np.ceil(xs.max())) + 1 + G

    lh = spec.line_height
    n_lines = 0
    while int(np.floor((n_lines + 1) * lh)) - ascent_rows < spec.height:
        n_lines += 1
    y_base = (np.arange(n_lines) + 1) * lh
    y0 = np.floor(y_base).astype(np.int32) - ascent_rows
    fy = y_base - np.floor(y_base)
    n_slots = (spec.width + bearing_x + G - 1) // G + 1

    n_ink = int(inked.sum())
    n_variants = 1 + n_ink * n_lines * G * q_subpixel

    # Batch every variant into one native rasterizer call. Variant
    # (ink glyph i, line l, residual r, phase q) draws the glyph with its
    # pen at cell-x = bearing_x + r + q/Q and baseline at ascent_rows + fy_l.
    base_dev, counts = [], []
    for s in flat:
        if len(s):
            d = np.empty_like(s)
            d[:, 0], d[:, 1] = s[:, 0], -s[:, 1]
            d[:, 2], d[:, 3] = s[:, 2], -s[:, 3]
            base_dev.append(d)
            counts.append(len(s))
    m_per = np.asarray(counts, np.int64)

    seg_chunks, item_offsets, total = [], [0], 0
    for i, d in enumerate(base_dev):
        for l in range(n_lines):
            for r in range(G):
                for q in range(q_subpixel):
                    ox = bearing_x + r + q / q_subpixel
                    oy = ascent_rows + fy[l]
                    moved = d.copy()
                    moved[:, 0] += ox
                    moved[:, 2] += ox
                    moved[:, 1] += oy
                    moved[:, 3] += oy
                    seg_chunks.append(moved)
                    total += len(moved)
                    item_offsets.append(total)
    segments = (
        np.concatenate(seg_chunks) if seg_chunks else np.zeros((0, 4), np.float32)
    )
    covs = native.rasterize_batch(
        segments, np.asarray(item_offsets, np.int64), cell_w, cell_h
    )
    table = np.zeros((n_variants, cell_h, cell_w), np.float32)
    table[1:] = covs
    return PropAtlas(
        table=table,
        charset=charset,
        spec=spec,
        advances_px=advances_px,
        inked=inked,
        ink_index=ink_index,
        kerning=kerning,
        n_lines=n_lines,
        n_slots=n_slots,
        stride=G,
        q_subpixel=q_subpixel,
        cell_h=cell_h,
        cell_w=cell_w,
        ascent_rows=ascent_rows,
        bearing_x=bearing_x,
        y0=y0,
    )


def layout_prop_grid(text: str, atlas: PropAtlas) -> np.ndarray:
    """One string -> variant-id grid [n_lines, n_slots] (0 = blank)."""
    spec = atlas.spec
    if len(text) > spec.max_chars:
        text = text[: spec.max_chars]
    adv = atlas.advance_table()
    grid = np.zeros((atlas.n_lines, atlas.n_slots), np.int32)
    lines = wrap_text(text, adv, spec.width - 2 * spec.padding)
    Q, G = atlas.q_subpixel, atlas.stride
    for l, line in enumerate(lines[: atlas.n_lines]):
        pen = float(spec.padding)
        prev = None
        prev_k = -1
        for ch in line:
            ci = adv.char_index(ch)
            if prev is not None:
                pen += adv.kern(prev, ch)  # GPOS pair adjustment
            prev = ch
            pen_int = int(np.floor(max(pen, 0.0)))  # pen >= 0 after clamping
            if pen_int - atlas.bearing_x >= spec.width:
                break  # rest of the line is clipped off the sheet
            if atlas.inked[ci]:
                q = int(np.floor((pen - pen_int) * Q + 0.5))
                anchor = pen_int
                if q == Q:  # phase rounded up to the next full pixel
                    anchor, q = pen_int + 1, 0
                k, r = divmod(anchor, G)
                if k <= prev_k:
                    # Slot already holds the previous glyph. Steps >= G
                    # make this unreachable in exact arithmetic (round-up
                    # of glyph i forces round-up of glyph i+1 whenever
                    # their anchors could share a slot), but accumulated
                    # fp error in `pen` can nudge glyph i+1 just under
                    # the round-up threshold. Shift to the next slot edge
                    # (< 1 px right, bounded by the same argument) rather
                    # than silently dropping glyph i.
                    k, r, q = prev_k + 1, 0, 0
                if k < atlas.n_slots:
                    grid[l, k] = atlas.variant(ci, l, r, q)
                    prev_k = k
            pen += atlas.advances_px[ci]
    return grid


def encode_prop_grids(strings: list[str], atlas: PropAtlas) -> np.ndarray:
    out = np.zeros((len(strings), atlas.n_lines, atlas.n_slots), np.int32)
    for i, s in enumerate(strings):
        out[i] = layout_prop_grid(s, atlas)
    return out


def make_prop_placements(atlas: PropAtlas) -> tuple[np.ndarray, np.ndarray]:
    """Static placement operators for the coarse grid."""
    W, H = atlas.spec.width, atlas.spec.height
    G = atlas.stride
    col = np.zeros((atlas.n_slots, atlas.cell_w, W), np.float32)
    for s in range(atlas.n_slots):
        left = s * G - atlas.bearing_x
        for c in range(atlas.cell_w):
            x = left + c
            if 0 <= x < W:
                col[s, c, x] = 1.0
    row = np.zeros((atlas.n_lines, atlas.cell_h, H), np.float32)
    for l in range(atlas.n_lines):
        for a in range(atlas.cell_h):
            y = atlas.y0[l] + a
            if 0 <= y < H:
                row[l, a, y] = 1.0
    return col, row


def prop_synth_operands(atlas: PropAtlas, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(table, col, row) in f32 on ``device``: the variant cells and the two
    placement operators, uploaded once for many chunks."""
    col, row = make_prop_placements(atlas)
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
        for a in (atlas.table, col, row)
    )


def _synth(table, col, row, grids, quantize: bool = True) -> torch.Tensor:
    """Variant grids [B, L, S] -> f32 sheets [B, H, W] on the operands'
    device: gather the cells, place them along x, then along y."""
    cells = table[grids.to(table.device, torch.long)]  # [B, L, S, ch, cw]
    strips = torch.einsum("blsac,scx->blax", cells, col)
    cov = torch.einsum("blax,lay->byx", strips, row)
    sheet = (1.0 - cov).clamp(0.0, 1.0)
    if quantize:
        sheet = torch.round(sheet * 255.0) / 255.0
    return sheet


def synthesize_prop_sheets(
    atlas: PropAtlas, grids, device: str | torch.device | None = None, quantize: bool = True
) -> torch.Tensor:
    """Variant grids (numpy or tensor [B, L, S]) -> f32 sheets [B, H, W] on
    ``device`` (the card unless ``"cpu"``), snapped to the 8-bit grid unless
    ``quantize`` is False."""
    table, col, row = prop_synth_operands(atlas, resolve_device(device))
    grids = grids if isinstance(grids, torch.Tensor) else torch.from_numpy(np.asarray(grids))
    return _synth(table, col, row, grids, quantize)


def synthesize_prop_host(atlas: PropAtlas, grids: np.ndarray) -> np.ndarray:
    """Numpy oracle."""
    col, row = make_prop_placements(atlas)
    cells = atlas.table[np.asarray(grids)]
    strips = np.einsum("blsac,scx->blax", cells, col, optimize=True)
    cov = np.einsum("blax,lay->byx", strips, row, optimize=True)
    return (np.round(np.clip(1.0 - cov, 0.0, 1.0) * 255.0) / 255.0).astype(
        np.float32
    )
