"""Sheet synthesis: glyph atlas + layout grid -> pixel sheets, on the device.

The port of ai_font_renderer_tpu/fontgen/sheets.py. A sheet is built from
three tensors:

  * the baked atlas          [L, S, C, ch, cw]   (coverage cells, static)
  * a per-sample layout grid [B, L, S] int       (charset index per cell)
  * two static 0/1 placement operators mapping cell-local pixels to sheet
    pixels: colP [S, cw, W] and rowP [L, ch, H].

Synthesis is one gather and two f32 einsums:

    cells  = atlas[line, slot, grid]                    # gather
    strips = einsum('blsac,scx->blax', cells, colP)
    cov    = einsum('blax,lay->byx',  strips, rowP)
    sheet  = round(clip(1 - cov) * 255) / 255           # white bg, 8-bit

The einsums run in f32 with TF32 off (``device.resolve_device`` turns it
off), so the u8 sheets equal those of the numpy oracle
:func:`synthesize_sheets_host`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .atlas import GlyphAtlas


@dataclass(frozen=True)
class SynthOps:
    """Device-resident operands for sheet synthesis."""

    atlas: torch.Tensor  # [L, S, C, ch, cw] f32
    col_place: torch.Tensor  # [S, cw, W] f32
    row_place: torch.Tensor  # [L, ch, H] f32
    height: int
    width: int


def make_placement_operators(atlas: GlyphAtlas) -> tuple[np.ndarray, np.ndarray]:
    """Static 0/1 placement matrices (host-side, built once per atlas).

    colP[s, c, x] = 1 iff sheet column x == x0[s] + c (clipped at edges);
    rowP[l, a, y] = 1 iff sheet row    y == y0[l] + a.
    """
    W, H = atlas.spec.width, atlas.spec.height
    col = np.zeros((atlas.n_slots, atlas.cell_w, W), np.float32)
    for s in range(atlas.n_slots):
        for c in range(atlas.cell_w):
            x = atlas.x0[s] + c
            if 0 <= x < W:
                col[s, c, x] = 1.0
    row = np.zeros((atlas.n_lines, atlas.cell_h, H), np.float32)
    for l in range(atlas.n_lines):
        for a in range(atlas.cell_h):
            y = atlas.y0[l] + a
            if 0 <= y < H:
                row[l, a, y] = 1.0
    return col, row


def make_synth_ops(atlas: GlyphAtlas, device: torch.device) -> SynthOps:
    """Upload the atlas and the placement operators to ``device`` in f32."""
    col, row = make_placement_operators(atlas)
    return SynthOps(
        atlas=torch.from_numpy(np.ascontiguousarray(atlas.table, np.float32)).to(device),
        col_place=torch.from_numpy(col).to(device),
        row_place=torch.from_numpy(row).to(device),
        height=atlas.spec.height,
        width=atlas.spec.width,
    )


def synthesize_sheets(ops: SynthOps, grids: torch.Tensor, quantize: bool = True) -> torch.Tensor:
    """Render layout grids [B, L, S] (charset indices, 0 = blank) to f32
    sheets [B, H, W] on the operands' device: 1.0 is the white background,
    0.0 full ink. ``quantize`` snaps to the 8-bit grid of the BMP targets."""
    L, S = ops.atlas.shape[0], ops.atlas.shape[1]
    dev = ops.atlas.device
    line_ix = torch.arange(L, device=dev)[:, None].expand(L, S)
    slot_ix = torch.arange(S, device=dev)[None, :].expand(L, S)
    cells = ops.atlas[line_ix, slot_ix, grids.to(dev).long()]  # [B, L, S, ch, cw]
    strips = torch.einsum("blsac,scx->blax", cells, ops.col_place)
    cov = torch.einsum("blax,lay->byx", strips, ops.row_place)
    sheet = (1.0 - cov).clamp(0.0, 1.0)
    if quantize:
        sheet = torch.round(sheet * 255.0) / 255.0
    return sheet


def synthesize_sheets_host(atlas: GlyphAtlas, grids: np.ndarray) -> np.ndarray:
    """Float32 numpy reference implementation (the oracle of the tests)."""
    col, row = make_placement_operators(atlas)
    grids = np.asarray(grids)
    L, S = atlas.n_lines, atlas.n_slots
    line_ix = np.broadcast_to(np.arange(L)[:, None], (L, S))
    slot_ix = np.broadcast_to(np.arange(S)[None, :], (L, S))
    cells = atlas.table[line_ix, slot_ix, grids]
    strips = np.einsum("blsac,scx->blax", cells, col, optimize=True)
    cov = np.einsum("blax,lay->byx", strips, row, optimize=True)
    sheet = np.clip(1.0 - cov, 0.0, 1.0)
    return (np.round(sheet * 255.0) / 255.0).astype(np.float32)
