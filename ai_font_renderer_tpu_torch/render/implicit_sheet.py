"""SIREN glyph bank -> text sheets at any scale, with the layout engine's
positions or the learned placement net's.

The port of ai_font_renderer_tpu/render/implicit_sheet.py. A string is laid
out on the host (``place_glyphs``: the engine's word wrap and kerned pen
walk) or by the placement transformer (``render_learned_sheets``: no layout
engine in the loop); each placed glyph then evaluates the glyph MLP over a
fixed [win, win] window of sheet pixels, and the windows' coverage is added
onto white sheets: clip(1 - sum cov, 0, 1).

Three ways to get each window's coverage: exact evaluation per window
(:func:`compose`), a bilinear gather from a once-baked supersampled bank
(:func:`compose_baked`), or a whole-block fetch from a bank baked at P x P
subpixel phases (:func:`compose_phased`). Two ways to add the windows up:
the scatter-add (:func:`_composite`) or one-hot placement products
(:func:`_composite_matmul`).

Everything after the host layout runs on the device that holds the bank's
parameters. The JAX package computes all of it in XLA, outside any Pallas
kernel, so it is plain PyTorch here too.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..config import PRINTABLE_ASCII, ModelConfig, SheetSpec
from ..fontgen.layout import AdvanceTable, encode_codes, wrap_text
from ..fontgen.ttf import TrueTypeFont
from ..models import placement, siren

# Most window points one SIREN evaluation of :func:`compose` holds: each
# hidden activation is [points, hidden] f32, 2 GiB at 2^22 points and 128
# hidden. 256 sheets of 100 windows of 13 x 13 are 4.3M points.
COMPOSE_POINTS = 1 << 22


@dataclass(frozen=True)
class ImplicitLayout:
    """Static geometry binding a SIREN glyph bank to sheet composition."""

    cell: int  # SIREN training cell resolution
    fill: float  # em fraction of the cell (rasterize_charset default 0.85)
    scale: float  # output sheet scale (1.0 = reference 80x240)
    height: int  # output sheet pixels
    width: int
    win: int  # per-glyph eval window, sheet px
    r: float  # sheet px per cell px
    cell_baseline: float  # baseline row inside the cell, cell px
    cell_x_center: float  # cell column of the advance midpoint, cell px
    max_glyphs: int


def build_layout(
    font: TrueTypeFont,
    spec: SheetSpec = SheetSpec(),
    cell: int = 64,
    fill: float = 0.85,
    scale: float = 1.0,
    max_glyphs: int = 100,
) -> ImplicitLayout:
    span = max(font.ascent - font.descent, 1)
    k_cell = fill * cell / span  # cell px per font unit
    k_sheet = spec.font_size * scale / font.units_per_em  # sheet px per unit
    r = k_sheet / k_cell
    top_margin = 0.5 * (cell - fill * cell)
    return ImplicitLayout(
        cell=cell,
        fill=fill,
        scale=scale,
        height=int(round(spec.height * scale)),
        width=int(round(spec.width * scale)),
        win=int(np.ceil(cell * r)) + 1,
        r=r,
        cell_baseline=top_margin + font.ascent * k_cell,
        cell_x_center=0.5 * cell,
        max_glyphs=max_glyphs,
    )


def font_kerning(font_path: str, charset: str, spec: SheetSpec = SheetSpec()):
    """The font's GPOS/kern pair table for ``charset``, or None if it has no
    pairs (FiraCode), so callers can pass the result unconditionally."""
    from ..fontgen.kerning import KerningTable

    k = KerningTable(font_path, charset, spec.font_size)
    return k if len(k) else None


def place_glyphs(
    strings: list[str],
    font: TrueTypeFont,
    lay: ImplicitLayout,
    spec: SheetSpec = SheetSpec(),
    charset: str = PRINTABLE_ASCII,
    kerning=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side layout -> (char_ids [N, G] int32, window origins [N, G, 2]
    (x, y) f32 in output sheet px, valid [N, G] bool). The layout happens
    at base scale, so the wrap is the same at every output scale; positions
    then multiply by the scale. ``kerning`` (a KerningTable) enters the
    wrap's measure and the pen walk. An unknown char advances like a space
    and places no glyph."""
    idx = {c: i for i, c in enumerate(charset)}
    adv_base = np.array(
        [font.advance(font.glyph_id(ord(c))) * spec.font_size / font.units_per_em for c in charset]
    )
    table = AdvanceTable(charset, adv_base, kerning)
    G = lay.max_glyphs
    n = len(strings)
    ids = np.zeros((n, G), np.int32)
    origins = np.zeros((n, G, 2), np.float32)
    valid = np.zeros((n, G), bool)
    wrap_width = spec.width - 2 * spec.padding
    for si, s in enumerate(strings):
        g = 0
        for li, line in enumerate(wrap_text(s[: spec.max_chars], table, wrap_width)):
            baseline = (li + 1) * spec.line_height * lay.scale
            pen = spec.padding
            prev = None
            for ch in line:
                ci = idx.get(ch)
                if prev is not None:
                    pen += table.kern(prev, ch)
                prev = ch
                if ci is not None and ch != " " and g < G:
                    # The window's top-left puts the cell's advance midpoint
                    # on the pen's midpoint and its baseline on the line's.
                    mid = (pen + 0.5 * adv_base[ci]) * lay.scale
                    ids[si, g] = ci
                    origins[si, g, 0] = mid - lay.cell_x_center * lay.r
                    origins[si, g, 1] = baseline - lay.cell_baseline * lay.r
                    valid[si, g] = True
                    g += 1
                pen += adv_base[0 if ci is None else ci]
    return ids, origins, valid


def origins_from_midpoints(mids, lay: ImplicitLayout):
    """(advance-midpoint x, baseline y) at base scale [..., 2] -> window
    origins at the output scale: the inverse of place_glyphs' geometry.
    Takes and returns numpy arrays or tensors."""
    mx = mids[..., 0] * lay.scale - lay.cell_x_center * lay.r
    my = mids[..., 1] * lay.scale - lay.cell_baseline * lay.r
    if isinstance(mids, torch.Tensor):
        return torch.stack([mx, my], dim=-1)
    return np.stack([mx, my], axis=-1).astype(np.float32)


def _window_geometry(origins: torch.Tensor, lay: ImplicitLayout):
    """(px, py, u, v): the absolute pixel centres of each glyph's window
    [N, G, win, win] and their cell-local coordinates in [-1, 1] (the
    SIREN's input frame)."""
    win, r, cell = lay.win, lay.r, lay.cell
    x0 = torch.floor(origins[..., 0]).to(torch.int32)  # [N, G]
    y0 = torch.floor(origins[..., 1]).to(torch.int32)
    ar = torch.arange(win, dtype=torch.int32, device=origins.device)
    jj, ii = torch.meshgrid(ar, ar, indexing="xy")
    px = x0[..., None, None] + jj + 0.5  # integer + 0.5: exact in f32
    py = y0[..., None, None] + ii + 0.5
    xc = (px - origins[..., 0, None, None]) / r
    yc = (py - origins[..., 1, None, None]) / r
    return px, py, xc / cell * 2.0 - 1.0, yc / cell * 2.0 - 1.0


def _composite(cov, px, py, u, v, valid, lay: ImplicitLayout) -> torch.Tensor:
    """Add each window's coverage onto white sheets -> [N, H, W].

    A pixel outside the glyph cell, off the sheet or of an invalid slot adds
    0. The windows are added one slot at a time, in slot order, as the JAX
    package's scatter-add on the CPU adds them: within one slot no two
    window pixels of a sheet land on the same sheet pixel (the clipped
    off-sheet ones add exact zeros), so float atomics on the card add in
    one fixed order and two renders give the same bits. ``px - 0.5`` is an
    integer-valued float, so its truncation is exact."""
    N, G = cov.shape[:2]
    H, W = lay.height, lay.width
    inside = (u.abs() <= 1.0) & (v.abs() <= 1.0)
    xi = (px - 0.5).to(torch.int64)
    yi = (py - 0.5).to(torch.int64)
    onscreen = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    mask = inside & onscreen & valid[..., None, None]
    flat = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(N, G, -1)
    vals = torch.where(mask, cov, 0.0).reshape(N, G, -1)
    ink = torch.zeros((N, H * W), dtype=torch.float32, device=cov.device)
    for g in range(G):
        ink.scatter_add_(1, flat[:, g], vals[:, g])
    return (1.0 - ink.reshape(N, H, W)).clamp(0.0, 1.0)


def compose_chunk_size(glyphs: int, lay: ImplicitLayout) -> int:
    """Most sheets of ``glyphs`` slots one SIREN evaluation of
    :func:`compose` takes: as many as hold at most COMPOSE_POINTS window
    points (one at least)."""
    return max(1, COMPOSE_POINTS // (glyphs * lay.win * lay.win))


def compose_all(params, char_ids, origins, valid, cfg: siren.SirenConfig, lay: ImplicitLayout) -> torch.Tensor:
    """:func:`compose` of the whole batch in one SIREN evaluation, whatever
    its size (an exported program's body, which runs on a batch it does not
    know; its callers feed it at most :func:`compose_chunk_size` sheets)."""
    n, G = char_ids.shape
    win = lay.win
    px, py, u, v = _window_geometry(origins, lay)
    coords = torch.stack([u, v], dim=-1).reshape(n * G, win * win, 2)
    cov = siren.apply(params, char_ids.reshape(n * G), coords, cfg)
    return _composite(cov.reshape(n, G, win, win), px, py, u, v, valid, lay)


def compose(params, char_ids, origins, valid, cfg: siren.SirenConfig, lay: ImplicitLayout) -> torch.Tensor:
    """Evaluate the bank at every pixel of every slot's window and add the
    windows up: char_ids [N, G], origins [N, G, 2] f32, valid [N, G] bool ->
    sheets [N, H, W] f32 in [0, 1] (1 = white). Every slot is evaluated,
    valid or not. Sheets go through the bank in chunks of at most
    COMPOSE_POINTS window points; each sheet's result does not depend on
    the chunk it lands in."""
    N = char_ids.shape[0]
    per_chunk = compose_chunk_size(char_ids.shape[1], lay)
    out = [
        compose_all(params, char_ids[n0 : n0 + per_chunk], origins[n0 : n0 + per_chunk],
                    valid[n0 : n0 + per_chunk], cfg, lay)
        for n0 in range(0, N, per_chunk)
    ]
    if not out:
        return torch.ones((0, lay.height, lay.width), device=origins.device)
    return torch.cat(out)


def bake_bank(params, cfg: siren.SirenConfig, supersample: int = 4) -> torch.Tensor:
    """The bank evaluated once on a ``supersample``-times finer glyph grid:
    [n_chars, cell*ss, cell*ss] f32 coverage, in chunks of 16 glyphs."""
    cfg_ss = dataclasses.replace(cfg, cell=cfg.cell * supersample)
    return siren.render_atlas_chunked(params, cfg_ss, chunk=16)


def _composite_matmul(cov, x0, y0, valid, lay: ImplicitLayout) -> torch.Tensor:
    """Place every window by one-hot products: R[n,g,h,i] marks the window
    row i at sheet row h, C[n,g,j,w] the column j at sheet column w; then

        sheet[n] = sum_g R[n,g] @ cov[n,g] @ C[n,g]

    with the sum over slots inside the second product. ``cov`` must be zero
    outside the glyph cell (bake_bank_phased bakes that in); invalid slots
    are zeroed here. The JAX package multiplies bf16 one-hots by bf16
    coverage with f32 results and rounds the first product to bf16; here
    the operands are the same bf16 values held in f32 and the products are
    f32 (TF32 off). A product of a bf16 value and 0 or 1 is exact, and each
    sum of the first product has one nonzero term, so only the order of the
    second product's sums over slots differs."""
    N, G, win, _ = cov.shape
    H, W = lay.height, lay.width
    dev = cov.device
    i = torch.arange(win, device=dev)
    R = (torch.arange(H, device=dev)[None, None, :, None] == (y0[..., None, None] + i)).float()
    C = (torch.arange(W, device=dev)[None, None, None, :] == (x0[..., None, None] + i[:, None])).float()
    covm = torch.where(valid[..., None, None], cov, 0.0).to(torch.bfloat16).float()
    A = (R @ covm).to(torch.bfloat16).float()  # [N, G, H, win]
    ink = A.permute(0, 2, 1, 3).reshape(N, H, G * win) @ C.reshape(N, G * win, W)
    return (1.0 - ink).clamp(0.0, 1.0)


def bake_bank_phased(params, cfg: siren.SirenConfig, lay: ImplicitLayout, phases: int = 8) -> torch.Tensor:
    """Every glyph at every subpixel phase of the composite window:
    [n_chars, P, P, win, win], phase (pi, pj) holding the window of a glyph
    whose origin's fraction is (pj/P, pi/P). A window pixel's cell-local
    coordinate depends only on the origin's fractional part, so this table
    is every window :func:`compose` could evaluate, up to 1/P px. Zero
    outside the glyph cell."""
    win, r, cell = lay.win, lay.r, lay.cell
    C, P = cfg.n_chars, phases
    dev = params["embed"].device
    f = torch.arange(P, dtype=torch.float32, device=dev) / P  # origin fractions
    j = torch.arange(win, dtype=torch.float32, device=dev) + 0.5
    u = ((j[None, :] - f[:, None]) / r) / cell * 2.0 - 1.0  # [P, win]
    uu = u[None, :, None, :].expand(P, P, win, win)  # [pi, pj, i, j]
    vv = u[:, None, :, None].expand(P, P, win, win)
    coords = torch.stack([uu, vv], dim=-1).reshape(1, P * P * win * win, 2).expand(C, -1, -1)
    vals = siren.apply(params, torch.arange(C, device=dev), coords, cfg)
    inside = (uu.abs() <= 1.0) & (vv.abs() <= 1.0)
    return vals.reshape(C, P, P, win, win) * inside[None].to(vals.dtype)


def compose_phased(
    baked,
    char_ids,
    origins,
    valid,
    cfg: siren.SirenConfig,
    lay: ImplicitLayout,
    phases: int = 8,
    onehot: bool = False,
    composite: str = "scatter",
) -> torch.Tensor:
    """Composite from a phase-binned bake: each origin rounds to the 1/P px
    grid (``torch.round``: half to even, as ``jnp.round``) and its whole
    [win, win] block is fetched by index (``onehot``: by a one-hot product
    with the table rounded to bf16, as the JAX package's; otherwise an
    exact gather of the f32 table). ``composite`` is "scatter"
    (:func:`_composite`) or "matmul" (:func:`_composite_matmul`)."""
    N, G = char_ids.shape
    win, P = lay.win, phases
    C = baked.shape[0]
    oq = torch.round(origins * P) / P
    o0 = torch.floor(oq)
    bins = torch.round((oq - o0) * P).to(torch.int64) % P  # [N, G, 2]
    idx = (char_ids.long() * P + bins[..., 1]) * P + bins[..., 0]  # [N, G]
    flatb = baked.reshape(C * P * P, win * win)
    if onehot:
        oh = F.one_hot(idx.reshape(-1), C * P * P).float()
        cov = oh @ flatb.to(torch.bfloat16).float()
    else:
        cov = flatb.index_select(0, idx.reshape(-1))
    cov = cov.reshape(N, G, win, win)
    if composite == "matmul":
        return _composite_matmul(cov, o0[..., 0].long(), o0[..., 1].long(), valid, lay)
    px, py, u, v = _window_geometry(oq, lay)
    return _composite(cov, px, py, u, v, valid, lay)


def compose_baked(
    baked,
    char_ids,
    origins,
    valid,
    cfg: siren.SirenConfig,
    lay: ImplicitLayout,
    supersample: int = 4,
) -> torch.Tensor:
    """Composite by a 4-tap bilinear gather from a bank baked once at
    ``supersample``x (:func:`bake_bank`), at each window pixel's exact
    subpixel phase; the windows and the composite are :func:`compose`'s."""
    cs = baked.shape[-1]
    px, py, u, v = _window_geometry(origins, lay)
    # Baked pixel i holds the field at ((i + 0.5) / cs) * 2 - 1 (grid_coords).
    fx = (u + 1.0) * 0.5 * cs - 0.5
    fy = (v + 1.0) * 0.5 * cs - 0.5
    x0 = torch.floor(fx).long().clamp(0, cs - 2)
    y0 = torch.floor(fy).long().clamp(0, cs - 2)
    wx = (fx - x0).clamp(0.0, 1.0)
    wy = (fy - y0).clamp(0.0, 1.0)
    c = char_ids.long()[..., None, None]
    v00 = baked[c, y0, x0]
    v01 = baked[c, y0, x0 + 1]
    v10 = baked[c, y0 + 1, x0]
    v11 = baked[c, y0 + 1, x0 + 1]
    cov = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx + v10 * wy * (1 - wx) + v11 * wy * wx
    return _composite(cov, px, py, u, v, valid, lay)


def _finish(bank_params, ids, origins, valid, cfg, lay, baked: int, phased: int) -> torch.Tensor:
    """The composite of the render entry points: phased (matmul composite),
    baked, or exact."""
    if phased:
        bank = bake_bank_phased(bank_params, cfg, lay, phases=phased)
        return compose_phased(bank, ids, origins, valid, cfg, lay, phased, composite="matmul")
    if baked:
        bank = bake_bank(bank_params, cfg, supersample=baked)
        return compose_baked(bank, ids, origins, valid, cfg, lay, baked)
    return compose(bank_params, ids, origins, valid, cfg, lay)


def known_slots(strings: list[str], charset: str, G: int) -> tuple[np.ndarray, np.ndarray]:
    """Per original slot: (charset index [N, G] int32, known [N, G] bool),
    known where the char is in the charset and is not a space."""
    idx = {c: i for i, c in enumerate(charset)}
    ids = np.zeros((len(strings), G), np.int32)
    known = np.zeros((len(strings), G), bool)
    for si, s in enumerate(strings):
        for ci, ch in enumerate(s[:G]):
            k = idx.get(ch)
            if k is not None and ch != " ":
                ids[si, ci] = k
                known[si, ci] = True
    return ids, known


@torch.inference_mode()
def render_learned_sheets(
    siren_params,
    placement_params,
    strings: list[str],
    font_path: str,
    cfg: siren.SirenConfig,
    pcfg: ModelConfig | None = None,
    spec: SheetSpec = SheetSpec(),
    scale: float = 1.0,
    charset: str = PRINTABLE_ASCII,
    hard: bool = False,
    monotone: bool = False,
    baked: int = 0,
    phased: int = 0,
) -> torch.Tensor:
    """Fully neural strings -> sheets [N, H*scale, W*scale] on the bank's
    device: the placement transformer predicts every slot's midpoint and
    visibility from the raw char codes (``hard``/``monotone``: its
    discrete decodes), and the bank paints the glyphs there. The font file
    gives only the cell geometry, never the layout. A slot places its
    glyph where its char is known, not a space, and sigmoid(logit) > 0.5.
    Both parameter dicts must be on one device."""
    if pcfg is None:
        pcfg = ModelConfig()
    dev = siren_params["embed"].device
    font = TrueTypeFont.load(font_path)
    lay = build_layout(font, spec, cfg.cell, scale=scale, max_glyphs=pcfg.max_length)
    codes = torch.from_numpy(encode_codes(strings, pcfg.max_length)).to(dev)
    mids, logits = placement.apply(placement_params, codes, pcfg, hard=hard, monotone=monotone, spec=spec)
    origins = origins_from_midpoints(mids, lay)
    ids, known = known_slots(strings, charset, pcfg.max_length)
    valid = torch.from_numpy(known).to(dev) & (torch.sigmoid(logits) > 0.5)
    return _finish(siren_params, torch.from_numpy(ids).to(dev), origins, valid, cfg, lay, baked, phased)


@torch.inference_mode()
def render_implicit_sheets(
    params,
    strings: list[str],
    font_path: str,
    cfg: siren.SirenConfig,
    spec: SheetSpec = SheetSpec(),
    scale: float = 1.0,
    charset: str = PRINTABLE_ASCII,
    kerned: bool = True,
    baked: int = 0,
    phased: int = 0,
) -> torch.Tensor:
    """Strings -> sheets [N, H*scale, W*scale] on the bank's device, at the
    layout engine's positions: kerned where the font has pairs (Montserrat)
    unless ``kerned=False``. ``baked=SS``: :func:`compose_baked` over a
    bank baked at SSx; ``phased=P``: :func:`compose_phased` with the matmul
    composite; else exact :func:`compose`."""
    dev = params["embed"].device
    font = TrueTypeFont.load(font_path)
    lay = build_layout(font, spec, cfg.cell, scale=scale)
    kern = font_kerning(font_path, charset, spec) if kerned else None
    ids, origins, valid = place_glyphs(strings, font, lay, spec, charset, kern)
    t = [torch.from_numpy(a).to(dev) for a in (ids, origins, valid)]
    return _finish(params, *t, cfg, lay, baked, phased)
