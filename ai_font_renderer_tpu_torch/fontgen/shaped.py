"""Shaped ground-truth sheet rendering: GSUB + GPOS + rasterize, per string.

The HarfBuzz-parity sibling of ``dataset.synthesize_ground_truth``: where the
training paths compose char-indexed atlas cells on a static grid (fast, but
by construction unshaped), this renders arbitrary strings the way node-canvas
does behind the reference (generate_font.ts:100-141) — word-wrap, GSUB glyph
substitution (ligatures, fontgen/shaping.py), glyph advances plus GPOS pair
kerning, then direct rasterization of the positioned outlines into the sheet.

Host-side by design: this serves `afr render --truth`, fidelity evals, and
tests — not the training hot path (the A-Z+space corpus triggers no
substitutions, so the einsum synthesis path remains exact there).

The port's own copy of ai_font_renderer_tpu/fontgen/shaped.py, code unchanged,
so both packages draw the same shaped sheets.
"""

from __future__ import annotations

import numpy as np

from ..config import SheetSpec
from . import native
from .kerning import extract_pair_kerning
from .layout import AdvanceTable, wrap_text
from .raster import flatten_glyph
from .shaping import GsubShaper
from .ttf import TrueTypeFont


class ShapedRenderer:
    """Renders strings to sheets with full shaping for one font."""

    def __init__(
        self,
        font_path: str,
        spec: SheetSpec | None = None,
        shape: bool = True,
        kern: bool = True,
        hinted: bool = False,
    ):
        """``shape``/``kern`` exist for ablation studies (fidelity tests
        compare shaped vs unshaped renders against HarfBuzz output).
        ``hinted`` adds FreeType-style light grid fitting (fontgen/
        hinting.py): integer baselines + blue-zone snapping — for
        comparisons against hinted FreeType output only, never the
        dataset contract."""
        self.spec = spec or SheetSpec()
        self.font_path = font_path
        self.font = TrueTypeFont.load(font_path)
        self.shaper = GsubShaper(self.font)
        if not shape:
            self.shaper.enabled = []
        self.kern = kern
        self.scale = self.spec.font_size / self.font.units_per_em
        self.hinted = hinted
        if hinted:
            from .hinting import BlueZones

            self._zones = BlueZones.from_font(self.font, self.scale)
        self._flat_cache: dict[int, np.ndarray] = {}
        self._adv_cache: dict[str, AdvanceTable] = {}
        self._kern_cache: dict[frozenset, dict] = {}

    def _advances_for(self, text: str) -> AdvanceTable:
        """Char-level advance table over exactly the chars of ``text`` (the
        wrap measure; node-canvas measureText shapes, but substitution is
        advance-preserving for these fonts' default features)."""
        charset = "".join(sorted(set(text) | {" "}))
        if charset not in self._adv_cache:
            adv = np.array(
                [
                    self.font.advance(self.font.glyph_id(ord(c))) * self.scale
                    for c in charset
                ]
            )
            from .kerning import KerningTable

            kt = KerningTable(self.font_path, charset, self.spec.font_size)
            self._adv_cache[charset] = AdvanceTable(
                charset, adv, kt if len(kt) else None
            )
        return self._adv_cache[charset]

    def _kern_pairs(self, gids: set[int]) -> dict:
        key = frozenset(gids)
        if key not in self._kern_cache:
            self._kern_cache[key] = extract_pair_kerning(self.font, gids)
        return self._kern_cache[key]

    def _flat(self, gid: int) -> np.ndarray:
        if gid not in self._flat_cache:
            segs = flatten_glyph(self.font.glyph(gid), self.scale)
            if self.hinted and len(segs):
                from .hinting import hint_segments

                segs = hint_segments(segs, self._zones)
            self._flat_cache[gid] = segs
        return self._flat_cache[gid]

    def render(self, text: str) -> np.ndarray:
        """One string -> float32 [H, W] sheet, 1.0 = white background."""
        return self.render_batch([text])[0]

    def render_batch(self, strings: list[str]) -> np.ndarray:
        spec = self.spec
        seg_chunks: list[np.ndarray] = []
        offsets = [0]
        total = 0
        for text in strings:
            if len(text) > spec.max_chars:
                text = text[: spec.max_chars]
            adv = self._advances_for(text)
            lines = wrap_text(text, adv, spec.width - 2 * spec.padding)
            runs = [self.shaper.shape(line) for line in lines]
            all_gids = set(g for run in runs for g in run)
            kern = self._kern_pairs(all_gids) if (all_gids and self.kern) else {}
            for l, run in enumerate(runs):
                baseline = (l + 1) * spec.line_height
                if self.hinted:
                    # FreeType rounds the pen's baseline to a pixel row,
                    # half-down (measured in PIL: 13.50 -> row 13,
                    # 13.51 -> row 14).
                    baseline = float(np.ceil(baseline - 0.5))
                if baseline - spec.font_size > spec.height:
                    break  # whole line starts below the sheet
                pen = float(spec.padding)
                prev = None
                for gid in run:
                    if prev is not None:
                        pen += kern.get((prev, gid), 0) * self.scale
                    prev = gid
                    segs = self._flat(gid)
                    if len(segs):
                        d = np.empty_like(segs)
                        d[:, 0] = segs[:, 0] + pen
                        d[:, 2] = segs[:, 2] + pen
                        d[:, 1] = baseline - segs[:, 1]
                        d[:, 3] = baseline - segs[:, 3]
                        seg_chunks.append(d)
                        total += len(d)
                    pen += self.font.advance(gid) * self.scale
            offsets.append(total)
        segments = (
            np.concatenate(seg_chunks)
            if seg_chunks
            else np.zeros((0, 4), np.float32)
        )
        cov = native.rasterize_batch(
            segments, np.asarray(offsets, np.int64), spec.width, spec.height
        )
        sheets = np.clip(1.0 - cov, 0.0, 1.0)
        return np.round(sheets * 255.0) / 255.0


def render_shaped_sheets(
    font_path: str, strings: list[str], spec: SheetSpec | None = None
) -> np.ndarray:
    """Convenience: float32 [N, H, W] shaped ground-truth sheets."""
    return ShapedRenderer(font_path, spec).render_batch(strings)
