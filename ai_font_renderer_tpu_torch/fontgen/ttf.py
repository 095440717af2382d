"""Pure-Python TrueType font parser.

First-party replacement for the reference's node-canvas/Cairo dependency
(reference: generate_font.ts:1,104-109 registers a TTF and rasterizes through
Cairo). Here we parse the TTF tables ourselves (head, maxp, cmap, loca, glyf,
hhea, hmtx) and hand the quadratic-bezier outlines to our own rasterizer
(`raster.py` / the native C++ rasterizer) — no node/Bun/Cairo anywhere.

Only the tables needed for glyph rasterization and horizontal metrics are
parsed. Composite glyphs (arg1/arg2 offsets + 2x2 transforms) are supported.

The port's own copy of ai_font_renderer_tpu/fontgen/ttf.py, code unchanged,
so both packages build the same corpus and glyphs.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from functools import lru_cache


def _u16(b: bytes, o: int) -> int:
    return struct.unpack_from(">H", b, o)[0]


def _i16(b: bytes, o: int) -> int:
    return struct.unpack_from(">h", b, o)[0]


def _u32(b: bytes, o: int) -> int:
    return struct.unpack_from(">I", b, o)[0]


@dataclass
class Glyph:
    """A decoded glyph outline in font units.

    ``contours`` is a list of closed contours; each contour is a list of
    ``(x, y, on_curve)`` triples with quadratic-bezier semantics (TrueType):
    consecutive off-curve points imply an on-curve midpoint between them.
    """

    contours: list = field(default_factory=list)
    x_min: int = 0
    y_min: int = 0
    x_max: int = 0
    y_max: int = 0

    @property
    def is_empty(self) -> bool:
        return not self.contours


# Component flags for composite glyphs.
_ARG_1_AND_2_ARE_WORDS = 0x0001
_ARGS_ARE_XY_VALUES = 0x0002
_WE_HAVE_A_SCALE = 0x0008
_MORE_COMPONENTS = 0x0020
_WE_HAVE_AN_X_AND_Y_SCALE = 0x0040
_WE_HAVE_A_TWO_BY_TWO = 0x0080

# Simple-glyph point flags.
_ON_CURVE = 0x01
_X_SHORT = 0x02
_Y_SHORT = 0x04
_REPEAT = 0x08
_X_SAME_OR_POS = 0x10
_Y_SAME_OR_POS = 0x20


class TrueTypeFont:
    """Parses a .ttf file into glyph outlines + metrics.

    Usage::

        font = TrueTypeFont.load("assets/FiraCode-Retina.ttf")
        gid = font.glyph_id(ord("A"))
        glyph = font.glyph(gid)          # outline in font units
        adv = font.advance(gid)          # advance width in font units
        scale = 12.0 / font.units_per_em # px per font unit at 12px
    """

    def __init__(self, data: bytes):
        self.data = data
        self.tables: dict[str, tuple[int, int]] = {}
        self._parse_offset_table()
        self._parse_head()
        self._parse_maxp()
        self._parse_hhea()
        self._parse_hmtx()
        self._parse_loca()
        self._parse_cmap()

    @classmethod
    def load(cls, path: str) -> "TrueTypeFont":
        with open(path, "rb") as f:
            return cls(f.read())

    # ---------------------------------------------------------------- tables

    def _parse_offset_table(self) -> None:
        b = self.data
        sfnt = _u32(b, 0)
        if sfnt not in (0x00010000, 0x74727565):  # 'true' for mac fonts
            raise ValueError(f"not a TrueType font (sfnt=0x{sfnt:08x})")
        num_tables = _u16(b, 4)
        for i in range(num_tables):
            o = 12 + 16 * i
            tag = b[o : o + 4].decode("latin-1")
            offset = _u32(b, o + 8)
            length = _u32(b, o + 12)
            self.tables[tag] = (offset, length)

    def _table(self, tag: str) -> memoryview:
        offset, length = self.tables[tag]
        return memoryview(self.data)[offset : offset + length]

    def _parse_head(self) -> None:
        t = bytes(self._table("head"))
        self.units_per_em = _u16(t, 18)
        self.x_min = _i16(t, 36)
        self.y_min = _i16(t, 38)
        self.x_max = _i16(t, 40)
        self.y_max = _i16(t, 42)
        self.index_to_loc_format = _i16(t, 50)

    def _parse_maxp(self) -> None:
        t = bytes(self._table("maxp"))
        self.num_glyphs = _u16(t, 4)

    def _parse_hhea(self) -> None:
        t = bytes(self._table("hhea"))
        self.ascent = _i16(t, 4)
        self.descent = _i16(t, 6)
        self.line_gap = _i16(t, 8)
        self.num_h_metrics = _u16(t, 34)

    def _parse_hmtx(self) -> None:
        t = bytes(self._table("hmtx"))
        n = self.num_h_metrics
        self._advances = [_u16(t, 4 * i) for i in range(n)]
        self._lsbs = [_i16(t, 4 * i + 2) for i in range(n)]

    def _parse_loca(self) -> None:
        t = bytes(self._table("loca"))
        n = self.num_glyphs + 1
        if self.index_to_loc_format == 0:
            self._loca = [2 * _u16(t, 2 * i) for i in range(n)]
        else:
            self._loca = [_u32(t, 4 * i) for i in range(n)]

    def _parse_cmap(self) -> None:
        t = bytes(self._table("cmap"))
        num_subtables = _u16(t, 2)
        best = None  # prefer (3,10) > (3,1) > (0,*)
        for i in range(num_subtables):
            o = 4 + 8 * i
            platform = _u16(t, o)
            encoding = _u16(t, o + 2)
            offset = _u32(t, o + 4)
            rank = {(3, 10): 3, (3, 1): 2, (0, 4): 2, (0, 3): 1, (0, 6): 1}.get(
                (platform, encoding), 0
            )
            if best is None or rank > best[0]:
                best = (rank, offset)
        if best is None:
            raise ValueError("no usable cmap subtable")
        self._cmap = self._parse_cmap_subtable(t, best[1])

    def _parse_cmap_subtable(self, t: bytes, o: int) -> dict[int, int]:
        fmt = _u16(t, o)
        mapping: dict[int, int] = {}
        if fmt == 4:
            seg_count = _u16(t, o + 6) // 2
            ends = [_u16(t, o + 14 + 2 * i) for i in range(seg_count)]
            starts = [_u16(t, o + 16 + 2 * seg_count + 2 * i) for i in range(seg_count)]
            deltas = [_i16(t, o + 16 + 4 * seg_count + 2 * i) for i in range(seg_count)]
            range_offset_pos = o + 16 + 6 * seg_count
            for i in range(seg_count):
                ro = _u16(t, range_offset_pos + 2 * i)
                for c in range(starts[i], min(ends[i], 0xFFFF) + 1):
                    if ro == 0:
                        gid = (c + deltas[i]) & 0xFFFF
                    else:
                        gi = range_offset_pos + 2 * i + ro + 2 * (c - starts[i])
                        if gi + 1 >= len(t):
                            continue
                        gid = _u16(t, gi)
                        if gid != 0:
                            gid = (gid + deltas[i]) & 0xFFFF
                    if gid != 0:
                        mapping[c] = gid
        elif fmt == 12:
            n_groups = _u32(t, o + 12)
            for i in range(n_groups):
                go = o + 16 + 12 * i
                start, end, start_gid = (
                    _u32(t, go),
                    _u32(t, go + 4),
                    _u32(t, go + 8),
                )
                for c in range(start, end + 1):
                    mapping[c] = start_gid + (c - start)
        elif fmt == 6:
            first = _u16(t, o + 6)
            count = _u16(t, o + 8)
            for i in range(count):
                mapping[first + i] = _u16(t, o + 10 + 2 * i)
        elif fmt == 0:
            for c in range(256):
                gid = t[o + 6 + c]
                if gid:
                    mapping[c] = gid
        else:
            raise ValueError(f"unsupported cmap format {fmt}")
        return mapping

    # ---------------------------------------------------------------- public

    def glyph_id(self, codepoint: int) -> int:
        """Codepoint -> glyph index (0 = .notdef)."""
        return self._cmap.get(codepoint, 0)

    def advance(self, gid: int) -> int:
        """Advance width in font units (monospace fonts: constant)."""
        if gid < len(self._advances):
            return self._advances[gid]
        return self._advances[-1]

    @lru_cache(maxsize=4096)
    def glyph(self, gid: int, _depth: int = 0) -> Glyph:
        """Decode glyph ``gid`` into contours of (x, y, on_curve) triples."""
        if gid >= self.num_glyphs or _depth > 5:
            return Glyph()
        start, end = self._loca[gid], self._loca[gid + 1]
        if start == end:
            return Glyph()  # empty glyph (e.g. space)
        g = bytes(self._table("glyf"))[start:end]
        num_contours = _i16(g, 0)
        glyph = Glyph(
            x_min=_i16(g, 2), y_min=_i16(g, 4), x_max=_i16(g, 6), y_max=_i16(g, 8)
        )
        if num_contours >= 0:
            glyph.contours = self._parse_simple(g, num_contours)
        else:
            glyph.contours = self._parse_composite(g, _depth)
        return glyph

    def _parse_simple(self, g: bytes, num_contours: int) -> list:
        end_pts = [_u16(g, 10 + 2 * i) for i in range(num_contours)]
        num_points = end_pts[-1] + 1 if end_pts else 0
        instr_len = _u16(g, 10 + 2 * num_contours)
        o = 12 + 2 * num_contours + instr_len

        flags = []
        while len(flags) < num_points:
            f = g[o]
            o += 1
            flags.append(f)
            if f & _REPEAT:
                rep = g[o]
                o += 1
                flags.extend([f] * rep)
        flags = flags[:num_points]

        xs, x = [], 0
        for f in flags:
            if f & _X_SHORT:
                dx = g[o]
                o += 1
                x += dx if f & _X_SAME_OR_POS else -dx
            elif not f & _X_SAME_OR_POS:
                x += _i16(g, o)
                o += 2
            xs.append(x)
        ys, y = [], 0
        for f in flags:
            if f & _Y_SHORT:
                dy = g[o]
                o += 1
                y += dy if f & _Y_SAME_OR_POS else -dy
            elif not f & _Y_SAME_OR_POS:
                y += _i16(g, o)
                o += 2
            ys.append(y)

        contours, p0 = [], 0
        for ep in end_pts:
            contour = [
                (xs[i], ys[i], bool(flags[i] & _ON_CURVE)) for i in range(p0, ep + 1)
            ]
            contours.append(contour)
            p0 = ep + 1
        return contours

    def _parse_composite(self, g: bytes, depth: int) -> list:
        contours = []
        o = 10
        while True:
            flags = _u16(g, o)
            comp_gid = _u16(g, o + 2)
            o += 4
            if flags & _ARG_1_AND_2_ARE_WORDS:
                arg1, arg2 = _i16(g, o), _i16(g, o + 2)
                o += 4
            else:
                arg1 = struct.unpack_from(">b", g, o)[0]
                arg2 = struct.unpack_from(">b", g, o + 1)[0]
                o += 2
            a, b_, c, d = 1.0, 0.0, 0.0, 1.0
            if flags & _WE_HAVE_A_SCALE:
                a = d = _i16(g, o) / 16384.0
                o += 2
            elif flags & _WE_HAVE_AN_X_AND_Y_SCALE:
                a = _i16(g, o) / 16384.0
                d = _i16(g, o + 2) / 16384.0
                o += 4
            elif flags & _WE_HAVE_A_TWO_BY_TWO:
                a = _i16(g, o) / 16384.0
                b_ = _i16(g, o + 2) / 16384.0
                c = _i16(g, o + 4) / 16384.0
                d = _i16(g, o + 6) / 16384.0
                o += 8
            dx, dy = (arg1, arg2) if flags & _ARGS_ARE_XY_VALUES else (0, 0)
            component = self.glyph(comp_gid, depth + 1)
            for contour in component.contours:
                contours.append(
                    [
                        (a * x + c * y + dx, b_ * x + d * y + dy, on)
                        for (x, y, on) in contour
                    ]
                )
            if not flags & _MORE_COMPONENTS:
                break
        return contours
