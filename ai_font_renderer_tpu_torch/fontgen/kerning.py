"""GPOS pair-kerning extraction (PairPos formats 1 and 2) + legacy 'kern'.

node-canvas shapes text through Pango/HarfBuzz, which applies GPOS pair
adjustments; advance-sum layout alone drifts from it on kerned proportional
fonts (Montserrat kerns pairs like AV, To, Ya). This module extracts the
horizontal x-advance adjustments into a plain {(left_gid, right_gid): units}
dict that the proportional layout adds while accumulating the pen.

Scope: GPOS lookup type 2 (PairPos), the only positioning that affects plain
horizontal advance runs of these fonts; lookups behind required features of
the default script are included. Mark/cursive positioning is out of scope
(irrelevant for printable-ASCII runs).

The port's own copy of ai_font_renderer_tpu/fontgen/kerning.py, code unchanged,
so both packages build the same corpus and glyphs.
"""

from __future__ import annotations

import struct

from .ttf import TrueTypeFont


def _u16(b, o):
    return struct.unpack_from(">H", b, o)[0]


def _i16(b, o):
    return struct.unpack_from(">h", b, o)[0]


def _parse_coverage(b: bytes, o: int) -> list[int]:
    fmt = _u16(b, o)
    glyphs = []
    if fmt == 1:
        count = _u16(b, o + 2)
        for i in range(count):
            glyphs.append(_u16(b, o + 4 + 2 * i))
    elif fmt == 2:
        count = _u16(b, o + 2)
        for i in range(count):
            start = _u16(b, o + 4 + 6 * i)
            end = _u16(b, o + 6 + 6 * i)
            for g in range(start, end + 1):
                glyphs.append(g)
    return glyphs


def _parse_class_def(b: bytes, o: int) -> dict[int, int]:
    fmt = _u16(b, o)
    classes: dict[int, int] = {}
    if fmt == 1:
        start = _u16(b, o + 2)
        count = _u16(b, o + 4)
        for i in range(count):
            c = _u16(b, o + 6 + 2 * i)
            if c:
                classes[start + i] = c
    elif fmt == 2:
        count = _u16(b, o + 2)
        for i in range(count):
            s = _u16(b, o + 4 + 6 * i)
            e = _u16(b, o + 6 + 6 * i)
            c = _u16(b, o + 8 + 6 * i)
            if c:
                for g in range(s, e + 1):
                    classes[g] = c
    return classes


def _value_record_size(fmt: int) -> int:
    return bin(fmt & 0xFF).count("1") * 2


def _x_advance(b: bytes, o: int, fmt: int) -> tuple[int, int]:
    """Read XAdvance from a ValueRecord at o; returns (value, size)."""
    size = 0
    x_adv = 0
    for bit in range(8):
        if fmt & (1 << bit):
            if bit == 2:  # XAdvance
                x_adv = _i16(b, o + size)
            size += 2
    return x_adv, size


def extract_pair_kerning(
    font: TrueTypeFont, gid_filter: set[int] | None = None
) -> dict[tuple[int, int], int]:
    """GPOS PairPos x-advance adjustments in font units.

    ``gid_filter`` restricts extraction to pairs whose glyphs are both in
    the set — class-based (format 2) tables expand to hundreds of thousands
    of pairs otherwise.
    """
    pairs: dict[tuple[int, int], int] = {}
    if "GPOS" in font.tables:
        g = bytes(font._table("GPOS"))
        try:
            _extract_gpos(g, pairs, gid_filter)
        except (struct.error, IndexError):
            pass  # malformed table: fall through with what we have
    if "kern" in font.tables:
        k = bytes(font._table("kern"))
        try:
            _extract_legacy_kern(k, pairs, gid_filter)
        except (struct.error, IndexError):
            pass
    return pairs


def _kern_lookup_indices(g: bytes) -> set[int] | None:
    """Lookup indices referenced by default-on kerning features.

    Resolves ScriptList -> default script (DFLT, else latn, else first) ->
    default LangSys -> features, keeping 'kern' features plus the LangSys's
    required feature — the set HarfBuzz applies for a plain horizontal run.
    PairPos subtables behind optional features (cpsp capital spacing,
    stylistic sets) are thereby excluded. Returns None when the script list
    is absent/unresolvable (caller then scans all lookups as a fallback).
    """
    script_list_off = _u16(g, 4)
    feature_list_off = _u16(g, 6)
    if not script_list_off or not feature_list_off:
        return None
    script_count = _u16(g, script_list_off)
    if not script_count:
        return None
    chosen = None
    by_tag = {}
    for i in range(script_count):
        ro = script_list_off + 2 + 6 * i
        tag = g[ro : ro + 4]
        by_tag[tag] = script_list_off + _u16(g, ro + 4)
    for tag in (b"DFLT", b"latn"):
        if tag in by_tag:
            chosen = by_tag[tag]
            break
    if chosen is None:
        chosen = next(iter(by_tag.values()))
    # Script table: default LangSys, else the first LangSysRecord.
    default_ls = _u16(g, chosen)
    if default_ls:
        ls = chosen + default_ls
    else:
        if not _u16(g, chosen + 2):
            return set()  # script with no LangSys: nothing applies
        ls = chosen + _u16(g, chosen + 4 + 4)
    required = _u16(g, ls + 2)
    feat_count = _u16(g, ls + 4)
    feature_indices = [_u16(g, ls + 6 + 2 * i) for i in range(feat_count)]
    if required != 0xFFFF:
        feature_indices.append(required)

    lookups: set[int] = set()
    total_features = _u16(g, feature_list_off)
    for fi in feature_indices:
        if fi >= total_features:
            continue
        ro = feature_list_off + 2 + 6 * fi
        tag = g[ro : ro + 4]
        if tag != b"kern" and fi != required:
            continue
        fo = feature_list_off + _u16(g, ro + 4)
        n = _u16(g, fo + 2)
        for i in range(n):
            lookups.add(_u16(g, fo + 4 + 2 * i))
    return lookups


def _extract_gpos(g: bytes, pairs: dict, gid_filter=None) -> None:
    lookup_list_off = _u16(g, 8)
    lookup_count = _u16(g, lookup_list_off)
    try:
        kern_lookups = _kern_lookup_indices(g)
    except (struct.error, IndexError):
        kern_lookups = None
    for li in range(lookup_count):
        if kern_lookups is not None and li not in kern_lookups:
            continue
        lo = lookup_list_off + _u16(g, lookup_list_off + 2 + 2 * li)
        lookup_type = _u16(g, lo)
        subtable_count = _u16(g, lo + 4)
        for si in range(subtable_count):
            so = lo + _u16(g, lo + 6 + 2 * si)
            if lookup_type == 9:  # extension positioning
                if _u16(g, so) != 1:
                    continue
                ext_type = _u16(g, so + 2)
                if ext_type != 2:
                    continue
                so = so + struct.unpack_from(">I", g, so + 4)[0]
            elif lookup_type != 2:
                continue
            _parse_pairpos(g, so, pairs, gid_filter)


def _parse_pairpos(g: bytes, so: int, pairs: dict, gid_filter=None) -> None:
    fmt = _u16(g, so)
    coverage = _parse_coverage(g, so + _u16(g, so + 2))
    vf1 = _u16(g, so + 4)
    vf2 = _u16(g, so + 6)
    sz1 = _value_record_size(vf1)
    sz2 = _value_record_size(vf2)
    if fmt == 1:
        set_count = _u16(g, so + 8)
        for i in range(min(set_count, len(coverage))):
            if gid_filter is not None and coverage[i] not in gid_filter:
                continue
            ps_off = so + _u16(g, so + 10 + 2 * i)
            pv_count = _u16(g, ps_off)
            rec_size = 2 + sz1 + sz2
            for j in range(pv_count):
                ro = ps_off + 2 + j * rec_size
                second = _u16(g, ro)
                if gid_filter is not None and second not in gid_filter:
                    continue
                x_adv, _ = _x_advance(g, ro + 2, vf1)
                if x_adv:
                    pairs.setdefault((coverage[i], second), x_adv)
    elif fmt == 2:
        cd1 = _parse_class_def(g, so + _u16(g, so + 8))
        cd2 = _parse_class_def(g, so + _u16(g, so + 10))
        c1_count = _u16(g, so + 12)
        c2_count = _u16(g, so + 14)
        rec_size = sz1 + sz2
        # Class 0 holds "everything else"; build reverse maps incl. only
        # glyphs in coverage (class1) / any glyph (class2).
        by_class1: dict[int, list[int]] = {}
        for gid in coverage:
            if gid_filter is not None and gid not in gid_filter:
                continue
            by_class1.setdefault(cd1.get(gid, 0), []).append(gid)
        by_class2: dict[int, list[int]] = {}
        for gid, c in cd2.items():
            if gid_filter is not None and gid not in gid_filter:
                continue
            by_class2.setdefault(c, []).append(gid)
        for c1 in range(c1_count):
            lefts = by_class1.get(c1)
            if not lefts:
                continue
            for c2 in range(c2_count):
                ro = so + 16 + (c1 * c2_count + c2) * rec_size
                x_adv, _ = _x_advance(g, ro, vf1)
                if not x_adv:
                    continue
                rights = by_class2.get(c2)
                if c2 == 0 or not rights:
                    continue  # class-0 pairs: skip (catch-all, usually 0)
                for l in lefts:
                    for r in rights:
                        pairs.setdefault((l, r), x_adv)


def _extract_legacy_kern(k: bytes, pairs: dict, gid_filter=None) -> None:
    n_tables = _u16(k, 2)
    o = 4
    for _ in range(n_tables):
        length = _u16(k, o + 2)
        coverage = _u16(k, o + 4)
        if coverage & 0xFF00 == 0 and coverage & 0x1:  # horizontal, format 0
            n_pairs = _u16(k, o + 6)
            for i in range(n_pairs):
                po = o + 14 + 6 * i
                left = _u16(k, po)
                right = _u16(k, po + 2)
                if gid_filter is not None and (
                    left not in gid_filter or right not in gid_filter
                ):
                    continue
                val = _i16(k, po + 4)
                if val:
                    pairs.setdefault((left, right), val)
        o += length


class KerningTable:
    """Charset-indexed kerning in pixels for the layout engine."""

    def __init__(self, font_path: str, charset: str, font_size: float):
        font = TrueTypeFont.load(font_path)
        scale = font_size / font.units_per_em
        gid = {c: font.glyph_id(ord(c)) for c in charset}
        raw = extract_pair_kerning(font, set(gid.values()))
        self.pairs_px: dict[tuple[str, str], float] = {}
        for a in charset:
            for b in charset:
                v = raw.get((gid[a], gid[b]))
                if v:
                    self.pairs_px[(a, b)] = v * scale

    def get(self, left: str, right: str) -> float:
        return self.pairs_px.get((left, right), 0.0)

    def __len__(self) -> int:
        return len(self.pairs_px)
