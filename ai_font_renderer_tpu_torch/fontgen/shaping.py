"""GSUB glyph substitution: the shaping half of HarfBuzz-parity layout.

node-canvas renders text through Pango/HarfBuzz (generate_font.ts:100-141),
which applies the font's default-on GSUB features before positioning.
FiraCode is ligature-heavy — and implements its programming ligatures
("->", "=>", "!=", "===", ...) NOT as `liga` type-4 ligature lookups but as
`calt` chained-context (type 6) rule cascades over spacer glyphs, so real
shaping needs the contextual machinery, not just ligature matching.

This module implements every GSUB substitution lookup type:

  * type 1 (single substitution, formats 1/2)
  * type 2 (multiple substitution, format 1)
  * type 3 (alternate substitution; first alternate, HarfBuzz's default
    when no alternate index is selected)
  * type 4 (ligature substitution, format 1)
  * type 5 (contextual substitution, formats 1/2/3 — lowered onto the
    chain matchers with empty backtrack/lookahead)
  * type 6 (chained contextual substitution, formats 1/2/3) with nested
    SubstLookupRecord application, HarfBuzz-style position tracking
  * type 7 (extension) indirection
  * type 8 (reverse chaining single substitution, back-to-front)

The bundled fonts exercise 1/2/4/6/7; types 3/5/8 are covered by
synthetic-table tests (test_shaping.py) for fonts that need them.

Feature selection mirrors HarfBuzz's defaults for a plain horizontal run:
ccmp/locl/rclt/rlig/calt/liga/clig of the default script's default LangSys
plus the required feature. Lookups apply in LookupList order over the whole
glyph buffer, each to completion before the next — the OpenType processing
model. LookupFlags are not interpreted (FiraCode and Montserrat use flag 0
everywhere; ASCII runs carry no marks to skip).

The charset-indexed monospace/proportional training paths are intentionally
unshaped: the A-Z+space corpus triggers no FiraCode rules (tested), and the
static-grid synthesis depends on char-indexed atlases. Shaping serves the
arbitrary-string surfaces (`afr render --truth`, fidelity evals).

The port's own copy of ai_font_renderer_tpu/fontgen/shaping.py, code unchanged,
so both packages shape the same glyph runs.
"""

from __future__ import annotations

import struct

from .kerning import _parse_class_def, _parse_coverage
from .ttf import TrueTypeFont

# HarfBuzz default-on GSUB features for horizontal text.
DEFAULT_FEATURES = (b"ccmp", b"locl", b"rclt", b"rlig", b"calt", b"liga", b"clig")

_MAX_NESTING = 8


def _u16(b, o):
    return struct.unpack_from(">H", b, o)[0]


def _cov_map(b: bytes, o: int) -> dict[int, int]:
    """Coverage table -> {gid: coverage_index}."""
    return {g: i for i, g in enumerate(_parse_coverage(b, o))}


class GsubShaper:
    """Applies a font's default-on GSUB substitutions to glyph-id runs."""

    def __init__(self, font: TrueTypeFont, features: tuple = DEFAULT_FEATURES):
        self.font = font
        self._lookups: dict[int, tuple[int, list]] = {}
        self.enabled: list[int] = []
        if "GSUB" not in font.tables:
            return
        g = bytes(font._table("GSUB"))
        try:
            self._g = g
            self._lookup_list_off = _u16(g, 8)
            enabled = self._resolve_features(g, features)
            count = _u16(g, self._lookup_list_off)
            self.enabled = sorted(i for i in enabled if i < count)
            for li in self.enabled:
                self._ensure_lookup(li)
        except (struct.error, IndexError):
            self.enabled = []

    # -- table parsing -------------------------------------------------

    def _resolve_features(self, g: bytes, features) -> set[int]:
        """Lookup indices of default-on features of the default LangSys
        (same resolution walk as kerning._kern_lookup_indices)."""
        script_list_off = _u16(g, 4)
        feature_list_off = _u16(g, 6)
        if not script_list_off or not feature_list_off:
            return set()
        n = _u16(g, script_list_off)
        if not n:
            return set()
        by_tag = {}
        for i in range(n):
            ro = script_list_off + 2 + 6 * i
            by_tag[g[ro : ro + 4]] = script_list_off + _u16(g, ro + 4)
        script = by_tag.get(b"DFLT") or by_tag.get(b"latn")
        if script is None:
            script = next(iter(by_tag.values()))
        default_ls = _u16(g, script)
        if default_ls:
            ls = script + default_ls
        else:
            if not _u16(g, script + 2):
                return set()
            ls = script + _u16(g, script + 4 + 4)
        required = _u16(g, ls + 2)
        fcount = _u16(g, ls + 4)
        findices = [_u16(g, ls + 6 + 2 * i) for i in range(fcount)]
        if required != 0xFFFF:
            findices.append(required)

        lookups: set[int] = set()
        total = _u16(g, feature_list_off)
        for fi in findices:
            if fi >= total:
                continue
            ro = feature_list_off + 2 + 6 * fi
            if g[ro : ro + 4] not in features and fi != required:
                continue
            fo = feature_list_off + _u16(g, ro + 4)
            for i in range(_u16(g, fo + 2)):
                lookups.add(_u16(g, fo + 4 + 2 * i))
        return lookups

    def _ensure_lookup(self, li: int):
        """Parse lookup ``li`` (and, transitively, nested lookups) into
        python-native matcher structures."""
        if li in self._lookups:
            return
        g = self._g
        lo = self._lookup_list_off + _u16(g, self._lookup_list_off + 2 + 2 * li)
        ltype = _u16(g, lo)
        sub_count = _u16(g, lo + 4)
        subtables = []
        self._lookups[li] = (ltype, subtables)  # placeholder breaks cycles
        nested: set[int] = set()
        for si in range(sub_count):
            so = lo + _u16(g, lo + 6 + 2 * si)
            t = ltype
            if t == 7:  # extension: {fmt, extensionLookupType, u32 offset}
                if _u16(g, so) != 1:
                    continue
                t = _u16(g, so + 2)
                so = so + struct.unpack_from(">I", g, so + 4)[0]
            parsed = self._parse_subtable(g, t, so, nested)
            if parsed is not None:
                subtables.append(parsed)
        if ltype == 7 and subtables:
            # all extension subtables share one effective type
            self._lookups[li] = (subtables[0][0], subtables)
        for nli in nested:
            self._ensure_lookup(nli)

    def _parse_subtable(self, g, t, so, nested):
        fmt = _u16(g, so)
        if t == 3 and fmt == 1:
            # AlternateSubst: coverage + AlternateSet per glyph. Shaping
            # without user alternate selection takes the FIRST alternate
            # (HarfBuzz's default for aalt/salt when no index is chosen).
            cov = _cov_map(g, so + _u16(g, so + 2))
            alts = {}
            for gid, ci in cov.items():
                ao = so + _u16(g, so + 6 + 2 * ci)
                cnt = _u16(g, ao)
                if cnt:
                    alts[gid] = [_u16(g, ao + 2 + 2 * k) for k in range(cnt)]
            return (3, alts)
        if t == 5:
            # ContextSubst = the chaining machinery with empty backtrack/
            # lookahead; reuse the chain matchers (tags 61/62/63) by
            # emitting rules with bt = la = ().
            if fmt == 1:
                cov = _cov_map(g, so + _u16(g, so + 2))
                set_n = _u16(g, so + 4)
                rule_sets = {}
                for gid, ci in cov.items():
                    if ci >= set_n:
                        continue
                    rso = so + _u16(g, so + 6 + 2 * ci)
                    rules = []
                    for k in range(_u16(g, rso)):
                        ro = rso + _u16(g, rso + 2 + 2 * k)
                        rules.append(self._parse_context_rule(g, ro, nested))
                    rule_sets[gid] = rules
                return (61, rule_sets)
            if fmt == 2:
                cov = set(_cov_map(g, so + _u16(g, so + 2)))
                cd = _parse_class_def(g, so + _u16(g, so + 4))
                set_n = _u16(g, so + 6)
                class_rules = {}
                for c in range(set_n):
                    off = _u16(g, so + 8 + 2 * c)
                    if not off:
                        continue
                    rso = so + off
                    rules = []
                    for k in range(_u16(g, rso)):
                        ro = rso + _u16(g, rso + 2 + 2 * k)
                        rules.append(self._parse_context_rule(g, ro, nested))
                    class_rules[c] = rules
                # One ClassDef serves the (empty) backtrack/lookahead too.
                return (62, (cov, cd, cd, cd, class_rules))
            if fmt == 3:
                n = _u16(g, so + 2)
                rec_n = _u16(g, so + 4)
                inp = [
                    _cov_map(g, so + _u16(g, so + 6 + 2 * i)) for i in range(n)
                ]
                o = so + 6 + 2 * n
                recs = [
                    (_u16(g, o + 4 * i), _u16(g, o + 2 + 4 * i))
                    for i in range(rec_n)
                ]
                for _, nli in recs:
                    nested.add(nli)
                return (63, ([], inp, [], recs))
        if t == 8 and fmt == 1:
            # ReverseChainSingleSubst: applied back-to-front over the run,
            # in-place single substitutions (length never changes).
            cov = _cov_map(g, so + _u16(g, so + 2))
            o = so + 4
            bt_n = _u16(g, o)
            bt = [_cov_map(g, so + _u16(g, o + 2 + 2 * i)) for i in range(bt_n)]
            o += 2 + 2 * bt_n
            la_n = _u16(g, o)
            la = [_cov_map(g, so + _u16(g, o + 2 + 2 * i)) for i in range(la_n)]
            o += 2 + 2 * la_n
            cnt = _u16(g, o)
            subs = [_u16(g, o + 2 + 2 * k) for k in range(cnt)]
            return (8, (cov, bt, la, subs))
        if t == 1:
            cov = _cov_map(g, so + _u16(g, so + 2))
            if fmt == 1:
                delta = struct.unpack_from(">h", g, so + 4)[0]
                return (1, {gid: (gid + delta) & 0xFFFF for gid in cov})
            if fmt == 2:
                subs = {}
                for gid, ci in cov.items():
                    subs[gid] = _u16(g, so + 6 + 2 * ci)
                return (1, subs)
        elif t == 2 and fmt == 1:
            cov = _cov_map(g, so + _u16(g, so + 2))
            seqs = {}
            for gid, ci in cov.items():
                qo = so + _u16(g, so + 6 + 2 * ci)
                cnt = _u16(g, qo)
                seqs[gid] = [_u16(g, qo + 2 + 2 * k) for k in range(cnt)]
            return (2, seqs)
        elif t == 4 and fmt == 1:
            cov = _cov_map(g, so + _u16(g, so + 2))
            ligs = {}
            for gid, ci in cov.items():
                lso = so + _u16(g, so + 6 + 2 * ci)
                rules = []
                for k in range(_u16(g, lso)):
                    lgo = lso + _u16(g, lso + 2 + 2 * k)
                    lig = _u16(g, lgo)
                    comp_count = _u16(g, lgo + 2)
                    comps = tuple(
                        _u16(g, lgo + 4 + 2 * j) for j in range(comp_count - 1)
                    )
                    rules.append((comps, lig))
                ligs[gid] = rules
            return (4, ligs)
        elif t == 6:
            if fmt == 3:
                o = so + 2
                bt_n = _u16(g, o)
                bt = [_cov_map(g, so + _u16(g, o + 2 + 2 * i)) for i in range(bt_n)]
                o += 2 + 2 * bt_n
                in_n = _u16(g, o)
                inp = [_cov_map(g, so + _u16(g, o + 2 + 2 * i)) for i in range(in_n)]
                o += 2 + 2 * in_n
                la_n = _u16(g, o)
                la = [_cov_map(g, so + _u16(g, o + 2 + 2 * i)) for i in range(la_n)]
                o += 2 + 2 * la_n
                rec_n = _u16(g, o)
                recs = [
                    (_u16(g, o + 2 + 4 * i), _u16(g, o + 4 + 4 * i))
                    for i in range(rec_n)
                ]
                for _, nli in recs:
                    nested.add(nli)
                return (63, (bt, inp, la, recs))
            if fmt == 1:
                cov = _cov_map(g, so + _u16(g, so + 2))
                rule_sets = {}
                set_n = _u16(g, so + 4)
                for gid, ci in cov.items():
                    if ci >= set_n:
                        continue
                    rso = so + _u16(g, so + 6 + 2 * ci)
                    rules = []
                    for k in range(_u16(g, rso)):
                        ro = rso + _u16(g, rso + 2 + 2 * k)
                        rules.append(self._parse_chain_rule(g, ro, recs_out=nested))
                    rule_sets[gid] = rules
                return (61, rule_sets)
            if fmt == 2:
                cov = set(_cov_map(g, so + _u16(g, so + 2)))
                bt_cd = _parse_class_def(g, so + _u16(g, so + 4))
                in_cd = _parse_class_def(g, so + _u16(g, so + 6))
                la_cd = _parse_class_def(g, so + _u16(g, so + 8))
                set_n = _u16(g, so + 10)
                class_rules = {}
                for c in range(set_n):
                    off = _u16(g, so + 12 + 2 * c)
                    if not off:
                        continue
                    rso = so + off
                    rules = []
                    for k in range(_u16(g, rso)):
                        ro = rso + _u16(g, rso + 2 + 2 * k)
                        rules.append(self._parse_chain_rule(g, ro, recs_out=nested))
                    class_rules[c] = rules
                return (62, (cov, bt_cd, in_cd, la_cd, class_rules))
        return None  # unsupported format: skipped

    @staticmethod
    def _parse_context_rule(g, ro, recs_out):
        """SubRule / SubClassRule (type 5 fmts 1-2): glyphCount and
        substCount precede the arrays (unlike chain rules). Emits the
        chain-rule tuple shape with empty backtrack/lookahead so the
        chain matchers apply unchanged."""
        in_n = _u16(g, ro)
        rec_n = _u16(g, ro + 2)
        inp = tuple(_u16(g, ro + 4 + 2 * i) for i in range(in_n - 1))
        o = ro + 4 + 2 * (in_n - 1)
        recs = [
            (_u16(g, o + 4 * i), _u16(g, o + 2 + 4 * i)) for i in range(rec_n)
        ]
        for _, nli in recs:
            recs_out.add(nli)
        return ((), inp, (), recs)

    @staticmethod
    def _parse_chain_rule(g, ro, recs_out):
        """ChainSubRule / ChainSubClassRule (identical layout; glyph ids vs
        class ids). Backtrack is stored nearest-first."""
        bt_n = _u16(g, ro)
        o = ro + 2
        bt = tuple(_u16(g, o + 2 * i) for i in range(bt_n))
        o += 2 * bt_n
        in_n = _u16(g, o)
        inp = tuple(_u16(g, o + 2 + 2 * i) for i in range(in_n - 1))
        o += 2 + 2 * (in_n - 1)
        la_n = _u16(g, o)
        la = tuple(_u16(g, o + 2 + 2 * i) for i in range(la_n))
        o += 2 + 2 * la_n
        rec_n = _u16(g, o)
        recs = [
            (_u16(g, o + 2 + 4 * i), _u16(g, o + 4 + 4 * i)) for i in range(rec_n)
        ]
        for _, nli in recs:
            recs_out.add(nli)
        return (bt, inp, la, recs)

    # -- application ---------------------------------------------------

    def shape(self, text: str) -> list[int]:
        """Character string -> substituted glyph-id run."""
        gids = [self.font.glyph_id(ord(c)) for c in text]
        return self.shape_gids(gids)

    def shape_gids(self, gids: list[int]) -> list[int]:
        out = list(gids)
        for li in self.enabled:
            out = self._apply_over(li, out)
        return out

    def _apply_over(self, li: int, gids: list[int]) -> list[int]:
        ltype, subtables = self._lookups.get(li, (0, ()))
        if any(t == 8 for t, _ in subtables):
            # ReverseChainSingleSubst applies back-to-front, in place.
            gids = list(gids)
            for i in range(len(gids) - 1, -1, -1):
                for t, data in subtables:
                    if t != 8:
                        continue
                    cov, bt, la, subs = data
                    ci = cov.get(gids[i])
                    if ci is None or ci >= len(subs):
                        continue
                    if i < len(bt) or i + 1 + len(la) > len(gids):
                        continue
                    if any(gids[i - 1 - k] not in bt[k] for k in range(len(bt))):
                        continue
                    if any(
                        gids[i + 1 + k] not in la[k] for k in range(len(la))
                    ):
                        continue
                    gids[i] = subs[ci]
                    break
            return gids
        i = 0
        while i < len(gids):
            res = self._apply_at(li, gids, i, 0)
            if res is None:
                i += 1
            else:
                gids, consumed, _ = res
                i += max(1, consumed)
        return gids

    def _apply_at(self, li, gids, i, depth):
        """Try lookup ``li`` at position ``i``.

        Returns (new_gids, consumed_len, length_delta) or None. ``consumed``
        is the post-substitution length of the matched region (the caller
        advances past it), mirroring HarfBuzz's skip-after-match behavior.
        """
        if depth > _MAX_NESTING or li not in self._lookups:
            return None
        ltype, subtables = self._lookups[li]
        for t, data in subtables:
            if t == 1:
                sub = data.get(gids[i])
                if sub is not None:
                    return gids[:i] + [sub] + gids[i + 1 :], 1, 0
            elif t == 3:
                alts = data.get(gids[i])
                if alts:
                    return gids[:i] + [alts[0]] + gids[i + 1 :], 1, 0
            elif t == 2:
                seq = data.get(gids[i])
                if seq:
                    return gids[:i] + seq + gids[i + 1 :], len(seq), len(seq) - 1
            elif t == 4:
                for comps, lig in data.get(gids[i], ()):
                    m = len(comps)
                    if gids[i + 1 : i + 1 + m] == list(comps):
                        return gids[:i] + [lig] + gids[i + 1 + m :], 1, -m
            elif t == 63:
                bt, inp, la, recs = data
                n = len(inp)
                if i + n > len(gids) or i < len(bt):
                    continue
                if any(gids[i + k] not in inp[k] for k in range(n)):
                    continue
                if any(gids[i - 1 - k] not in bt[k] for k in range(len(bt))):
                    continue
                if i + n + len(la) > len(gids) or any(
                    gids[i + n + k] not in la[k] for k in range(len(la))
                ):
                    continue
                return self._apply_records(gids, i, n, recs, depth)
            elif t == 61:
                for rule in data.get(gids[i], ()):
                    res = self._match_rule(
                        gids, i, rule, lambda gid, want: gid == want, depth
                    )
                    if res is not None:
                        return res
            elif t == 62:
                cov, bt_cd, in_cd, la_cd, class_rules = data
                if gids[i] not in cov:
                    continue
                c = in_cd.get(gids[i], 0)
                for rule in class_rules.get(c, ()):
                    res = self._match_rule_classed(
                        gids, i, rule, bt_cd, in_cd, la_cd, depth
                    )
                    if res is not None:
                        return res
        return None

    def _match_rule(self, gids, i, rule, eq, depth):
        bt, inp, la, recs = rule
        n = 1 + len(inp)
        if i < len(bt) or i + n + len(la) > len(gids):
            return None
        if any(not eq(gids[i + 1 + k], inp[k]) for k in range(len(inp))):
            return None
        if any(not eq(gids[i - 1 - k], bt[k]) for k in range(len(bt))):
            return None
        if any(not eq(gids[i + n + k], la[k]) for k in range(len(la))):
            return None
        return self._apply_records(gids, i, n, recs, depth)

    def _match_rule_classed(self, gids, i, rule, bt_cd, in_cd, la_cd, depth):
        bt, inp, la, recs = rule
        n = 1 + len(inp)
        if i < len(bt) or i + n + len(la) > len(gids):
            return None
        if any(in_cd.get(gids[i + 1 + k], 0) != inp[k] for k in range(len(inp))):
            return None
        if any(bt_cd.get(gids[i - 1 - k], 0) != bt[k] for k in range(len(bt))):
            return None
        if any(la_cd.get(gids[i + n + k], 0) != la[k] for k in range(len(la))):
            return None
        return self._apply_records(gids, i, n, recs, depth)

    def _apply_records(self, gids, i, n_input, recs, depth):
        """Apply nested SubstLookupRecords with HarfBuzz position tracking:
        sequence indices address the ORIGINAL input positions; earlier
        nested substitutions shift later positions by their length delta."""
        positions = list(range(i, i + n_input))
        total_delta = 0
        for seq_idx, nli in recs:
            if seq_idx >= len(positions):
                continue
            res = self._apply_at(nli, gids, positions[seq_idx], depth + 1)
            if res is None:
                continue
            gids, _, delta = res
            if delta:
                for j in range(seq_idx + 1, len(positions)):
                    positions[j] += delta
                total_delta += delta
        return gids, n_input + total_delta, total_delta
