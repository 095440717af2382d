"""The port's shaping, hinting and shaped ground truth against the JAX
package's, on the CPU.

``fontgen/shaping.py``, ``hinting.py`` and ``shaped.py`` are copies, so
every output must be equal: the parsed GSUB lookups and the glyph runs for
FiraCode's calt ligatures, Montserrat's fi/fl and the test strings; the
blue zones and the grid-fitted outlines; the shaped sheets bit for bit, for
both fonts, hinted and not.
"""

import struct

import numpy as np
import pytest

from ai_font_renderer_tpu.config import FIRACODE_PATH, MONTSERRAT_PATH
from ai_font_renderer_tpu.fontgen import hinting as jhint
from ai_font_renderer_tpu.fontgen import raster as jraster
from ai_font_renderer_tpu.fontgen import shaped as jshaped
from ai_font_renderer_tpu.fontgen import shaping as jshaping
from ai_font_renderer_tpu.fontgen.ttf import TrueTypeFont as JaxFont
from ai_font_renderer_tpu_torch.cli import TEST_STRINGS
from ai_font_renderer_tpu_torch.fontgen import hinting as thint
from ai_font_renderer_tpu_torch.fontgen import raster as traster
from ai_font_renderer_tpu_torch.fontgen import shaped as tshaped
from ai_font_renderer_tpu_torch.fontgen import shaping as tshaping
from ai_font_renderer_tpu_torch.fontgen.textgen import generate_corpus
from ai_font_renderer_tpu_torch.fontgen.ttf import TrueTypeFont
from test_torch_native_build import install_reference_native

install_reference_native()

FONTS = {"firacode": FIRACODE_PATH, "montserrat": MONTSERRAT_PATH}
LIGATURES = ["->", "=>", "!=", "===", "<=>", "::", "www", "<!-- x -->", "a -> b != c", "|| && ++"]
WORDS = ["fi", "fl", "office", "fluffy", "waffle", "FIFTY", "difficult flow"]
STRINGS = LIGATURES + WORDS + TEST_STRINGS + ["", " ", "Hello, World!"]


@pytest.fixture(scope="module", params=list(FONTS))
def shapers(request):
    path = FONTS[request.param]
    return tshaping.GsubShaper(TrueTypeFont.load(path)), jshaping.GsubShaper(JaxFont.load(path))


def test_gsub_lookups_equal_jax(shapers):
    got, want = shapers
    assert got.enabled == want.enabled and len(got.enabled) > 0
    assert got._lookups == want._lookups


def test_shaped_runs_equal_jax(shapers):
    """Glyph runs for the ligature sequences, words with fi/fl, the test
    strings and 50 corpus strings; at least one of them substitutes."""
    got, want = shapers
    changed = 0
    for s in STRINGS + generate_corpus(50):
        run = got.shape(s)
        assert run == want.shape(s), s
        changed += run != [got.font.glyph_id(ord(c)) for c in s]
    assert changed > 0


def _cov(gids):
    return struct.pack(f">HH{len(gids)}H", 1, len(gids), *gids)


def _alternate_blob():
    alt0, alt1 = struct.pack(">HHH", 2, 100, 101), struct.pack(">HH", 1, 200)
    off_cov = 10 + len(alt0) + len(alt1)
    return struct.pack(">HHHHH", 1, off_cov, 2, 10, 10 + len(alt0)) + alt0 + alt1 + _cov([10, 20])


def _reverse_chain_blob():
    cov_bt = _cov([9])
    return struct.pack(">HHHHHHHH", 1, 16 + len(cov_bt), 1, 16, 0, 2, 50, 60) + cov_bt + _cov([5, 6])


def _context_blob():
    cov_a, cov_b = _cov([1]), _cov([2])
    off_a = 6 + 2 * 2 + 4
    return struct.pack(">HHHHHHH", 3, 2, 1, off_a, off_a + len(cov_a), 0, 991) + cov_a + cov_b


@pytest.mark.parametrize(
    "kind,blob,runs",
    [
        (3, _alternate_blob(), [[10, 20, 30]]),
        (5, _context_blob(), [[1, 2, 3], [1, 3, 2]]),
        (8, _reverse_chain_blob(), [[9, 5, 6], [5, 6], [9, 5, 9, 6]]),
    ],
    ids=["type3_alternate", "type5_context", "type8_reverse_chain"],
)
def test_lookup_types_unused_by_the_fonts_equal_jax(kind, blob, runs):
    """The hand-built subtables of tests/test_shaping.py (types 3, 5 and 8,
    which neither bundled font uses), parsed and applied by both copies."""
    got = tshaping.GsubShaper(TrueTypeFont.load(FIRACODE_PATH))
    want = jshaping.GsubShaper(JaxFont.load(FIRACODE_PATH))
    results = []
    for sh in (got, want):
        sh._lookups[991] = (1, [(1, {1: 99})])
        nested = set()
        parsed = sh._parse_subtable(blob, kind, 0, nested)
        sh._lookups[990] = (kind, [parsed])
        results.append((parsed, nested, [sh._apply_over(990, list(r)) for r in runs]))
    assert results[0] == results[1]


@pytest.mark.parametrize("name", list(FONTS))
def test_blue_zones_and_hinted_outlines_equal_jax(name):
    tfont, jfont = TrueTypeFont.load(FONTS[name]), JaxFont.load(FONTS[name])
    scale = 12.0 / tfont.units_per_em
    tz, jz = thint.BlueZones.from_font(tfont, scale), jhint.BlueZones.from_font(jfont, scale)
    assert tz.zones == jz.zones and len(tz.zones) >= 3
    for y in (-3.1, -0.2, 0.3, 6.4, 8.7, 9.3, 4.0):
        assert tz.capture(y) == jz.capture(y)
    for ch in "HEOxbpgt@W":
        segs = traster.flatten_glyph(tfont.glyph(tfont.glyph_id(ord(ch))), scale)
        np.testing.assert_array_equal(segs, jraster.flatten_glyph(jfont.glyph(jfont.glyph_id(ord(ch))), scale))
        np.testing.assert_array_equal(thint.hint_segments(segs, tz), jhint.hint_segments(segs, jz))


@pytest.mark.parametrize("hinted", [False, True], ids=["unhinted", "hinted"])
@pytest.mark.parametrize("name", list(FONTS))
def test_shaped_renderer_sheets_equal_jax(name, hinted):
    """The --truth sheets, bit for bit: the test strings, ligatures and
    fi/fl words."""
    got = tshaped.ShapedRenderer(FONTS[name], hinted=hinted).render_batch(STRINGS)
    want = jshaped.ShapedRenderer(FONTS[name], hinted=hinted).render_batch(STRINGS)
    assert got.shape == (len(STRINGS), 80, 240)
    np.testing.assert_array_equal(got, want)
    assert (got < 0.5).any(axis=(1, 2)).sum() >= len(STRINGS) - 3  # all but the blank strings carry ink


def test_render_shaped_sheets_equal_jax():
    np.testing.assert_array_equal(
        tshaped.render_shaped_sheets(MONTSERRAT_PATH, WORDS),
        jshaped.render_shaped_sheets(MONTSERRAT_PATH, WORDS),
    )
