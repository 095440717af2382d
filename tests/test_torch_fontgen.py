"""The port's data pipeline against the JAX package's, on the CPU.

Corpus, atlas, layouts and 8-bit sheets must be bit-exact: they define the
training data. The sheets are synthesized by the port's torch einsums on
the CPU (f32, TF32 irrelevant here) and compared byte for byte with the
numpy oracle.
"""

import hashlib

import numpy as np
import pytest
import torch

from ai_font_renderer_tpu import fontgen as jfg
from ai_font_renderer_tpu.config import FIRACODE_PATH, MONTSERRAT_PATH
from ai_font_renderer_tpu.config import SheetSpec as JaxSheetSpec
from ai_font_renderer_tpu.fontgen import dataset as jds
from ai_font_renderer_tpu.train import loop as jloop
from ai_font_renderer_tpu_torch import fontgen as tfg
from ai_font_renderer_tpu_torch.config import FIRACODE_PATH as T_FIRACODE
from ai_font_renderer_tpu_torch.config import PRINTABLE_ASCII, SheetSpec
from ai_font_renderer_tpu_torch.fontgen import dataset as tds
from ai_font_renderer_tpu_torch.fontgen import native, raster, sheets
from ai_font_renderer_tpu_torch.train import loop as tloop

# tests/test_golden.py's locks on the dataset definition.
CORPUS16_SHEETS_SHA = "1a02fab08632dda345b8a928ae742ef97862fc53ba8ef9d4867de66b5f50349d"
CORPUS16_STRINGS_SHA = "15bb8b4435d3d7ec14f6a2b33f1fb3c01cf20d231addd5e5d24ac22fd53a6df2"
ATLAS_SHA = "fbdbe1be9bab654e65b47d173ac724acde1b839b2518691e6a90f7f5c264b153"

SMALL = dict(width=60, height=20, max_chars=24)


@pytest.fixture(scope="module")
def atlas():
    return tfg.bake_atlas(T_FIRACODE)


@pytest.fixture(scope="module")
def jax_cache(tmp_path_factory):
    """A cache directory of this module's own for the JAX package's bakers.
    Their default cache is shared by every test process and written in
    place, so a reader in another process could find a half-written file."""
    return str(tmp_path_factory.mktemp("jax_cache"))


def _u8(sheets: np.ndarray) -> np.ndarray:
    return np.round(sheets * 255).astype(np.uint8)


def test_font_paths_and_charset_match_jax():
    from ai_font_renderer_tpu import config as jcfg

    assert T_FIRACODE == FIRACODE_PATH
    assert PRINTABLE_ASCII == jcfg.PRINTABLE_ASCII


def test_generate_corpus_equal():
    assert tfg.generate_corpus(2000) == jfg.generate_corpus(2000)
    assert tfg.generate_corpus(50, base_seed=7, min_length=3, max_length=9) == jfg.generate_corpus(
        50, base_seed=7, min_length=3, max_length=9
    )


@pytest.mark.parametrize("spec_kw", [{}, SMALL], ids=["full", "small"])
def test_bake_atlas_tables_equal(spec_kw, jax_cache):
    got = tfg.bake_atlas(T_FIRACODE, SheetSpec(**spec_kw))
    want = jfg.bake_atlas(FIRACODE_PATH, JaxSheetSpec(**spec_kw), cache_dir=jax_cache)
    np.testing.assert_array_equal(got.table, want.table)
    for field in ("x0", "y0", "advances_px"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    for field in ("charset", "advance_px", "cell_h", "cell_w", "ascent_rows", "bearing_x"):
        assert getattr(got, field) == getattr(want, field), field


def test_atlas_cache_is_the_ports_own(tmp_path):
    """A warm bake reads the port's cache; the JAX package's is never read."""
    cold = tfg.bake_atlas(T_FIRACODE, SheetSpec(**SMALL), cache_dir=str(tmp_path))
    files = list(tmp_path.iterdir())
    assert len(files) == 1 and files[0].suffix == ".npz"
    warm = tfg.bake_atlas(T_FIRACODE, SheetSpec(**SMALL), cache_dir=str(tmp_path))
    np.testing.assert_array_equal(cold.table, warm.table)
    import inspect

    src = inspect.getsource(tfg.atlas.bake_atlas)
    assert '"torch_atlas"' in src and '"atlas"' not in src


def test_build_layouts_equal(atlas, tmp_path, jax_cache):
    got_codes, got_grids = tfg.build_layouts(atlas, 2000, cache_dir=str(tmp_path / "t"))
    jatlas = jfg.bake_atlas(FIRACODE_PATH, cache_dir=jax_cache)
    want_codes, want_grids = jds.build_layouts(jatlas, 2000, cache_dir=str(tmp_path / "j"))
    np.testing.assert_array_equal(got_codes, want_codes)
    np.testing.assert_array_equal(got_grids, want_grids)
    # The cached copy reads back the same arrays.
    again = tfg.build_layouts(atlas, 2000, cache_dir=str(tmp_path / "t"))
    np.testing.assert_array_equal(again[1], got_grids)


def test_native_corpus_equals_python_layout(atlas):
    """The port's copy of corpus.cpp against its own Python path."""
    if not native.corpus_available():
        pytest.skip("no C++ compiler for the native corpus generator")
    spec = atlas.spec
    codes, grids = native.generate_corpus_grids(
        300, 42, 10, 100, float(atlas.advance_px), spec.width, atlas.n_lines, atlas.n_slots, spec.max_chars
    )
    texts = tfg.generate_corpus(300)
    np.testing.assert_array_equal(codes, tfg.encode_codes(texts, spec.max_chars))
    np.testing.assert_array_equal(
        grids, tfg.encode_grids(texts, atlas.advance_table(), spec, atlas.n_lines, atlas.n_slots)
    )


def test_native_rasterizer_equals_python(atlas):
    """The port's copy of rasterizer.cpp against its Python rasterizer, on
    a few glyph outlines at subpixel offsets (float32 vs float64 sums)."""
    from ai_font_renderer_tpu_torch.fontgen.ttf import TrueTypeFont

    font = TrueTypeFont.load(T_FIRACODE)
    scale = 12.0 / font.units_per_em
    segs, offsets = [], [0]
    for ch, dx in (("A", 2.3), ("g", 1.7), ("@", 2.0), ("W", 1.25)):
        s = raster.flatten_glyph(font.glyph(font.glyph_id(ord(ch))), scale).copy()
        s[:, [1, 3]] = 13.4 - s[:, [1, 3]]
        s[:, [0, 2]] += dx
        segs.append(s)
        offsets.append(offsets[-1] + len(s))
    segments = np.concatenate(segs).astype(np.float32)
    got = native.rasterize_batch(segments, np.asarray(offsets, np.int64), 12, 18)
    for i in range(4):
        want = raster.rasterize_segments(segments[offsets[i] : offsets[i + 1]], 12, 18)
        np.testing.assert_allclose(got[i], want, atol=1e-5)


def test_synthesized_sheets_equal_host_oracle(atlas, jax_cache):
    """torch synthesis (CPU) vs the numpy oracle, 2000 samples, byte-exact;
    and the port's oracle vs the JAX package's."""
    _, grids = tfg.build_layouts(atlas, 2000)
    ops = sheets.make_synth_ops(atlas, torch.device("cpu"))
    got = _u8(sheets.synthesize_sheets(ops, torch.from_numpy(grids.astype(np.int32))).numpy())
    host = sheets.synthesize_sheets_host(atlas, grids)
    np.testing.assert_array_equal(got, _u8(host))
    jatlas = jfg.bake_atlas(FIRACODE_PATH, cache_dir=jax_cache)
    np.testing.assert_array_equal(host[:200], jfg.synthesize_sheets_host(jatlas, grids[:200]))


def test_build_device_dataset_matches_jax(jax_cache):
    """The port's device dataset (on the CPU) against the JAX package's at
    the small geometry of tests/test_train.py."""
    spec = SheetSpec(**SMALL)
    got = tds.build_device_dataset(tfg.bake_atlas(T_FIRACODE, spec), 96, synth_batch=32, device="cpu")
    jatlas = jfg.bake_atlas(FIRACODE_PATH, JaxSheetSpec(**SMALL), cache_dir=jax_cache)
    want = jds.build_device_dataset(jatlas, 96, synth_batch=32, cache_dir=jax_cache)
    assert got.codes.dtype == torch.int32 and got.targets_u8.dtype == torch.uint8
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.targets_u8.numpy(), np.asarray(want.targets_u8))
    idx = np.array([3, 0, 95, 3])
    codes, targets = got.gather_batch(torch.from_numpy(idx))
    jcodes, jtargets = want.gather_batch(idx)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(targets.numpy(), np.asarray(jtargets))


def test_corpus_strings_locked():
    texts = tfg.generate_corpus(16)
    assert hashlib.sha256("\n".join(texts).encode()).hexdigest() == CORPUS16_STRINGS_SHA


def test_atlas_locked(atlas):
    assert hashlib.sha256(_u8(atlas.table).tobytes()).hexdigest() == ATLAS_SHA


def test_synthesized_sheets_locked(atlas):
    texts = tfg.generate_corpus(16)
    grids = tfg.encode_grids(texts, atlas.advance_table(), atlas.spec, atlas.n_lines, atlas.n_slots)
    ops = sheets.make_synth_ops(atlas, torch.device("cpu"))
    got = sheets.synthesize_sheets(ops, torch.from_numpy(grids.astype(np.int32))).numpy()
    for u8 in (_u8(got), _u8(sheets.synthesize_sheets_host(atlas, grids))):
        assert hashlib.sha256(u8.tobytes()).hexdigest() == CORPUS16_SHEETS_SHA


@pytest.mark.parametrize("n,seed", [(96, 42), (150000, 42), (1201, 7)])
def test_split_permutation_and_sizes_equal(n, seed):
    np.testing.assert_array_equal(tds.split_permutation(n, seed), jds.split_permutation(n, seed))
    assert tds.split_sizes(n, 0.2) == jds.split_sizes(n, 0.2)


@pytest.mark.parametrize("n,batch", [(19, 16), (16, 16), (4096, 1024), (0, 8)])
def test_val_batches_equal(n, batch):
    idx = np.random.default_rng(n).permutation(max(n, 1))[:n].astype(np.int32)
    for got, want in zip(tloop._val_batches(idx, batch), jloop._val_batches(idx, batch)):
        np.testing.assert_array_equal(got, want)


def test_font_is_monospace_and_proportional_refusal():
    """Kept under its old name: a proportional font used to be refused; now
    the font kind picks the atlas (bake_font_atlas), as in the JAX
    package."""
    assert tds.font_is_monospace(T_FIRACODE) == jds.font_is_monospace(FIRACODE_PATH) is True
    assert tds.font_is_monospace(MONTSERRAT_PATH) == jds.font_is_monospace(MONTSERRAT_PATH) is False
    for font, kind in ((T_FIRACODE, "GlyphAtlas"), (MONTSERRAT_PATH, "PropAtlas")):
        assert type(tds.bake_font_atlas(font, proportional=not tds.font_is_monospace(font))).__name__ == kind
    np.testing.assert_array_equal(
        tds.bake_font_atlas(MONTSERRAT_PATH, proportional=True).table,
        jds.bake_font_atlas(MONTSERRAT_PATH, proportional=True).table,
    )


def test_wrap_and_layout_equal_jax(jax_cache):
    from ai_font_renderer_tpu.fontgen import layout as jlayout

    jatlas = jfg.bake_atlas(FIRACODE_PATH, cache_dir=jax_cache)
    texts = ["HELLO  WORLD", "   ", "A" * 140, "AB CD " * 9, ""]
    spec = SheetSpec()
    adv = tfg.AdvanceTable(PRINTABLE_ASCII, jatlas.advances_px)
    jadv = jatlas.advance_table()
    for t in texts:
        assert tfg.wrap_text(t, adv, 240.0) == jlayout.wrap_text(t, jadv, 240.0)
    np.testing.assert_array_equal(
        tfg.encode_grids(texts, adv, spec, jatlas.n_lines, jatlas.n_slots),
        jlayout.encode_grids(texts, jadv, JaxSheetSpec(), jatlas.n_lines, jatlas.n_slots),
    )
