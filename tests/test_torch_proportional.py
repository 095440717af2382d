"""The port's proportional-font pipeline against the JAX package's, on the CPU.

The atlas bake, the pen-walk layout and the numpy oracle are copies: their
outputs must be equal bit for bit. The port's synthesis is a torch gather
and two f32 einsums; its sheets must equal the oracle's and the JAX
package's f32 device synthesis on the 8-bit grid (u8 equal). Most cases run
at the small sheet of tests/test_proportional.py (120x40, 40 characters),
one at the full 240x80.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_font_renderer_tpu.config import FIRACODE_PATH, MONTSERRAT_PATH
from ai_font_renderer_tpu.config import SheetSpec as JaxSheetSpec
from ai_font_renderer_tpu.fontgen import dataset as jds
from ai_font_renderer_tpu.fontgen import proportional as jprop
from ai_font_renderer_tpu_torch.cli import TEST_STRINGS
from ai_font_renderer_tpu_torch.config import SheetSpec
from ai_font_renderer_tpu_torch.fontgen import dataset as tds
from ai_font_renderer_tpu_torch.fontgen import proportional as tprop
from ai_font_renderer_tpu_torch.fontgen.textgen import generate_corpus

SMALL = dict(width=120, height=40, max_chars=40)
EDGE = ["", "   ", "WWWWWWWWWWWWWWWWWWWWWWWWWWWWWW", "IIIIIIIIIIIIIIIIIIII", "AV TO WA", "A" * 130]
ARRAY_FIELDS = ("table", "advances_px", "inked", "ink_index", "y0")
SCALAR_FIELDS = ("charset", "n_lines", "n_slots", "stride", "q_subpixel", "cell_h", "cell_w", "ascent_rows",
                 "bearing_x")


def _pair(font, spec_kw):
    return tprop.bake_prop_atlas(font, SheetSpec(**spec_kw)), jprop.bake_prop_atlas(font, JaxSheetSpec(**spec_kw))


@pytest.fixture(scope="module")
def small():
    return _pair(MONTSERRAT_PATH, SMALL)


def _u8(sheets) -> np.ndarray:
    return np.round(np.asarray(sheets) * 255).astype(np.uint8)


@pytest.mark.parametrize(
    "font,spec_kw", [(MONTSERRAT_PATH, SMALL), (MONTSERRAT_PATH, {}), (FIRACODE_PATH, SMALL)],
    ids=["montserrat_small", "montserrat_full", "firacode_small"],
)
def test_prop_atlas_equals_jax(font, spec_kw):
    """Every PropAtlas field and the variant table, bit for bit; the
    kerning table's pairs too."""
    got, want = _pair(font, spec_kw)
    for f in ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    for f in SCALAR_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert dataclasses.asdict(got.spec) == dataclasses.asdict(want.spec)
    assert got.kerning.pairs_px == want.kerning.pairs_px
    assert got.table.dtype == np.float32 and got.table.shape[0] == want.table.shape[0]


def test_prop_grids_and_placements_equal_jax(small):
    got, want = small
    texts = generate_corpus(200) + TEST_STRINGS + EDGE
    np.testing.assert_array_equal(tprop.encode_prop_grids(texts, got), jprop.encode_prop_grids(texts, want))
    for a, b in zip(tprop.make_prop_placements(got), jprop.make_prop_placements(want)):
        np.testing.assert_array_equal(a, b)
    assert got.variant(33, 1, 0, 3) == want.variant(33, 1, 0, 3)


def test_cpu_synthesis_equals_jax_host_and_device(small):
    """The port's torch synthesis on the CPU against the JAX package's
    numpy oracle and its f32 device einsum: u8 equal; the port's oracle
    (a copy) equals the JAX one bit for bit."""
    got, want = small
    texts = generate_corpus(64, base_seed=3) + TEST_STRINGS + EDGE
    grids = tprop.encode_prop_grids(texts, got)
    sheets = tprop.synthesize_prop_sheets(got, grids, device="cpu")
    assert sheets.dtype == torch.float32 and sheets.shape == (len(texts), 40, 120)
    host = jprop.synthesize_prop_host(want, grids)
    np.testing.assert_array_equal(tprop.synthesize_prop_host(got, grids), host)
    np.testing.assert_array_equal(_u8(sheets.numpy()), _u8(host))
    jdev = jprop.synthesize_prop_sheets(want, grids, dtype=jnp.float32)
    np.testing.assert_array_equal(_u8(sheets.numpy()), _u8(jdev))
    raw = tprop.synthesize_prop_sheets(got, torch.from_numpy(grids), device="cpu", quantize=False)
    jraw = np.asarray(jprop.synthesize_prop_sheets(want, grids, dtype=jnp.float32, quantize=False))
    np.testing.assert_allclose(raw.numpy(), jraw, atol=1e-6, rtol=0)  # f32 sums in another order


def test_build_device_dataset_prop_matches_jax(small):
    """n = 48 in chunks of 32 (the last one short): codes and u8 targets
    equal the JAX package's, and a gathered batch too."""
    got_atlas, want_atlas = small
    got = tds.build_device_dataset_prop(got_atlas, 48, synth_batch=32, device="cpu")
    want = jds.build_device_dataset_prop(want_atlas, 48, synth_batch=32)
    assert got.codes.dtype == torch.int32 and got.targets_u8.dtype == torch.uint8
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.targets_u8.numpy(), np.asarray(want.targets_u8))
    idx = np.array([5, 0, 47, 5])
    codes, targets = got.gather_batch(torch.from_numpy(idx))
    jcodes, jtargets = want.gather_batch(jnp.asarray(idx))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(targets.numpy(), np.asarray(jtargets))


def test_empty_prop_dataset_has_the_sheet_shape(small):
    ds = tds.build_device_dataset_prop(small[0], 0, device="cpu")
    assert tuple(ds.targets_u8.shape) == (0, 40, 120) and ds.num_samples == 0
