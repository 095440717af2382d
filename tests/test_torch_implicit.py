"""The port's implicit render path (models/siren.py, render/implicit_sheet.py,
the SIREN bank's npz and ``render --implicit [--placement]``) against the
JAX package's, on the CPU, on the committed artifacts of both fonts.

Tolerances, each with what was measured on the CPU when it was set:

- f32 paths (the SIREN, the exact compose at engine positions, the baked
  and phased banks, the gather composites): 1e-4 max abs; sums in another
  order, through sin(30 x), which multiplies its argument's rounding by 30.
  Measured: at most 6e-6.
- bf16 paths (``compose_phased`` with the one-hot fetch or the matmul
  composite): one bf16 step of the coverage, 2^-8. Both packages round the
  coverage to bf16 first; where the baked f32 values differ in their last
  bits (6e-6 at most) a value near a rounding boundary rounds to the other
  neighbour. Measured: 0 on one table in both packages; 2^-9 on 52 of
  288000 pixels of the phased render of the 15 test strings (FiraCode).
- ``compute="bfloat16"`` SIREN: 2e-2 max abs. An operand that lies near a
  bf16 rounding boundary may round to the other neighbour in one package
  (its f32 value differs in the last bits), a 2^-8 relative step that the
  following sines carry on.
- Sheets of the learned placement (soft decode): 5e-3 max abs, about 1.3
  gray levels. The structured head's soft x is ill-conditioned where its
  line distribution hedges (tests/test_torch_placement.py): midpoints differ
  by up to 7.6e-4 px, and a glyph edge moves its coverage by about that
  much a pixel. Measured 1.9e-3 (Montserrat), 9.9e-5 (FiraCode).
- The golden locks are the JAX package's own (tests/test_artifacts.py):
  per-string MSE within 1e-4 of golden_mse.json, mean under 0.009 / 0.010,
  the kerned engine-layout oracle under 0.0042 / 0.0031.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_font_renderer_tpu.cli import TEST_STRINGS
from ai_font_renderer_tpu.fontgen.bmp import encode_bmp as jax_encode_bmp
from ai_font_renderer_tpu.fontgen.ttf import TrueTypeFont as JaxFont
from ai_font_renderer_tpu.models import siren as js
from ai_font_renderer_tpu.render import implicit_sheet as jis
from ai_font_renderer_tpu.utils import checkpoint as jck
from ai_font_renderer_tpu_torch import cli
from ai_font_renderer_tpu_torch.config import FIRACODE_PATH, MONTSERRAT_PATH, SheetSpec
from ai_font_renderer_tpu_torch.fontgen.bmp import read_bmp
from ai_font_renderer_tpu_torch.fontgen.dataset import bake_font_atlas, unit_ground_truth
from ai_font_renderer_tpu_torch.fontgen.ttf import TrueTypeFont
from ai_font_renderer_tpu_torch.models import siren as ts
from ai_font_renderer_tpu_torch.render import implicit_sheet as tis
from ai_font_renderer_tpu_torch.utils import checkpoint as tck
from test_torch_native_build import install_reference_native

install_reference_native()

ART = os.path.join(os.path.dirname(__file__), "..", "artifacts")
FONTS = {"firacode": FIRACODE_PATH, "montserrat": MONTSERRAT_PATH}
LEARNED_BOUND = {"firacode": 0.009, "montserrat": 0.010}
ORACLE_BOUND = {"firacode": 0.0042, "montserrat": 0.0031}
F32_TOL = 1e-4
BF16_STEP = 2.0**-8
SIREN_BF16_TOL = 2e-2
LEARNED_SHEET_TOL = 5e-3
GOLDEN_TOL = 1e-4
# Three test strings (wrapping, one line, all spaces) and the edge cases.
FEW = [TEST_STRINGS[1], TEST_STRINGS[9], TEST_STRINGS[14], "", "AVATAR WAVE Tyé?"]


def _bank(font):
    return os.path.join(ART, font, "siren_finetuned.npz")


def _net(font):
    return os.path.join(ART, font, "placement_finetuned.npz")


@pytest.fixture(scope="module", params=sorted(FONTS))
def banks(request):
    font = request.param
    jb = jck.load_siren(_bank(font))
    tb = tck.load_siren(_bank(font), device="cpu")
    return font, jb, tb


@pytest.fixture(scope="module")
def fira_bank():
    return jck.load_siren(_bank("firacode")), tck.load_siren(_bank("firacode"), device="cpu")


_LEARNED = {}


def _learned(font):
    """(JAX sheets, port sheets, ground truth) of the 15 test strings through
    the committed pair, soft decode; computed once per test process."""
    if font not in _LEARNED:
        jsp, jscfg, charset = jck.load_siren(_bank(font))
        jpp, jpcfg = jck.load_params_with_config(_net(font))
        tsp, tscfg, _ = tck.load_siren(_bank(font), device="cpu")
        tpp, tpcfg = tck.load_params_with_config(_net(font), device="cpu")
        want = np.asarray(jis.render_learned_sheets(jsp, jpp, TEST_STRINGS, FONTS[font], jscfg, jpcfg, charset=charset))
        got = tis.render_learned_sheets(tsp, tpp, TEST_STRINGS, FONTS[font], tscfg, tpcfg, charset=charset).numpy()
        gt = unit_ground_truth(bake_font_atlas(FONTS[font], proportional=font == "montserrat"), TEST_STRINGS)
        _LEARNED[font] = (want, got, gt)
    return _LEARNED[font]


# -- SIREN ----------------------------------------------------------------


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_siren_apply_matches_jax(fira_bank, compute):
    (jp, jcfg, _), (tp, tcfg, _) = fira_bank
    jcfg, tcfg = dataclasses.replace(jcfg, compute=compute), dataclasses.replace(tcfg, compute=compute)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 95, 48).astype(np.int32)
    coords = rng.uniform(-1.0, 1.0, (48, 300, 2)).astype(np.float32)
    want = np.asarray(js.apply(jp, jnp.asarray(ids), jnp.asarray(coords), jcfg))
    got = ts.apply(tp, torch.from_numpy(ids), torch.from_numpy(coords), tcfg).numpy()
    tol = F32_TOL if compute == "float32" else SIREN_BF16_TOL
    err = float(np.abs(got - want).max())
    print(f"siren apply {compute}: max abs diff {err:.3g} (tol {tol})")
    assert got.shape == (48, 300) and err <= tol


def test_siren_atlas_and_chunked_atlas_match_jax(fira_bank):
    """render_atlas, and render_atlas_chunked with chunk 16 over the 95
    glyphs (the last chunk wraps to the first glyphs and is cut away), at
    a 32-pixel cell to keep the CPU's work small."""
    (jp, jcfg, _), (tp, tcfg, _) = fira_bank
    jcfg, tcfg = dataclasses.replace(jcfg, cell=32), dataclasses.replace(tcfg, cell=32)
    want = np.asarray(js.render_atlas(jp, jcfg))
    got = ts.render_atlas(tp, tcfg).numpy()
    want_c = np.asarray(js.render_atlas_chunked(jp, jcfg, chunk=16))
    got_c = ts.render_atlas_chunked(tp, tcfg, chunk=16).numpy()
    assert got.shape == got_c.shape == (95, 32, 32)
    assert np.abs(got - want).max() <= F32_TOL and np.abs(got_c - want_c).max() <= F32_TOL
    assert np.abs(got_c - got).max() <= 1e-6
    np.testing.assert_array_equal(ts.grid_coords(8).numpy(), np.asarray(js.grid_coords(8)))


def test_siren_init_matches_jax_keys_shapes_and_bounds():
    cfg = ts.SirenConfig(n_chars=40, embed_dim=32, hidden_dim=48, n_layers=3, w0_hidden=2.0)
    want = js.init(jax.random.PRNGKey(0), js.SirenConfig(**dataclasses.asdict(cfg)))
    got = ts.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape) and got[k].dtype == torch.float32, k
        if k.startswith(("b_", "film_b")):
            assert float(got[k].abs().max()) == 0.0, k
    h = cfg.hidden_dim
    assert float(got["w_in"].abs().max()) <= 0.5
    assert all(float(got[f"w_{i}"].abs().max()) <= (6.0 / h) ** 0.5 / 2.0 for i in range(3))
    assert float(got["w_out"].abs().max()) <= (6.0 / h) ** 0.5
    assert abs(float(got["embed"].std()) - 0.1) < 0.01
    assert abs(float(got["film_w_0"].std()) - 0.01) < 0.001


def test_siren_bank_npz_crosses_between_packages(tmp_path):
    cfg = ts.SirenConfig(n_chars=5, embed_dim=8, hidden_dim=16, n_layers=2, cell=16)
    params = ts.init(torch.Generator().manual_seed(3), cfg, device="cpu")
    path = str(tmp_path / "port.npz")
    tck.save_siren(params, cfg, "ABCDE", path, font="/some/dir/Montserrat-Regular.ttf")
    jparams, jcfg, jcharset = jck.load_siren(path)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg) and jcharset == "ABCDE"
    for k, v in params.items():
        np.testing.assert_array_equal(np.asarray(jparams[k]), v.numpy(), err_msg=k)
    assert jck.siren_font(path) == tck.siren_font(path) == "Montserrat-Regular.ttf"

    jpath = str(tmp_path / "jax.npz")
    jck.save_siren(jparams, jcfg, "ABCDE", jpath)
    back, bcfg, bcharset = tck.load_siren(jpath, device="cpu")
    assert bcfg == cfg and bcharset == "ABCDE"
    for k, v in params.items():
        assert torch.equal(back[k], v), k
    assert tck.siren_font(jpath) is None
    with pytest.raises(ValueError, match="not a SIREN bank"):
        tck.load_siren(_net("firacode"), device="cpu")


# -- host layout ------------------------------------------------------------


@pytest.mark.parametrize("kerned", [False, True], ids=["unkerned", "kerned"])
@pytest.mark.parametrize("font", sorted(FONTS))
def test_layout_and_pen_walk_match_jax(font, kerned):
    spec = SheetSpec()
    strings = TEST_STRINGS + FEW + ["LAYAWAY PAYLOAD VAT TAVERN WAYWARD AVOCADO VOYAGE " * 3]
    charset = "".join(chr(c) for c in range(32, 127))
    tfont, jfont = TrueTypeFont.load(FONTS[font]), JaxFont.load(FONTS[font])
    for scale in (1.0, 2.5):
        tlay = tis.build_layout(tfont, spec, 64, scale=scale)
        jlay = jis.build_layout(jfont, jis.SheetSpec(), 64, scale=scale)
        assert dataclasses.asdict(tlay) == dataclasses.asdict(jlay)
        tk = tis.font_kerning(FONTS[font], charset, spec) if kerned else None
        jk = jis.font_kerning(FONTS[font], charset) if kerned else None
        assert (tk is None) == (jk is None) and (tk is None or tk.pairs_px == jk.pairs_px)
        got = tis.place_glyphs(strings, tfont, tlay, spec, charset, tk)
        want = jis.place_glyphs(strings, jfont, jlay, jis.SheetSpec(), charset, jk)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        mids = np.random.default_rng(0).uniform(0, 240, (4, 100, 2)).astype(np.float32)
        want_o = jis.origins_from_midpoints(mids, jlay)
        np.testing.assert_array_equal(tis.origins_from_midpoints(mids, tlay), want_o)
        np.testing.assert_array_equal(tis.origins_from_midpoints(torch.from_numpy(mids), tlay).numpy(), want_o)
    assert font == "firacode" or not kerned or len(tk) > 0


def test_unknown_chars_advance_like_spaces():
    font = TrueTypeFont.load(FIRACODE_PATH)
    spec = SheetSpec()
    lay = tis.build_layout(font, spec, cell=32)
    charset = " ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    _, org_q, val_q = tis.place_glyphs(["A?B"], font, lay, spec, charset)
    _, org_s, val_s = tis.place_glyphs(["A B"], font, lay, spec, charset)
    assert val_q[0].sum() == val_s[0].sum() == 2
    np.testing.assert_array_equal(org_q, org_s)


# -- composition --------------------------------------------------------------


def _placed(font, strings, charset, scale=1.0):
    tfont = TrueTypeFont.load(FONTS[font])
    lay = tis.build_layout(tfont, SheetSpec(), 64, scale=scale)
    kern = tis.font_kerning(FONTS[font], charset)
    ids, origins, valid = tis.place_glyphs(strings, tfont, lay, SheetSpec(), charset, kern)
    jlay = jis.build_layout(JaxFont.load(FONTS[font]), jis.SheetSpec(), 64, scale=scale)
    return lay, jlay, ids, origins, valid


def test_exact_compose_matches_jax(banks):
    font, (jp, jcfg, charset), (tp, tcfg, _) = banks
    lay, jlay, ids, origins, valid = _placed(font, FEW, charset)
    want = np.asarray(jis.compose(jp, jnp.asarray(ids), jnp.asarray(origins), jnp.asarray(valid), jcfg, jlay))
    got = tis.compose(tp, *(torch.from_numpy(a) for a in (ids, origins, valid)), tcfg, lay).numpy()
    err = float(np.abs(got - want).max())
    print(f"{font} compose: max abs diff {err:.3g}")
    assert got.shape == (len(FEW), 80, 240) and err <= F32_TOL
    assert (got[2:4] == 1.0).all()  # all spaces, empty: white


def test_compose_chunks_over_sheets_without_changing_results(fira_bank, monkeypatch):
    _, (tp, tcfg, charset) = fira_bank
    lay, _, ids, origins, valid = _placed("firacode", FEW, charset)
    args = [torch.from_numpy(a) for a in (ids, origins, valid)]
    whole = tis.compose(tp, *args, tcfg, lay)
    monkeypatch.setattr(tis, "COMPOSE_POINTS", 2 * 100 * lay.win**2)  # two sheets a chunk
    chunked = tis.compose(tp, *args, tcfg, lay)
    assert float((chunked - whole).abs().max()) <= 1e-6


def test_composite_adds_slots_in_order():
    """The scatter composite equals a plain loop that adds each slot's
    window pixel by pixel in slot order, bit for bit, and the JAX package's
    scatter-add on the same inputs within 1e-6."""
    rng = np.random.default_rng(5)
    lay = tis.ImplicitLayout(cell=8, fill=0.85, scale=1.0, height=12, width=20, win=6, r=0.9,
                             cell_baseline=6.0, cell_x_center=4.0, max_glyphs=9)
    N, G = 3, 9
    origins = rng.uniform(-4.0, 20.0, (N, G, 2)).astype(np.float32)
    valid = rng.uniform(size=(N, G)) < 0.8
    cov = rng.uniform(0.0, 0.9, (N, G, 6, 6)).astype(np.float32)
    px, py, u, v = tis._window_geometry(torch.from_numpy(origins), lay)
    got = tis._composite(torch.from_numpy(cov), px, py, u, v, torch.from_numpy(valid), lay).numpy()
    ink = np.zeros((N, 12, 20), np.float32)
    for n in range(N):
        for g in range(G):
            for i in range(6):
                for j in range(6):
                    x, y = int(px[n, g, i, j] - 0.5), int(py[n, g, i, j] - 0.5)
                    inside = abs(float(u[n, g, i, j])) <= 1.0 and abs(float(v[n, g, i, j])) <= 1.0
                    if valid[n, g] and inside and 0 <= x < 20 and 0 <= y < 12:
                        ink[n, y, x] = np.float32(ink[n, y, x] + cov[n, g, i, j])
    np.testing.assert_array_equal(got, np.clip(1.0 - ink, 0.0, 1.0))
    jlay = jis.ImplicitLayout(**dataclasses.asdict(lay))
    jpx, jpy, ju, jv = jis._window_geometry(jnp.asarray(origins), jlay)
    want = np.asarray(jis._composite(jnp.asarray(cov), jpx, jpy, ju, jv, jnp.asarray(valid), jlay))
    assert np.abs(got - want).max() <= 1e-6


def test_baked_banks_match_jax(fira_bank):
    """bake_bank (ss 4, at a 16-pixel cell: 95 glyphs at 64 x 64) and
    bake_bank_phased (P = 4 at the committed layout) on the committed
    FiraCode bank; the cells are cut to keep the CPU's work small."""
    (jp, jcfg, charset), (tp, tcfg, _) = fira_bank
    lay, jlay, *_ = _placed("firacode", [], charset)
    want = np.asarray(jis.bake_bank(jp, dataclasses.replace(jcfg, cell=16), supersample=4))
    got = tis.bake_bank(tp, dataclasses.replace(tcfg, cell=16), supersample=4).numpy()
    assert got.shape == (95, 64, 64) and np.abs(got - want).max() <= F32_TOL
    want = np.asarray(jis.bake_bank_phased(jp, jcfg, jlay, phases=4))
    got = tis.bake_bank_phased(tp, tcfg, lay, phases=4).numpy()
    assert got.shape == (95, 4, 4, lay.win, lay.win) and np.abs(got - want).max() <= F32_TOL


def _table(shape, seed):
    return np.random.default_rng(seed).uniform(0.0, 1.0, shape).astype(np.float32)


def test_compose_baked_matches_jax(fira_bank):
    """compose_baked at ss 4 on one table, [95, 256, 256] from a seed, in
    both packages (the bake is held to JAX's above)."""
    (_, jcfg, charset), (_, tcfg, _) = fira_bank
    lay, jlay, ids, origins, valid = _placed("firacode", FEW, charset)
    table = _table((95, 256, 256), 6)
    want = np.asarray(jis.compose_baked(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(origins),
                                        jnp.asarray(valid), jcfg, jlay, 4))
    got = tis.compose_baked(torch.from_numpy(table), *(torch.from_numpy(a) for a in (ids, origins, valid)),
                            tcfg, lay, 4).numpy()
    assert np.abs(got - want).max() <= F32_TOL


@pytest.mark.parametrize("composite", ["scatter", "matmul"])
@pytest.mark.parametrize("onehot", [False, True], ids=["take", "onehot"])
def test_compose_phased_matches_jax(fira_bank, onehot, composite):
    """compose_phased at P = 8 on one phase table from a seed, in both
    packages, each way of fetching the blocks and of adding them up."""
    (_, jcfg, charset), (_, tcfg, _) = fira_bank
    lay, jlay, ids, origins, valid = _placed("firacode", FEW + TEST_STRINGS[:6], charset)
    table = _table((95, 8, 8, lay.win, lay.win), 7)
    want = np.asarray(jis.compose_phased(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(origins),
                                         jnp.asarray(valid), jcfg, jlay, 8, onehot=onehot, composite=composite))
    got = tis.compose_phased(torch.from_numpy(table), *(torch.from_numpy(a) for a in (ids, origins, valid)),
                             tcfg, lay, 8, onehot=onehot, composite=composite).numpy()
    tol = F32_TOL if not onehot and composite == "scatter" else BF16_STEP
    err = float(np.abs(got - want).max())
    print(f"compose_phased {'onehot' if onehot else 'take'} {composite}: max abs diff {err:.3g} (tol {tol:.3g})")
    assert err <= tol
    assert (got[2:4] == 1.0).all()


# -- the golden locks, in the port alone --------------------------------------


@pytest.mark.parametrize("font", sorted(FONTS))
def test_committed_pair_meets_the_golden_locks(font):
    """tests/test_artifacts.py's locks with the port's functions: each test
    string's MSE within 1e-4 of golden_mse.json, their mean under the
    1.4x-of-best bound."""
    _, got, gt = _learned(font)
    with open(os.path.join(ART, font, "golden_mse.json")) as f:
        golden = json.load(f)
    mse = [float(np.mean((got[i] - gt[i]) ** 2)) for i in range(len(TEST_STRINGS))]
    assert len(mse) == golden["n_strings"]
    deltas = np.abs(np.array(mse) - np.array(golden["per_string_mse"]))
    print(f"{font}: mean MSE {np.mean(mse):.6f}, largest per-string delta {deltas.max():.2e}")
    assert deltas.max() < GOLDEN_TOL
    assert float(np.mean((got - gt) ** 2)) < LEARNED_BOUND[font]


@pytest.mark.parametrize("font", sorted(FONTS))
def test_committed_bank_engine_layout_oracle(font):
    sp, scfg, charset = tck.load_siren(_bank(font), device="cpu")
    sheets = tis.render_implicit_sheets(sp, TEST_STRINGS, FONTS[font], scfg, charset=charset).numpy()
    _, _, gt = _learned(font)
    mse = float(np.mean((sheets - gt) ** 2))
    print(f"{font}: kerned oracle MSE {mse:.6f}")
    assert mse < ORACLE_BOUND[font]


@pytest.mark.parametrize("font", sorted(FONTS))
def test_learned_sheets_match_jax(font):
    want, got, _ = _learned(font)
    err = float(np.abs(got - want).max())
    print(f"{font}: learned sheets max abs diff {err:.3g} (tol {LEARNED_SHEET_TOL})")
    assert got.shape == want.shape == (15, 80, 240) and err <= LEARNED_SHEET_TOL


# -- the command line -----------------------------------------------------------


def _font_args(font):
    return ["--font", FONTS[font]]


@pytest.mark.parametrize("font", sorted(FONTS))
def test_cli_renders_the_committed_pair_as_the_jax_cli_does(font, tmp_path, capsys):
    """render --implicit BANK --placement NET --device cpu: the 15 test
    strings as BMPs within one gray level of the JAX CLI's (its
    render_learned_sheets through its BMP encoder)."""
    out = str(tmp_path / "r")
    argv = ["render", "--implicit", _bank(font), "--placement", _net(font), "--out", out, "--device", "cpu"]
    assert cli.main(argv + _font_args(font)) == 0
    assert f"Saved 15 implicit renders to {out}/" in capsys.readouterr().out
    want, _, _ = _learned(font)
    for i in range(15):
        got = read_bmp(os.path.join(out, f"string_{i}.bmp"))
        assert np.abs(got - read_bmp(jax_encode_bmp(want[i]))).max() <= 1 / 255 + 1e-6, i


@pytest.mark.parametrize(
    "font,extra,shape",
    [
        ("montserrat", ["--hard-placement"], (80, 240)),
        ("montserrat", ["--monotone-placement"], (80, 240)),
        ("firacode", ["--monotone-placement"], (80, 240)),
        ("firacode", ["--baked", "2"], (80, 240)),
        ("montserrat", ["--phased", "8"], (80, 240)),
        ("montserrat", ["--scale", "2"], (160, 480)),
        ("firacode", ["--no-placement"], (80, 240)),
    ],
    ids=["hard", "monotone", "monotone_line_head", "baked2", "phased8", "scale2", "engine"],
)
def test_cli_variants_run(font, extra, shape, tmp_path):
    out = str(tmp_path / "v")
    placement = [] if "--no-placement" in extra else ["--placement", _net(font)]
    extra = [a for a in extra if a != "--no-placement"]
    argv = ["render", "HELLO WORLD", "Type AV", "--implicit", _bank(font), *placement, "--out", out,
            "--device", "cpu", *extra, *_font_args(font)]
    assert cli.main(argv) == 0
    for i in range(2):
        img = read_bmp(os.path.join(out, f"string_{i}.bmp"))
        assert img.shape == shape and img.min() < 0.5  # ink on white


@pytest.mark.parametrize("which", ["bank", "net"])
def test_cli_missing_bank_or_net_exits_1(which, tmp_path, capsys):
    bank = "/nonexistent/bank.npz" if which == "bank" else _bank("firacode")
    argv = ["render", "HI", "--implicit", bank, "--placement", "/nonexistent/net.npz", "--out",
            str(tmp_path), "--device", "cpu"]
    assert cli.main(argv) == 1
    assert "not found" in capsys.readouterr().out
    assert not os.path.exists(tmp_path / "string_0.bmp")


def test_cli_warns_when_a_tagged_bank_meets_another_font(tmp_path, capsys):
    cfg = ts.SirenConfig(embed_dim=8, hidden_dim=16, n_layers=1, cell=16)
    path = str(tmp_path / "bank.npz")
    charset = "".join(chr(c) for c in range(32, 127))
    tck.save_siren(ts.init(torch.Generator().manual_seed(0), cfg, device="cpu"), cfg, charset, path,
                   font=MONTSERRAT_PATH)
    argv = ["render", "HI", "--implicit", path, "--out", str(tmp_path / "o"), "--device", "cpu"]
    assert cli.main(argv) == 0
    assert "WARNING: SIREN bank" in capsys.readouterr().out
    assert cli.main(argv + _font_args("montserrat")) == 0
    assert "WARNING" not in capsys.readouterr().out
