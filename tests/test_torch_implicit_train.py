"""The port's implicit-model training (fontgen/glyphs.py, models/multifont.py,
train/implicit.py, train/optim.py's schedules) against the JAX package's,
on the CPU: the same inputs, made from a seed with numpy, through both.

Tolerances. Glyph rasters, SDFs and charsets: equal (the same host numpy
code over the same rasterizer). The multifont forward and loss from JAX
params: 1e-5 max abs (f32 sums in another order through sin(30 x)).
_scan_train from the same params: each step's loss within 1e-4 relative
of JAX's, and every parameter within 1e-5 of JAX's after 20 Adam steps at
lr 1e-3 (measured: 1.2e-6 at most; Adam normalises each gradient, so an
element whose gradient is at rounding level could move by up to lr a step
in either direction in each package, and none of these does). Schedules:
1e-7 relative of optax's (f32 against f32 cos).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ai_font_renderer_tpu.fontgen import glyphs as jglyphs
from ai_font_renderer_tpu.models import multifont as jmf
from ai_font_renderer_tpu.models import siren as jsiren
from ai_font_renderer_tpu.train import implicit as jimplicit
from ai_font_renderer_tpu_torch.config import FIRACODE_PATH, MONTSERRAT_PATH
from ai_font_renderer_tpu_torch.fontgen import glyphs as tglyphs
from ai_font_renderer_tpu_torch.models import multifont as tmf
from ai_font_renderer_tpu_torch.models import siren as tsiren
from ai_font_renderer_tpu_torch.models.font_renderer import params_from_jax
from ai_font_renderer_tpu_torch.train import implicit as timplicit
from ai_font_renderer_tpu_torch.train import optim
from test_torch_native_build import install_reference_native

install_reference_native()

FONTS = {"firacode": FIRACODE_PATH, "montserrat": MONTSERRAT_PATH}
CHARSET = "AgW.|é0 q@"  # 10 glyphs: ink, a descender, a blank, a non-ASCII one
CELL = 24
FWD_TOL = 1e-5
LOSS_REL_TOL = 1e-4
LR = 1e-3
STEPS = 20
TRAIN_PARAM_TOL = 1e-5


@pytest.mark.parametrize("font", sorted(FONTS))
@pytest.mark.parametrize("what", ["rasterize", "sdf", "unicode"])
def test_glyph_targets_equal_jax(what, font):
    path = FONTS[font]
    if what == "unicode":
        got, want = tglyphs.unicode_charset(path), jglyphs.unicode_charset(path)
        assert got == want and len(got) > 95
        assert tglyphs.unicode_charset(path, limit=10) == jglyphs.unicode_charset(path, limit=10)
        return
    fn = "rasterize_charset" if what == "rasterize" else "sdf_charset"
    got = getattr(tglyphs, fn)(path, CHARSET, CELL)
    want = getattr(jglyphs, fn)(path, CHARSET, CELL)
    assert got.dtype == want.dtype == np.float32 and got.shape == (len(CHARSET), CELL, CELL)
    np.testing.assert_array_equal(got, want)
    if what == "sdf":
        assert (got[0] < 0).any() and (got[0] > 0).any()  # 'A' has inside and outside
        assert (got[CHARSET.index(" ")] == CELL).all()  # a blank glyph: no ink anywhere


def _mf_cfgs(mode):
    kw = dict(n_fonts=2, n_chars=5, embed_dim=8, font_dim=4, hidden_dim=16, n_layers=2, cell=8, mode=mode)
    return jmf.MultiFontConfig(**kw), tmf.MultiFontConfig(**kw)


def test_multifont_init_matches_jax_keys_shapes_and_bounds():
    jcfg, tcfg = _mf_cfgs("coverage")
    want = jmf.init(jax.random.PRNGKey(0), jcfg)
    got = tmf.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert list(got) == list(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape) and got[k].dtype == torch.float32, k
    assert float(got["w_in"].abs().max()) <= 0.5
    assert float(got["w_0"].abs().max()) <= (6.0 / 16) ** 0.5
    assert all(float(got[k].abs().max()) == 0.0 for k in got if k.startswith(("b_", "film_b_")))


@pytest.mark.parametrize("mode", ["coverage", "sdf"])
def test_multifont_apply_loss_and_atlas_match_jax(mode):
    jcfg, tcfg = _mf_cfgs(mode)
    jparams = jmf.init(jax.random.PRNGKey(1), jcfg)
    tparams = params_from_jax(jparams, "cpu")
    rng = np.random.default_rng(0)
    B, P = 6, 30
    fonts = rng.integers(0, 2, B).astype(np.int32)
    chars = rng.integers(0, 5, B).astype(np.int32)
    coords = rng.uniform(-1, 1, (B, P, 2)).astype(np.float32)
    targets = rng.uniform(0, 1, (B, P)).astype(np.float32)
    want = np.asarray(jmf.apply(jparams, fonts, chars, coords, jcfg))
    got = tmf.apply(tparams, torch.from_numpy(fonts), torch.from_numpy(chars), torch.from_numpy(coords), tcfg)
    assert np.abs(got.numpy() - want).max() <= FWD_TOL
    want_loss = float(jmf.loss_fn(jparams, fonts, chars, coords, targets, jcfg))
    got_loss = float(tmf.loss_fn(tparams, torch.from_numpy(fonts), torch.from_numpy(chars),
                                 torch.from_numpy(coords), torch.from_numpy(targets), tcfg))
    assert abs(got_loss - want_loss) <= FWD_TOL
    want_atlas = np.asarray(jmf.render_atlas(jparams, jcfg))
    got_atlas = tmf.render_atlas(tparams, tcfg).numpy()
    assert got_atlas.shape == want_atlas.shape == (2, 5, 8, 8)
    assert np.abs(got_atlas - want_atlas).max() <= FWD_TOL


def _siren_problem(mode):
    kw = dict(n_chars=4, embed_dim=8, hidden_dim=16, n_layers=2, cell=8, mode=mode)
    jcfg, tcfg = jsiren.SirenConfig(**kw), tsiren.SirenConfig(**kw)
    if mode == "sdf":
        t = tglyphs.sdf_charset(FIRACODE_PATH, "AgW.", 8) / 2.0
    else:
        t = tglyphs.rasterize_charset(FIRACODE_PATH, "AgW.", 8)
    targets = t.reshape(4, -1)
    coords = np.broadcast_to(tsiren.grid_coords(8).numpy()[None], (4, 64, 2)).copy()
    ids = np.arange(4, dtype=np.int32)
    jparams = jsiren.init(jax.random.PRNGKey(2), jcfg)
    jdata = (jnp.asarray(ids), jnp.asarray(coords), jnp.asarray(targets))
    tdata = (torch.from_numpy(ids), torch.from_numpy(coords), torch.from_numpy(targets))
    return jsiren.loss_fn, jcfg, tsiren.loss_fn, tcfg, jparams, jdata, tdata


def _multifont_problem(mode):
    jcfg, tcfg = _mf_cfgs(mode)
    rng = np.random.default_rng(3)
    fonts = np.repeat(np.arange(2, dtype=np.int32), 5)
    chars = np.tile(np.arange(5, dtype=np.int32), 2)
    coords = np.broadcast_to(tsiren.grid_coords(8).numpy()[None], (10, 64, 2)).copy()
    targets = rng.uniform(0, 1, (10, 64)).astype(np.float32)
    jparams = jmf.init(jax.random.PRNGKey(4), jcfg)
    arrays = (fonts, chars, coords, targets)
    return (jmf.loss_fn, jcfg, tmf.loss_fn, tcfg, jparams, tuple(jnp.asarray(a) for a in arrays),
            tuple(torch.from_numpy(a) for a in arrays))


@pytest.mark.parametrize("model,mode", [("siren", "coverage"), ("siren", "sdf"), ("multifont", "coverage")])
def test_scan_train_matches_jax(model, mode):
    """Full-batch Adam under the cosine decay (alpha 0.01) from the same
    params: the loss curve and the final params track JAX's _scan_train."""
    problem = _siren_problem if model == "siren" else _multifont_problem
    jloss, jcfg, tloss, tcfg, jparams, jdata, tdata = problem(mode)
    jp, jl = jimplicit._scan_train(lambda p, *a: jloss(p, *a, cfg=jcfg), jparams, STEPS, LR, jdata)
    tp, tl = timplicit._scan_train(lambda p, *a: tloss(p, *a, cfg=tcfg), params_from_jax(jparams, "cpu"),
                                   STEPS, LR, tdata)
    jl, tl = np.asarray(jl), tl.numpy()
    assert tl.shape == jl.shape == (STEPS,)
    rel = np.abs(tl - jl) / np.abs(jl)
    worst = {k: float(np.abs(tp[k].numpy() - np.asarray(jp[k])).max()) for k in jp}
    print(f"{model} {mode}: loss {jl[0]:.5f} -> {jl[-1]:.5f}, worst rel step diff {rel.max():.3g}, "
          f"worst param diff {max(worst.values()):.3g} ({max(worst, key=worst.get)})")
    assert rel.max() <= LOSS_REL_TOL
    assert max(worst.values()) <= TRAIN_PARAM_TOL
    assert tl[-1] < tl[0]


def test_scan_train_item_batch_draws_rows_in_range_and_learns():
    """With item_batch each step takes item_batch rows (with replacement)
    of the data from the seeded generator; the loss falls, and the same
    seed draws the same rows."""
    _, _, tloss, tcfg, jparams, _, tdata = _siren_problem("coverage")
    seen = []

    def loss(p, ids, coords, targets):
        seen.append(ids.clone())
        return tloss(p, ids, coords, targets, cfg=tcfg)

    params = params_from_jax(jparams, "cpu")
    _, losses = timplicit._scan_train(loss, params, 60, 3e-3, tdata, item_batch=2, seed=5)
    rows = torch.stack(seen)
    assert rows.shape == (60, 2) and int(rows.min()) >= 0 and int(rows.max()) < 4
    assert len(set(rows.flatten().tolist())) == 4
    assert float(losses[-10:].mean()) < float(losses[:10].mean())
    seen.clear()
    timplicit._scan_train(loss, params, 60, 3e-3, tdata, item_batch=2, seed=5)
    assert torch.equal(torch.stack(seen), rows)


def test_train_siren_and_train_multifont_run_on_the_cpu():
    cfg = tsiren.SirenConfig(n_chars=3, embed_dim=8, hidden_dim=16, n_layers=2, cell=8, mode="sdf")
    params, losses, t = timplicit.train_siren(FIRACODE_PATH, cfg, charset="AW.", steps=30, lr=3e-3, device="cpu")
    assert set(params) == set(tsiren.init(torch.Generator(), cfg, device="cpu"))
    assert losses.shape == (30,) and losses.dtype == np.float32 and losses[-1] < losses[0]
    np.testing.assert_array_equal(t, tglyphs.sdf_charset(FIRACODE_PATH, "AW.", 8) / 2.0)
    mcfg = tmf.MultiFontConfig(n_fonts=2, n_chars=3, embed_dim=8, font_dim=4, hidden_dim=16, n_layers=2, cell=8)
    params, losses, t = timplicit.train_multifont(list(FONTS.values()), mcfg, charset="AW.", steps=30, lr=3e-3,
                                                  device="cpu")
    assert t.shape == (2, 3, 8, 8) and losses[-1] < losses[0]
    assert tmf.render_atlas(params, mcfg).shape == (2, 3, 8, 8)


@pytest.mark.parametrize("kind", ["cosine", "cosine_alpha", "warmup_cosine", "linear"])
def test_schedules_match_optax(kind):
    if kind == "cosine":
        want, got = optax.cosine_decay_schedule(1e-4, 37), optim.cosine_decay_schedule(1e-4, 37)
    elif kind == "cosine_alpha":
        want, got = optax.cosine_decay_schedule(3e-4, 300, alpha=0.01), optim.cosine_decay_schedule(3e-4, 300, 0.01)
    elif kind == "warmup_cosine":
        want = optax.warmup_cosine_decay_schedule(0.0, 1e-3, 5, 100)
        got = optim.warmup_cosine_decay_schedule(0.0, 1e-3, 5, 100)
    else:
        want, got = optax.linear_schedule(0.0, 2e-3, 7), optim.linear_schedule(0.0, 2e-3, 7)
    for count in list(range(0, 12)) + [36, 37, 38, 99, 100, 150, 299, 300, 400]:
        w = float(want(count))
        assert abs(got(count) - w) <= 1e-7 * max(abs(w), 1e-3), (count, got(count), w)
    if kind == "warmup_cosine":
        assert got(0) == 0.0  # lr 0 on the first update
