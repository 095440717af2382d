"""The port's placement training (models/placement.py's placement_targets and
loss_fn, train/placement_cli.py's supervised and fine-tune steps,
train/optim.py's AdamW and Adam, the fine-tune checkpoint) against the JAX
package's, on the CPU: the same inputs, made from a seed with numpy, and
JAX-initialised params through both. Dropout is 0 (threefry's masks cannot
be reproduced), the default precision profile is used.

Tolerances. placement_targets: equal. The loss: 1e-5 relative; its
gradients: within 1e-4 of the largest |gradient| of any leaf (f32 sums in
another order; bk's gradient is 0 in exact arithmetic, since a key bias
shifts every logit of a query row alike, so it is rounding noise in both).
Steps: every leaf within 1e-5 of JAX's, except the leaves ROUNDING_LEAVES
names: Adam divides each gradient by its own root mean square, so a leaf
whose gradient is rounding noise moves by up to lr a step in either
direction in each package; those are held to 2 x the sum of the step
sizes. The pixel loss's gradient through the composite: within 1e-4 of
the largest, for the bank's params and for the window origins.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ai_font_renderer_tpu.config import ModelConfig as JaxModelConfig
from ai_font_renderer_tpu.config import SheetSpec as JaxSheetSpec
from ai_font_renderer_tpu.models import placement as jp
from ai_font_renderer_tpu.models import siren as jsiren
from ai_font_renderer_tpu.render import implicit_sheet as jis
from ai_font_renderer_tpu.train import placement_cli as jcli
from ai_font_renderer_tpu.fontgen.ttf import TrueTypeFont as JaxTTF
from ai_font_renderer_tpu_torch.config import FIRACODE_PATH, MONTSERRAT_PATH, PRINTABLE_ASCII, ModelConfig, SheetSpec
from ai_font_renderer_tpu_torch.fontgen.dataset import bake_font_atlas, unit_ground_truth
from ai_font_renderer_tpu_torch.fontgen.layout import encode_codes
from ai_font_renderer_tpu_torch.fontgen.textgen import generate_corpus
from ai_font_renderer_tpu_torch.fontgen.ttf import TrueTypeFont
from ai_font_renderer_tpu_torch.models import placement as tp
from ai_font_renderer_tpu_torch.models import siren as tsiren
from ai_font_renderer_tpu_torch.models.font_renderer import params_from_jax
from ai_font_renderer_tpu_torch.render import implicit_sheet as tis
from ai_font_renderer_tpu_torch.train import optim
from ai_font_renderer_tpu_torch.train import placement_cli as tcli
from ai_font_renderer_tpu_torch.utils.checkpoint import CheckpointManager
from test_torch_native_build import install_reference_native

install_reference_native()

FONTS = {"firacode": FIRACODE_PATH, "montserrat": MONTSERRAT_PATH}
LOSS_REL_TOL = 1e-5
GRAD_REL_TOL = 1e-4
LEAF_TOL = 1e-5
# Leaves whose gradient is rounding noise in exact arithmetic (above).
ROUNDING_LEAVES = ("bk",)
DIMS = dict(embedding_dim=16, num_heads=2, hidden_dim=24, dropout_rate=0.0, fc_dropout_rate=0.0)
EDGE = ["", "   ", "A" * 120, "HELLO  WORLD   WIDE WWWWWWWWWWWWWWWWWWWWWWW IIII", "AVATAR WAVE To Ty yo."]


def _strings(n, seed=0):
    return EDGE + generate_corpus(n, base_seed=seed)


def _tables(font):
    kerned = font == "montserrat"
    return (jcli.build_table(FONTS[font], JaxSheetSpec(), PRINTABLE_ASCII, kerned),
            tcli.build_table(FONTS[font], SheetSpec(), PRINTABLE_ASCII, kerned))


@pytest.mark.parametrize("font,kw", [
    ("firacode", {}),
    ("firacode", {"full": True, "margins": True}),
    ("montserrat", {"full": True, "margins": True}),
    ("montserrat", {"margins": True, "max_glyphs": 30}),
], ids=["firacode", "firacode-full-margins", "montserrat-full-margins", "montserrat-margins-cap30"])
def test_placement_targets_equal_jax(font, kw):
    jtable, ttable = _tables(font)
    strings = _strings(300)
    want = jp.placement_targets(strings, jtable, JaxSheetSpec(), **kw)
    got = tp.placement_targets(strings, ttable, SheetSpec(), **kw)
    assert len(got) == len(want) == 2 + 2 * kw.get("full", False) + kw.get("margins", False)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    if kw.get("max_glyphs"):
        assert got[1].sum(axis=1).max() == kw["max_glyphs"]


def _cfgs(**kw):
    return dataclasses.replace(JaxModelConfig(), **DIMS, **kw), dataclasses.replace(ModelConfig(), **DIMS, **kw)


def _head_kw(kind, font="firacode"):
    """init kwargs of a head kind: 'regression', 'lines' or 'structured'
    (with the font's ASCII advance and kern tables)."""
    if kind == "regression":
        return {}
    if kind == "lines":
        return {"lines": 5}
    _, ttable = _tables(font)
    adv = tcli._ascii_advances(ttable, PRINTABLE_ASCII)
    kern = np.zeros((128, 128), np.float32)
    for a in PRINTABLE_ASCII:
        for b in PRINTABLE_ASCII:
            kern[ord(a), ord(b)] = ttable.kern(a, b)
    return {"lines": 5, "advances": adv, "kerning": kern}


def _batch(font, n=16, seed=1):
    """(codes, mids, vis, line, contrib, margin) numpy arrays for n corpus
    strings."""
    _, ttable = _tables(font)
    strings = generate_corpus(n, base_seed=seed)
    out = tp.placement_targets(strings, ttable, SheetSpec(), full=True, margins=True)
    return (encode_codes(strings, 100),) + out


def _setup(kind, font="firacode", uncertainty=False, seed=0, **cfg_kw):
    jcfg, tcfg = _cfgs(**cfg_kw)
    jparams = jp.init(jax.random.PRNGKey(seed), jcfg, uncertainty=uncertainty, **_head_kw(kind, font))
    if uncertainty:
        jparams["loss_logvar"] = jnp.asarray([0.3, -0.2, 0.1, -0.4], jnp.float32)
    return jcfg, tcfg, jparams


CASES = {
    "regression": ("regression", {}),
    "lines": ("lines", {}),
    "lines-ce_w-uncertainty": ("lines", {"ce_w": True, "uncertainty": True}),
    "structured": ("structured", {}),
    "structured-detach": ("structured", {"detach": True}),
    "structured-montserrat-ce_w-uncertainty": ("structured", {"font": "montserrat", "ce_w": True,
                                                              "uncertainty": True}),
    "lines-fused_attention": ("lines", {"fused": True}),
}


def _loss_args(kind, opts, arrays, to):
    codes, mids, vis, line, contrib, margin = arrays
    kw = {}
    if kind == "structured":
        kw.update(line_tgt=to(line), contrib_tgt=to(contrib))
    if opts.get("detach"):
        kw["detach_structure"] = True
    if opts.get("ce_w"):
        kw["ce_w"] = to(1.0 + 3.0 * (margin < 12.0).astype(np.float32))
    return (to(codes), to(mids), to(vis)), kw


def _max_rel(got: dict, want: dict) -> tuple[float, str]:
    """Largest |got - want| over all leaves, relative to the largest |want|
    of any leaf, and the leaf where it is."""
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    errs = {k: float(np.abs(got[k] - np.asarray(want[k])).max()) / scale for k in want}
    worst = max(errs, key=errs.get)
    return errs[worst], worst


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_gradients_match_jax(case):
    kind, opts = CASES[case]
    font = opts.get("font", "firacode")
    jcfg, tcfg, jparams = _setup(kind, font, opts.get("uncertainty", False))
    if opts.get("fused"):
        # The port's kernel entry (its plain version on the CPU) against
        # JAX's plain attention.
        tcfg = dataclasses.replace(tcfg, fused_attention=True)
    arrays = _batch(font)
    jargs, jkw = _loss_args(kind, opts, arrays, jnp.asarray)
    targs, tkw = _loss_args(kind, opts, arrays, torch.from_numpy)
    want, wgrads = jax.value_and_grad(jp.loss_fn)(jparams, *jargs, jcfg, key=jax.random.PRNGKey(0), train=True, **jkw)
    tparams = tcli.trainable(params_from_jax(jparams, "cpu"))
    got = tp.loss_fn(tparams, *targs, tcfg, generator=torch.Generator(), train=True, **tkw)
    grads = dict(zip(tparams, torch.autograd.grad(got, list(tparams.values()))))
    rel = abs(float(got.detach()) - float(want)) / abs(float(want))
    err, leaf = _max_rel({k: g.numpy() for k, g in grads.items()}, wgrads)
    print(f"{case}: loss {float(want):.6g}, rel diff {rel:.3g}; gradients {err:.3g} of the largest ({leaf})")
    assert rel <= LOSS_REL_TOL
    assert err <= GRAD_REL_TOL


def test_bce_matches_jax_at_large_logits():
    x = np.array([-200.0, -30.0, -1.0, 0.0, 1e-3, 2.0, 50.0, 300.0], np.float32)
    t = np.array([0, 1, 1, 0, 1, 0, 1, 0], np.float32)
    want = float(jp._bce(jnp.asarray(x), jnp.asarray(t)))
    assert abs(float(tp._bce(torch.from_numpy(x), torch.from_numpy(t))) - want) <= 1e-6 * abs(want)


STEP_CASES = {
    "regression": ("regression", False),
    "lines": ("lines", False),
    "structured-uncertainty": ("structured", True),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_three_supervised_steps_match_jax(case):
    """Three AdamW steps (weight decay 1e-4) under the CLI's warmup-cosine
    schedule (total 40 steps, warmup 2: lr 0 on the first update) from JAX
    params: every leaf, place_adv, place_kern and loss_logvar included."""
    kind, uncertainty = STEP_CASES[case]
    jcfg, tcfg, jparams = _setup(kind, uncertainty=uncertainty, seed=3)
    sched = dict(init_value=0.0, peak_value=1e-3, warmup_steps=2, decay_steps=40)
    jopt = optax.adamw(optax.warmup_cosine_decay_schedule(**sched), weight_decay=1e-4)
    topt = optim.Adam(optim.warmup_cosine_decay_schedule(*sched.values()), weight_decay=1e-4)
    jstep = jcli.make_supervised_step(jcfg, jopt)
    tstep = tcli.make_supervised_step(tcfg, topt)
    tparams = tcli.trainable(params_from_jax(jparams, "cpu"))
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    gen, key = torch.Generator().manual_seed(7), jax.random.PRNGKey(7)
    for s in range(3):
        arrays = _batch("firacode", seed=10 + s)
        codes, mids, vis, line, contrib, _ = arrays
        extra = (line, contrib) if kind == "structured" else (None, None)
        jparams, jstate, jloss = jstep(jparams, jstate, jnp.asarray(codes), jnp.asarray(mids), jnp.asarray(vis),
                                       *(None if a is None else jnp.asarray(a) for a in extra), None, key)
        tparams, tstate, tloss = tstep(tparams, tstate, torch.from_numpy(codes), torch.from_numpy(mids),
                                       torch.from_numpy(vis),
                                       *(None if a is None else torch.from_numpy(a) for a in extra), None, gen)
        assert abs(float(tloss) - float(jloss)) <= LOSS_REL_TOL * abs(float(jloss))
    assert tstate["count"] == 3 and int(jstate[0].count) == 3
    bound = 2 * sum(topt.lr(c) for c in range(3))
    errs = {k: float(np.abs(tparams[k].detach().numpy() - np.asarray(jparams[k])).max()) for k in jparams}
    moved = {k: float(np.abs(np.asarray(jparams[k]) - np.asarray(_setup(kind, uncertainty=uncertainty, seed=3)[2][k])).max())
             for k in jparams}
    print(f"{case}: worst leaf {max(errs, key=errs.get)} {max(errs.values()):.3g}; "
          f"{ {k: round(v, 9) for k, v in errs.items() if v > LEAF_TOL} }")
    for k, e in errs.items():
        assert e <= (bound if k in ROUNDING_LEAVES else LEAF_TOL), (k, e)
    for k in ("place_adv", "place_kern", "loss_logvar"):
        if k in jparams:
            assert moved[k] > 0.0, k  # trained, and decayed, in both packages


def _tiny_bank():
    kw = dict(n_chars=len(PRINTABLE_ASCII), cell=16, embed_dim=8, hidden_dim=16, n_layers=2)
    return jsiren.SirenConfig(**kw), tsiren.SirenConfig(**kw)


@functools.lru_cache(maxsize=None)
def _ft_inputs(n=8):
    """Numpy fine-tune inputs of n FiraCode corpus strings: codes, ids,
    valid, ground truth."""
    strings = generate_corpus(n, base_seed=5)
    ids, valid = tis.known_slots(strings, PRINTABLE_ASCII, 100)
    gt = unit_ground_truth(bake_font_atlas(FIRACODE_PATH), strings)
    return encode_codes(strings, 100), ids, valid, gt


def _jax_pixel_loss(pcfg, scfg, lay, bank=None):
    """The JAX pipeline's pixel loss, as train/placement_cli.py:774-784
    writes it inside run()."""
    def pixel_loss(tunable, c, ids, valid, gt):
        p, sp = tunable if bank is None else (tunable, bank)
        xy, _ = jp.apply(p, c, pcfg, train=False)
        origins = jis.origins_from_midpoints(xy, lay)
        sheets = jis.compose(sp, ids, origins, valid, scfg, lay)
        return jnp.mean((sheets - gt) ** 2)
    return pixel_loss


@pytest.mark.parametrize("joint", [False, True], ids=["placement", "joint"])
def test_two_finetune_steps_match_jax(joint):
    """Two Adam steps of the pixel fine-tune (cosine from 1e-4 over 2 steps,
    the CLI's --finetune-schedule cosine) from JAX params and a tiny JAX
    bank: the pixel loss and every leaf of the tunable tree."""
    jcfg, tcfg, jparams = _setup("lines", seed=4)
    jscfg, tscfg = _tiny_bank()
    jbank = jsiren.init(jax.random.PRNGKey(1), jscfg)
    jlay = jis.build_layout(JaxTTF.load(FIRACODE_PATH), JaxSheetSpec(), 16, max_glyphs=100)
    tlay = tis.build_layout(TrueTypeFont.load(FIRACODE_PATH), SheetSpec(), 16, max_glyphs=100)
    jopt, topt = optax.adam(optax.cosine_decay_schedule(1e-4, 2)), optim.Adam(optim.cosine_decay_schedule(1e-4, 2))
    tparams = tcli.trainable(params_from_jax(jparams, "cpu"))
    tbank = params_from_jax(jbank, "cpu")
    if joint:
        jt, tt = (jparams, jbank), (tparams, tcli.trainable(tbank))
        jloss, tloss = _jax_pixel_loss(jcfg, jscfg, jlay), tcli.make_pixel_loss(tcfg, tscfg, tlay)
    else:
        jt, tt = jparams, tparams
        jloss = _jax_pixel_loss(jcfg, jscfg, jlay, bank=jbank)
        tloss = tcli.make_pixel_loss(tcfg, tscfg, tlay, bank=tbank)
    jstep, tstep = jcli.make_finetune_step(jloss, jopt), tcli.make_finetune_step(tloss, topt)
    jstate, tstate = jopt.init(jt), topt.init(tt)
    codes, ids, valid, gt = _ft_inputs()
    for s in range(2):
        sl = slice(4 * s, 4 * s + 4)
        jt, jstate, jl = jstep(jt, jstate, *(jnp.asarray(a[sl]) for a in (codes, ids, valid, gt)))
        tt, tstate, tl = tstep(tt, tstate, *(torch.from_numpy(a[sl]) for a in (codes, ids, valid, gt)))
        print(f"step {s}: pixel loss JAX {float(jl):.7g}, port {float(tl):.7g}")
        assert abs(float(tl) - float(jl)) <= LOSS_REL_TOL * abs(float(jl))
    pairs = [(tt, jt)] if not joint else list(zip(tt, jt))
    bound = 2 * sum(topt.lr(c) for c in range(2))
    errs = {k: float(np.abs(t[k].detach().numpy() - np.asarray(j[k])).max()) for t, j in pairs for k in j}
    print(f"worst leaf {max(errs, key=errs.get)} {max(errs.values()):.3g}")
    assert len(errs) == len(optim.tree_leaves(tt))
    for name, err in errs.items():
        assert err <= (bound if name in ROUNDING_LEAVES else LEAF_TOL), (name, err)


def test_pixel_loss_gradients_reach_the_bank_and_the_origins_as_in_jax():
    """jax.grad of the sheet MSE through compose, against torch.autograd,
    on the committed FiraCode bank at the engine's origins shifted by a
    sub-pixel offset: the gradient of every bank param and of the window
    origins (through the windows' cell coordinates u, v)."""
    from ai_font_renderer_tpu.utils.checkpoint import load_siren as jload_siren
    from ai_font_renderer_tpu_torch.utils.checkpoint import load_siren

    bank = "artifacts/firacode/siren_finetuned.npz"
    jbank, jscfg, charset = jload_siren(bank)
    tbank, tscfg, _ = load_siren(bank, device="cpu")
    strings = generate_corpus(4, base_seed=6)
    font = TrueTypeFont.load(FIRACODE_PATH)
    lay = tis.build_layout(font, cell=tscfg.cell)
    ids, origins, valid = tis.place_glyphs(strings, font, lay, charset=charset)
    origins = origins + np.float32(0.37)
    gt = unit_ground_truth(bake_font_atlas(FIRACODE_PATH), strings)
    jlay = jis.build_layout(JaxTTF.load(FIRACODE_PATH), cell=jscfg.cell)

    def jloss(bank, o):
        return jnp.mean((jis.compose(bank, jnp.asarray(ids), o, jnp.asarray(valid), jscfg, jlay) - gt) ** 2)

    want_loss, (wbank, worig) = jax.value_and_grad(jloss, argnums=(0, 1))(jbank, jnp.asarray(origins))
    tb = tcli.trainable(tbank)
    to = torch.from_numpy(origins).requires_grad_()
    loss = torch.mean((tis.compose(tb, torch.from_numpy(ids), to, torch.from_numpy(valid), tscfg, lay)
                       - torch.from_numpy(gt)) ** 2)
    grads = torch.autograd.grad(loss, list(tb.values()) + [to])
    assert abs(float(loss.detach()) - float(want_loss)) <= LOSS_REL_TOL * float(want_loss)
    err, leaf = _max_rel({k: g.numpy() for k, g in zip(tb, grads)}, wbank)
    worig = np.asarray(worig)
    oerr = float(np.abs(grads[-1].numpy() - worig).max()) / float(np.abs(worig).max())
    print(f"bank gradients {err:.3g} of the largest ({leaf}); origin gradients {oerr:.3g} of the largest; "
          f"{int((worig != 0).any(-1).sum())} of {valid.sum()} valid slots with a nonzero origin gradient")
    assert err <= GRAD_REL_TOL and oerr <= GRAD_REL_TOL
    assert (np.abs(worig).sum(-1) > 0).sum() >= valid.sum() // 2  # the pixels reach the origins


def test_tree_checkpoint_round_trips_the_finetune_state(tmp_path):
    """save_tree/restore_tree keep a (tunable, Adam state) tree: the tuple,
    the count, each tensor's values, dtype, device and requires_grad; a
    tree of another structure is refused."""
    params = tcli.trainable({"a": torch.randn(3, 2), "b": torch.arange(4.0)})
    bank = tcli.trainable({"w": torch.randn(5)})
    opt = optim.Adam(1e-3)
    tree = ((params, bank), opt.init((params, bank)))
    opt.update_((params, bank), [torch.ones_like(t) for t in optim.tree_leaves((params, bank))], tree[1])
    mgr = CheckpointManager(str(tmp_path / "ft_ckpt"), keep=2)
    for step in (2, 4, 6):
        mgr.save_tree(step, tree, {"joint": True, "first_px": 0.125})
    assert mgr.steps() == [4, 6]
    template = ((tcli.trainable(params), tcli.trainable(bank)), opt.init((params, bank)))
    step, got, host = mgr.restore_tree(template=template)
    assert step == 6 and host == {"joint": True, "first_px": 0.125}
    assert isinstance(got, tuple) and isinstance(got[0], tuple) and got[1]["count"] == 1
    for a, b in zip(optim.tree_leaves(got), optim.tree_leaves(tree)):
        assert (torch.equal(a, b) and a.dtype == b.dtype) if isinstance(b, torch.Tensor) else a == b
    assert all(t.requires_grad for t in optim.tree_leaves(got[0]))
    with pytest.raises(ValueError):
        mgr.restore_tree(template=(params, opt.init(params)))
