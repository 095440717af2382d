"""The port's placement net (models/placement.py) against the JAX package's,
on the CPU: the same inputs, made from a seed with numpy, through both.

Tolerances. Midpoints: 1e-4 px, except the structured head's soft decode
(Montserrat): its x sums advances over the whole line weighted by
same-line probabilities, and where the line distribution hedges (p about
0.5 at a break) the JAX package itself moves by 1.5e-3 px when its line
logits move by 1e-5, which is how far the two frontends' f32 sums in
another order put them apart (1.2e-5). So that decode is held to 2e-3 px
against JAX, and to 1e-4 px on the same logits (structured_x alone, random
logits). Line indices and visibility flags: equal wherever JAX's top-two
margin (line) or |logit| (visibility) exceeds 1e-4.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_font_renderer_tpu.cli import TEST_STRINGS
from ai_font_renderer_tpu.config import ModelConfig as JaxModelConfig
from ai_font_renderer_tpu.fontgen.layout import encode_codes
from ai_font_renderer_tpu.models import placement as jp
from ai_font_renderer_tpu.utils.checkpoint import load_params_with_config as jax_load
from ai_font_renderer_tpu_torch.config import ModelConfig
from ai_font_renderer_tpu_torch.models import font_renderer as tfr
from ai_font_renderer_tpu_torch.models import placement as tp
from ai_font_renderer_tpu_torch.utils.checkpoint import load_params_with_config
from test_torch_native_build import install_reference_native

install_reference_native()

ART = os.path.join(os.path.dirname(__file__), "..", "artifacts", "{}", "placement_finetuned.npz")
MID_TOL = 1e-4
SOFT_STRUCTURED_MID_TOL = 2e-3
MARGIN = 1e-4


def _strings(n: int, seed: int) -> list[str]:
    """Random strings over the printable charset with runs of spaces, up
    to 100 chars, so lines wrap."""
    rng = np.random.default_rng(seed)
    alphabet = np.array(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ abcdefghij.,;:!?  WWWIII"))
    return ["".join(alphabet[rng.integers(0, len(alphabet), rng.integers(0, 101))]) for _ in range(n)]


STRINGS = TEST_STRINGS + _strings(17, 0)


@pytest.fixture(scope="module", params=["firacode", "montserrat"])
def nets(request):
    path = ART.format(request.param)
    jparams, jcfg = jax_load(path)
    tparams, tcfg = load_params_with_config(path, device="cpu")
    return request.param, jparams, jcfg, tparams, tcfg


def test_committed_configs_load_alike(nets):
    """The FiraCode net's config lacks num_blocks, Montserrat's has it; both
    carry decoder_grid/decoder_channels lists. The port reads the same
    config as the JAX package, and the place_* arrays unchanged."""
    font, jparams, jcfg, tparams, tcfg = nets
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (tcfg.embedding_dim, tcfg.num_heads, tcfg.hidden_dim, tcfg.num_blocks) == (64, 8, 128, 1)
    assert set(tparams) == set(jparams)
    for k in jparams:
        np.testing.assert_array_equal(tparams[k].numpy(), np.asarray(jparams[k]), err_msg=k)
    assert tp.head_lines(tparams) == jp.head_lines(jparams) == 5
    assert tp.head_structured(tparams) == jp.head_structured(jparams) == (font == "montserrat")


def _top2_margin(llog: np.ndarray) -> np.ndarray:
    s = np.sort(llog, axis=-1)
    return s[..., -1] - s[..., -2]


@pytest.mark.parametrize("decode", ["soft", "hard", "monotone"])
def test_apply_matches_jax(nets, decode):
    font, jparams, jcfg, tparams, tcfg = nets
    kw = {"soft": {}, "hard": {"hard": True}, "monotone": {"monotone": True}}[decode]
    codes = encode_codes(STRINGS, 100)
    jm, jl = (np.asarray(a) for a in jp.apply(jparams, jnp.asarray(codes), jcfg, **kw))
    with torch.no_grad():
        tm, tl = (a.numpy() for a in tp.apply(tparams, torch.from_numpy(codes), tcfg, **kw))
    assert tm.shape == jm.shape == (len(STRINGS), 100, 2) and tl.shape == jl.shape
    tol = SOFT_STRUCTURED_MID_TOL if (decode == "soft" and font == "montserrat") else MID_TOL
    err = float(np.abs(tm - jm).max())
    print(f"{font} {decode}: midpoints max abs diff {err:.3g} px (tol {tol}), logits {np.abs(tl - jl).max():.3g}")
    assert err <= tol
    sure = np.abs(jl) > MARGIN
    print(f"{font} {decode}: {int((~sure).sum())} visibility logits within {MARGIN} of 0")
    np.testing.assert_array_equal((tl > 0)[sure], (jl > 0)[sure])


def test_line_logits_and_line_indices_match_jax(nets):
    """line_logits, the argmax lines (hard) and the Viterbi lines (monotone,
    weighted by the contribution or visibility probability) of the port
    equal JAX's wherever JAX's top-two margin exceeds 1e-4."""
    font, jparams, jcfg, tparams, tcfg = nets
    codes = encode_codes(STRINGS, 100)
    jll = np.asarray(jp.line_logits(jparams, jnp.asarray(codes), jcfg))
    with torch.no_grad():
        tll = tp.line_logits(tparams, torch.from_numpy(codes), tcfg).numpy()
    assert float(np.abs(tll - jll).max()) <= MID_TOL
    sure = _top2_margin(jll) > MARGIN
    print(f"{font}: {int((~sure).sum())} of {sure.size} slots within {MARGIN} of a tie")
    np.testing.assert_array_equal(tll.argmax(-1)[sure], jll.argmax(-1)[sure])
    # The Viterbi decode on each package's own logits and weights.
    col = 2 if jp.head_structured(jparams) else 1
    jout = np.asarray(jp._head(jp.font_renderer.features(jparams, jnp.asarray(codes), jcfg),
                               jparams["place_w"], jparams["place_b"]))
    with torch.no_grad():
        tout = tp._head(tfr.features(tparams, torch.from_numpy(codes), tcfg), tparams["place_w"], tparams["place_b"])
    jlines = np.asarray(jp.monotone_lines(jnp.asarray(jll), jax.nn.sigmoid(jout[..., col])))
    tlines = tp.monotone_lines(torch.from_numpy(tll), torch.sigmoid(tout[..., col])).numpy()
    np.testing.assert_array_equal(tlines, jlines)


@pytest.mark.parametrize("hard", [False, True], ids=["soft", "hard"])
def test_structured_x_matches_jax_on_random_logits(hard):
    rng = np.random.default_rng(1)
    B, S, L = 6, 100, 5
    params = {
        "place_adv": rng.uniform(3.0, 11.0, 128).astype(np.float32),
        "place_kern": (rng.standard_normal((128, 128)) * 0.4).astype(np.float32),
    }
    codes = rng.integers(0, 128, (B, S)).astype(np.int32)
    contrib = (rng.standard_normal((B, S)) * 3).astype(np.float32)
    line_log = (rng.standard_normal((B, S, L)) * 3).astype(np.float32)
    want = np.asarray(jp.structured_x({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(codes),
                                      jnp.asarray(contrib), jnp.asarray(line_log), hard=hard))
    got = tp.structured_x({k: torch.from_numpy(v) for k, v in params.items()}, torch.from_numpy(codes),
                          torch.from_numpy(contrib), torch.from_numpy(line_log), hard=hard).numpy()
    print(f"structured_x {'hard' if hard else 'soft'}: max abs diff {np.abs(got - want).max():.3g} px")
    assert np.abs(got - want).max() <= MID_TOL


def test_structured_x_detach_stops_gradients_at_the_structure():
    rng = np.random.default_rng(2)
    params = {"place_adv": torch.from_numpy(rng.uniform(3, 11, 128).astype(np.float32)).requires_grad_(),
              "place_kern": torch.zeros(128, 128)}
    codes = torch.from_numpy(rng.integers(0, 128, (2, 10)))
    contrib = torch.randn(2, 10, requires_grad=True)
    line_log = torch.randn(2, 10, 3, requires_grad=True)
    tp.structured_x(params, codes, contrib, line_log, detach=True).sum().backward()
    assert contrib.grad is None and line_log.grad is None and params["place_adv"].grad.abs().sum() > 0
    tp.structured_x(params, codes, contrib, line_log).sum().backward()
    assert contrib.grad.abs().sum() > 0 and line_log.grad.abs().sum() > 0


def _monotone_cases():
    rng = np.random.default_rng(3)
    B, S, L = 5, 100, 5
    random = (rng.standard_normal((B, S, L)) * 2).astype(np.float32)
    # Integer logits: many exact ties between staying and coming up.
    ties = rng.integers(-1, 2, (B, S, L)).astype(np.float32)
    flat = np.zeros((B, S, L), np.float32)  # every path scores the same
    weight = rng.uniform(0.0, 1.0, (B, S)).astype(np.float32)
    weight[:, ::7] = 0.0  # unsupervised slots carry no weight
    return {"random": (random, None), "ties": (ties, None), "flat": (flat, None),
            "weighted": (random, weight), "weighted_ties": (ties, weight)}


@pytest.mark.parametrize("case", sorted(_monotone_cases()))
def test_monotone_lines_matches_jax(case):
    line_log, weight = _monotone_cases()[case]
    want = np.asarray(jp.monotone_lines(jnp.asarray(line_log), None if weight is None else jnp.asarray(weight)))
    got = tp.monotone_lines(torch.from_numpy(line_log), None if weight is None else torch.from_numpy(weight))
    np.testing.assert_array_equal(got.numpy(), want)
    steps = np.diff(got.numpy(), axis=1)
    assert (got[:, 0] == 0).all() and ((steps == 0) | (steps == 1)).all()
    if case == "flat":
        assert (got == 0).all()  # ties stay on the lower line


@pytest.mark.parametrize(
    "kind,kw,n_out",
    [("regression", {}, 3), ("lines", {"lines": 5}, 7),
     ("structured", {"lines": 4, "advances": True, "uncertainty": True}, 7)],
)
def test_init_matches_jax_keys_shapes_and_bounds(kind, kw, n_out):
    cfg = dataclasses.replace(ModelConfig(), embedding_dim=16, num_heads=2, hidden_dim=24, num_blocks=2)
    jcfg = JaxModelConfig(embedding_dim=16, num_heads=2, hidden_dim=24, num_blocks=2)
    kw = dict(kw)
    if kw.pop("advances", False):
        adv = np.linspace(4.0, 9.0, 128).astype(np.float32)
        kern = np.full((128, 128), -0.5, np.float32)
        kw.update(advances=adv, kerning=kern)
    want = jp.init(jax.random.PRNGKey(0), jcfg, **kw)
    got = tp.init(torch.Generator().manual_seed(0), cfg, device="cpu", **kw)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert got[k].dtype == torch.float32, k
    assert got["place_w"].shape == (24, n_out)
    assert float(got["place_w"].abs().max()) <= 1.0 / 24**0.5
    assert float(got["place_b"].abs().max()) == 0.0
    if "advances" in kw:
        np.testing.assert_array_equal(got["place_adv"].numpy(), kw["advances"])
        np.testing.assert_array_equal(got["place_kern"].numpy(), kw["kerning"])
        assert float(got["loss_logvar"].abs().max()) == 0.0
    assert tp.head_lines(got) == jp.head_lines(want)
    assert tp.head_structured(got) == jp.head_structured(want)
    # The frontend is init_frontend's, which is font_renderer.init's.
    front = tfr.init_frontend(torch.Generator().manual_seed(0), cfg, "cpu")
    full = tfr.init(torch.Generator().manual_seed(0), cfg, "cpu")
    for k, v in front.items():
        assert torch.equal(got[k], v) and torch.equal(full[k], v), k


def test_init_refuses_what_jax_refuses():
    g = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="lines must be 0"):
        tp.init(g, lines=1, device="cpu")
    with pytest.raises(ValueError, match="structured head requires"):
        tp.init(g, advances=np.zeros(128), device="cpu")
    with pytest.raises(ValueError, match=r"\[128\] table"):
        tp.init(g, lines=3, advances=np.zeros(64), device="cpu")


def test_regression_head_has_no_line_logits():
    params = tp.init(torch.Generator().manual_seed(0), dataclasses.replace(ModelConfig(), hidden_dim=16), device="cpu")
    codes = torch.from_numpy(encode_codes(["HI"], 100))
    mids, logits = tp.apply(params, codes, dataclasses.replace(ModelConfig(), hidden_dim=16), monotone=True)
    assert mids.shape == (1, 100, 2) and logits.shape == (1, 100)
    with pytest.raises(ValueError, match="no line logits"):
        tp.line_logits(params, codes, dataclasses.replace(ModelConfig(), hidden_dim=16))
