"""The port's conv decoders ("conv", "conv_ps") against the JAX package's,
on the CPU: the plans, the resize and depth-to-space stages, the forward at
the default plan, gradients, AdamW steps, configs, checkpoints and the CLI.
Parameters are JAX-initialised and carried across with params_from_jax;
inputs are made from numpy seeds."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_font_renderer_tpu import config as jcfg
from ai_font_renderer_tpu.models import font_renderer as jfr
from ai_font_renderer_tpu.train import step as jstep
from ai_font_renderer_tpu.utils import checkpoint as jckpt
from ai_font_renderer_tpu.utils.torch_interop import to_state_dict as jax_to_state_dict
from ai_font_renderer_tpu_torch import cli
from ai_font_renderer_tpu_torch import config as tcfg
from ai_font_renderer_tpu_torch.fontgen.bmp import read_bmp
from ai_font_renderer_tpu_torch.models import font_renderer as tfr
from ai_font_renderer_tpu_torch.ops import fused_attention, fused_attention2
from ai_font_renderer_tpu_torch.train import step as tstep
from ai_font_renderer_tpu_torch.utils import checkpoint as tckpt
from ai_font_renderer_tpu_torch.utils.torch_interop import to_state_dict
from test_torch_native_build import install_reference_native

install_reference_native()

DECODERS = ("conv", "conv_ps")
NO_DROPOUT = dict(dropout_rate=0.0, fc_dropout_rate=0.0)
# A narrowed model for the steps: 24 slots on a 4 x 6 grid, a 20 x 60
# sheet (conv_ps factors (1, 1, 1, 5) and (2, 1, 1, 5)), channels cut.
NARROW = dict(max_length=24, sheet_height=20, sheet_width=60, decoder_grid=(4, 6),
              decoder_channels=(32, 32, 16, 16, 8))
# The f32 forward's bound, that of tests/test_torch_parity.py.
F32_ATOL = 1e-5
# bf16 hidden stages: the two frameworks' convolutions sum in other orders
# before each bf16 rounding, so an activation may round to the other bf16
# neighbour and the ink stage carries that on (8.4e-5 measured at B = 4,
# default plan, pre-clamp).
BF16_ATOL = 1e-3


def _pair(**kw):
    jm = jcfg.ModelConfig(**kw)
    return jm, tcfg.ModelConfig(**dataclasses.asdict(jm))


def _codes(bsz, length, seed=0):
    return np.random.default_rng(seed).integers(32, 127, (bsz, length)).astype(np.int32)


def _np(params):
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def default_params():
    """JAX-initialised parameters of each decoder at the default plan."""
    return {d: _np(jfr.init(jax.random.PRNGKey(0), jcfg.ModelConfig(decoder=d))) for d in DECODERS}


# --- plans ------------------------------------------------------------------


def test_default_plans_are_pinned():
    _, tm = _pair(decoder="conv")
    assert [p[:2] for p in tfr._decoder_plan(tm)] == [(10, 40), (20, 80), (40, 160), (80, 240)]
    assert [p[2:] for p in tfr._decoder_plan(tm)] == [(128, 128), (128, 64), (64, 32), (32, 16)]
    _, tm = _pair(decoder="conv_ps")
    assert [p[:2] for p in tfr._decoder_plan_ps(tm)] == [(2, 2), (2, 2), (2, 1), (2, 3)]
    assert [p[2:] for p in tfr._decoder_plan_ps(tm)] == [(128, 128), (128, 64), (64, 32), (32, 16)]


PLAN_CASES = {
    "default": {},
    "narrow": NARROW,
    "three_stages": dict(decoder_channels=(64, 32, 16, 8)),
    "wide_grid": dict(max_length=40, decoder_grid=(2, 20), decoder_channels=(32, 32, 16, 8, 8, 4)),
    "tall_sheet": dict(max_length=16, sheet_height=96, sheet_width=48, decoder_grid=(4, 4)),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plans_match_jax(case):
    for decoder in DECODERS:
        jm, tm = _pair(decoder=decoder, **PLAN_CASES[case])
        assert tfr._decoder_plan(tm) == jfr._decoder_plan(jm)
        assert tfr._decoder_plan_ps(tm) == jfr._decoder_plan_ps(jm)


@pytest.mark.parametrize("ratio,n", [(16, 4), (12, 4), (15, 3), (1, 4), (7, 1), (48, 5)])
def test_ps_factors_match_jax(ratio, n):
    got = tfr._ps_factors(ratio, n)
    assert got == jfr._ps_factors(ratio, n) and int(np.prod(got)) == ratio


@pytest.mark.parametrize(
    "decoder,kw,words",
    [
        ("conv", dict(decoder_grid=(7, 13)), "must tile max_length"),
        ("conv_ps", dict(decoder_grid=(7, 13)), "must tile max_length"),
        ("conv_ps", dict(decoder_grid=(4, 25)), "must divide the sheet"),
    ],
)
def test_decoder_field_rules_match_jax(decoder, kw, words):
    """The port checks the rules when the config is made; the JAX package
    when it initialises (and plans) the decoder. Same message."""
    jm = jcfg.ModelConfig(decoder=decoder, **kw)
    with pytest.raises(ValueError, match=words) as jerr:
        jfr.init(jax.random.PRNGKey(0), jm)
    with pytest.raises(ValueError, match=words) as terr:
        tcfg.ModelConfig(decoder=decoder, **kw)
    assert str(terr.value) == str(jerr.value)


def test_conv_grid_need_not_divide_the_sheet():
    """Only conv_ps needs the grid to divide the sheet: conv resizes."""
    jm, tm = _pair(decoder="conv", decoder_grid=(4, 25))
    assert tfr._decoder_plan(tm) == jfr._decoder_plan(jm)
    assert tfr._decoder_plan(tm)[-1][:2] == (80, 240)


# --- init -------------------------------------------------------------------


@pytest.mark.parametrize("decoder", DECODERS)
def test_init_matches_jax_keys_shapes_and_bounds(decoder, default_params):
    jm, tm = _pair(decoder=decoder)
    want = default_params[decoder]
    got = tfr.init(torch.Generator().manual_seed(0), tm, "cpu")
    assert list(got) == list(want)
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    assert all(v.dtype == torch.float32 for v in got.values())
    h, chans = tm.hidden_dim, tm.decoder_channels
    bounds = {"dec_in_w": h**-0.5, "dec_in_b": h**-0.5, "dec_out_w": (9 * chans[-1]) ** -0.5}
    for i, c in enumerate(chans[:-1]):
        bounds[f"dec_w{i}"] = bounds[f"dec_b{i}"] = (9 * c) ** -0.5
    for k, bound in bounds.items():
        assert float(got[k].abs().max()) <= bound and float(np.abs(want[k]).max()) <= bound, k
        # Uniform draws fill their range: the largest lies near the bound.
        assert float(got[k].abs().max()) > 0.5 * bound, k
    assert float(got["dec_out_b"]) == float(want["dec_out_b"][0]) == 1.0
    assert "out_w" not in got and tfr.param_count(got) == sum(v.size for v in want.values())


# --- the stages on their own ------------------------------------------------


@pytest.mark.parametrize("src,dst", [((40, 160), (80, 240)), ((10, 40), (20, 80)), ((5, 20), (80, 240))])
def test_resize_matches_jax_image_resize(src, dst):
    """Nearest resize at the conv plan's stages; 160 -> 240 (ratio 1.5) is
    where torch's "nearest" would pick another source column."""
    x = np.random.default_rng(1).standard_normal((2, *src, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst, 3), "nearest"))
    got = tfr._resize(torch.from_numpy(x), *dst).numpy()
    np.testing.assert_array_equal(got, want)


def test_torchs_nearest_differs_from_jax_at_ratio_1_5():
    """Why _resize uses "nearest-exact": "nearest" takes floor(i * 2/3),
    JAX floor((i + 0.5) * 2/3), which differ in 80 of 240 columns."""
    x = torch.arange(160, dtype=torch.float32).reshape(1, 1, 1, 160)
    exact = tfr._resize(x.permute(0, 2, 3, 1), 1, 240)[0, 0, :, 0]
    nearest = torch.nn.functional.interpolate(x, size=(1, 240), mode="nearest")[0, 0, 0]
    assert int((exact != nearest).sum()) == 80


def _jax_depth_to_space(x, fy, fx):
    """ai_font_renderer_tpu/models/font_renderer.py:463-468, as written."""
    B, hh, ww, k = x.shape
    cout = k // (fy * fx)
    x = x.reshape(B, hh, ww, fy, fx, cout)
    return x.transpose(0, 1, 3, 2, 4, 5).reshape(B, hh * fy, ww * fx, cout)


@pytest.mark.parametrize("fy,fx", [(2, 1), (2, 3), (2, 2), (1, 5)])
def test_depth_to_space_matches_jax(fy, fx):
    x = np.random.default_rng(2).standard_normal((2, 5, 7, fy * fx * 4)).astype(np.float32)
    want = np.asarray(_jax_depth_to_space(jnp.asarray(x), fy, fx))
    got = tfr._depth_to_space(torch.from_numpy(x), fy, fx).numpy()
    np.testing.assert_array_equal(got, want)


# --- forward ----------------------------------------------------------------


def _forward_pair(params, decoder, bf16):
    jm, tm = _pair(decoder=decoder, bf16_matmul=bf16)
    codes = _codes(4, 100)
    flat = np.asarray(jfr.frontend(params, jnp.asarray(codes), jm))
    tp = tfr.params_from_jax(params, "cpu")
    pre = (np.asarray(jfr.conv_decode(params, jnp.asarray(flat), jm)),
           tfr.conv_decode(tp, torch.from_numpy(flat.copy()), tm).numpy())
    out = (np.asarray(jfr.apply(params, jnp.asarray(codes), jm)), tfr.apply(tp, torch.from_numpy(codes), tm).numpy())
    return pre, out


@pytest.mark.parametrize("decoder", DECODERS)
def test_forward_f32_matches_jax_at_the_default_plan(decoder, default_params):
    """Before the clamp (most pixels sit above 1 at init, where the clamp
    would hide a difference) and after it, to the f32 bound."""
    (jpre, tpre), (jout, tout) = _forward_pair(default_params[decoder], decoder, bf16=False)
    assert tpre.shape == (4, 80, 240) and tout.shape == (4, 80, 240)
    assert float(np.abs(tpre - jpre).max()) <= F32_ATOL
    assert float(np.abs(tout - jout).max()) <= F32_ATOL
    assert tpre.std() > 1e-3  # the decoder's output is not constant


@pytest.mark.parametrize("decoder", DECODERS)
def test_forward_bf16_matches_jax_at_the_default_plan(decoder, default_params):
    (jpre, tpre), (jout, tout) = _forward_pair(default_params[decoder], decoder, bf16=True)
    assert float(np.abs(tpre - jpre).max()) <= BF16_ATOL
    assert float(np.abs(tout - jout).max()) <= BF16_ATOL


@pytest.mark.parametrize("decoder", DECODERS)
def test_projection_flags_do_not_touch_a_conv_decoder(decoder, default_params):
    """As in the JAX package, the conv branch comes before
    use_pallas_output and bf16_cotangent: the same sheets either way, and
    no output kernel on a conv model."""
    tp = tfr.params_from_jax(default_params[decoder], "cpu")
    codes = torch.from_numpy(_codes(2, 100))
    plain = tfr.apply(tp, codes, tcfg.ModelConfig(decoder=decoder))
    for kw in (dict(use_pallas_output=True), dict(bf16_cotangent=True)):
        torch.testing.assert_close(tfr.apply(tp, codes, tcfg.ModelConfig(decoder=decoder, **kw)), plain,
                                   rtol=0, atol=0)


@pytest.mark.parametrize("decoder", DECODERS)
def test_leaky_clamp_in_training_matches_jax(decoder):
    """train=True with dropout off: the leaky clamp of the JAX package on
    the conv sheet (whose pixels exceed 1 at init, so the slope shows)."""
    jm, tm = _pair(decoder=decoder, bf16_matmul=False, leaky_clamp=0.05, **NARROW, **NO_DROPOUT)
    params = _np(jfr.init(jax.random.PRNGKey(4), jm))
    codes = _codes(4, 24, seed=3)
    want = np.asarray(jfr.apply(params, jnp.asarray(codes), jm, train=True, key=jax.random.PRNGKey(0)))
    got = tfr.apply(tfr.params_from_jax(params, "cpu"), torch.from_numpy(codes), tm, train=True,
                    generator=torch.Generator().manual_seed(0)).numpy()
    assert want.max() > 1.0
    assert float(np.abs(got - want).max()) <= F32_ATOL


# --- gradients and steps ----------------------------------------------------


def _mse_grads_jax(params, codes, targets, jm):
    def loss(p):
        return jnp.mean((jfr.apply(p, jnp.asarray(codes), jm) - jnp.asarray(targets)) ** 2)

    return jax.grad(loss)({k: jnp.asarray(v) for k, v in params.items()})


@pytest.mark.parametrize("decoder", DECODERS)
def test_mse_gradients_match_jax(decoder):
    """The MSE's gradient at dropout 0, f32, for every parameter, to 1e-4
    of its largest value (bk: 0 in exact arithmetic, rounding noise on
    both sides, held to 1e-4 of bq's). The ink bias starts at 0.5 so that
    most pixels lie inside the clamp and carry a gradient."""
    jm, tm = _pair(decoder=decoder, bf16_matmul=False, **NARROW, **NO_DROPOUT)
    params = _np(jfr.init(jax.random.PRNGKey(5), jm))
    params["dec_out_b"] = np.full((1,), 0.5, np.float32)
    codes = _codes(4, 24, seed=6)
    targets = np.random.default_rng(7).uniform(size=(4, 20, 60)).astype(np.float32)
    jgrads = _mse_grads_jax(params, codes, targets, jm)
    tp = tstep._trainable(tfr.params_from_jax(params, "cpu"))
    loss = tstep.mse_loss(tfr.apply(tp, torch.from_numpy(codes), tm), torch.from_numpy(targets))
    grads = dict(zip(tp, torch.autograd.grad(loss, list(tp.values()))))
    for k, g in grads.items():
        want = np.asarray(jgrads[k])
        if k == "bk":
            assert float(g.abs().max()) <= 1e-4 * float(np.abs(np.asarray(jgrads["bq"])).max())
            continue
        scale = float(np.abs(want).max())
        assert scale > 0, k
        assert float(np.abs(g.numpy() - want).max()) <= 1e-4 * scale, k


# f32 stages: under bf16_matmul the JAX package's gradients of the conv
# biases on the CPU are far from its f32 ones (see
# test_bf16_gradients_match_jax_but_the_conv_biases), so the steps are held
# against JAX in f32.
STEP_CASES = {
    # name: (decoder, model kw, loss rel tol, (mu, nu) tol of the largest value)
    "conv": ("conv", {}, 1e-5, (2.0**-8, 1e-4)),
    "conv_ps": ("conv_ps", {}, 1e-5, (2.0**-8, 1e-4)),
    "conv_ps_leaky": ("conv_ps", dict(leaky_clamp=0.05), 1e-5, (2.0**-8, 1e-4)),
    "conv_three_stages": ("conv", dict(decoder_channels=(32, 16, 16, 8)), 1e-5, (2.0**-8, 1e-4)),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_three_steps_match_jax(case):
    """As tests/test_torch_train.py::test_three_steps_match_jax, on the
    narrowed conv decoders: three standard AdamW steps (optax's AdamW
    decays every parameter) from a JAX state 3 steps in, dropout off."""
    decoder, mkw, loss_tol, (mu_tol, nu_tol) = STEP_CASES[case]
    jm, tm = _pair(decoder=decoder, bf16_matmul=False, **{**NARROW, **NO_DROPOUT, **mkw})
    jt = jcfg.TrainConfig(batch_size=8, num_samples=96)
    tt = tcfg.TrainConfig(**dataclasses.asdict(jt))
    codes = _codes(8, 24, seed=8)
    targets = np.random.default_rng(9).uniform(size=(8, 20, 60)).astype(np.float32)
    jc, jtg = jnp.asarray(codes), jnp.asarray(targets)
    state = jstep.init_state(jax.random.PRNGKey(0), jm, jt)
    for i in range(3):
        state, _ = jstep.train_step(state, jc, jtg, jnp.float32(1e-3), jax.random.PRNGKey(i), jm, jt)
    port = tstep.train_state_from_jax(jax.tree.map(np.asarray, state), "cpu")
    assert set(port.params) == set(port.mu) and "dec_out_w" in port.params
    gen = torch.Generator().manual_seed(0)
    for i in range(3):
        state, jl = jstep.train_step(state, jc, jtg, jnp.float32(1e-3), jax.random.PRNGKey(10 + i), jm, jt)
        port, tl = tstep.train_step(port, torch.from_numpy(codes), torch.from_numpy(targets), 1e-3, gen, tm, tt)
        assert abs(float(tl) - float(jl)) <= loss_tol * float(jl), (i, float(tl), float(jl))
    adam = state.opt_state[0]
    assert float(np.abs(np.asarray(adam.nu["embedding"])).max()) > 0  # the gradient reaches the frontend
    for k in port.mu:
        if k == "bk":
            continue
        for got, want, tol in ((port.mu[k].float(), adam.mu[k], mu_tol), (port.nu[k], adam.nu[k], nu_tol)):
            want = np.asarray(want).astype(np.float32)
            assert float(np.abs(got.numpy() - want).max()) <= tol * float(np.abs(want).max()) + 1e-30, k


def _port_grads(params, codes, targets, tm):
    tp = tstep._trainable(tfr.params_from_jax(params, "cpu"))
    loss = tstep.mse_loss(tfr.apply(tp, torch.from_numpy(codes), tm), torch.from_numpy(targets))
    return dict(zip(tp, (g.numpy() for g in torch.autograd.grad(loss, list(tp.values())))))


@pytest.mark.parametrize("decoder", DECODERS)
def test_bf16_gradients_match_jax_but_the_conv_biases(decoder):
    """The MSE's gradient under bf16_matmul (bf16 hidden stages), dropout
    off: each parameter's within 2e-2 of its largest value of JAX's (0.011
    measured, dec_in_b of conv_ps). But the conv biases dec_b{i}: the JAX
    package on the CPU sums their bf16 cotangent over B x H x W in bf16, so
    its gradients lie up to 0.39 of the largest from its own f32 ones
    (dec_b3 of conv); the port's are held to 0.05 of the f32 gradient
    instead (0.040 measured, dec_b0 of conv_ps)."""
    jm32, tm32 = _pair(decoder=decoder, bf16_matmul=False, **NARROW, **NO_DROPOUT)
    jm16, tm16 = _pair(decoder=decoder, **NARROW, **NO_DROPOUT)
    params = _np(jfr.init(jax.random.PRNGKey(0), jm32))
    codes = _codes(8, 24, seed=8)
    targets = np.random.default_rng(9).uniform(size=(8, 20, 60)).astype(np.float32)
    f32 = _mse_grads_jax(params, codes, targets, jm32)
    want = _mse_grads_jax(params, codes, targets, jm16)
    got = _port_grads(params, codes, targets, tm16)
    for k in got:
        if k == "bk":  # 0 in exact arithmetic
            continue
        ref, tol = (f32, 0.05) if k.startswith("dec_b") else (want, 2e-2)
        ref = np.asarray(ref[k])
        assert float(np.abs(got[k] - ref).max()) <= tol * float(np.abs(ref).max()), k


@pytest.mark.parametrize("flag", ["fused_attention", "fused_attention_v2"])
def test_one_step_with_a_fused_attention_flag_and_conv_ps_matches_jax(flag):
    """One standard step of conv_ps (f32 stages) with an attention flag at
    rate 0: the JAX step runs the Pallas kernel in interpret mode, the
    port's its Function's plain versions on the CPU (no launch). Loss to
    1e-4, the moments of every parameter to one bf16 step (mu) and 1e-3
    (nu)."""
    jm, tm = _pair(decoder="conv_ps", bf16_matmul=False, **NARROW, **NO_DROPOUT, **{flag: True})
    jt = jcfg.TrainConfig(batch_size=16, num_samples=96)
    tt = tcfg.TrainConfig(**dataclasses.asdict(jt))
    codes = _codes(16, 24, seed=10)
    targets = np.random.default_rng(11).uniform(size=(16, 20, 60)).astype(np.float32)
    state = jstep.init_state(jax.random.PRNGKey(1), jm, jt)
    port = tstep.train_state_from_jax(jax.tree.map(np.asarray, state), "cpu")
    state, jl = jstep.train_step(state, jnp.asarray(codes), jnp.asarray(targets), jnp.float32(1e-3),
                                 jax.random.PRNGKey(0), jm, jt)
    before = (fused_attention.launches, fused_attention2.launches)
    port, tl = tstep.train_step(port, torch.from_numpy(codes), torch.from_numpy(targets), 1e-3,
                                torch.Generator().manual_seed(0), tm, tt)
    assert (fused_attention.launches, fused_attention2.launches) == before
    assert abs(float(tl) - float(jl)) <= 1e-4 * float(jl)
    adam = state.opt_state[0]
    for k in port.mu:
        if k == "bk":
            continue
        for got, want, tol in ((port.mu[k].float(), adam.mu[k], 2.0**-8), (port.nu[k], adam.nu[k], 1e-3)):
            want = np.asarray(want).astype(np.float32)
            assert float(np.abs(got.numpy() - want).max()) <= tol * float(np.abs(want).max()) + 1e-30, k


@pytest.mark.parametrize(
    "tkw,words",
    [(dict(fused_dw_adamw=True), "fused_dw_adamw fuses the linear decoder's out_w update"),
     (dict(handrolled_bwd=True), "handrolled_bwd hand-codes the linear projection")],
)
def test_linear_only_steps_refuse_a_conv_decoder_as_jax(tkw, words):
    jm, tm = _pair(decoder="conv_ps", **NARROW)
    jt = jcfg.TrainConfig(batch_size=4, **tkw)
    tt = tcfg.TrainConfig(**dataclasses.asdict(jt))
    codes = _codes(4, 24)
    targets = np.zeros((4, 20, 60), np.float32)
    with pytest.raises(ValueError, match=words) as jerr:
        if tt.fused_dw_adamw:
            jstep.init_fused_state(jax.random.PRNGKey(0), jm, jt)
        else:
            state = jstep.init_state(jax.random.PRNGKey(0), jm, jt)
            jstep._handrolled_step(state, jnp.asarray(codes), jnp.asarray(targets), jnp.float32(1e-3),
                                   jax.random.PRNGKey(1), jm, jt)
    with pytest.raises(ValueError, match=words) as terr:
        if tt.fused_dw_adamw:
            tstep.init_fused_state(torch.Generator(), tm, tt, "cpu")
        else:
            state = tstep.init_state(torch.Generator(), tm, tt, "cpu")
            tstep.train_step(state, torch.from_numpy(codes), torch.from_numpy(targets), 1e-3,
                             torch.Generator(), tm, tt)
    assert str(terr.value) == str(jerr.value)


# --- configs and checkpoints ------------------------------------------------


INFER_CASES = {
    "conv": dict(decoder="conv"),
    "conv_ps": dict(decoder="conv_ps"),
    # 24 slots: the grid comes from the sheet's aspect, (3, 8).
    "narrow_conv": dict(decoder="conv", **NARROW),
    "conv_ps_3_stages": dict(decoder="conv_ps", decoder_channels=(64, 32, 16, 8)),
}


@pytest.mark.parametrize("case", list(INFER_CASES))
def test_infer_model_config_matches_jax_on_conv_dicts(case):
    jm, _ = _pair(**INFER_CASES[case])
    params = _np(jfr.init(jax.random.PRNGKey(0), jm))
    want = jfr.infer_model_config(params)
    got = tfr.infer_model_config(tfr.params_from_jax(params, "cpu"))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.decoder == jm.decoder and got.decoder_channels == jm.decoder_channels


def test_infer_refuses_a_grid_that_conv_ps_cannot_plan():
    """A conv_ps dict of 24 slots without its config: both packages infer
    the grid (3, 8), which does not divide the 80 x 240 sheet. The JAX
    package returns that config and refuses it when it plans the decoder;
    the port refuses it when it makes the config, with the same message."""
    jm, _ = _pair(decoder="conv_ps", **NARROW)
    params = _np(jfr.init(jax.random.PRNGKey(0), jm))
    inferred = jfr.infer_model_config(params)
    assert inferred.decoder_grid == (3, 8)
    with pytest.raises(ValueError, match="must divide the sheet") as jerr:
        jfr._decoder_plan_ps(inferred)
    with pytest.raises(ValueError, match="must divide the sheet") as terr:
        tfr.infer_model_config(tfr.params_from_jax(params, "cpu"))
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("decoder", DECODERS)
def test_npz_round_trip_in_both_directions(decoder, tmp_path):
    jm, tm = _pair(decoder=decoder, **NARROW)
    params = _np(jfr.init(jax.random.PRNGKey(2), jm))
    jax_file, port_file = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jckpt.save_params(params, jax_file, jm)
    tparams, tcfg_loaded = tckpt.load_params_with_config(jax_file, device="cpu")
    assert dataclasses.asdict(tcfg_loaded) == dataclasses.asdict(tm)
    assert list(tparams) == list(params)
    for k, v in params.items():
        np.testing.assert_array_equal(tparams[k].numpy(), v)
    tckpt.save_params(tparams, port_file, tcfg_loaded)
    jparams, jcfg_loaded = jckpt.load_params_with_config(port_file)
    assert dataclasses.asdict(jcfg_loaded) == dataclasses.asdict(jm)
    for k, v in params.items():
        np.testing.assert_array_equal(np.asarray(jparams[k]), v)


def test_pth_stays_refused_for_a_conv_dict_as_in_jax(default_params):
    params = default_params["conv_ps"]
    with pytest.raises(ValueError, match="conv/conv_ps checkpoints cannot be exported") as jerr:
        jax_to_state_dict(params)
    with pytest.raises(ValueError, match="conv/conv_ps checkpoints cannot be exported") as terr:
        to_state_dict(tfr.params_from_jax(params, "cpu"))
    assert str(terr.value) == str(jerr.value)


# --- the CLI ----------------------------------------------------------------


@pytest.fixture(scope="module")
def conv_run(tmp_path_factory):
    """--train --decoder conv_ps on the CPU, narrowed, in its own directory:
    (working directory, output directory, exit code)."""
    mp = pytest.MonkeyPatch()
    work = tmp_path_factory.mktemp("conv_run")
    configs = cli._configs

    def small(args):
        mcfg, tcfg_ = configs(args)
        return tcfg.replace(mcfg, max_length=16, hidden_dim=16, sheet_height=16, sheet_width=24,
                            decoder_grid=(4, 4)), tcfg_

    mp.setattr(cli, "_configs", small)
    mp.chdir(work)
    out = str(work / "run")
    try:
        rc = cli.main(["--train", "--decoder", "conv_ps", "--decoder-channels", "16,16,8,8,4", "--device", "cpu",
                       "--samples", "80", "--epochs", "2", "--batch-size", "16", "--output", out])
    finally:
        mp.undo()
    return work, out, rc


def test_train_conv_ps_on_the_cpu_writes_weights_and_bmps(conv_run):
    work, out, rc = conv_run
    assert rc == 0
    assert {f"string_{i}.bmp" for i in range(15)} <= set(os.listdir(out))
    assert read_bmp(os.path.join(out, "string_0.bmp")).shape == (16, 24)
    params, mcfg = tckpt.load_params_with_config(str(work / "font_renderer.npz"), device="cpu")
    assert (mcfg.decoder, mcfg.decoder_grid, mcfg.decoder_channels) == ("conv_ps", (4, 4), (16, 16, 8, 8, 4))
    assert "out_w" not in params and params["dec_w0"].shape == (3, 3, 16, 16 * 2 * 2)
    metrics = [line for line in open(os.path.join(out, "metrics.jsonl")) if "train_loss" in line]
    assert len(metrics) == 2


def test_trained_conv_npz_loads_in_jax_and_renders_alike(conv_run, tmp_path):
    """The conv run's npz in the JAX package: the same config; the port's
    render CLI writes BMPs within one gray level of JAX's render."""
    from ai_font_renderer_tpu.render.render import render_batch as jax_render_batch

    work, _, _ = conv_run
    weights = str(work / "font_renderer.npz")
    jparams, jm = jckpt.load_params_with_config(weights)
    assert (jm.decoder, jm.decoder_grid, jm.decoder_channels) == ("conv_ps", (4, 4), (16, 16, 8, 8, 4))
    out = str(tmp_path / "r")
    assert cli.main(["render", "HELLO", "CONV", "--weights", weights, "--out", out, "--device", "cpu"]) == 0
    want = np.round(np.clip(jax_render_batch(jparams, ["HELLO", "CONV"], jm), 0, 1) * 255)
    for i in range(2):
        got = np.round(read_bmp(os.path.join(out, f"string_{i}.bmp")) * 255)
        assert np.abs(got - want[i]).max() <= 1


def test_eval_runs_on_a_conv_checkpoint(conv_run, capsys):
    work, _, _ = conv_run
    capsys.readouterr()
    assert cli.main(["eval", "--weights", str(work / "font_renderer.npz"), "--num-samples", "40",
                     "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["val_samples"] == 8 and 0 < got["val_mse"] < 1


@pytest.mark.parametrize("decoder", DECODERS)
@pytest.mark.parametrize("kernels", ["output", "fused"])
def test_projection_kernels_with_a_conv_decoder_exit_1(decoder, kernels, tmp_path, capsys):
    """--kernels output|fused selects kernels of the linear head's
    projection; with a conv decoder they would launch nothing, so the run
    is refused before anything is written."""
    out = tmp_path / "o"
    assert cli.main(["--train", "--decoder", decoder, "--kernels", kernels, "--output", str(out),
                     "--device", "cpu"]) == 1
    text = capsys.readouterr().out
    assert "the output-projection kernels need the linear decoder" in text and f"--decoder {decoder}" in text
    assert not os.path.exists(out)


def _seen_configs(monkeypatch):
    seen = {}

    def fake_run_training(mcfg, tcfg_, output_dir, font=None, checkpoint_dir=None, resume=False, device=None,
                          mesh=None):
        seen.update(mcfg=mcfg, tcfg=tcfg_)
        raise SystemExit(0)

    monkeypatch.setattr(cli, "run_training", fake_run_training)
    return seen


@pytest.mark.parametrize("decoder", DECODERS)
def test_fast_profile_keeps_the_standard_step_for_conv(decoder, monkeypatch, tmp_path):
    """As the JAX CLI (cli.py:885-892): --profile fast sets the bf16
    frontend and bits dropout, and the hand-rolled backward only for the
    linear decoder; --decoder-channels reaches the config."""
    seen = _seen_configs(monkeypatch)
    with pytest.raises(SystemExit):
        cli.main(["--train", "--profile", "fast", "--decoder", decoder, "--decoder-channels", "32,16,8",
                  "--output", str(tmp_path / "o"), "--device", "cpu"])
    m, t = seen["mcfg"], seen["tcfg"]
    assert m.decoder == decoder and m.decoder_channels == (32, 16, 8)
    assert m.bf16_frontend and m.bits_dropout and not t.handrolled_bwd
