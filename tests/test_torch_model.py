"""The port's model (ai_font_renderer_tpu_torch.models.font_renderer) against
the JAX package's, on JAX-initialised parameters carried across with
params_from_jax, at small widths on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_font_renderer_tpu import config as jcfg
from ai_font_renderer_tpu.models import font_renderer as jfr
from ai_font_renderer_tpu_torch import config as tcfg
from ai_font_renderer_tpu_torch.models import AttentionFontRenderer
from ai_font_renderer_tpu_torch.models import font_renderer as tfr

SMALL = dict(max_length=16, hidden_dim=16, sheet_height=16, sheet_width=24)


def _pair(**kw):
    return jcfg.ModelConfig(**SMALL, **kw), tcfg.ModelConfig(**SMALL, **kw)


def _codes(bsz, s, seed=0):
    return np.random.default_rng(seed).integers(32, 127, (bsz, s)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_params():
    jc, _ = _pair()
    return {k: np.asarray(v) for k, v in jfr.init(jax.random.PRNGKey(0), jc).items()}


def _both(params, codes, **kw):
    jc, tc = _pair(**kw)
    want = np.asarray(jfr.apply({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(codes), jc))
    got = tfr.apply(tfr.params_from_jax(params, "cpu"), torch.from_numpy(codes), tc).numpy()
    return got, want


@pytest.mark.parametrize(
    "kw,atol",
    [
        # Strict f32: the same f32 math in another summation order.
        (dict(bf16_matmul=False), 1e-5),
        # bf16 operands of the projection, f32 sums: products are exact.
        (dict(), 1e-4),
        # bf16 frontend: the two frameworks round the bf16 products and sums
        # of the attention/MLP at other places; a flat feature then moves by
        # up to a bf16 ulp and the sheet by that times the projection's
        # gain (about 3.5e-3 seen on these inputs).
        (dict(bf16_frontend=True), 1e-2),
        # The kernel flags on the CPU run each kernel's plain version; the
        # JAX side runs fused_attention in interpret mode and fused_output's
        # plain fallback (M = 8 is no multiple of 128).
        (dict(use_pallas_output=True, fused_attention=True), 1e-4),
        (dict(use_pallas_output=True, fused_attention_v2=True), 1e-4),
    ],
    ids=["f32", "bf16_matmul", "bf16_frontend", "kernels_v1", "kernels_v2"],
)
def test_apply_matches_jax(jax_params, kw, atol):
    got, want = _both(jax_params, _codes(8, 16), **kw)
    assert got.shape == want.shape == (8, 16, 24)
    np.testing.assert_allclose(got, want, atol=atol)


def test_apply_short_sequence_zero_pad(jax_params):
    """Codes shorter than max_length: the flat features are zero-padded."""
    got, want = _both(jax_params, _codes(3, 5, seed=1), bf16_matmul=False)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_apply_long_sequence_truncates(jax_params):
    got, want = _both(jax_params, _codes(2, 40, seed=2), bf16_matmul=False)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_apply_depth_two_matches_jax():
    jc, _ = _pair(num_blocks=2)
    params = {k: np.asarray(v) for k, v in jfr.init(jax.random.PRNGKey(1), jc).items()}
    assert "wq_b1" in params
    for kw, atol in ((dict(bf16_matmul=False), 1e-5), (dict(), 1e-4)):
        got, want = _both(params, _codes(4, 16, seed=3), num_blocks=2, **kw)
        np.testing.assert_allclose(got, want, atol=atol)


def test_frontend_matches_jax(jax_params):
    jc, tc = _pair()
    codes = _codes(4, 16, seed=4)
    want = jfr.frontend({k: jnp.asarray(v) for k, v in jax_params.items()}, jnp.asarray(codes), jc)
    got = tfr.frontend(tfr.params_from_jax(jax_params, "cpu"), torch.from_numpy(codes), tc)
    assert got.shape == (4, 16 * 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_module_carries_jax_key_names(jax_params):
    _, tc = _pair()
    model = AttentionFontRenderer(tfr.params_from_jax(jax_params, "cpu"), tc)
    assert set(model.state_dict()) == set(jax_params)
    codes = torch.from_numpy(_codes(2, 16))
    with torch.no_grad():
        out = model(codes)
    np.testing.assert_array_equal(out.numpy(), tfr.apply(model.params(), codes, tc).numpy())

    other = AttentionFontRenderer(tfr.init(torch.Generator().manual_seed(5), tc, "cpu"), tc)
    other.load_jax_params(jax_params)
    for k, v in jax_params.items():
        np.testing.assert_array_equal(other.state_dict()[k].numpy(), v)
    back = tfr.params_to_numpy(other.params())
    assert all(np.array_equal(back[k], v) for k, v in jax_params.items())


@pytest.mark.parametrize("num_blocks", [1, 3])
def test_init_matches_jax_layout_and_distributions(num_blocks):
    jc, tc = _pair(num_blocks=num_blocks)
    want = jfr.init(jax.random.PRNGKey(0), jc)
    got = tfr.init(torch.Generator().manual_seed(0), tc, "cpu")
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert got[k].dtype == torch.float32
    flat = tc.max_length * tc.hidden_dim
    assert float(got["out_w"].abs().max()) <= 1.0 / flat**0.5
    assert abs(float(got["embedding"].std()) - 1.0) < 0.05
    assert float(got["bq"].abs().max()) == 0.0 and float(got["ln_scale"].min()) == 1.0


def test_infer_model_config_matches_jax():
    jc, tc = _pair(num_blocks=2)
    params = {k: np.asarray(v) for k, v in jfr.init(jax.random.PRNGKey(0), jc).items()}
    want = jfr.infer_model_config(params, jcfg.ModelConfig())
    got = tfr.infer_model_config(params, tcfg.ModelConfig())
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_config_fields_and_defaults_match_jax():
    assert dataclasses.asdict(tcfg.ModelConfig()) == dataclasses.asdict(jcfg.ModelConfig())
    assert dataclasses.asdict(tcfg.SheetSpec()) == dataclasses.asdict(jcfg.SheetSpec())
    assert tcfg.replace(tcfg.ModelConfig(), hidden_dim=8).hidden_dim == 8


def test_constraint_and_not_ported_errors(jax_params):
    params = tfr.params_from_jax(jax_params, "cpu")
    codes = torch.from_numpy(_codes(2, 16))
    for kw in (dict(leaky_clamp=0.1), dict(bf16_cotangent=True)):
        _, tc = _pair(use_pallas_output=True, **kw)
        with pytest.raises(ValueError, match="use_pallas_output"):
            tfr.apply(params, codes, tc)
    _, tc = _pair(bf16_cotangent=True, bf16_matmul=False)
    with pytest.raises(ValueError, match="bf16_cotangent"):
        tfr.apply(params, codes, tc)
    # The conv decoders are ported: init and apply run, and on JAX's
    # parameters apply matches JAX's (f32 stages, the f32 bound).
    for decoder in ("conv", "conv_ps"):
        jc, tc = _pair(decoder=decoder, decoder_grid=(4, 4), bf16_matmul=False)
        assert "dec_out_w" in tfr.init(torch.Generator(), tc, "cpu")
        conv = {k: np.asarray(v) for k, v in jfr.init(jax.random.PRNGKey(0), jc).items()}
        want = np.asarray(jfr.apply(conv, jnp.asarray(codes.numpy()), jc))
        got = tfr.apply(tfr.params_from_jax(conv, "cpu"), codes, tc).numpy()
        assert got.shape == (2, 16, 24) and float(np.abs(got - want).max()) <= 1e-5
