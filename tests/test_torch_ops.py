"""The port's kernel modules against the JAX package's kernels.

On the CPU each wrapper runs its plain version; these tests hold that plain
version against the Pallas kernel run in interpret mode (as tests/test_ops.py
and tests/test_fused_attention.py run it). The CUDA kernels themselves are
held against the plain versions on the card by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_font_renderer_tpu.models.font_renderer import attention as jax_attention
from ai_font_renderer_tpu.ops.fused_attention import fused_attention as jax_fa
from ai_font_renderer_tpu.ops.fused_attention import fused_attention2 as jax_fa2
from ai_font_renderer_tpu.ops.fused_output import _reference as jax_output_reference
from ai_font_renderer_tpu.ops.fused_output import fused_output as jax_fused_output
from ai_font_renderer_tpu.config import ModelConfig as JaxModelConfig
from ai_font_renderer_tpu_torch.ops import (
    fused_attention,
    fused_attention2,
    fused_attention_reference,
    fused_output,
    fused_output_reference,
)

KEYS = ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo")


def _output_inputs(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.standard_normal((m, k)), 0).astype(np.float32) * 0.2
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(n) * 0.5).astype(np.float32)
    return x, w, b


def _attn_inputs(bsz, s=100, e=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, s, e)).astype(np.float32)
    w = {k: (rng.uniform(-0.3, 0.3, (e, e))).astype(np.float32) for k in KEYS[:4]}
    w.update({k: (rng.standard_normal(e) * 0.1).astype(np.float32) for k in KEYS[4:]})
    return x, w


def test_fused_output_plain_matches_pallas_interpret():
    """Tolerance 1e-5: both sides sum exact bf16 products in f32. K and N
    are multiples of the Pallas kernel's 640-wide tiles: at K = 256,
    N = 384 (multiples of 128, so the kernel is taken) its edge blocks read
    past the arrays and the interpret run returns NaN."""
    x, w, b = _output_inputs(128, 640, 1280)
    want = np.asarray(jax_fused_output(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), True))
    before = fused_output.launches
    got = fused_output(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)).numpy()
    assert fused_output.launches == before  # CPU tensors never launch
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert got.min() == 0.0 and got.max() == 1.0  # clamp engaged on both sides


def test_fused_output_ragged_rows_match_reference():
    """M = 15 (the 15 test strings): the TPU path falls back to _reference
    there; the port's plain version agrees with it within 1e-5."""
    x, w, b = _output_inputs(15, 256, 384, seed=1)
    want = np.asarray(jax_output_reference(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = fused_output_reference(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("entry", ["v1", "v2"])
@pytest.mark.parametrize(
    "dtype,atol",
    # Bounds of tests/test_fused_attention.py: 2e-5 in f32; 0.05 in bf16,
    # where the fused kernel rounds at other places than the plain math.
    [(torch.float32, 2e-5), (torch.bfloat16, 0.05)],
    ids=["f32", "bf16"],
)
def test_fused_attention_plain_matches_pallas_interpret(entry, dtype, atol):
    x, w = _attn_inputs(16)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jx = jnp.asarray(x).astype(jdt)
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    if entry == "v1":
        want = jax_fa(4, 0.0, 8, True, jx, jw, jnp.int32(0))
        fn = fused_attention
    else:
        want = jax_fa2(4, 0.0, 8, 8, True, jx, jw, jnp.int32(0))
        fn = fused_attention2
    tx = torch.from_numpy(x).to(dtype)
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    got = fn(tx, tw, 4)
    assert got.dtype == dtype and got.shape == (16, 100, 32)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=atol
    )


def test_attention_reference_matches_jax_attention_math():
    """The plain version is the JAX model's attention (font_renderer.py:273)."""
    x, w = _attn_inputs(4, s=20)
    want = jax_attention({k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x), JaxModelConfig())
    got = fused_attention_reference(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in w.items()}, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("fn", [fused_attention, fused_attention2])
def test_dropout_waits_for_training_slice(fn):
    x, w = _attn_inputs(2, s=8)
    with pytest.raises(NotImplementedError, match="training slice"):
        fn(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in w.items()}, 4, 0.2)
