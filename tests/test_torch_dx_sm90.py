"""K2's two-pass design on the CPU: the operand pass and the GEMM's plain
versions against the JAX package's ``_dx_kernel``.

On the card K2 is ``round_bf16`` (g masked and rounded to bf16, W rounded,
both zero-padded to a multiple of 8 columns) and then ``gemm_bf16_tn``. On
the CPU every wrapper takes its plain version; these tests hold those plain
versions against the bf16 operands the Pallas kernel forms
(ai_font_renderer_tpu/ops/fused_output.py, ``_dx_kernel``) and against the
kernel itself in interpret mode. The CUDA kernels are held against the same
plain versions on the card by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_font_renderer_tpu.ops.fused_output import _dx_pallas
from ai_font_renderer_tpu_torch.ops import (
    dx_operands_reference,
    fused_output_dx,
    fused_output_dx_reference,
    gemm_bf16_tn,
    gemm_bf16_tn_reference,
    round_bf16,
    round_bf16_reference,
)
from ai_font_renderer_tpu_torch.ops.fused_output import padded_width


def _dx_inputs(m, k, n, seed):
    """g, out, w as numpy f32; out holds values exactly at 0 and 1 (the
    clamp's bounds, where the mask stops g), below 0, above 1 and inside."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((m, n)).astype(np.float32)
    out = rng.uniform(-0.2, 1.2, (m, n)).astype(np.float32)
    out[:, ::5] = 0.0
    out[:, 2::5] = 1.0
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    return g, out, w


def _jax_operands(g, out, w):
    """The bf16 operands _dx_kernel forms (fused_output.py:104-108)."""
    o = jnp.asarray(out)
    gm = jnp.where((o > 0.0) & (o < 1.0), jnp.asarray(g), 0.0).astype(jnp.bfloat16)
    return np.asarray(gm), np.asarray(jnp.asarray(w).astype(jnp.bfloat16))


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


@pytest.mark.parametrize(
    "m,k,n,seed",
    [(37, 24, 301, 0), (16, 8, 301, 1), (5, 3, 8, 2), (9, 130, 13, 3), (130, 202, 301, 9), (200, 16, 384, 10)],
)
def test_operand_pass_equals_jax_operands_bit_for_bit(m, k, n, seed):
    """The operand pass's plain version makes, bit for bit, the bf16
    operands of the TPU kernel, with zero pad columns up to a multiple of 8."""
    g, out, w = _dx_inputs(m, k, n, seed)
    gm16, w16 = dx_operands_reference(*(torch.from_numpy(a) for a in (g, out, w)))
    npad = padded_width(n)
    assert gm16.dtype == w16.dtype == torch.bfloat16
    assert gm16.shape == (m, npad) and w16.shape == (k, npad)
    want_gm, want_w = _jax_operands(g, out, w)
    np.testing.assert_array_equal(_bits(gm16[:, :n].contiguous()), want_gm.view(np.int16))
    np.testing.assert_array_equal(_bits(w16[:, :n].contiguous()), want_w.view(np.int16))
    assert not gm16[:, n:].any() and not w16[:, n:].any()
    # The mask is strict: every column held at a bound passes nothing.
    assert not gm16[:, 0:n:5].any() and not gm16[:, 2:n:5].any()


@pytest.mark.parametrize(
    "m,k,n,seed", [(37, 24, 301, 4), (64, 40, 640, 5), (3, 200, 1, 6), (130, 202, 301, 11), (33, 202, 640, 12)]
)
def test_product_of_padded_operands_equals_k2_plain_version(m, k, n, seed):
    """The GEMM's plain version on the padded operands is K2's plain
    version: the pad adds zeros, and each bf16 product is exact in f32, so
    only the order of the f32 sums differs (1e-6 of the largest value)."""
    g, out, w = (torch.from_numpy(a) for a in _dx_inputs(m, k, n, seed))
    got = gemm_bf16_tn_reference(*dx_operands_reference(g, out, w))
    want = fused_output_dx_reference(g, out, w)
    assert got.shape == want.shape == (m, k)
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


def test_k2_cpu_path_equals_pallas_interpret():
    """fused_output_dx on CPU tensors against the Pallas _dx_kernel in
    interpret mode at K = 640, N = 1280 (multiples of its blocks): 1e-5 of
    the largest value, f32 sums of exact bf16 products in another order."""
    m, k, n = 256, 640, 1280
    g, out, w = _dx_inputs(m, k, n, seed=7)
    want = np.asarray(_dx_pallas(jnp.asarray(g), jnp.asarray(out), jnp.asarray(w),
                                 bm=128, bk=128, bn=640, interpret=True))
    counts = (fused_output_dx.launches, round_bf16.launches, gemm_bf16_tn.launches)
    got = fused_output_dx(*(torch.from_numpy(a) for a in (g, out, w))).numpy()
    assert (fused_output_dx.launches, round_bf16.launches, gemm_bf16_tn.launches) == counts
    assert float(np.abs(got - want).max()) <= 1e-5 * float(np.abs(want).max())


def test_wrappers_on_cpu_take_their_plain_versions():
    """round_bf16 and gemm_bf16_tn on CPU tensors are their plain versions
    and launch nothing; chained they give K2's plain version."""
    g, out, w = (torch.from_numpy(a) for a in _dx_inputs(12, 20, 30, seed=8))
    before = (round_bf16.launches, gemm_bf16_tn.launches)
    gm16, w16 = round_bf16(g, out), round_bf16(w)
    assert torch.equal(gm16, round_bf16_reference(g, out)) and torch.equal(w16, round_bf16_reference(w))
    dx = gemm_bf16_tn(gm16, w16)
    assert (round_bf16.launches, gemm_bf16_tn.launches) == before
    assert torch.equal(dx, gemm_bf16_tn_reference(gm16, w16))
    torch.testing.assert_close(dx, fused_output_dx_reference(g, out, w), atol=1e-6, rtol=1e-6)


def test_padded_width_rounds_up_to_eight():
    assert [padded_width(n) for n in (1, 8, 9, 301, 19200)] == [8, 8, 16, 304, 19200]
