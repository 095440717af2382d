"""K3's two-pass design on the CPU: the operand pass and the MN-major GEMM's
plain versions against the JAX package's ``_dw_kernel``.

On the card K3 is ``round_bf16`` for x (rounded to bf16, zero-padded to a
multiple of 8 columns) and for the masked cotangent gm16 (which the
autograd backward shares with K2), then ``gemm_bf16_mn``, x16^T @ gm16.
On the CPU every wrapper takes its plain version; these tests hold those
plain versions against the bf16 operands the Pallas kernel forms
(ai_font_renderer_tpu/ops/fused_output.py, ``_dw_kernel``) and against the
kernel itself in interpret mode. The CUDA kernels are held against the same
plain versions on the card by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_font_renderer_tpu.ops.fused_output import _dw_pallas
from ai_font_renderer_tpu_torch.ops import (
    FusedOutputFunction,
    fused_output_dw,
    fused_output_dw_reference,
    fused_output_dx_reference,
    gemm_bf16_mn,
    gemm_bf16_mn_reference,
    round_bf16,
    round_bf16_reference,
)
from ai_font_renderer_tpu_torch.ops.fused_output import padded_width


def _dw_inputs(m, k, n, seed):
    """x, g, out as numpy f32; out holds values exactly at 0 and 1 (the
    clamp's bounds, where the mask stops g), below 0, above 1 and inside."""
    rng = np.random.default_rng(seed)
    x = (np.maximum(rng.standard_normal((m, k)), 0) * 0.3).astype(np.float32)
    g = rng.standard_normal((m, n)).astype(np.float32)
    out = rng.uniform(-0.2, 1.2, (m, n)).astype(np.float32)
    out[:, ::5] = 0.0
    out[:, 2::5] = 1.0
    return x, g, out


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


@pytest.mark.parametrize("m,k", [(5, 3), (37, 202), (4, 6400), (200, 202)])
def test_x_operand_pass_equals_jax_cast_bit_for_bit(m, k):
    """The unmasked operand pass makes, bit for bit, the bf16 x that
    _dw_kernel casts (fused_output.py:153), with zero pad columns up to a
    multiple of 8."""
    rng = np.random.default_rng(m + k)
    x = (rng.standard_normal((m, k)) * 3.0).astype(np.float32)
    x16 = round_bf16_reference(torch.from_numpy(x))
    assert x16.dtype == torch.bfloat16 and x16.shape == (m, padded_width(k))
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
    np.testing.assert_array_equal(_bits(x16[:, :k].contiguous()), want.view(np.int16))
    assert not x16[:, k:].any()


@pytest.mark.parametrize(
    "m,k,n,seed", [(1, 24, 301, 0), (37, 202, 301, 1), (200, 16, 384, 2), (37, 8, 8, 3), (200, 130, 13, 4)]
)
def test_product_of_padded_operands_equals_k3_plain_version(m, k, n, seed):
    """The MN GEMM's plain version on the padded operands, cut to [K, N], is
    K3's plain version: the pads are zero columns outside the cut, and each
    bf16 product is exact in f32, so only the order of the f32 sums differs
    (1e-6 of the largest value)."""
    x, g, out = (torch.from_numpy(a) for a in _dw_inputs(m, k, n, seed))
    x16, gm16 = round_bf16_reference(x), round_bf16_reference(g, out)
    got = gemm_bf16_mn_reference(x16, gm16, k, n)
    want = fused_output_dw_reference(x, g, out)
    assert got.shape == want.shape == (k, n)
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    # Uncut, the pad rows and columns of the product are zero.
    full = gemm_bf16_mn_reference(x16, gm16)
    assert full.shape == (padded_width(k), padded_width(n))
    assert not full[k:].any() and not full[:, n:].any()


def test_k3_cpu_path_equals_pallas_interpret():
    """fused_output_dw on CPU tensors against the Pallas _dw_kernel in
    interpret mode at K = 640, N = 1280 (multiples of its blocks), M = 256
    in two 128-row steps: 1e-5 of the largest value, f32 sums of exact bf16
    products in another order. Nothing is launched."""
    m, k, n = 256, 640, 1280
    x, g, out = _dw_inputs(m, k, n, seed=7)
    want = np.asarray(_dw_pallas(jnp.asarray(x), jnp.asarray(g), jnp.asarray(out),
                                 bk=640, bn=640, bm=128, interpret=True))
    counts = (fused_output_dw.launches, round_bf16.launches, gemm_bf16_mn.launches)
    got = fused_output_dw(*(torch.from_numpy(a) for a in (x, g, out))).numpy()
    assert (fused_output_dw.launches, round_bf16.launches, gemm_bf16_mn.launches) == counts
    assert got.shape == (k, n)
    assert float(np.abs(got - want).max()) <= 1e-5 * float(np.abs(want).max())


@pytest.mark.parametrize("k,n", [(None, None), (20, 30), (17, 1)])
def test_gemm_bf16_mn_on_cpu_takes_its_plain_version(k, n):
    """gemm_bf16_mn on CPU tensors is its plain version, cut to [k, n] (the
    widths by default), and launches nothing; chained after the operand
    passes it gives K3's plain version."""
    x, g, out = (torch.from_numpy(a) for a in _dw_inputs(12, 20, 30, seed=8))
    before = (round_bf16.launches, gemm_bf16_mn.launches)
    x16, gm16 = round_bf16(x), round_bf16(g, out)
    dw = gemm_bf16_mn(x16, gm16, k, n)
    assert (round_bf16.launches, gemm_bf16_mn.launches) == before
    assert torch.equal(dw, gemm_bf16_mn_reference(x16, gm16, k, n))
    assert dw.shape == (k or 24, n or 32)
    if k == 20:
        torch.testing.assert_close(dw, fused_output_dw_reference(x, g, out), atol=1e-6, rtol=1e-6)


def test_cpu_backward_takes_the_plain_versions():
    """FusedOutputFunction's backward on CPU tensors launches nothing and
    returns K2's and K3's plain versions on the cotangent, and db = the
    masked cotangent's column sums."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy((np.maximum(rng.standard_normal((9, 24)), 0) * 0.3).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((24, 40)) * 0.2).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(40) * 0.5).astype(np.float32))
    tx, tw, tb = (t.clone().requires_grad_() for t in (x, w, b))
    before = (round_bf16.launches, gemm_bf16_mn.launches, fused_output_dw.launches)
    out = FusedOutputFunction.apply(tx, tw, tb)
    out.square().sum().backward()
    assert (round_bf16.launches, gemm_bf16_mn.launches, fused_output_dw.launches) == before
    g = 2 * out.detach()
    assert torch.equal(tx.grad, fused_output_dx_reference(g, out.detach(), w))
    assert torch.equal(tw.grad, fused_output_dw_reference(x, g, out.detach()))
    mask = (out.detach() > 0) & (out.detach() < 1)
    assert torch.equal(tb.grad, torch.where(mask, g, 0.0).sum(0))
