"""K4 and K9 on the Hopper GEMM core, on the CPU, against the JAX package's
``fused_dw_adamw``.

On the card K4 (``fused_dw_adamw``) and K9 (``fused_dw_adamw_xt``) are the
TMA + wgmma GEMM of csrc/sm90_gemm.cuh with an AdamW epilogue: dW = x16^T @
gm16 never leaves the registers, w, mu and nu are updated in place and, when
W has a current bf16 shadow, the updated W's shadow is written too. The
operands are bf16 rows a multiple of 8 elements apart, padded with zeros.
On the CPU the wrappers take the plain version (``fused_dw_adamw_reference``)
and write the shadow by the operand pass's plain version: these tests hold
them against the Pallas kernel in interpret mode (ai_font_renderer_tpu/ops/
fused_dw_adamw.py, as tests/test_ops.py runs it), hold the shadow to the
operand pass, hold the operands the kernel is given, and hold the fused
training step's hand-over of K1's and K2's operands to the operands it
formed before. The CUDA kernel is held
against the same plain versions on the card by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_font_renderer_tpu.ops.fused_dw_adamw import fused_dw_adamw as jax_fused_dw_adamw
from ai_font_renderer_tpu_torch.config import ModelConfig
from ai_font_renderer_tpu_torch.ops import (
    bf16_shadow,
    fused_dw_adamw,
    fused_dw_adamw_reference,
    fused_dw_adamw_xt,
    fused_dw_adamw_xt_reference,
    round_bf16_reference,
)
from ai_font_renderer_tpu_torch.ops.fused_dw_adamw import _operand
from ai_font_renderer_tpu_torch.ops.fused_output import padded_width
from ai_font_renderer_tpu_torch.train.step import _dflat, _projection

HYPER = (1e-3, 5e-4, 0.9, 0.99)


def _inputs(m, k, n, seed, warm=True):
    """x, gm, w, mu, nu as numpy f32: relu inputs, a small cotangent, and
    moments seeded non-zero (warm) or zero."""
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.standard_normal((m, k)), 0).astype(np.float32)
    gm = (rng.standard_normal((m, n)) * 1e-3).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    mu = (rng.standard_normal((k, n)) * 1e-3 * warm).astype(np.float32)
    nu = (rng.uniform(size=(k, n)) * 1e-6 * warm).astype(np.float32)
    return x, gm, w, mu, nu


def _state(w, mu, nu, mu_dtype):
    return torch.from_numpy(w.copy()), torch.from_numpy(mu.copy()).to(mu_dtype), torch.from_numpy(nu.copy())


@pytest.mark.parametrize("m,k,n", [(37, 200, 301), (64, 256, 384)], ids=["ragged", "even"])
@pytest.mark.parametrize("count", [1, 5])
@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16], ids=["mu_f32", "mu_bf16"])
def test_k4_plain_path_matches_pallas_interpret(mu_dtype, count, m, k, n):
    """The wrapper on CPU tensors (x in f32, gm in bf16, the f32 update)
    against the JAX kernel in interpret mode, on a W with a shadow, which it
    rewrites. Tolerances as tests/test_torch_ops.py's: w to 1e-7 (the
    update is 1e-3 * O(1)); nu and an f32 mu to 1e-5 of their largest value
    (dW's f32 sums in another order); a bf16 mu to one bf16 step plus 1e-5
    of its largest value."""
    x, gm, w, mu, nu = _inputs(m, k, n, seed=count + 2 * m, warm=count > 1)
    jdt = jnp.bfloat16 if mu_dtype == torch.bfloat16 else jnp.float32
    jw, jmu, jnu = jax_fused_dw_adamw(
        jnp.asarray(x), jnp.asarray(gm), jnp.asarray(w), jnp.asarray(mu).astype(jdt), jnp.asarray(nu),
        jnp.float32(HYPER[0]), *HYPER[1:], jnp.int32(count),
    )
    tw, tmu, tnu = _state(w, mu, nu, mu_dtype)
    bf16_shadow(tw)
    before = fused_dw_adamw.launches
    got = fused_dw_adamw(torch.from_numpy(x), torch.from_numpy(gm).to(torch.bfloat16), tw, tmu, tnu, *HYPER, count)
    assert fused_dw_adamw.launches == before and got[0] is tw and got[1] is tmu and got[2] is tnu
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-7, rtol=0)
    jnu = np.asarray(jnu)
    np.testing.assert_allclose(tnu.numpy(), jnu, atol=1e-5 * np.abs(jnu).max(), rtol=0)
    jmu = np.asarray(jmu).astype(np.float32)
    rtol = 2.0**-7 if mu_dtype == torch.bfloat16 else 0.0
    np.testing.assert_allclose(tmu.float().numpy(), jmu, atol=1e-5 * np.abs(jmu).max(), rtol=rtol)
    assert tmu.dtype == mu_dtype
    assert torch.equal(bf16_shadow(tw), round_bf16_reference(tw))


def test_operands_are_padded_bf16_rows():
    """The kernel's operands: a float32 x through the operand pass, a bf16
    one of a width that is no multiple of 8 zero-padded, and a bf16 one
    whose rows already lie a multiple of 8 elements apart (a column slice
    of a padded operand included) taken as it is, without a copy."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((5, 13)).astype(np.float32))
    x16 = _operand(x)
    assert x16.shape == (5, 16) and torch.equal(x16, round_bf16_reference(x))
    padded = _operand(x.to(torch.bfloat16))
    assert torch.equal(padded, x16)
    view = x16[:, :13]
    assert _operand(view) is view
    whole = torch.zeros(5, 16, dtype=torch.bfloat16)
    assert _operand(whole) is whole


@pytest.mark.parametrize("xt", [False, True], ids=["K4", "K9"])
@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16], ids=["mu_f32", "mu_bf16"])
def test_update_writes_ws_shadow_bit_for_bit(mu_dtype, xt):
    """On a W with a current shadow, the update writes the new W's shadow:
    round_bf16_reference of the updated W bit for bit (pad columns zero),
    which bf16_shadow then returns without a build; a shadow held from
    before the update is left as it was."""
    x, gm, w, mu, nu = _inputs(37, 200, 301, seed=8)
    tw, tmu, tnu = _state(w, mu, nu, mu_dtype)
    held = bf16_shadow(tw)
    before = held.clone()
    x16, gm16 = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(gm).to(torch.bfloat16)
    if xt:
        fused_dw_adamw_xt(x16.T.contiguous(), gm16, tw, tmu, tnu, 1e-3, 5)
    else:
        fused_dw_adamw(x16, gm16, tw, tmu, tnu, *HYPER, 5)
    builds = bf16_shadow.builds
    w16 = bf16_shadow(tw)
    assert bf16_shadow.builds == builds and w16 is not held
    assert w16.shape == (200, padded_width(301)) and not w16[:, 301:].any()
    assert torch.equal(w16, round_bf16_reference(tw))
    assert torch.equal(held, before) and not torch.equal(held, w16)


@pytest.mark.parametrize("stale", [False, True], ids=["never_shadowed", "stale_shadow"])
def test_a_w_without_a_current_shadow_gets_none(stale):
    """A W that has no shadow, or whose shadow is stale, gets none from the
    update: the next read builds it, from the updated W."""
    x, gm, w, mu, nu = _inputs(16, 48, 40, seed=9)
    tw, tmu, tnu = _state(w, mu, nu, torch.bfloat16)
    if stale:
        bf16_shadow(tw)
        tw.mul_(1.5)
    fused_dw_adamw(torch.from_numpy(x), torch.from_numpy(gm), tw, tmu, tnu, *HYPER, 5)
    builds = bf16_shadow.builds
    assert torch.equal(bf16_shadow(tw), round_bf16_reference(tw))
    assert bf16_shadow.builds == builds + 1


@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16], ids=["mu_f32", "mu_bf16"])
def test_k9_plain_path_equals_k4_on_xt_transposed(mu_dtype):
    """K9's plain path on xt [K, M] (M = 37, padded to 40) gives what K4's
    gives on xt^T, to 1e-7 on w and 1e-6 of the largest value of nu and mu
    (the two products may sum in another order), and K9's own plain
    version, bit for bit."""
    x, gm, w, mu, nu = _inputs(37, 200, 301, seed=11)
    xt = torch.from_numpy(x.T.copy()).to(torch.bfloat16)
    tg = torch.from_numpy(gm).to(torch.bfloat16)
    k9, k4, ref = (_state(w, mu, nu, mu_dtype) for _ in range(3))
    before = fused_dw_adamw_xt.launches
    fused_dw_adamw_xt(xt, tg, *k9, 1e-3, 5)
    assert fused_dw_adamw_xt.launches == before
    fused_dw_adamw(xt.T.contiguous(), tg, *k4, 1e-3, 5e-4, 0.9, 0.99, 5)
    fused_dw_adamw_xt_reference(xt, tg, *ref, 1e-3, 5)
    assert all(torch.equal(a, b) for a, b in zip(k9, ref))
    torch.testing.assert_close(k9[0], k4[0], atol=1e-7, rtol=0)
    for a, b in zip(k9[1:], k4[1:]):
        torch.testing.assert_close(a.float(), b.float(), atol=1e-6 * float(b.float().abs().max()), rtol=0)


@pytest.mark.parametrize("k,n", [(20, 21), (64, 48)], ids=["ragged", "even"])
def test_fused_step_hands_k1_and_k2_operands_to_k4(k, n):
    """Under use_pallas_output the fused step hands K4 the bf16 operands
    that K1 (x16) and K2 (gm16) formed, as [B, K] and [B, N] views of the
    padded buffers, and they equal bit for bit the operands the step formed
    before (flat and the masked cotangent rounded to bf16 by torch), which
    the path without use_pallas_output still forms."""
    rng = np.random.default_rng(k)
    flat = torch.from_numpy(np.maximum(rng.standard_normal((6, k)), 0).astype(np.float32) * 0.3)
    params = {"out_w": torch.from_numpy((rng.standard_normal((k, n)) * 0.1).astype(np.float32)),
              "out_b": torch.from_numpy((rng.standard_normal(n) * 0.3 + 0.5).astype(np.float32))}
    targets = torch.from_numpy(rng.uniform(size=(6, 1, n)).astype(np.float32))
    kern = ModelConfig(use_pallas_output=True)
    plain = ModelConfig(bf16_matmul=True)
    _, out, g, gm, flat_dt = _projection(flat, params, targets, kern)
    dflat, gm_dt = _dflat(out, g, gm, params["out_w"], kern)
    assert flat_dt.stride(0) == padded_width(k) and gm_dt.stride(0) == padded_width(n)
    assert torch.equal(flat_dt, flat.to(torch.bfloat16))
    assert torch.equal(gm_dt, gm.to(torch.bfloat16))
    _, p_out, p_g, p_gm, p_flat_dt = _projection(flat, params, targets, plain)
    p_dflat, p_gm_dt = _dflat(p_out, p_g, p_gm, params["out_w"], plain)
    assert torch.equal(p_out, out) and torch.equal(p_flat_dt, flat_dt) and torch.equal(p_gm_dt, gm_dt)
    assert p_flat_dt.is_contiguous() and p_gm_dt.is_contiguous()
    torch.testing.assert_close(dflat, p_dflat, atol=1e-6, rtol=1e-6)
