"""The port's kernel modules against the JAX package's kernels.

On the CPU each wrapper runs its plain version; these tests hold that plain
version against the Pallas kernel run in interpret mode (as tests/test_ops.py
and tests/test_fused_attention.py run it). The CUDA kernels themselves are
held against the plain versions on the card by tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_font_renderer_tpu.models.font_renderer import attention as jax_attention
from ai_font_renderer_tpu.ops.fused_attention import fused_attention as jax_fa
from ai_font_renderer_tpu.ops.fused_attention import fused_attention2 as jax_fa2
from ai_font_renderer_tpu.ops.fused_output import _reference as jax_output_reference
from ai_font_renderer_tpu.ops.fused_output import fused_output as jax_fused_output
from ai_font_renderer_tpu.ops.fused_dw_adamw import fused_dw_adamw as jax_fused_dw_adamw
from ai_font_renderer_tpu.config import ModelConfig as JaxModelConfig
from ai_font_renderer_tpu_torch.ops import (
    FusedOutputFunction,
    fused_attention,
    fused_attention2,
    fused_attention_reference,
    fused_dw_adamw,
    fused_dw_adamw_reference,
    fused_output,
    fused_output_dw,
    fused_output_dw_reference,
    fused_output_dx,
    fused_output_dx_reference,
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


def test_fused_output_gradients_match_jax_custom_vjp():
    """Gradients through FusedOutputFunction (plain versions on the CPU)
    against jax.grad of the Pallas fused_output in interpret mode (K1, K2,
    K3 and db), as tests/test_ops.py:33-48 holds the Pallas VJP: atol 2e-5.
    K and N are multiples of the Pallas kernel's 640-wide tiles."""
    m, k, n = 256, 640, 1280
    x, w, b = _output_inputs(m, k, n, seed=4)
    t = np.random.default_rng(9).uniform(size=(m, n)).astype(np.float32)

    def loss(x, w, b):
        return jnp.mean((jax_fused_output(x, w, b, True) - t) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    got = torch.autograd.grad(((fused_output(tx, tw, tb) - torch.from_numpy(t)) ** 2).mean(), (tx, tw, tb))
    for g, jg, name in zip(got, want, "x w b".split()):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=2e-5, err_msg=name)


def test_saturated_bias_blocks_the_gradient_exactly():
    """As tests/test_ops.py:51-59: every output saturated at 1.0 passes no
    gradient at all, to x, w or b."""
    x, w, b = _output_inputs(128, 640, 1280)
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, w, b + 100.0))
    fused_output(tx, tw, tb).sum().backward()
    for t in (tx, tw, tb):
        assert t.grad is not None and float(t.grad.abs().max()) == 0.0


def test_backward_mask_is_strict_at_the_bounds():
    """Outputs exactly at 0 or 1 pass no gradient (the kernels' rule), where
    torch.clamp's own backward would pass it."""
    x = torch.zeros(2, 4, requires_grad=True)
    w = torch.ones(4, 3, requires_grad=True)
    b = torch.tensor([0.0, 1.0, 0.5], requires_grad=True)
    out = fused_output(x, w, b)
    assert out.detach().tolist() == [[0.0, 1.0, 0.5]] * 2
    out.sum().backward()
    assert b.grad.tolist() == [0.0, 0.0, 2.0]
    # dx = gm @ w^T: only the third column passes, and w is all ones.
    assert w.grad.abs().sum() == 0.0 and x.grad.eq(1.0).all()


def test_backward_plain_versions_are_the_kernels_math():
    """K2/K3 wrappers on CPU tensors take their plain versions and launch
    nothing; those equal the bf16-rounded f32 products of the masked
    cotangent computed here from scratch."""
    x, w, b = (torch.from_numpy(a) for a in _output_inputs(15, 256, 384, seed=2))
    out = fused_output_reference(x, w, b)
    g = torch.randn(15, 384, generator=torch.Generator().manual_seed(0))
    before = (fused_output_dx.launches, fused_output_dw.launches)
    dx, dw = fused_output_dx(g, out, w), fused_output_dw(x, g, out)
    assert (fused_output_dx.launches, fused_output_dw.launches) == before
    gm = torch.where((out > 0) & (out < 1), g, torch.zeros(()))
    bf = lambda t: t.to(torch.bfloat16).double()
    torch.testing.assert_close(dx.double(), bf(gm) @ bf(w).T, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(dw.double(), bf(x).T @ bf(gm), atol=1e-5, rtol=1e-5)
    assert dx.equal(fused_output_dx_reference(g, out, w)) and dw.equal(fused_output_dw_reference(x, g, out))
    assert FusedOutputFunction.apply(x, w, b).equal(out)


@pytest.mark.parametrize("count", [1, 5])
@pytest.mark.parametrize("mu_bf16", [False, True], ids=["mu_f32", "mu_bf16"])
def test_fused_dw_adamw_plain_matches_pallas_interpret(mu_bf16, count):
    """The plain version against the JAX package's fused_dw_adamw (its
    Pallas kernel in interpret mode on the CPU). Moments seeded non-zero at
    count 5. Tolerances: w to 1e-7 (the update is 1e-3 * O(1)); nu and an
    f32 mu to 1e-5 of their largest value (dW's f32 sums in another order);
    a bf16 mu to one bf16 step plus 1e-5 of its largest value."""
    m, k, n = 256, 640, 384
    rng = np.random.default_rng(count + 2 * mu_bf16)
    x = np.maximum(rng.standard_normal((m, k)), 0).astype(np.float32)
    gm = (rng.standard_normal((m, n)) * 1e-3).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    warm = count > 1
    mu = (rng.standard_normal((k, n)) * 1e-3 * warm).astype(np.float32)
    nu = (rng.uniform(size=(k, n)) * 1e-6 * warm).astype(np.float32)
    jdt = jnp.bfloat16 if mu_bf16 else jnp.float32
    tdt = torch.bfloat16 if mu_bf16 else torch.float32
    hyper = (1e-3, 5e-4, 0.9, 0.99)
    jw, jmu, jnu = jax_fused_dw_adamw(
        jnp.asarray(x), jnp.asarray(gm), jnp.asarray(w), jnp.asarray(mu).astype(jdt), jnp.asarray(nu),
        jnp.float32(hyper[0]), *hyper[1:], jnp.int32(count),
    )
    tw, tmu, tnu = torch.from_numpy(w.copy()), torch.from_numpy(mu).to(tdt), torch.from_numpy(nu.copy())
    before = fused_dw_adamw.launches
    got = fused_dw_adamw(torch.from_numpy(x), torch.from_numpy(gm), tw, tmu, tnu, *hyper, count)
    assert fused_dw_adamw.launches == before and got[0] is tw and got[1] is tmu
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-7, rtol=0)
    jnu = np.asarray(jnu)
    np.testing.assert_allclose(tnu.numpy(), jnu, atol=1e-5 * np.abs(jnu).max(), rtol=0)
    jmu = np.asarray(jmu).astype(np.float32)
    rtol = 2.0**-7 if mu_bf16 else 0.0
    np.testing.assert_allclose(tmu.float().numpy(), jmu, atol=1e-5 * np.abs(jmu).max(), rtol=rtol)
    assert tmu.dtype == tdt


def test_fused_dw_adamw_reference_refuses_step_0():
    z = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="starts at 1"):
        fused_dw_adamw(z, z, z.clone(), z.clone(), z.clone(), 1e-3, 0.0, 0.9, 0.99, 0)
    # The plain version is what the wrapper runs on the CPU.
    args = [torch.ones(4, 4) for _ in range(5)]
    ref = [t.clone() for t in args]
    fused_dw_adamw(*args, 1e-3, 0.0, 0.9, 0.99, 1)
    fused_dw_adamw_reference(*ref, 1e-3, 0.0, 0.9, 0.99, 1)
    assert all(a.equal(r) for a, r in zip(args[2:], ref[2:]))
