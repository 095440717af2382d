"""The port's CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so every test here is marked ``cuda`` and
skips without a card. This file imports no JAX, so it also runs where only
PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from ai_font_renderer_tpu_torch.ops import (
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
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    from ai_font_renderer_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def _output_inputs(m, k, n, device, seed=0):
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.standard_normal((m, k)), 0).astype(np.float32) * 0.2
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(n) * 0.5).astype(np.float32)
    return (torch.from_numpy(a).to(device) for a in (x, w, b))


def _attn_inputs(bsz, s, e, device, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((bsz, s, e)).astype(np.float32))
    w = {k: rng.uniform(-0.3, 0.3, (e, e)) for k in KEYS[:4]}
    w.update({k: rng.standard_normal(e) * 0.1 for k in KEYS[4:]})
    tw = {k: torch.from_numpy(v.astype(np.float32)).to(device) for k, v in w.items()}
    return x.to(device, dtype), tw


@pytest.mark.parametrize(
    "m,k,n",
    # 301 columns take the element-wise load path; 130 rows leave a ragged
    # row tile; K = 6400 is the model's depth.
    [(15, 200, 301), (130, 256, 384), (64, 6400, 512)],
)
def test_fused_output_kernel_matches_plain(cuda, m, k, n):
    """Tolerance 1e-4: f32 sums of exact bf16 products, in another order."""
    x, w, b = _output_inputs(m, k, n, cuda)
    before = fused_output.launches
    got = fused_output(x, w, b)
    assert fused_output.launches == before + 1
    torch.testing.assert_close(got, fused_output_reference(x, w, b), atol=1e-4, rtol=0)


@pytest.mark.parametrize(
    "dtype,atol",
    # bf16: the kernel rounds where the TPU kernel does, the plain version
    # where the JAX model's attention does; one bf16 rounding of O(1) values.
    [(torch.float32, 1e-4), (torch.bfloat16, 0.05)],
    ids=["f32", "bf16"],
)
@pytest.mark.parametrize("bsz,s,e,heads", [(3, 100, 32, 4), (5, 7, 16, 2), (2, 40, 32, 1)])
def test_fused_attention_kernel_matches_plain(cuda, dtype, atol, bsz, s, e, heads):
    x, w = _attn_inputs(bsz, s, e, cuda, dtype)
    for fn in (fused_attention, fused_attention2):
        before = fn.launches
        got = fn(x, w, heads)
        assert fn.launches == before + 1
        assert got.dtype == dtype and got.shape == x.shape
        want = fused_attention_reference(x, w, heads)
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


def test_kernel_wrappers_refuse_what_they_cannot_take(cuda):
    x, w, b = _output_inputs(4, 8, 8, cuda)
    with pytest.raises(ValueError, match="float32"):
        fused_output(x.double(), w, b)
    with pytest.raises(ValueError, match="shape mismatch"):
        fused_output(x, w[:4], b)
    ax, aw = _attn_inputs(2, 8, 32, cuda, torch.float32)
    with pytest.raises(ValueError, match="divide 32"):
        fused_attention(ax, aw, 5)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fused_attention(ax.half(), aw, 4)


def _backward_inputs(m, k, n, device, seed=0):
    """x, w, b as for K1, its clamped output, and a cotangent g: about a
    third of the outputs sit at a bound, where the mask stops g."""
    x, w, b = _output_inputs(m, k, n, device, seed)
    out = fused_output_reference(x, w, b)
    g = torch.randn(m, n, generator=torch.Generator(device=device).manual_seed(seed), device=device)
    return x, w, out, g


def _rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize(
    "m,k,n",
    # 200 and 130 leave ragged row tiles, 301 and 202 columns take the
    # element-wise load path, K = 6400 is the model's depth.
    [(200, 256, 384), (130, 200, 301), (64, 6400, 512), (33, 202, 640)],
)
def test_backward_kernels_match_plain(cuda, m, k, n):
    """K2 and K3 against their plain versions. Tolerance 1e-4 of the largest
    value: f32 sums of exact bf16 products, in another order."""
    x, w, out, g = _backward_inputs(m, k, n, cuda)
    before = (fused_output_dx.launches, fused_output_dw.launches)
    dx = fused_output_dx(g, out, w)
    dw = fused_output_dw(x, g, out)
    assert (fused_output_dx.launches, fused_output_dw.launches) == (before[0] + 1, before[1] + 1)
    assert _rel_err(dx, fused_output_dx_reference(g, out, w)) <= 1e-4
    assert _rel_err(dw, fused_output_dw_reference(x, g, out)) <= 1e-4


def test_autograd_function_launches_the_backward_kernels(cuda):
    x, w, b = _output_inputs(70, 256, 384, cuda)
    x, w, b = (t.clone().requires_grad_() for t in (x, w, b))
    before = (fused_output.launches, fused_output_dx.launches, fused_output_dw.launches)
    fused_output(x, w, b).square().sum().backward()
    after = (fused_output.launches, fused_output_dx.launches, fused_output_dw.launches)
    assert after == tuple(c + 1 for c in before)
    out = fused_output_reference(x.detach(), w.detach(), b.detach())
    g = 2 * out
    assert _rel_err(x.grad, fused_output_dx_reference(g, out, w.detach())) <= 1e-4
    assert _rel_err(w.grad, fused_output_dw_reference(x.detach(), g, out)) <= 1e-4
    torch.testing.assert_close(b.grad, torch.where((out > 0) & (out < 1), g, 0.0).sum(0))


def _adam_state(k, n, mu_dtype, device, seed=3, warm=True):
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn(k, n, generator=gen, device=device) * 0.05
    if not warm:
        return w, torch.zeros(k, n, device=device, dtype=mu_dtype), torch.zeros(k, n, device=device)
    mu = (torch.randn(k, n, generator=gen, device=device) * 1e-3).to(mu_dtype)
    nu = torch.rand(k, n, generator=gen, device=device) * 1e-6 + 1e-8
    return w, mu, nu


@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16], ids=["mu_f32", "mu_bf16"])
@pytest.mark.parametrize("m,k,n", [(200, 640, 384), (37, 200, 301), (64, 6400, 256)])
def test_fused_dw_adamw_matches_plain(cuda, mu_dtype, m, k, n):
    """K4 against its plain version at step 5 with non-zero moments, where
    Adam's update is no longer lr*sign(dW). Tolerances: nu and the f32 mu
    to 1e-4 of their largest value (dW's sums in another order); a bf16 mu
    to one bf16 step (2^-7 relative, a rounding that may fall either side)
    plus 1e-5 of its largest value, for entries that cancel to near zero;
    w to 1e-6, far below the 1e-3 learning rate."""
    gen = torch.Generator(device=cuda).manual_seed(m)
    x = torch.relu(torch.randn(m, k, generator=gen, device=cuda)).to(torch.bfloat16)
    gm = (torch.randn(m, n, generator=gen, device=cuda) * 1e-3).to(torch.bfloat16)
    w, mu, nu = _adam_state(k, n, mu_dtype, cuda)
    ref = [t.clone() for t in (w, mu, nu)]
    args = (1e-3, 5e-4, 0.9, 0.99, 5)
    before = fused_dw_adamw.launches
    got = fused_dw_adamw(x, gm, w, mu, nu, *args)
    assert fused_dw_adamw.launches == before + 1
    assert got[0] is w and got[1] is mu and got[2] is nu
    fused_dw_adamw_reference(x, gm, *ref, *args)
    torch.testing.assert_close(w, ref[0], atol=1e-6, rtol=0)
    assert _rel_err(nu, ref[2]) <= 1e-4
    if mu_dtype == torch.float32:
        assert _rel_err(mu, ref[1]) <= 1e-4
    else:
        scale = float(ref[1].float().abs().max())
        torch.testing.assert_close(mu.float(), ref[1].float(), rtol=2**-7, atol=1e-5 * scale)


@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16], ids=["mu_f32", "mu_bf16"])
def test_fused_dw_adamw_first_moment_is_the_gradient_at_step_1(cuda, mu_dtype):
    """At t = 1 from zero moments mu = (1-b1)*dW: mu/(1-b1) is the dW of the
    plain product, to 1e-4 of its largest value (f32 mu) or one bf16 step
    plus 1e-4 of its largest value (bf16 mu)."""
    m, k, n = 96, 320, 384
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(m, k, generator=gen, device=cuda).to(torch.bfloat16)
    gm = (torch.randn(m, n, generator=gen, device=cuda) * 1e-3).to(torch.bfloat16)
    w, mu, nu = _adam_state(k, n, mu_dtype, cuda, warm=False)
    fused_dw_adamw(x, gm, w, mu, nu, 1e-3, 5e-4, 0.9, 0.99, 1)
    dw = x.float().T @ gm.float()
    one_minus_b1 = float(np.float32(1) - np.float32(0.9))
    if mu_dtype == torch.float32:
        assert _rel_err(mu / one_minus_b1, dw) <= 1e-4
    else:
        scale = float(dw.abs().max())
        torch.testing.assert_close(mu.float() / one_minus_b1, dw, rtol=2**-7, atol=1e-4 * scale)


def test_backward_wrappers_refuse_what_they_cannot_take(cuda):
    x, w, out, g = _backward_inputs(8, 16, 24, cuda)
    with pytest.raises(ValueError, match="float32"):
        fused_output_dx(g.double(), out, w)
    with pytest.raises(ValueError, match="shape mismatch"):
        fused_output_dw(x, g[:4], out)
    mu = torch.zeros(16, 24, device=cuda)
    with pytest.raises(ValueError, match="shape mismatch"):
        fused_dw_adamw(x, g, w.T.contiguous()[:8], mu, mu.clone(), 1e-3, 0.0, 0.9, 0.99, 1)
    with pytest.raises(ValueError, match="starts at 1"):
        fused_dw_adamw(x, g, w.T.contiguous(), mu, mu.clone(), 1e-3, 0.0, 0.9, 0.99, 0)


@pytest.mark.parametrize("fused", [False, True], ids=["output", "fused"])
def test_train_step_with_kernels_matches_plain_step(cuda, fused):
    """One training step of a narrowed model on the card, dropout off, with
    the projection's kernels (K1/K2/K3, or K1/K2/K4) against the plain
    step on the same weights and a ragged batch of 24: loss to 1e-5
    relative, and out_w's first moment mu/(1-b1), which is dW at step 1, to
    1e-2 of its largest value (bf16 storage, 2^-8 relative, and the clamp
    mask where an output lies within an ulp of a bound). The updated
    weights themselves are no test at step 1: Adam's update is then about
    lr * sign(dW), which flips for entries of dW near zero."""
    from ai_font_renderer_tpu_torch.config import ModelConfig, TrainConfig, replace
    from ai_font_renderer_tpu_torch.models import font_renderer
    from ai_font_renderer_tpu_torch.train.step import state_from_params, train_step

    plain_m = ModelConfig(max_length=24, hidden_dim=32, sheet_height=20, sheet_width=60,
                          dropout_rate=0.0, fc_dropout_rate=0.0)
    kern_m = replace(plain_m, use_pallas_output=True)
    params = font_renderer.init(torch.Generator().manual_seed(0), plain_m, "cpu")
    params = {k: v.to(cuda) for k, v in params.items()}
    gen = torch.Generator(device=cuda).manual_seed(1)
    codes = torch.randint(32, 127, (24, 24), generator=gen, device=cuda, dtype=torch.int32)
    targets = torch.rand(24, 20, 60, generator=gen, device=cuda)
    tcfg = TrainConfig(fused_dw_adamw=fused)
    counts = (fused_output_dx.launches, fused_output_dw.launches, fused_dw_adamw.launches)
    kern, kloss = train_step(state_from_params(params, tcfg), codes, targets, 1e-3, gen, kern_m, tcfg)
    plain, ploss = train_step(state_from_params(params, TrainConfig()), codes, targets, 1e-3, gen, plain_m, TrainConfig())
    after = (fused_output_dx.launches, fused_output_dw.launches, fused_dw_adamw.launches)
    assert after == (counts[0] + 1, counts[1] + (not fused), counts[2] + fused)
    assert abs(float(kloss) - float(ploss)) <= 1e-5 * float(ploss)
    kern_mu = kern.mu_w if fused else kern.mu["out_w"]
    assert kern_mu.dtype == torch.bfloat16
    assert _rel_err(kern_mu.float(), plain.mu["out_w"].float()) <= 1e-2
