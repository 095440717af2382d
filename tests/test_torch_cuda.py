"""The port's CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so every test here is marked ``cuda`` and
skips without a card. This file imports no JAX, so it also runs where only
PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from ai_font_renderer_tpu_torch.ops.philox import dropout_keep
from ai_font_renderer_tpu_torch.ops import (
    attention_mma_bwd,
    attention_mma_fwd,
    attention_wide_bwd,
    attention_wide_fwd,
    bf16_shadow,
    fused_attention,
    fused_attention2,
    fused_attention2_backward,
    fused_attention_backward,
    fused_attention_backward_reference,
    fused_attention_reference,
    fused_dw_adamw,
    fused_dw_adamw_reference,
    fused_dw_adamw_xt,
    fused_dw_adamw_xt_reference,
    fused_output,
    fused_output_dw,
    fused_output_dw_reference,
    fused_output_dx,
    fused_output_dx_reference,
    fused_output_reference,
    gemm_bf16_bias_clamp,
    gemm_bf16_bias_clamp_reference,
    gemm_bf16_mn,
    gemm_bf16_mn_reference,
    gemm_bf16_tn,
    gemm_bf16_tn_reference,
    round_bf16,
    round_bf16_reference,
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
    with pytest.raises(ValueError, match="multiple of the 5 heads"):
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


# The four ragged shapes above, then K2 at the model's depth and width with
# the ragged 200 rows and the batch of 1024.
K2_SHAPES = [(200, 256, 384), (130, 200, 301), (64, 6400, 512), (33, 202, 640),
             (200, 6400, 19200), (1024, 6400, 19200)]


def _k2_counts():
    return fused_output_dx.launches, round_bf16.launches, gemm_bf16_tn.launches


@pytest.mark.parametrize("m,k,n", K2_SHAPES)
def test_k2_two_pass_matches_plain(cuda, m, k, n):
    """K2 on the card is one operand pass for g, one for w and one GEMM;
    within 1e-4 of the plain version's largest value (f32 sums of exact
    bf16 products, in another order)."""
    x, w, out, g = _backward_inputs(m, k, n, cuda)
    before = _k2_counts()
    dx = fused_output_dx(g, out, w)
    assert _k2_counts() == (before[0] + 1, before[1] + 2, before[2] + 1)
    assert dx.shape == (m, k) and dx.dtype == torch.float32
    assert _rel_err(dx, fused_output_dx_reference(g, out, w)) <= 1e-4


@pytest.mark.parametrize("masked", [False, True], ids=["w", "g_masked"])
@pytest.mark.parametrize("rows,cols", [(130, 301), (64, 384), (3, 5), (1024, 19200)])
def test_round_bf16_matches_plain_bit_for_bit(cuda, masked, rows, cols):
    """The operand pass equals its plain version bit for bit, pad columns
    included; outputs exactly at 0 and 1 stop the cotangent."""
    gen = torch.Generator(device=cuda).manual_seed(rows + cols)
    src = torch.randn(rows, cols, generator=gen, device=cuda)
    out = None
    if masked:
        out = torch.rand(rows, cols, generator=gen, device=cuda) * 1.5 - 0.25
        out[:, ::7] = 0.0
        out[:, 3::7] = 1.0
    before = round_bf16.launches
    got = round_bf16(src, out)
    assert round_bf16.launches == before + 1
    want = round_bf16_reference(src, out)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape == (rows, -(-cols // 8) * 8)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("m,k,width", [(200, 256, 384), (130, 202, 304), (64, 6400, 512),
                                       (33, 202, 640), (1024, 6400, 19200), (513, 400, 136),
                                       (1, 8, 8)])
def test_gemm_bf16_tn_matches_f32_product(cuda, m, k, width):
    """The GEMM alone on bf16 operands against the f32 product of the same
    values, to 1e-4 of its largest value (exact products, f32 sums in
    another order)."""
    gen = torch.Generator(device=cuda).manual_seed(m + k)
    a = torch.randn(m, width, generator=gen, device=cuda).to(torch.bfloat16)
    b = torch.randn(k, width, generator=gen, device=cuda).to(torch.bfloat16)
    before = gemm_bf16_tn.launches
    got = gemm_bf16_tn(a, b)
    assert gemm_bf16_tn.launches == before + 1
    assert _rel_err(got, gemm_bf16_tn_reference(a, b)) <= 1e-4


def test_k2_wrappers_refuse_what_they_cannot_take(cuda):
    a = torch.zeros(4, 12, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        gemm_bf16_tn(a, a)
    with pytest.raises(ValueError, match="bfloat16"):
        gemm_bf16_tn(a.float(), a.float())
    with pytest.raises(ValueError, match="one width"):
        gemm_bf16_tn(a[:, :8].contiguous(), torch.zeros(4, 16, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="float32"):
        round_bf16(a)


def _k3_counts():
    return fused_output_dw.launches, round_bf16.launches, gemm_bf16_mn.launches


@pytest.mark.parametrize("m,k,n", K2_SHAPES)
def test_k3_two_pass_matches_plain(cuda, m, k, n):
    """K3 on the card is one operand pass for x, one for the masked g and
    one MN-major GEMM; within 1e-4 of the plain version's largest value
    (f32 sums of exact bf16 products, in another order)."""
    x, w, out, g = _backward_inputs(m, k, n, cuda)
    before = _k3_counts()
    dw = fused_output_dw(x, g, out)
    assert _k3_counts() == (before[0] + 1, before[1] + 2, before[2] + 1)
    assert dw.shape == (k, n) and dw.dtype == torch.float32
    assert _rel_err(dw, fused_output_dw_reference(x, g, out)) <= 1e-4


@pytest.mark.parametrize("m,k,width", [(1, 8, 8), (37, 208, 304), (200, 256, 384), (513, 400, 136),
                                       (200, 6400, 19200), (1024, 6400, 19200)])
def test_gemm_bf16_mn_matches_f32_product(cuda, m, k, width):
    """The MN-major GEMM alone on bf16 operands a [M, K], b [M, N] against
    the f32 product a^T b of the same values, to 1e-4 of its largest value
    (exact products, f32 sums in another order); and cut to [k - 5, N - 3],
    which the kernel's stores clip at the edge."""
    gen = torch.Generator(device=cuda).manual_seed(m + k)
    a = torch.randn(m, k, generator=gen, device=cuda).to(torch.bfloat16)
    b = torch.randn(m, width, generator=gen, device=cuda).to(torch.bfloat16)
    before = gemm_bf16_mn.launches
    got = gemm_bf16_mn(a, b)
    assert gemm_bf16_mn.launches == before + 1
    assert got.shape == (k, width)
    assert _rel_err(got, gemm_bf16_mn_reference(a, b)) <= 1e-4
    cut = gemm_bf16_mn(a, b, k - 5, width - 3)
    assert cut.shape == (k - 5, width - 3)
    assert torch.equal(cut, got[: k - 5, : width - 3])


def test_k3_wrappers_refuse_what_they_cannot_take(cuda):
    a = torch.zeros(4, 16, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple"):
        gemm_bf16_mn(torch.zeros(4, 12, device=cuda, dtype=torch.bfloat16), a)
    with pytest.raises(ValueError, match="bfloat16"):
        gemm_bf16_mn(a.float(), a.float())
    with pytest.raises(ValueError, match="one depth"):
        gemm_bf16_mn(a, torch.zeros(5, 16, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="k <= Ka"):
        gemm_bf16_mn(a, a, 17, 16)
    with pytest.raises(ValueError, match="contiguous"):
        gemm_bf16_mn(torch.zeros(16, 4, device=cuda, dtype=torch.bfloat16).T, a)
    x, _, out, g = _backward_inputs(8, 16, 24, cuda)
    with pytest.raises(ValueError, match="float32"):
        fused_output_dw(x.half(), g, out)
    with pytest.raises(ValueError, match="shape mismatch"):
        fused_output_dw(x, g, out[:, :8].contiguous())


def test_autograd_function_launches_the_backward_kernels(cuda):
    """One backward with all three gradients: one K2 and one K3 call, the
    operand pass three times (gm16, shared by both, w16 and x16), each GEMM
    once."""
    x, w, b = _output_inputs(70, 256, 384, cuda)
    x, w, b = (t.clone().requires_grad_() for t in (x, w, b))
    before = (fused_output.launches, fused_output_dx.launches, fused_output_dw.launches)
    parts = (round_bf16.launches, gemm_bf16_tn.launches, gemm_bf16_mn.launches)
    fused_output(x, w, b).square().sum().backward()
    after = (fused_output.launches, fused_output_dx.launches, fused_output_dw.launches)
    assert after == tuple(c + 1 for c in before)
    assert (round_bf16.launches, gemm_bf16_tn.launches, gemm_bf16_mn.launches) == (
        parts[0] + 3, parts[1] + 1, parts[2] + 1)
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


def _k1_counts():
    return (fused_output.launches, round_bf16.launches, gemm_bf16_bias_clamp.launches,
            bf16_shadow.builds)


@pytest.mark.parametrize("m,k,n", [(1, 6400, 19200), (15, 6400, 19200), (64, 6400, 19200),
                                   (129, 6400, 19200), (1024, 6400, 19200), (37, 202, 301),
                                   (130, 640, 1283)])
def test_gemm_bf16_bias_clamp_matches_plain(cuda, m, k, n):
    """K1's GEMM on the x pass and W's shadow against its plain version at
    the model's width (K = 6400, N = 19200) and at ragged shapes (a ragged
    K-block, N not a multiple of 8): to 1e-4 (f32 sums of exact bf16
    products in another order, of outputs clamped to [0, 1])."""
    x, w, b = _output_inputs(m, k, n, cuda, seed=m)
    x16, w16 = round_bf16(x), round_bf16(w)
    before = gemm_bf16_bias_clamp.launches
    got = gemm_bf16_bias_clamp(x16, w16, b, n)
    assert gemm_bf16_bias_clamp.launches == before + 1
    assert got.shape == (m, n) and got.dtype == torch.float32
    want = gemm_bf16_bias_clamp_reference(x16, w16, b, n)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    torch.testing.assert_close(got, fused_output_reference(x, w, b), atol=1e-4, rtol=0)


def test_k1_wrappers_refuse_what_they_cannot_take(cuda):
    a = torch.zeros(4, 16, device=cuda, dtype=torch.bfloat16)
    w16 = torch.zeros(16, 24, device=cuda, dtype=torch.bfloat16)
    b = torch.zeros(24, device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        gemm_bf16_bias_clamp(a.float(), w16, b)
    with pytest.raises(ValueError, match="multiples of 8"):
        gemm_bf16_bias_clamp(torch.zeros(4, 12, device=cuda, dtype=torch.bfloat16), w16[:12].contiguous(), b)
    with pytest.raises(ValueError, match="K <= Ka"):
        gemm_bf16_bias_clamp(a[:, :8].contiguous(), w16, b)
    with pytest.raises(ValueError, match="bias"):
        gemm_bf16_bias_clamp(a, w16, b[:8].contiguous())
    with pytest.raises(ValueError, match="bias"):
        gemm_bf16_bias_clamp(a, w16, b.double())
    with pytest.raises(ValueError, match="contiguous"):
        gemm_bf16_bias_clamp(torch.zeros(16, 4, device=cuda, dtype=torch.bfloat16).T, w16, b)
    x, w, _ = _output_inputs(4, 16, 24, cuda)
    with pytest.raises(ValueError, match="shape mismatch"):
        fused_output(x, w, b[:8].contiguous())


def test_k1_launch_counts_and_shadow_builds(cuda):
    """K1 on the card is the x pass, W's shadow and the GEMM: on a new W the
    operand pass runs twice (x16, the shadow), on the same W again once;
    each call counts one K1 launch and one GEMM launch."""
    x, w, b = _output_inputs(64, 640, 1283, cuda)
    before = _k1_counts()
    first = fused_output(x, w, b)
    assert _k1_counts() == (before[0] + 1, before[1] + 2, before[2] + 1, before[3] + 1)
    again = fused_output(x, w, b)
    assert _k1_counts() == (before[0] + 2, before[1] + 3, before[2] + 2, before[3] + 1)
    assert torch.equal(first, again)


@pytest.mark.parametrize("xt", [False, True], ids=["K4", "K9"])
def test_k4_update_then_k1_reads_the_new_weights(cuda, xt):
    """K4 (or K9) writes W in place from CUDA and bumps the version counters
    of W and its moments; since W had a current shadow, it also writes W's
    new shadow, so the next K1 rebuilds nothing and gives the updated
    weights' plain result."""
    m, k, n = 64, 640, 384
    x, _, b = _output_inputs(m, k, n, cuda)
    gen = torch.Generator(device=cuda).manual_seed(9)
    x16 = torch.relu(torch.randn(m, k, generator=gen, device=cuda)).to(torch.bfloat16)
    gm = (torch.randn(m, n, generator=gen, device=cuda) * 1e-3).to(torch.bfloat16)
    w, mu, nu = _adam_state(k, n, torch.bfloat16, cuda)
    first = fused_output(x, w, b)
    versions = [t._version for t in (w, mu, nu)]
    builds = bf16_shadow.builds
    if xt:
        fused_dw_adamw_xt(x16.T.contiguous(), gm, w, mu, nu, 1e-2, 5)
    else:
        fused_dw_adamw(x16, gm, w, mu, nu, 1e-2, 5e-4, 0.9, 0.99, 5)
    assert all(t._version > v for t, v in zip((w, mu, nu), versions))
    got = fused_output(x, w, b)
    assert bf16_shadow.builds == builds
    assert not torch.equal(got, first)
    torch.testing.assert_close(got, fused_output_reference(x, w, b), atol=1e-4, rtol=0)
    fused_output(x, w, b)
    assert bf16_shadow.builds == builds


@pytest.mark.parametrize("xt,mu_dtype", [(False, torch.bfloat16), (False, torch.float32), (True, torch.bfloat16)],
                         ids=["K4-mu_bf16", "K4-mu_f32", "K9-mu_bf16"])
def test_k4_writes_ws_shadow_bit_for_bit_at_full_width(cuda, xt, mu_dtype):
    """At the model's width (M = 1024, K = 6400, N = 19200) the shadow that
    K4 (or K9) writes with W equals the operand pass on the updated W, and
    its plain version, bit for bit; bf16_shadow then returns it without a
    rebuild, and a shadow held from before the update is unchanged."""
    m, k, n = 1024, 6400, 19200
    gen = torch.Generator(device=cuda).manual_seed(21)
    x16 = torch.relu(torch.randn(m, k, generator=gen, device=cuda)).to(torch.bfloat16)
    gm = (torch.randn(m, n, generator=gen, device=cuda) * 1e-6).to(torch.bfloat16)
    w, mu, nu = _adam_state(k, n, mu_dtype, cuda)
    held = bf16_shadow(w)
    before = held.clone()
    if xt:
        fused_dw_adamw_xt(x16.T.contiguous(), gm, w, mu, nu, 1e-3, 5)
    else:
        fused_dw_adamw(x16, gm, w, mu, nu, 1e-3, 5e-4, 0.9, 0.99, 5)
    builds = bf16_shadow.builds
    w16 = bf16_shadow(w)
    assert bf16_shadow.builds == builds and w16 is not held
    assert torch.equal(w16, round_bf16(w)) and torch.equal(w16, round_bf16_reference(w))
    assert torch.equal(held, before)


@pytest.mark.parametrize("xt", [False, True], ids=["K4", "K9"])
def test_k4_on_a_w_without_a_shadow_writes_none(cuda, xt):
    """A W whose shadow is stale (or that has none) gets none from K4: the
    next K1 builds it, from the updated W. N = 301 leaves pad columns."""
    m, k, n = 37, 200, 301
    x, _, b = _output_inputs(m, k, n, cuda)
    gen = torch.Generator(device=cuda).manual_seed(5)
    x16 = torch.relu(torch.randn(m, k, generator=gen, device=cuda)).to(torch.bfloat16)
    gm = (torch.randn(m, n, generator=gen, device=cuda) * 1e-3).to(torch.bfloat16)
    w, mu, nu = _adam_state(k, n, torch.float32, cuda)
    fused_output(x, w, b)
    w.mul_(1.5)  # the shadow is stale now
    if xt:
        fused_dw_adamw_xt(x16.T.contiguous(), gm, w, mu, nu, 1e-3, 5)
    else:
        fused_dw_adamw(x16, gm, w, mu, nu, 1e-3, 5e-4, 0.9, 0.99, 5)
    builds = bf16_shadow.builds
    got = fused_output(x, w, b)
    assert bf16_shadow.builds == builds + 1
    assert torch.equal(bf16_shadow(w), round_bf16_reference(w))
    torch.testing.assert_close(got, fused_output_reference(x, w, b), atol=1e-4, rtol=0)


def test_k4_takes_column_slices_of_padded_operands(cuda):
    """K4 reads x16 and gm16 as the trainer hands them over, [M, K] and
    [M, N] views of K1's and K2's padded operands (K = 200 + 4, N = 301),
    without a copy, and updates as from contiguous ones; the shadow's pad
    columns are zero."""
    m, k, n = 40, 204, 301
    gen = torch.Generator(device=cuda).manual_seed(6)
    x = torch.relu(torch.randn(m, k, generator=gen, device=cuda))
    g = torch.randn(m, n, generator=gen, device=cuda) * 1e-3
    x16, gm16 = round_bf16(x), round_bf16(g)
    w, mu, nu = _adam_state(k, n, torch.bfloat16, cuda)
    ref = [t.clone() for t in (w, mu, nu)]
    bf16_shadow(w)
    fused_dw_adamw(x16[:, :k], gm16[:, :n], w, mu, nu, 1e-3, 5e-4, 0.9, 0.99, 5)
    fused_dw_adamw(x16[:, :k].contiguous(), gm16[:, :n].contiguous(), *ref, 1e-3, 5e-4, 0.9, 0.99, 5)
    torch.testing.assert_close(w, ref[0], atol=1e-6, rtol=0)
    assert torch.equal(nu, ref[2]) and torch.equal(mu, ref[1])
    w16 = bf16_shadow(w)
    assert w16.shape == (k, 304) and not w16[:, n:].any()


def test_k2_reads_the_shadow_k1_built(cuda):
    """After a K1 forward on W, K2 reads the same shadow: one operand pass
    (gm16) and one GEMM, no rebuild; its result is K2's plain version, to
    1e-4 of the largest value."""
    x, w, b = _output_inputs(200, 640, 1283, cuda)
    out = fused_output(x, w, b)
    assert out.is_contiguous()
    g = torch.randn(out.shape, generator=torch.Generator(device=cuda).manual_seed(2), device=cuda)
    before = (*_k2_counts(), bf16_shadow.builds)
    dx = fused_output_dx(g, out, w)
    assert (*_k2_counts(), bf16_shadow.builds) == (before[0] + 1, before[1] + 1, before[2] + 1, before[3])
    assert _rel_err(dx, fused_output_dx_reference(g, out, w)) <= 1e-4


ATTN_SHAPES = [(3, 100, 32, 4), (5, 7, 16, 2), (2, 40, 32, 1)]


def _seed(device, value=1234):
    return torch.tensor([value], dtype=torch.int32, device=device)


@pytest.mark.parametrize(
    "dtype,atol",
    # As at rate 0: bf16 rounds where the TPU kernel does in the kernel and
    # where the model's attention does in the plain version.
    [(torch.float32, 1e-4), (torch.bfloat16, 0.05)],
    ids=["f32", "bf16"],
)
@pytest.mark.parametrize("bsz,s,e,heads", ATTN_SHAPES)
def test_attention_dropout_forward_matches_plain(cuda, dtype, atol, bsz, s, e, heads):
    """K5 and K7 at rate 0.2 against the plain version fed the same seed:
    the Philox mask is the same, so the values compare; K7's stored mask
    equals the plain mask byte for byte, and v1 and v2 give the same bits."""
    x, w = _attn_inputs(bsz, s, e, cuda, dtype)
    seed = _seed(cuda)
    before = (fused_attention.launches, fused_attention2.launches)
    out1 = fused_attention(x, w, heads, 0.2, seed)
    out2, mask = fused_attention2(x, w, heads, 0.2, seed, return_mask=True)
    assert (fused_attention.launches, fused_attention2.launches) == (before[0] + 1, before[1] + 1)
    want_mask = dropout_keep(seed, (bsz, heads, s, s), 0.2)
    assert mask.dtype == torch.uint8 and torch.equal(mask, want_mask.to(torch.uint8))
    assert torch.equal(out1, out2)
    want = fused_attention_reference(x, w, heads, mask=want_mask, rate=0.2)
    torch.testing.assert_close(out1.float(), want.float(), atol=atol, rtol=0)
    assert not torch.equal(out1, fused_attention(x, w, heads, 0.2, _seed(cuda, 99)))


# Backward kernels against the plain backward, relative to the largest
# value: dx to its own, the weight gradients to the largest of the eight
# (dbk is 0 in exact arithmetic). f32: sums in another order. bf16: dlogits,
# dq, dk, dv and attn are rounded to bf16, and an f32 value that differs in
# its last bits may round to the other bf16 neighbour (2^-8 relative).
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _assert_grads_close(got, want, tol):
    dx, dw = got
    wdx, wdw = want
    assert dx.dtype == wdx.dtype
    assert _rel_err(dx.float(), wdx.float()) <= tol
    scale = max(float(v.abs().max()) for v in wdw.values())
    for k in KEYS:
        assert dw[k].dtype == torch.float32
        assert float((dw[k] - wdw[k]).abs().max()) <= tol * scale, k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("bsz,s,e,heads", ATTN_SHAPES)
def test_attention_backward_kernels_match_plain(cuda, dtype, rate, bsz, s, e, heads):
    """K6 (mask regenerated) and K8 (mask read) against
    fused_attention_backward_reference with the plain mask; both kernels
    give the same bits, twice."""
    x, w = _attn_inputs(bsz, s, e, cuda, dtype)
    g = torch.randn(x.shape, generator=torch.Generator(device=cuda).manual_seed(5), device=cuda).to(dtype)
    seed = _seed(cuda)
    mask = dropout_keep(seed, (bsz, heads, s, s), rate).to(torch.uint8) if rate else None
    before = (fused_attention_backward.launches, fused_attention2_backward.launches)
    k6 = fused_attention_backward(x, g, w, heads, rate, seed)
    k8 = fused_attention2_backward(x, g, w, heads, rate, mask)
    assert (fused_attention_backward.launches, fused_attention2_backward.launches) == (
        before[0] + 1, before[1] + 1)
    want = fused_attention_backward_reference(x, g, w, heads, rate, mask)
    _assert_grads_close(k6, want, BWD_TOL[dtype])
    again = fused_attention_backward(x, g, w, heads, rate, seed)
    assert torch.equal(k6[0], k8[0]) and torch.equal(k6[0], again[0])
    assert all(torch.equal(k6[1][k], k8[1][k]) and torch.equal(k6[1][k], again[1][k]) for k in KEYS)


@pytest.mark.parametrize("stored", [False, True], ids=["v1", "v2"])
def test_attention_autograd_launches_forward_and_backward(cuda, stored):
    """Through autograd at rate 0.2 each entry point launches its forward
    and its backward kernel once, and the gradients are the plain
    backward's with the plain mask."""
    x, w = _attn_inputs(4, 100, 32, cuda, torch.float32)
    x = x.clone().requires_grad_()
    w = {k: v.clone().requires_grad_() for k, v in w.items()}
    seed = _seed(cuda)
    fn, bwd = (fused_attention2, fused_attention2_backward) if stored else (fused_attention, fused_attention_backward)
    before = (fn.launches, bwd.launches)
    out = fn(x, w, 4, 0.2, seed)
    out.square().sum().backward()
    assert (fn.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    mask = dropout_keep(seed, (4, 4, 100, 100), 0.2)
    want = fused_attention_backward_reference(
        x.detach(), 2 * out.detach(), {k: v.detach() for k, v in w.items()}, 4, 0.2, mask)
    _assert_grads_close((x.grad, {k: v.grad for k, v in w.items()}), want, BWD_TOL[torch.float32])


# The bf16 tensor-core kernels: the test shapes above (S = 7 is odd, d = 32
# at H = 1) and the model's at the batches of render, serve and training.
MMA_SHAPES = ATTN_SHAPES + [(1, 100, 32, 4), (15, 100, 32, 4), (64, 100, 32, 4), (1024, 100, 32, 4)]


def _mma_counts():
    return attention_mma_fwd.launches, attention_mma_bwd.launches


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("bsz,s,e,heads", MMA_SHAPES)
def test_tensor_core_attention_matches_plain(cuda, rate, bsz, s, e, heads):
    """The bf16 forward and backward on tensor cores against the plain
    versions fed the plain mask (tolerances as above: 0.05 forward, 2e-2
    of the largest value backward); the stored mask equals the plain mask
    byte for byte; v1 and v2 give the same bits, and so do K6 and K8, twice;
    each call launches its kernel once."""
    x, w = _attn_inputs(bsz, s, e, cuda, torch.bfloat16)
    g = torch.randn(x.shape, generator=torch.Generator(device=cuda).manual_seed(5), device=cuda)
    g = g.to(torch.bfloat16)
    seed = _seed(cuda)
    want_mask = dropout_keep(seed, (bsz, heads, s, s), rate).to(torch.uint8) if rate else None
    before = _mma_counts()
    out1 = fused_attention(x, w, heads, rate, seed)
    out2, mask = fused_attention2(x, w, heads, rate, seed, return_mask=True)
    assert _mma_counts() == (before[0] + 2, before[1])
    assert torch.equal(out1, out2) and out1.dtype == torch.bfloat16
    if rate:
        assert torch.equal(mask, want_mask)
    else:
        assert mask is None
    want = fused_attention_reference(x, w, heads, mask=want_mask, rate=rate)
    torch.testing.assert_close(out1.float(), want.float(), atol=0.05, rtol=0)
    k6 = fused_attention_backward(x, g, w, heads, rate, seed)
    k8 = fused_attention2_backward(x, g, w, heads, rate, want_mask)
    again = fused_attention2_backward(x, g, w, heads, rate, want_mask)
    assert _mma_counts() == (before[0] + 2, before[1] + 3)
    _assert_grads_close(k8, fused_attention_backward_reference(x, g, w, heads, rate, want_mask),
                        BWD_TOL[torch.bfloat16])
    for other in (k6, again):
        assert torch.equal(k8[0], other[0]) and all(torch.equal(k8[1][k], other[1][k]) for k in KEYS)


@pytest.mark.parametrize("stored", [False, True], ids=["v1", "v2"])
def test_tensor_core_attention_through_autograd(cuda, stored):
    """A bf16 call through autograd launches the tensor-core forward and
    backward once each, and the entry point's own kernels once each."""
    x, w = _attn_inputs(4, 100, 32, cuda, torch.bfloat16)
    x = x.clone().requires_grad_()
    w = {k: v.clone().requires_grad_() for k, v in w.items()}
    fn, bwd = (fused_attention2, fused_attention2_backward) if stored else (fused_attention, fused_attention_backward)
    before = (*_mma_counts(), fn.launches, bwd.launches)
    fn(x, w, 4, 0.2, _seed(cuda)).float().square().sum().backward()
    assert (*_mma_counts(), fn.launches, bwd.launches) == tuple(c + 1 for c in before)
    assert x.grad.dtype == torch.bfloat16 and all(v.grad is not None for v in w.values())


def _f32_counts():
    return (fused_attention.launches, fused_attention2.launches, fused_attention_backward.launches,
            fused_attention2_backward.launches)


def test_f32_attention_still_takes_the_cuda_core_kernels(cuda):
    """An f32 call of each of the four entry points launches the f32
    kernels (the cluster kernels of csrc/fused_attention.cu) and not the
    tensor-core ones, directly and through autograd."""
    x, w = _attn_inputs(2, 100, 32, cuda, torch.float32)
    g = torch.randn(x.shape, generator=torch.Generator(device=cuda).manual_seed(5), device=cuda)
    before = (*_mma_counts(), *_f32_counts())
    out, mask = fused_attention2(x, w, 4, 0.2, _seed(cuda), return_mask=True)
    fused_attention2_backward(x, g, w, 4, 0.2, mask)
    fused_attention(x, w, 4, 0.2, _seed(cuda))
    fused_attention_backward(x, g, w, 4, 0.2, _seed(cuda))
    assert (*_mma_counts(), *_f32_counts()) == (
        before[0], before[1], before[2] + 1, before[3] + 1, before[4] + 1, before[5] + 1)
    xg = x.clone().requires_grad_()
    fused_attention(xg, w, 4, 0.2, _seed(cuda)).sum().backward()
    assert (*_mma_counts(), *_f32_counts()) == (
        before[0], before[1], before[2] + 2, before[3] + 1, before[4] + 2, before[5] + 1)


# The f32 kernels' layout at its edges: a cluster of H blocks a sample
# (H = 1, 2, 4; head widths 8, 16 and 32), a lane per 4 keys (S % 4 != 0
# draws each element's Philox word alone; S = 128, the most), the batches of
# render, serve and a single sample, and the backward's largest shared
# memory (S = 128, d = 32).
F32_EDGE_SHAPES = [(1, 100, 32, 4), (15, 100, 32, 4), (64, 100, 32, 4), (5, 7, 16, 2),
                   (3, 37, 32, 4), (2, 40, 32, 1), (2, 100, 32, 2), (4, 128, 32, 4), (2, 128, 32, 1)]


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("bsz,s,e,heads", F32_EDGE_SHAPES)
def test_f32_attention_kernels_at_the_layouts_edges(cuda, rate, bsz, s, e, heads):
    """K5/K7 and K6/K8 in f32 against the plain versions fed the plain
    mask (1e-4 forward, BWD_TOL backward); K7's mask equals the plain mask
    byte for byte; v1 and v2, K6 and K8, and a second run give the same
    bits."""
    x, w = _attn_inputs(bsz, s, e, cuda, torch.float32, seed=bsz + s)
    g = torch.randn(x.shape, generator=torch.Generator(device=cuda).manual_seed(6), device=cuda)
    seed = _seed(cuda)
    want_mask = dropout_keep(seed, (bsz, heads, s, s), rate).to(torch.uint8) if rate else None
    out1 = fused_attention(x, w, heads, rate, seed)
    out2, mask = fused_attention2(x, w, heads, rate, seed, return_mask=True)
    again = fused_attention(x, w, heads, rate, seed)
    assert torch.equal(out1, out2) and torch.equal(out1, again)
    if rate:
        assert torch.equal(mask, want_mask)
    want = fused_attention_reference(x, w, heads, mask=want_mask, rate=rate)
    torch.testing.assert_close(out1, want, atol=1e-4, rtol=0)
    k6 = fused_attention_backward(x, g, w, heads, rate, seed)
    k8 = fused_attention2_backward(x, g, w, heads, rate, want_mask)
    k6_again = fused_attention_backward(x, g, w, heads, rate, seed)
    _assert_grads_close(k6, fused_attention_backward_reference(x, g, w, heads, rate, want_mask),
                        BWD_TOL[torch.float32])
    for other in (k8, k6_again):
        assert torch.equal(k6[0], other[0]) and all(torch.equal(k6[1][k], other[1][k]) for k in KEYS)


def _wide_counts():
    return attention_wide_fwd.launches, attention_wide_bwd.launches


def test_f32_attention_refuses_what_it_cannot_take(cuda):
    """The f32 kernels' limits, each named by the error: a lane per 4 keys
    (S <= 128), a lane per output column (E <= 32), head widths 8, 16 and
    32. The entry points take those shapes through the general kernels."""
    from ai_font_renderer_tpu_torch.ops.fused_attention import _check_f32

    for (s, e, heads), match in (((129, 32, 4), "S <= 128"), ((8, 64, 4), "E <= 32"),
                                 ((8, 32, 8), "head width")):  # d = 4
        x, w = _attn_inputs(1, s, e, cuda, torch.float32)
        with pytest.raises(ValueError, match=match):
            _check_f32(x, heads, backward=False)
        before = _wide_counts()
        fused_attention(x, w, heads)
        fused_attention2(x, w, heads)
        assert _wide_counts() == (before[0] + 2, before[1])


def test_tensor_core_attention_refuses_what_it_cannot_take(cuda):
    x, w = _attn_inputs(2, 8, 32, cuda, torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        attention_mma_fwd(x.float(), w, 4)
    with pytest.raises(ValueError, match="head width"):
        attention_mma_fwd(x, w, 8)  # d = 4
    long_x, _ = _attn_inputs(1, 113, 32, cuda, torch.bfloat16)
    with pytest.raises(ValueError, match="S <= 112"):
        attention_mma_fwd(long_x, w, 4)
    before = _wide_counts()
    fused_attention2(long_x, w, 4)
    assert _wide_counts() == (before[0] + 1, before[1])


@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16], ids=["mu_f32", "mu_bf16"])
@pytest.mark.parametrize("m,k,n", [(200, 640, 384), (37, 200, 301), (1024, 256, 256)])
def test_fused_dw_adamw_xt_matches_plain(cuda, mu_dtype, m, k, n):
    """K9 against its plain version at step 5, with K4's tolerances; and K9
    equals K4 given x = xt^T, to the same tolerances (both sum the same bf16
    products in f32, in another order)."""
    gen = torch.Generator(device=cuda).manual_seed(m)
    xt = torch.relu(torch.randn(k, m, generator=gen, device=cuda)).to(torch.bfloat16)
    gm = (torch.randn(m, n, generator=gen, device=cuda) * 1e-3).to(torch.bfloat16)
    w, mu, nu = _adam_state(k, n, mu_dtype, cuda)
    ref = [t.clone() for t in (w, mu, nu)]
    k4 = [t.clone() for t in (w, mu, nu)]
    before = fused_dw_adamw_xt.launches
    got = fused_dw_adamw_xt(xt, gm, w, mu, nu, 1e-3, 5)
    assert fused_dw_adamw_xt.launches == before + 1 and got[0] is w
    fused_dw_adamw_xt_reference(xt, gm, *ref, 1e-3, 5)
    fused_dw_adamw(xt.T.contiguous(), gm, *k4, 1e-3, 5e-4, 0.9, 0.99, 5)
    for other in (ref, k4):
        torch.testing.assert_close(w, other[0], atol=1e-6, rtol=0)
        assert _rel_err(nu, other[2]) <= 1e-4
        scale = float(other[1].float().abs().max())
        rtol = 0.0 if mu_dtype == torch.float32 else 2**-7
        torch.testing.assert_close(mu.float(), other[1].float(), rtol=rtol, atol=1e-4 * scale)


@pytest.mark.parametrize("stored", [False, True], ids=["v1", "v2"])
def test_train_step_through_attention_kernels_matches_plain_step(cuda, stored):
    """One step of a narrowed model on the card with dropout off, through
    the attention kernels (forward and backward), against the plain step on
    the same weights and batch: loss to 1e-5 relative; the attention
    weights' first moment mu/(1-b1), the gradient at step 1 with f32
    moments, to 1e-3 of the largest of the eight (f32 sums in another
    order, through the clamp mask and fc1)."""
    from ai_font_renderer_tpu_torch.config import ModelConfig, TrainConfig, replace
    from ai_font_renderer_tpu_torch.models import font_renderer
    from ai_font_renderer_tpu_torch.train.step import state_from_params, train_step

    plain_m = ModelConfig(max_length=24, hidden_dim=32, sheet_height=20, sheet_width=60,
                          dropout_rate=0.0, fc_dropout_rate=0.0)
    kern_m = replace(plain_m, **{"fused_attention_v2" if stored else "fused_attention": True})
    params = font_renderer.init(torch.Generator().manual_seed(0), plain_m, "cpu")
    params = {k: v.to(cuda) for k, v in params.items()}
    gen = torch.Generator(device=cuda).manual_seed(1)
    codes = torch.randint(32, 127, (24, 24), generator=gen, device=cuda, dtype=torch.int32)
    targets = torch.rand(24, 20, 60, generator=gen, device=cuda)
    tcfg = TrainConfig(adam_mu_bf16=False)
    bwd = fused_attention2_backward if stored else fused_attention_backward
    before = bwd.launches
    kern, kloss = train_step(state_from_params(params, tcfg), codes, targets, 1e-3, gen, kern_m, tcfg)
    plain, ploss = train_step(state_from_params(params, tcfg), codes, targets, 1e-3, gen, plain_m, tcfg)
    assert bwd.launches == before + 1
    assert abs(float(kloss) - float(ploss)) <= 1e-5 * float(ploss)
    scale = max(float(plain.mu[k].abs().max()) for k in KEYS)
    for k in KEYS:
        assert float((kern.mu[k] - plain.mu[k]).abs().max()) <= 1e-3 * scale, k


# --- the general kernels, at the shapes the register-tiled ones do not take ---

# (B, S, E, H): S past both register-tiled kernels, E = 64, head width 4,
# head width 12 with an odd S, one head of 64, and the model's shape (which
# the entries send to the register-tiled kernels; the general wrappers take
# it too).
WIDE_SHAPES = [(2, 129, 32, 4), (3, 100, 64, 4), (2, 37, 32, 8), (3, 61, 36, 3), (1, 300, 64, 1),
               (4, 100, 32, 4)]


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("bsz,s,e,heads", WIDE_SHAPES)
def test_general_attention_kernels_match_plain(cuda, rate, dtype, bsz, s, e, heads):
    """The general forward and backward against the plain versions fed the
    plain mask (forward: 1e-4 in f32; in bf16 2e-2 of the largest |plain|
    value, since q, k, v and out round once here and twice in the plain
    version, and at S = 300, E = 64 an output of 2.25 lies 4 bf16 steps
    away; backward: BWD_TOL); the stored
    mask equals the plain mask byte for byte; the mask drawn and the mask
    stored give the same bits, forward and backward, and so does a second
    run; each call launches its kernel once."""
    x, w = _attn_inputs(bsz, s, e, cuda, dtype, seed=s + e)
    g = torch.randn(x.shape, generator=torch.Generator(device=cuda).manual_seed(5), device=cuda).to(dtype)
    seed = _seed(cuda)
    want_mask = dropout_keep(seed, (bsz, heads, s, s), rate).to(torch.uint8) if rate else None
    before = _wide_counts()
    out1, _ = attention_wide_fwd(x, w, heads, rate, seed)
    out2, mask = attention_wide_fwd(x, w, heads, rate, seed, store_mask=True)
    assert torch.equal(out1, out2) and out1.dtype == dtype
    assert torch.equal(mask, want_mask) if rate else mask is None
    want = fused_attention_reference(x, w, heads, mask=want_mask, rate=rate)
    atol = 1e-4 if dtype == torch.float32 else 2e-2 * float(want.float().abs().max())
    torch.testing.assert_close(out1.float(), want.float(), atol=atol, rtol=0)
    k6 = attention_wide_bwd(x, g, w, heads, rate, seed)
    k8 = attention_wide_bwd(x, g, w, heads, rate, None, want_mask)
    again = attention_wide_bwd(x, g, w, heads, rate, seed)
    assert _wide_counts() == (before[0] + 2, before[1] + 3)
    _assert_grads_close(k6, fused_attention_backward_reference(x, g, w, heads, rate, want_mask), BWD_TOL[dtype])
    for other in (k8, again):
        assert torch.equal(k6[0], other[0]) and all(torch.equal(k6[1][k], other[1][k]) for k in KEYS)


@pytest.mark.parametrize("stored", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_entries_take_the_general_kernels_at_E64_through_autograd(cuda, stored, dtype):
    """At E = 64 an entry point's forward and backward under autograd
    launch the general kernels once each, and their gradients equal the
    general backward's."""
    x, w = _attn_inputs(3, 100, 64, cuda, dtype)
    seed = _seed(cuda)
    entry = fused_attention2 if stored else fused_attention
    before = _wide_counts()
    xg = x.clone().requires_grad_()
    wg = {k: v.clone().requires_grad_() for k, v in w.items()}
    entry(xg, wg, 4, 0.2, seed).float().sum().backward()
    assert _wide_counts() == (before[0] + 1, before[1] + 1)
    dx, dw = attention_wide_bwd(x, torch.ones_like(x), w, 4, 0.2, seed)
    assert torch.equal(xg.grad, dx) and all(torch.equal(wg[k].grad, dw[k]) for k in KEYS)


@pytest.mark.parametrize("flag", ["fused_attention", "fused_attention_v2"])
@pytest.mark.parametrize(
    "kw,taken",
    [(dict(embedding_dim=64), False), (dict(max_length=129, hidden_dim=8), False),
     (dict(max_length=113, hidden_dim=8, bf16_frontend=True), False), (dict(), True)],
    ids=["E64", "S129", "S113_bf16", "model_width"],
)
def test_train_step_with_a_fused_attention_flag_at_any_shape(cuda, flag, kw, taken):
    """A training step with either fused attention flag at E = 64, S = 129
    and S = 113 in bf16, shapes the register-tiled kernels do not take:
    the entry points launch the general kernels, as the TPU kernels take
    any E and S, and the step runs (it raised before). At a shape the
    register-tiled kernels take, they launch and the general ones do not."""
    from ai_font_renderer_tpu_torch.config import ModelConfig, TrainConfig
    from ai_font_renderer_tpu_torch.models import font_renderer
    from ai_font_renderer_tpu_torch.train.step import state_from_params, train_step

    mcfg = ModelConfig(**{"max_length": 24, "hidden_dim": 16, "sheet_height": 20, "sheet_width": 60,
                          flag: True, **kw})
    params = font_renderer.init(torch.Generator(device=cuda).manual_seed(0), mcfg, cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    codes = torch.randint(32, 127, (16, mcfg.max_length), generator=gen, device=cuda, dtype=torch.int32)
    targets = torch.rand(16, 20, 60, generator=gen, device=cuda)
    tcfg = TrainConfig(batch_size=16)
    fwd = fused_attention2 if flag == "fused_attention_v2" else fused_attention
    bwd = fused_attention2_backward if flag == "fused_attention_v2" else fused_attention_backward
    before = (fwd.launches, bwd.launches, *_wide_counts())
    _, loss = train_step(state_from_params(params, tcfg), codes, targets, 1e-3, gen, mcfg, tcfg)
    assert bool(torch.isfinite(loss))
    wide = 0 if taken else 1
    assert (fwd.launches, bwd.launches, *_wide_counts()) == (
        before[0] + 1, before[1] + 1, before[2] + wide, before[3] + wide)


def test_kernel_takes_equals_the_libraries_rules(cuda):
    """The Python predicate the entry points dispatch on against the
    libraries' own rules, afr_fused_attention_shape_ok (f32) and
    afr_attention_mma_shape_ok (bf16), over a grid of (S, E, H); the
    general kernels take every shape of the grid."""
    from ai_font_renderer_tpu_torch.ops import _build
    from ai_font_renderer_tpu_torch.ops.fused_attention import (
        _MMA_SIGNATURES,
        _SIGNATURES,
        _WIDE_SIGNATURES,
        kernel_takes,
    )

    f32 = _build.load("fused_attention", _SIGNATURES)
    mma = _build.load("attention_mma", _MMA_SIGNATURES)
    wide = _build.load("attention_wide", _WIDE_SIGNATURES)
    checked = 0
    for S in (1, 7, 64, 100, 111, 112, 113, 127, 128, 129, 200):
        for E in (8, 16, 24, 30, 32, 40, 64):
            for H in (1, 2, 3, 4, 8):
                assert kernel_takes(S, E, H, torch.float32) is bool(f32.afr_fused_attention_shape_ok(S, E, H))
                assert kernel_takes(S, E, H, torch.bfloat16) is bool(mma.afr_attention_mma_shape_ok(S, E, H))
                assert bool(wide.afr_attention_wide_shape_ok(S, E, H)) is (E % H == 0)
                checked += 1
    assert checked == 11 * 7 * 5


# --- the data path on the card ----------------------------------------------


def test_proportional_synthesis_on_the_card_equals_the_oracle(cuda):
    """Montserrat at full width: 96 corpus sheets and the test strings
    synthesized on the card (TF32 off) equal the numpy oracle in u8."""
    from ai_font_renderer_tpu_torch.cli import TEST_STRINGS
    from ai_font_renderer_tpu_torch.config import MONTSERRAT_PATH
    from ai_font_renderer_tpu_torch.fontgen import (
        bake_prop_atlas,
        encode_prop_grids,
        generate_corpus,
        synthesize_prop_host,
        synthesize_prop_sheets,
    )
    from ai_font_renderer_tpu_torch.fontgen.dataset import build_device_dataset_prop, synthesize_ground_truth

    atlas = bake_prop_atlas(MONTSERRAT_PATH)
    texts = generate_corpus(96) + TEST_STRINGS
    grids = encode_prop_grids(texts, atlas)
    got = synthesize_prop_sheets(atlas, grids, device=cuda)
    assert got.device.type == "cuda"
    want = np.round(synthesize_prop_host(atlas, grids) * 255)
    np.testing.assert_array_equal(np.round(got.cpu().numpy() * 255), want)
    ds = build_device_dataset_prop(atlas, 96, synth_batch=64, device=cuda)
    np.testing.assert_array_equal(ds.targets_u8.cpu().numpy(), want[:96].astype(np.uint8))
    truth = synthesize_ground_truth(atlas, TEST_STRINGS, on_device=True, synth_batch=8, device=cuda)
    np.testing.assert_array_equal(np.round(truth * 255), want[96:])


def test_device_dataset_from_disk_onto_the_card(cuda, tmp_path):
    """fontgen on the card, read back onto the card: codes and u8 targets
    equal the device dataset's."""
    from ai_font_renderer_tpu_torch import cli
    from ai_font_renderer_tpu_torch.config import FIRACODE_PATH
    from ai_font_renderer_tpu_torch.fontgen import bake_atlas, build_device_dataset
    from ai_font_renderer_tpu_torch.fontgen.dataset import device_dataset_from_disk

    out = str(tmp_path / "train_input")
    assert cli.main(["fontgen", "--num-samples", "40", "--out", out]) == 0
    disk = device_dataset_from_disk(out, 40, device=cuda)
    built = build_device_dataset(bake_atlas(FIRACODE_PATH), 40, device=cuda)
    assert disk.targets_u8.device.type == "cuda" and disk.codes.device.type == "cuda"
    assert torch.equal(disk.targets_u8, built.targets_u8) and torch.equal(disk.codes, built.codes)


# --- the conv decoders and int8 serving on the card --------------------------


@pytest.mark.parametrize("decoder", ["conv", "conv_ps"])
def test_conv_forward_f32_on_the_card_matches_the_cpu(cuda, decoder):
    """The full-width conv decoders (default plan) in f32 on the card
    (cuDNN, TF32 off) against the same forward on the CPU: 1e-5 before
    the clamp; TF32 would show as about 1e-3."""
    from ai_font_renderer_tpu_torch.config import ModelConfig
    from ai_font_renderer_tpu_torch.models import font_renderer

    mcfg = ModelConfig(decoder=decoder, bf16_matmul=False)
    params = font_renderer.init(torch.Generator().manual_seed(0), mcfg, "cpu")
    codes = torch.randint(32, 127, (15, 100), generator=torch.Generator().manual_seed(1), dtype=torch.int32)
    flat = font_renderer.frontend(params, codes, mcfg)
    want = font_renderer.conv_decode(params, flat, mcfg)
    got = font_renderer.conv_decode({k: v.to(cuda) for k, v in params.items()}, flat.to(cuda), mcfg)
    assert got.shape == (15, 80, 240)
    assert float((got.cpu() - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("flag", [None, "fused_attention", "fused_attention_v2"])
@pytest.mark.parametrize("decoder", ["conv", "conv_ps"])
def test_conv_training_step_on_the_card(cuda, decoder, flag):
    """One standard step of a full-width conv model at batch 16, dropout
    off, through each attention flag (f32: K5/K6, v2: K7/K8 in f32), against
    the same step on the CPU: the loss to 1e-4 relative, every first moment
    mu/(1-b1) (the gradient, f32 moments) to 1e-2 of its largest value:
    f32 sums in other orders through five convolutions, and pixels within
    f32 rounding of a clamp bound that take the mask's other side (1.45e-3
    of the largest seen on the embedding, the farthest parameter)."""
    from ai_font_renderer_tpu_torch.config import ModelConfig, TrainConfig, replace
    from ai_font_renderer_tpu_torch.models import font_renderer
    from ai_font_renderer_tpu_torch.train.step import state_from_params, train_step

    plain = ModelConfig(decoder=decoder, bf16_matmul=False, dropout_rate=0.0, fc_dropout_rate=0.0)
    mcfg = replace(plain, **{flag: True}) if flag else plain
    params = font_renderer.init(torch.Generator().manual_seed(2), plain, "cpu")
    params["dec_out_b"] = torch.full((1,), 0.5)  # pixels inside the clamp carry a gradient
    gen = torch.Generator().manual_seed(3)
    codes = torch.randint(32, 127, (16, 100), generator=gen, dtype=torch.int32)
    targets = torch.rand(16, 80, 240, generator=gen)
    tcfg = TrainConfig(adam_mu_bf16=False)
    bwd = {None: None, "fused_attention": fused_attention_backward,
           "fused_attention_v2": fused_attention2_backward}[flag]
    before = bwd.launches if bwd else 0
    card, closs = train_step(state_from_params({k: v.to(cuda) for k, v in params.items()}, tcfg),
                             codes.to(cuda), targets.to(cuda), 1e-3, torch.Generator(device=cuda), mcfg, tcfg)
    host, hloss = train_step(state_from_params(params, tcfg), codes, targets, 1e-3, torch.Generator(), plain, tcfg)
    if bwd:
        assert bwd.launches == before + 1
    assert abs(float(closs) - float(hloss)) <= 1e-4 * float(hloss)
    for k in host.mu:
        if k == "bk":
            continue
        want = host.mu[k]
        assert float((card.mu[k].cpu() - want).abs().max()) <= 1e-2 * float(want.abs().max()), k


@pytest.mark.parametrize("m", [3, 15, 17, 64, 1024])
def test_int_mm_accumulators_equal_the_plain_product(cuda, m):
    """int8_product on the card (torch._int_mm, rows below 17 padded)
    against the f64 plain product at the model's K and N: equal."""
    from ai_font_renderer_tpu_torch.ops import quantized

    gen = torch.Generator(device=cuda).manual_seed(m)
    a = torch.randint(-127, 128, (m, 6400), generator=gen, device=cuda, dtype=torch.int8)
    w = torch.randint(-127, 128, (6400, 19200), generator=gen, device=cuda, dtype=torch.int8)
    before = quantized.int8_product.launches
    got = quantized.int8_product(a, w)
    assert quantized.int8_product.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (m, 19200)
    assert torch.equal(got, quantized.int8_product_reference(a, w))


def test_int8_render_atlas_on_the_card_matches_the_cpu(cuda):
    """An int8 render_atlas of 96 strings at full width (chunks of 64) on
    the card, with the f32 attention, against the CPU's int8 render. The
    frontends agree to f32 rounding, so the int8 activations are equal but
    where a value lies within that rounding of a half step: a pixel then
    moves by about max|flat| * max|W| / 127 per flipped unit (about 5e-4
    here). Held to 1e-3 at most and 1e-6 in the median row."""
    from ai_font_renderer_tpu_torch.config import ModelConfig
    from ai_font_renderer_tpu_torch.models import font_renderer
    from ai_font_renderer_tpu_torch.ops.quantized import quantize_params
    from ai_font_renderer_tpu_torch.render import render_atlas

    mcfg = ModelConfig(fused_attention=True)
    params = font_renderer.init(torch.Generator().manual_seed(4), mcfg, "cpu")
    served = quantize_params(params)
    rng = np.random.default_rng(5)
    letters = np.array(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ "))
    strings = ["".join(r) for r in letters[rng.integers(0, 27, (96, 60))]]
    want = render_atlas(served, strings, mcfg, chunk=64)
    got = render_atlas({k: v.to(cuda) for k, v in served.items()}, strings, mcfg, chunk=64).cpu()
    assert got.shape == (96, 80, 240) and bool(torch.isfinite(got).all())
    err = (got - want).abs().amax(dim=(1, 2))
    assert float(err.max()) <= 1e-3 and float(err.median()) <= 1e-6


def _implicit_pair(font, device):
    import os

    from ai_font_renderer_tpu_torch.utils.checkpoint import load_params_with_config, load_siren

    art = os.path.join(os.path.dirname(__file__), "..", "artifacts", font)
    sp, scfg, charset = load_siren(os.path.join(art, "siren_finetuned.npz"), device=device)
    pp, pcfg = load_params_with_config(os.path.join(art, "placement_finetuned.npz"), device=device)
    return sp, scfg, charset, pp, pcfg


@pytest.mark.parametrize("font", ["firacode", "montserrat"])
@pytest.mark.parametrize("flag", ["fused_attention", "fused_attention_v2"])
def test_placement_net_through_the_attention_kernels(cuda, flag, font):
    """The committed placement nets (E = 64, H = 8: the general attention
    forward) with a fused attention flag against the plain attention:
    midpoints and logits within 1e-4 of the largest |plain| value."""
    from ai_font_renderer_tpu_torch.cli import TEST_STRINGS
    from ai_font_renderer_tpu_torch.config import replace
    from ai_font_renderer_tpu_torch.fontgen.layout import encode_codes
    from ai_font_renderer_tpu_torch.models import placement

    _, _, _, pp, pcfg = _implicit_pair(font, cuda)
    codes = torch.from_numpy(encode_codes(TEST_STRINGS * 4, 100)).to(cuda)
    before = attention_wide_fwd.launches
    with torch.inference_mode():
        want = placement.apply(pp, codes, pcfg)
        got = placement.apply(pp, codes, replace(pcfg, **{flag: True}))
    assert attention_wide_fwd.launches > before
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


def test_implicit_composites_are_deterministic_on_the_card(cuda):
    """The scatter composite (exact compose) and the one-hot products
    (phased) give the same bits on two renders."""
    from ai_font_renderer_tpu_torch.cli import TEST_STRINGS
    from ai_font_renderer_tpu_torch.config import MONTSERRAT_PATH
    from ai_font_renderer_tpu_torch.render.implicit_sheet import render_implicit_sheets, render_learned_sheets

    sp, scfg, charset, pp, pcfg = _implicit_pair("montserrat", cuda)
    for kw in ({}, {"phased": 8}):
        a = render_learned_sheets(sp, pp, TEST_STRINGS, MONTSERRAT_PATH, scfg, pcfg, charset=charset, **kw)
        b = render_learned_sheets(sp, pp, TEST_STRINGS, MONTSERRAT_PATH, scfg, pcfg, charset=charset, **kw)
        assert torch.equal(a, b), kw
    a = render_implicit_sheets(sp, TEST_STRINGS, MONTSERRAT_PATH, scfg, charset=charset)
    assert torch.equal(a, render_implicit_sheets(sp, TEST_STRINGS, MONTSERRAT_PATH, scfg, charset=charset))


def test_learned_sheets_on_the_card_match_the_cpu(cuda):
    """The Montserrat pair's soft-decode sheets on the card against the CPU,
    within tests/test_torch_implicit.py's bound against the JAX package
    (5e-3: the soft structured decode is ill-conditioned where it hedges)."""
    from ai_font_renderer_tpu_torch.cli import TEST_STRINGS
    from ai_font_renderer_tpu_torch.config import MONTSERRAT_PATH
    from ai_font_renderer_tpu_torch.render.implicit_sheet import render_learned_sheets

    out = []
    for dev in (cuda, "cpu"):
        sp, scfg, charset, pp, pcfg = _implicit_pair("montserrat", dev)
        out.append(render_learned_sheets(sp, pp, TEST_STRINGS, MONTSERRAT_PATH, scfg, pcfg, charset=charset).cpu())
    assert out[0].shape == (15, 80, 240)
    assert float((out[0] - out[1]).abs().max()) <= 5e-3


EXPORT_CFG = dict(embedding_dim=32, num_heads=4, hidden_dim=16, max_length=40, sheet_height=16, sheet_width=48,
                  use_pallas_output=True, fused_attention=True)


def _export_counts():
    """K1, its GEMM, K5, and K5 on its f32 kernel (the entry's launches
    less those of the tensor-core and general builds)."""
    f32 = fused_attention.launches - attention_mma_fwd.launches - attention_wide_fwd.launches
    return fused_output.launches, gemm_bf16_bias_clamp.launches, fused_attention.launches, f32


@pytest.mark.parametrize("traced_on", ["cuda", "cpu"])
def test_exported_artifact_launches_k1_and_f32_k5(cuda, traced_on, tmp_path):
    """An artifact with K1 and f32 K5 at a narrow width, exported on the
    card or on the CPU and loaded onto the card: every call launches K1
    and the f32 K5 kernel, and its u8 sheets equal the direct render's on
    the card bit for bit."""
    from ai_font_renderer_tpu_torch.config import ModelConfig
    from ai_font_renderer_tpu_torch.models import font_renderer
    from ai_font_renderer_tpu_torch.render.render import render_batch_u8_async
    from ai_font_renderer_tpu_torch.utils.export import export_render, load_exported, render_exported_u8

    cfg = ModelConfig(**EXPORT_CFG)
    params = font_renderer.init(torch.Generator(device=cuda).manual_seed(3), cfg, cuda)
    path = str(tmp_path / "k.pt2")
    export_render({k: v.to(traced_on) for k, v in params.items()}, cfg, path)
    artifact = load_exported(path, cuda)
    assert artifact.operators == ("afr::attention_fwd", "afr::fused_output_fwd")
    strings = ["HELLO", "", "THE QUICK BROWN FOX JUMPS OVER THE LAZY"]
    for batch in (strings[:1], strings, strings * 5):
        before = _export_counts()
        got = render_exported_u8(artifact, batch)
        torch.cuda.synchronize()
        after = _export_counts()
        assert all(a == b + 1 for a, b in zip(after, before)), (before, after)
        assert torch.equal(got, render_batch_u8_async(params, batch, cfg))
