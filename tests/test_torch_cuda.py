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
    fused_output,
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
