"""The f32 attention kernels' order of arithmetic against the JAX package,
on the CPU.

csrc/fused_attention.cu computes the f32 attention block (K5-K8) in
another order than the TPU kernels: a block per head, whose partial
outputs are summed over the heads in head order before bo; the softmax as
exp2 of logits prescaled by log2(e) times the sum's reciprocal, which
scales P v and sum(dP P) after their sums over the keys; the division by
1 - rate as a product with its reciprocal; dk and dv as the
sums of each warp's rows (rows s with s % 4 == w) in warp order; dx as each
head's [dq|dk|dv] [Wq|Wk|Wv]^T, summed over the heads in head order. The
CUDA kernel runs only on the card, so these tests write that order out in
torch (``kernel_order_forward``, ``kernel_order_backward``) and hold it
against the JAX package's f32 fused_attention, fused_attention2 and their
backward (the Pallas kernels in interpret mode), fed the same inputs from
numpy seeds and, at a rate above 0, the mask the JAX _fwd2 drew and stored.
tests/test_torch_cuda.py holds the kernels themselves against the port's
plain versions on the card.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_font_renderer_tpu.ops.fused_attention import _bwd2 as jax_bwd2
from ai_font_renderer_tpu.ops.fused_attention import _fwd2 as jax_fwd2
from ai_font_renderer_tpu.ops.fused_attention import fused_attention as jax_fa
from ai_font_renderer_tpu.ops.fused_attention import fused_attention2 as jax_fa2
from ai_font_renderer_tpu_torch.ops import fused_attention_backward_reference, fused_attention_reference

KEYS = ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo")
LOG2E = 1.4426950408889634
BWD_WARPS = 4  # the backward kernel's warps: query row s goes to warp s % 4
RATES = [0.0, 0.2]
# (B, S, E, H): the model's shape; S % 4 != 0 with two heads of width 8;
# one head of width 32; a ragged S at the model's width.
SHAPES = [(2, 100, 32, 4), (2, 7, 16, 2), (2, 40, 32, 1), (3, 37, 32, 4)]
# Forward: the strict-f32 bound of tests/test_torch_parity.py. Backward:
# the bounds of tests/test_fused_attention.py:59-74 (dx rtol 1e-3, atol
# 2e-4; the weights rtol 2e-3, atol 2e-4 of the largest of the eight).
FWD_ATOL = 1e-5


def _inputs(shape, seed=0):
    bsz, s, e, _ = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, s, e)).astype(np.float32)
    w = {k: rng.uniform(-0.3, 0.3, (e, e)).astype(np.float32) for k in KEYS[:4]}
    w.update({k: (rng.standard_normal(e) * 0.1).astype(np.float32) for k in KEYS[4:]})
    r = rng.standard_normal((bsz, s, e)).astype(np.float32)  # a fixed cotangent
    return x, w, r


def _inv_keep(rate):
    """1 / (1 - rate) as the kernels form it: the f32 reciprocal of f32(1 - rate)."""
    return float(np.float32(1.0) / np.float32(1.0 - rate))


def _head(x, w, h, d):
    cols = slice(h * d, (h + 1) * d)
    return cols, [x @ w[n][:, cols] + w[b][cols] for n, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv"))]


def _dropout(p, keep, rate):
    """p where kept, times 1 / (1 - rate); 0 where dropped."""
    return p if rate == 0.0 else torch.where(keep, p * _inv_keep(rate), torch.zeros(()))


def _softmax(q, k, d):
    """(exp2 of the prescaled logits less their row max, the reciprocal of
    their row sum)."""
    logits = (q @ k.transpose(-1, -2)) * float(np.float32(LOG2E / math.sqrt(d)))
    e = torch.exp2(logits - logits.amax(-1, keepdim=True))
    return e, torch.reciprocal(e.sum(-1, keepdim=True))


def kernel_order_forward(x, w, heads, mask=None, rate=0.0):
    """The forward in the f32 kernel's order: each head's partial output
    attn_h Wo[h rows], summed over the heads in head order, then bo."""
    _, _, e = x.shape
    d = e // heads
    out = None
    for h in range(heads):
        cols, (q, k, v) = _head(x, w, h, d)
        keep = mask[:, h].bool() if mask is not None else None
        e, rs = _softmax(q, k, d)
        part = ((_dropout(e, keep, rate) @ v) * rs) @ w["wo"][cols, :]
        out = part if out is None else out + part
    return out + w["bo"]


def _by_warp(a, b):
    """sum_s a[:, s]^T b[:, s] per sample, as the backward's warps form it:
    each warp over its rows s % BWD_WARPS == w, the warps summed in order."""
    total = None
    for wi in range(BWD_WARPS):
        part = a[:, wi::BWD_WARPS].transpose(-1, -2) @ b[:, wi::BWD_WARPS]
        total = part if total is None else total + part
    return total


def kernel_order_backward(x, g, w, heads, mask=None, rate=0.0):
    """The backward in the f32 kernel's order: per head the row pass
    (exponentials, dP, their sums, P, inner, dlogits, P used, attn_h and
    dq_h of each row), dk_h and dv_h
    by warps, the head's parameter gradients per sample, and dx summed over
    the heads in head order. Returns (dx, {key: gradient summed over the
    batch})."""
    bsz, _, e = x.shape
    d = e // heads
    scale = float(np.float32(1.0 / math.sqrt(d)))
    per = {k: torch.zeros(bsz, e, e) for k in KEYS[:4]}
    per.update({k: torch.zeros(bsz, e) for k in KEYS[4:]})
    dx = None
    for h in range(heads):
        cols, (q, k, v) = _head(x, w, h, d)
        dout = g @ w["wo"][cols, :].T
        keep = mask[:, h].bool() if mask is not None else None
        e, rs = _softmax(q, k, d)
        dp = _dropout(dout @ v.transpose(-1, -2), keep, rate)
        inner = (dp * e).sum(-1, keepdim=True) * rs
        p = e * rs
        pu = _dropout(p, keep, rate)
        dl = (p * (dp - inner)) * scale
        attn = (_dropout(e, keep, rate) @ v) * rs
        dq = dl @ k
        dk, dv = _by_warp(dl, q), _by_warp(pu, dout)
        dqkv = torch.cat([dq, dk, dv], dim=-1)
        for key, bkey, grad in (("wq", "bq", dq), ("wk", "bk", dk), ("wv", "bv", dv)):
            per[key][:, :, cols] = x.transpose(-1, -2) @ grad
            per[bkey][:, cols] = grad.sum(1)
        per["wo"][:, cols, :] = attn.transpose(-1, -2) @ g
        w3 = torch.cat([w["wq"][:, cols], w["wk"][:, cols], w["wv"][:, cols]], dim=1)
        part = dqkv @ w3.T
        dx = part if dx is None else dx + part
    per["bo"] = g.sum(1)
    return dx, {k: v.sum(0) for k, v in per.items()}


def _torch(x, w):
    return torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in w.items()}


def _jax(x, w):
    return jnp.asarray(x), {k: jnp.asarray(v) for k, v in w.items()}


def _jax_mask(shape, x, w, rate):
    """The JAX _fwd2's output and the uint8 mask it drew and stored."""
    bsz, _, _, heads = shape
    jout, (_, _, jmask) = jax_fwd2(heads, rate, bsz, bsz, True, *_jax(x, w), 1234)
    return np.array(jout), np.array(jmask)


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_forward_order_matches_jax(shape, rate):
    """The kernel's forward order against the JAX f32 forward: both entry
    points at rate 0, _fwd2 with the mask it stored at rate 0.2."""
    heads = shape[3]
    x, w, _ = _inputs(shape)
    tx, tw = _torch(x, w)
    if rate == 0.0:
        got = kernel_order_forward(tx, tw, heads).numpy()
        for want in (jax_fa(heads, 0.0, shape[0], True, *_jax(x, w), jnp.int32(0)),
                     jax_fa2(heads, 0.0, shape[0], shape[0], True, *_jax(x, w), jnp.int32(0))):
            np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=FWD_ATOL)
    else:
        want, mask = _jax_mask(shape, x, w, rate)
        got = kernel_order_forward(tx, tw, heads, torch.from_numpy(mask), rate).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL)


def _assert_grads(got, jdx, jdw):
    dx, dw = got
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=1e-3, atol=2e-4)
    gmax = max(float(np.abs(np.asarray(jdw[k])).max()) for k in KEYS)
    for k in KEYS:
        np.testing.assert_allclose(dw[k].numpy(), np.asarray(jdw[k]), rtol=2e-3, atol=2e-4 * gmax,
                                   err_msg=k)


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_backward_order_matches_jax(shape, rate):
    """The kernel's backward order against the JAX f32 backward for the
    loss sum(out * r): jax.grad of both entry points at rate 0 (_bwd_kernel
    and _bwd2_kernel), _bwd2 given _fwd2's stored mask at rate 0.2."""
    bsz, _, _, heads = shape
    x, w, r = _inputs(shape)
    tx, tw = _torch(x, w)
    g = torch.from_numpy(r)
    if rate == 0.0:
        got = kernel_order_backward(tx, g, tw, heads)

        def loss(fn):
            return lambda x, w: jnp.sum(fn(x, w) * r)

        for fn in (lambda x, w: jax_fa(heads, 0.0, bsz, True, x, w, jnp.int32(0)),
                   lambda x, w: jax_fa2(heads, 0.0, bsz, bsz, True, x, w, jnp.int32(0))):
            jdx, jdw = jax.grad(loss(fn), argnums=(0, 1))(*_jax(x, w))
            _assert_grads(got, jdx, jdw)
    else:
        _, mask = _jax_mask(shape, x, w, rate)
        got = kernel_order_backward(tx, g, tw, heads, torch.from_numpy(mask), rate)
        jdx, jdw, _ = jax_bwd2(heads, rate, bsz, bsz, True, (*_jax(x, w), jnp.asarray(mask)), jnp.asarray(r))
        _assert_grads(got, jdx, jdw)


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_order_matches_the_plain_versions(shape, rate):
    """The same order against the port's plain versions, which the card
    tests hold the kernels to (1e-4 there): within 1e-5 forward and 1e-5
    of the largest value backward, so the reordering leaves room."""
    bsz, s, _, heads = shape
    x, w, r = _inputs(shape, seed=1)
    tx, tw = _torch(x, w)
    g = torch.from_numpy(r)
    mask = None
    if rate:
        mask = torch.from_numpy(np.random.default_rng(2).random((bsz, heads, s, s)) >= rate).to(torch.uint8)
    got = kernel_order_forward(tx, tw, heads, mask, rate)
    want = fused_attention_reference(tx, tw, heads, mask=mask, rate=rate)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    dx, dw = kernel_order_backward(tx, g, tw, heads, mask, rate)
    wdx, wdw = fused_attention_backward_reference(tx, g, tw, heads, rate, mask)
    assert float((dx - wdx).abs().max()) <= 1e-5 * float(wdx.abs().max())
    gmax = max(float(v.abs().max()) for v in wdw.values())
    for k in KEYS:
        assert float((dw[k] - wdw[k]).abs().max()) <= 1e-5 * gmax, k
