"""The port's attention training path against the JAX package, on the CPU.

On CPU tensors the attention entry points run their plain versions: the
forward is the model's attention math with the kernels' Philox mask, the
backward is the TPU kernel's backward written out. These tests hold them
against the JAX package's Pallas kernels in interpret mode (as
tests/test_fused_attention.py runs them), feeding both sides the same
inputs from numpy seeds and, at a rate above 0, the same uint8 mask. The
CUDA kernels are held against the same plain versions on the card by
tests/test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_font_renderer_tpu import config as jcfg
from ai_font_renderer_tpu.models import font_renderer as jfr
from ai_font_renderer_tpu.ops.fused_attention import _bwd2 as jax_bwd2
from ai_font_renderer_tpu.ops.fused_attention import _fwd2 as jax_fwd2
from ai_font_renderer_tpu.ops.fused_attention import fused_attention as jax_fa
from ai_font_renderer_tpu.ops.fused_attention import fused_attention2 as jax_fa2
from ai_font_renderer_tpu.ops.fused_dw_adamw import fused_dw_adamw as jax_fused_dw_adamw
from ai_font_renderer_tpu.train import step as jstep
from ai_font_renderer_tpu_torch import config as tcfg
from ai_font_renderer_tpu_torch.models import font_renderer as tfr
from ai_font_renderer_tpu_torch.ops import (
    attention_mma_bwd,
    attention_mma_fwd,
    fused_attention,
    fused_attention2,
    fused_attention2_backward,
    fused_attention_backward,
    fused_attention_backward_reference,
    fused_attention_reference,
    fused_dw_adamw_xt,
)
from ai_font_renderer_tpu_torch.ops.fused_attention import _wide_bytes, attention_wide_plan, kernel_takes
from ai_font_renderer_tpu_torch.ops import philox
from ai_font_renderer_tpu_torch.train import step as tstep
from test_torch_native_build import install_reference_native

install_reference_native()

KEYS = ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo")
B, S, E, H = 8, 32, 32, 4
RATE = 0.2
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(bsz=B, s=S, seed=0, e=E):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, s, e)).astype(np.float32)
    w = {k: rng.uniform(-0.3, 0.3, (e, e)).astype(np.float32) for k in KEYS[:4]}
    w.update({k: (rng.standard_normal(e) * 0.1).astype(np.float32) for k in KEYS[4:]})
    r = rng.standard_normal((bsz, s, e)).astype(np.float32)  # a fixed cotangent
    return x, w, r


def _torch(x, w, dtype, grad=False):
    tx = torch.from_numpy(x).to(dtype).requires_grad_(grad)
    tw = {k: torch.from_numpy(v).requires_grad_(grad) for k, v in w.items()}
    return tx, tw


def _seed(value=1234):
    return torch.tensor([value], dtype=torch.int32)


def _mask(seed=None, bsz=B, s=S, heads=H):
    return philox.dropout_keep(seed if seed is not None else _seed(), (bsz, heads, s, s), RATE)


# --- Philox -----------------------------------------------------------------


@pytest.mark.parametrize(
    "counter,key,want",
    # Random123's known-answer vectors of philox4x32-10 (kat_vectors).
    [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        (
            (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
            (0xA4093822, 0x299F31D0),
            (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1),
        ),
    ],
    ids=["zeros", "ones", "pi"],
)
def test_philox_known_answers(counter, key, want):
    words = philox.philox4x32_10(*(torch.tensor([c], dtype=torch.int64) for c in counter), *key)
    assert tuple(int(w) for w in words) == want


def test_mask_bits_do_not_depend_on_how_the_batch_is_cut():
    """The bits of sample b are the same whether drawn for the whole batch
    or for that sample alone (offset b): the mask depends only on the seed
    and the element; a ragged S (not a multiple of 4) included."""
    seed = _seed(77)
    for s in (32, 7):
        whole = philox.dropout_bits(seed, (5, H, s, s))
        parts = torch.cat([philox.dropout_bits(seed, (1, H, s, s), batch_start=b) for b in range(5)])
        assert torch.equal(whole, parts)
        assert int(whole.min()) >= 0 and int(whole.max()) < 2**32
    assert not torch.equal(philox.dropout_bits(_seed(78), (5, H, 7, 7)), whole)


def test_keep_rate_is_within_5_sigma():
    n_mask = _mask(_seed(5), bsz=64)
    n = n_mask.numel()
    keep = 1.0 - RATE
    assert philox.keep_threshold(RATE) == 3435973836
    assert abs(float(n_mask.float().mean()) - keep) <= 5 * (keep * (1 - keep) / n) ** 0.5


def test_dropout_needs_an_int32_seed_on_the_device():
    x, w, _ = _inputs(2)
    tx, tw = _torch(x, w, torch.float32)
    for bad in (None, 3, torch.tensor([3]), torch.tensor([3, 4], dtype=torch.int32)):
        with pytest.raises(ValueError, match="seed"):
            fused_attention(tx, tw, H, RATE, bad)
    with pytest.raises(ValueError, match="forward's mask"):
        fused_attention2_backward(tx, tx, tw, H, RATE, None)
    assert fused_attention(tx, tw, H, 0.0).shape == tx.shape  # rate 0 needs none


# --- gradients against the Pallas kernels ----------------------------------


@pytest.mark.parametrize("entry", ["v1", "v2"])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_gradients_at_rate_0_match_jax_grad(entry, dt):
    """Gradients through the port's autograd Function (plain versions)
    against jax.grad of the JAX fused_attention / fused_attention2 in
    interpret mode, for the loss sum(out * r) with a fixed r. Tolerances of
    tests/test_fused_attention.py:59-74: dx rtol 1e-3 atol 2e-4; the weights
    rtol 2e-3 and atol 2e-4 of the largest of the eight (dbk is 0 in exact
    arithmetic)."""
    tdt, jdt = DTYPES[dt]
    x, w, r = _inputs()

    def loss(x, w):
        if entry == "v1":
            o = jax_fa(H, 0.0, 8, True, x, w, jnp.int32(0))
        else:
            o = jax_fa2(H, 0.0, 8, 8, True, x, w, jnp.int32(0))
        return jnp.sum(o.astype(jnp.float32) * r)

    jdx, jdw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x).astype(jdt), {k: jnp.asarray(v) for k, v in w.items()})
    tx, tw = _torch(x, w, tdt, grad=True)
    fn = fused_attention if entry == "v1" else fused_attention2
    out = fn(tx, tw, H)
    got = torch.autograd.grad((out.float() * torch.from_numpy(r)).sum(), [tx, *(tw[k] for k in KEYS)])
    assert got[0].dtype == tdt
    np.testing.assert_allclose(got[0].float().numpy(), np.asarray(jdx, np.float32), rtol=1e-3, atol=2e-4)
    gmax = max(float(np.abs(jdw[k]).max()) for k in KEYS)
    for k, g in zip(KEYS, got[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(jdw[k]), rtol=2e-3, atol=2e-4 * gmax, err_msg=k)


def _jnp_fwd2(x, w, heads, rate, mask):
    """The forward of _fwd2_kernel (ai_font_renderer_tpu/ops/fused_attention.py
    :384-424) in jnp ops, with a given uint8 keep mask [B, H, S, S]."""
    bsz, s, e = x.shape
    d = e // heads
    scale = 1.0 / (d**0.5)
    dt = x.dtype
    f32 = jnp.float32
    x2 = x.reshape(bsz * s, e)
    q, k, v = (
        (jnp.dot(x2, w[n].astype(dt), preferred_element_type=f32) + w[b]).reshape(bsz, s, e)
        for n, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv"))
    )
    keep = 1.0 - rate
    outs = []
    for h in range(heads):
        qh, kh, vh = (t[:, :, h * d : (h + 1) * d].astype(dt) for t in (q, k, v))
        logits = jax.lax.dot_general(qh, kh, (((2,), (2,)), ((0,), (0,))), preferred_element_type=f32) * scale
        p = jnp.exp(logits - jnp.max(logits, axis=2, keepdims=True))
        probs = (p / jnp.sum(p, axis=2, keepdims=True)).astype(dt)
        probs = jnp.where(mask[:, h] != 0, probs / keep, jnp.zeros((), dt))
        outs.append(jax.lax.dot_general(probs, vh, (((2,), (1,)), ((0,), (0,))), preferred_element_type=f32))
    attn = jnp.concatenate(outs, axis=2).astype(dt).reshape(bsz * s, e)
    out = jnp.dot(attn, w["wo"].astype(dt), preferred_element_type=f32)
    return (out + w["bo"]).reshape(bsz, s, e).astype(dt)


# (B, S, E, H): the shape these tests began with; the model's shape, which
# the bf16 kernels pad to S = 112; an odd S with two heads of width 8.
KERNEL_SHAPES = {"": (B, S, E, H), "-model": (2, 100, 32, 4), "-odd": (2, 7, 16, 2)}


def _shape_cases(tols):
    """(dt, tolerance, shape) cases; the first shape keeps the ids the
    tests had before the other shapes were added."""
    return [
        pytest.param(dt, tol, shape, id=f"{dt}-{tol}{tag}")
        for tag, shape in KERNEL_SHAPES.items()
        for dt, tol in tols
    ]


# As at rate 0 (tests/test_torch_ops.py): 2e-5 in f32; 0.05 in bf16, where
# the plain version rounds where the model's attention does.
@pytest.mark.parametrize("dt,atol,shape", _shape_cases([("f32", 2e-5), ("bf16", 0.05)]))
def test_rate_02_forward_matches_the_kernel_math(dt, atol, shape):
    """Both entry points at rate 0.2 against _fwd2_kernel's math in jnp fed
    the port's Philox mask; the v2 mask returned is that mask. And the
    plain forward fed the mask that the JAX _fwd2 (the Pallas kernel in
    interpret mode) drew and stored against that kernel's output."""
    bsz, s, e, heads = shape
    tdt, jdt = DTYPES[dt]
    x, w, _ = _inputs(bsz, s, e=e)
    mask = _mask(bsz=bsz, s=s, heads=heads).to(torch.uint8)
    jx = jnp.asarray(x).astype(jdt)
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    want = _jnp_fwd2(jx, jw, heads, RATE, jnp.asarray(mask.numpy()))
    tx, tw = _torch(x, w, tdt)
    got1 = fused_attention(tx, tw, heads, RATE, _seed())
    got2, mask2 = fused_attention2(tx, tw, heads, RATE, _seed(), return_mask=True)
    assert torch.equal(mask2, mask) and torch.equal(got1, got2) and got1.dtype == tdt
    np.testing.assert_allclose(got1.float().numpy(), np.asarray(want, np.float32), atol=atol)
    jout, (_, _, jmask) = jax_fwd2(heads, RATE, bsz, bsz, True, jx, jw, 1234)
    plain = fused_attention_reference(tx, tw, heads, mask=torch.from_numpy(np.array(jmask)), rate=RATE)
    np.testing.assert_allclose(plain.float().numpy(), np.asarray(jout, np.float32), atol=atol)


# Relative to the largest value (dx: its own; the weights: the largest of
# the eight). f32: sums in another order. bf16: both sides round dlogits,
# dq, dk, dv and attn to bf16, and an f32 sum that differs in its last bits
# may round to the other bf16 neighbour (2^-8 relative).
@pytest.mark.parametrize("dt,tol,shape", _shape_cases([("f32", 1e-5), ("bf16", 2e-2)]))
def test_rate_02_backward_matches_jax_bwd2_given_the_same_mask(dt, tol, shape):
    """The port's plain backward with the port's mask against the JAX
    package's _bwd2 (the Pallas _bwd2_kernel in interpret mode) called with
    that same uint8 mask; K6's and K8's plain paths agree bit for bit."""
    bsz, s, e, heads = shape
    tdt, jdt = DTYPES[dt]
    x, w, r = _inputs(bsz, s, e=e)
    mask = _mask(bsz=bsz, s=s, heads=heads).to(torch.uint8)
    jx = jnp.asarray(x).astype(jdt)
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    bb = min(8, bsz)
    jdx, jdw, _ = jax_bwd2(heads, RATE, bb, bb, True, (jx, jw, jnp.asarray(mask.numpy())),
                           jnp.asarray(r).astype(jdt))
    tx, tw = _torch(x, w, tdt)
    g = torch.from_numpy(r).to(tdt)
    dx, dw = fused_attention2_backward(tx, g, tw, heads, RATE, mask)
    dx1, dw1 = fused_attention_backward(tx, g, tw, heads, RATE, _seed())
    assert torch.equal(dx, dx1) and all(torch.equal(dw[k], dw1[k]) for k in KEYS)
    jdx = np.asarray(jdx, np.float32)
    assert dx.dtype == tdt
    assert np.abs(dx.float().numpy() - jdx).max() <= tol * np.abs(jdx).max()
    gmax = max(float(np.abs(jdw[k]).max()) for k in KEYS)
    for k in KEYS:
        assert np.abs(dw[k].numpy() - np.asarray(jdw[k])).max() <= tol * gmax, k


@pytest.mark.parametrize("shape", [KERNEL_SHAPES["-model"], KERNEL_SHAPES["-odd"]], ids=["model", "odd"])
def test_tensor_core_wrappers_on_cpu_take_the_plain_versions(shape):
    """The bf16 tensor-core kernels' wrappers on CPU tensors give the entry
    points' plain results bit for bit (stored and regenerated mask alike)
    and count no launch."""
    bsz, s, e, heads = shape
    x, w, r = _inputs(bsz, s, e=e)
    tx, tw = _torch(x, w, torch.bfloat16)
    g = torch.from_numpy(r).to(torch.bfloat16)
    before = (attention_mma_fwd.launches, attention_mma_bwd.launches)
    out, mask = attention_mma_fwd(tx, tw, heads, RATE, _seed(), store_mask=True)
    want, want_mask = fused_attention2(tx, tw, heads, RATE, _seed(), return_mask=True)
    assert torch.equal(out, want) and torch.equal(mask, want_mask)
    want_dx, want_dw = fused_attention2_backward(tx, g, tw, heads, RATE, mask)
    for dx, dw in (attention_mma_bwd(tx, g, tw, heads, RATE, mask=mask),
                   attention_mma_bwd(tx, g, tw, heads, RATE, seed=_seed())):
        assert torch.equal(dx, want_dx) and all(torch.equal(dw[k], want_dw[k]) for k in KEYS)
    assert (attention_mma_fwd.launches, attention_mma_bwd.launches) == before


@pytest.mark.parametrize("rate", [0.1, 0.2, 0.25, 0.5, 0.7])
def test_keep_inverse_rounds_as_the_division(rate):
    """The bf16 tensor-core kernels scale kept probabilities by RN(1/keep)
    instead of dividing by keep (csrc/attention_mma.cu, keep_inverse): for
    every positive finite bf16 value the product rounds to the same bf16 as
    the quotient."""
    keep = torch.tensor(1.0 - rate, dtype=torch.bfloat16).float()
    inv = torch.tensor(np.float32(1.0 / np.float64(keep.item())))
    bits = torch.arange(1, 0x7F80, dtype=torch.int32).to(torch.int16)
    p = bits.view(torch.bfloat16).float()
    assert torch.equal((p * inv).to(torch.bfloat16), (p / keep).to(torch.bfloat16))


# --- dropout semantics (tests/test_fused_attention.py:77-102, 187-211) ------


@pytest.mark.parametrize("entry", ["v1", "v2"])
def test_same_seed_gives_the_same_bits_and_a_new_seed_another_output(entry):
    fn = fused_attention if entry == "v1" else fused_attention2
    x, w, r = _inputs()
    runs = []
    for seed in (7, 7, 8):
        tx, tw = _torch(x, w, torch.float32, grad=True)
        out = fn(tx, tw, H, RATE, _seed(seed))
        grads = torch.autograd.grad((out * torch.from_numpy(r)).sum(), [tx, *tw.values()])
        runs.append((out.detach(), grads))
    (o1, g1), (o2, g2), (o3, _) = runs
    assert torch.equal(o1, o2) and all(torch.equal(a, b) for a, b in zip(g1, g2))
    assert all(bool(torch.isfinite(g).all()) for g in g1)
    assert float((o1 - o3).abs().max()) > 0
    assert float((o1 - fn(*_torch(x, w, torch.float32), H, 0.0)).abs().max()) > 1e-3


def test_v1_and_v2_give_the_same_output_and_gradients_for_one_seed():
    x, w, r = _inputs()
    results = []
    for fn in (fused_attention, fused_attention2):
        tx, tw = _torch(x, w, torch.bfloat16, grad=True)
        out = fn(tx, tw, H, RATE, _seed(3))
        results.append((out.detach(), torch.autograd.grad((out.float() * torch.from_numpy(r)).sum(), [tx, *tw.values()])))
    (o1, g1), (o2, g2) = results
    assert torch.equal(o1, o2) and all(torch.equal(a, b) for a, b in zip(g1, g2))


def test_dropout_is_unbiased_over_seeds():
    """The mean over 8 seeds approaches the undropped output: its error is
    below 0.55 of one seed's (sampling noise ~ 1/sqrt(8) = 0.35)."""
    x, w, _ = _inputs()
    tx, tw = _torch(x, w, torch.float32)
    o0 = fused_attention2(tx, tw, H, 0.0)
    outs = [fused_attention2(tx, tw, H, RATE, _seed(s)) for s in range(8)]
    single = float((outs[0] - o0).abs().mean())
    mean = float((torch.stack(outs).mean(0) - o0).abs().mean())
    assert mean < 0.55 * single, (mean, single)


@pytest.mark.parametrize("bits", [False, True], ids=["bernoulli", "bits"])
@pytest.mark.parametrize("rate", [0.2, 0.25])
def test_plain_dropout_scales_kept_bf16_values_as_jax(rate, bits):
    """The model's plain dropout divides a bf16 x by keep rounded to bf16,
    as jnp does with the Python scalar (1/0.80078125 at rate 0.2, where an
    f32 keep gave 1/0.8): kept values equal the JAX package's _dropout's."""
    x = np.random.default_rng(0).uniform(0.5, 2.0, 4096).astype(np.float32)
    want = np.asarray(jfr._dropout(jnp.asarray(x, jnp.bfloat16), rate, jax.random.PRNGKey(0), True, bits), np.float32)
    got = tfr._dropout(torch.from_numpy(x).to(torch.bfloat16), rate, torch.Generator().manual_seed(0), True, bits)
    got = got.float().numpy()
    both = (got != 0) & (want != 0)
    assert both.mean() > 0.5
    np.testing.assert_array_equal(got[both], want[both])


# --- the model and the trainer ---------------------------------------------

SMALL = dict(max_length=24, sheet_height=20, sheet_width=60, fused_attention_tile=8, fa2_tile_fwd=8, fa2_tile_bwd=8)
NO_DROPOUT = dict(dropout_rate=0.0, fc_dropout_rate=0.0)
FLAGS = {"v1": dict(fused_attention=True), "v2": dict(fused_attention_v2=True)}


def _configs(**kw):
    jm = jcfg.ModelConfig(**SMALL, **kw)
    return jm, tcfg.ModelConfig(**dataclasses.asdict(jm))


@pytest.fixture(scope="module")
def jax_params():
    jm, _ = _configs()
    return {k: np.asarray(v) for k, v in jfr.init(jax.random.PRNGKey(0), jm).items()}


def _codes(bsz, length, seed=0):
    return np.random.default_rng(seed).integers(32, 127, (bsz, length)).astype(np.int32)


@pytest.mark.parametrize("flag", list(FLAGS))
def test_frontend_with_the_flag_matches_the_jax_frontend_vjp(flag, jax_params):
    """The port's frontend through the attention Function at rate 0 against
    the JAX frontend's jax.vjp with the Pallas kernel in interpret mode
    (batch 16, a multiple of the JAX tiles set to 8): output to 2e-5, and
    every parameter's gradient to 1e-4 of its largest value (f32 sums in
    another order through the attention, LayerNorm and fc1)."""
    jm, tm = _configs(**FLAGS[flag], bf16_matmul=False)
    codes = _codes(16, 24)
    cot = np.random.default_rng(1).standard_normal((16, 24 * 64)).astype(np.float32)
    jout, vjp = jax.vjp(lambda p: jfr.frontend(p, jnp.asarray(codes), jm), {k: jnp.asarray(v) for k, v in jax_params.items()})
    (jgrads,) = vjp(jnp.asarray(cot))
    tp = tstep._trainable(tfr.params_from_jax(jax_params, "cpu"))
    before = (fused_attention.launches, fused_attention2.launches)
    out = tfr.frontend(tp, torch.from_numpy(codes), tm)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=2e-5)
    keys = [k for k in tp if k not in ("out_w", "out_b")]
    grads = torch.autograd.grad(out, [tp[k] for k in keys], torch.from_numpy(cot))
    assert (fused_attention.launches, fused_attention2.launches) == before  # CPU: plain versions
    for k, g in zip(keys, grads):
        want = np.asarray(jgrads[k])
        scale = float(np.abs(want).max())
        if k == "bk":  # 0 in exact arithmetic: both sides hold rounding noise
            assert float(g.abs().max()) <= 1e-4 * max(float(np.abs(jgrads["bq"]).max()), 1e-30)
            continue
        assert float(np.abs(g.numpy() - want).max()) <= 1e-4 * scale + 1e-30, k


@pytest.mark.parametrize(
    "case,tkw",
    [("v1_standard", {}), ("v2_fused", dict(fused_dw_adamw=True))],
)
def test_three_steps_through_the_attention_kernels_match_jax(case, tkw):
    """As tests/test_torch_train.py:test_three_steps_match_jax: three steps
    from a JAX state 3 steps in, dropout off, through the fused attention
    (the JAX kernel in interpret mode, the port's Function on the CPU), f32
    frontend and bf16 products: losses to 1e-4 relative, the moments of the
    attention weights to one bf16 step (mu) and 1e-3 (nu) of their largest
    value."""
    flag = FLAGS[case.split("_")[0]]
    jm, tm = _configs(**flag, **NO_DROPOUT)
    jt = jcfg.TrainConfig(batch_size=16, num_samples=96, **tkw)
    tt = tcfg.TrainConfig(**dataclasses.asdict(jt))
    fused = tt.fused_dw_adamw
    init = jstep.init_fused_state if fused else jstep.init_state
    step = jstep.train_step_fused if fused else jstep.train_step
    codes = _codes(16, 24, seed=2)
    targets = np.random.default_rng(3).uniform(size=(16, 20, 60)).astype(np.float32)
    jc, jtg = jnp.asarray(codes), jnp.asarray(targets)
    state = init(jax.random.PRNGKey(0), jm, jt)
    for i in range(3):
        state, _ = step(state, jc, jtg, jnp.float32(1e-3), jax.random.PRNGKey(i), jm, jt)
    port = tstep.train_state_from_jax(jax.tree.map(np.asarray, state), "cpu")
    gen = torch.Generator().manual_seed(0)
    for i in range(3):
        state, jl = step(state, jc, jtg, jnp.float32(1e-3), jax.random.PRNGKey(10 + i), jm, jt)
        port, tl = tstep.train_step(port, torch.from_numpy(codes), torch.from_numpy(targets), 1e-3, gen, tm, tt)
        assert abs(float(tl) - float(jl)) <= 1e-4 * float(jl), (i, float(tl), float(jl))
    adam = state.opt_state[0]
    for k in ("wq", "wk", "wv", "wo", "bq", "bv", "bo"):
        for got, want, tol in ((port.mu[k].float(), adam.mu[k], 2.0**-8), (port.nu[k], adam.nu[k], 1e-3)):
            want = np.asarray(want).astype(np.float32)
            assert float(np.abs(got.numpy() - want).max()) <= tol * float(np.abs(want).max()), k


@pytest.mark.parametrize("flag", list(FLAGS))
def test_remat_none_dots_full_give_bit_equal_steps_with_dropout(flag):
    """remat_frontend recomputes the frontend in the backward; the generator
    is replayed, so "dots" and "full" redraw the attention's seed, and with
    it v1's regenerated mask or v2's stored mask: the updated parameters,
    the loss and the generator's state equal those of "none" bit for bit."""
    _, tm = _configs(**FLAGS[flag])
    params = tfr.init(torch.Generator().manual_seed(0), tm, "cpu")
    codes = torch.from_numpy(_codes(16, 24, seed=4))
    targets = torch.rand(16, 20, 60, generator=torch.Generator().manual_seed(6))
    results = {}
    for mode in ("none", "dots", "full"):
        tt = tcfg.TrainConfig(batch_size=16, handrolled_bwd=True, remat_frontend=mode)
        gen = torch.Generator().manual_seed(5)
        state, loss = tstep.train_step(tstep.state_from_params(params, tt), codes, targets, 1e-3, gen, tm, tt)
        results[mode] = (float(loss), state.params, gen.get_state())
    l0, p0, g0 = results["none"]
    for mode in ("dots", "full"):
        l1, p1, g1 = results[mode]
        assert l1 == l0 and torch.equal(g1, g0), mode
        assert all(torch.equal(p1[k], p0[k]) for k in p0), mode


@pytest.mark.parametrize("flag", list(FLAGS))
def test_training_forward_draws_its_seed_from_the_generator(flag):
    """features(train=True) with a fused attention flag: the same generator
    seed gives the same sheets, another seed other sheets, and the draws go
    embedding mask, attention seed, fc1 mask, as in the JAX package."""
    _, tm = _configs(**FLAGS[flag])
    params = tfr.init(torch.Generator().manual_seed(0), tm, "cpu")
    codes = torch.from_numpy(_codes(4, 24, seed=7))
    run = lambda seed: tfr.apply(params, codes, tm, train=True, generator=torch.Generator().manual_seed(seed))
    assert torch.equal(run(3), run(3)) and not torch.equal(run(3), run(4))
    gen = torch.Generator().manual_seed(9)
    tfr.features(params, codes, tm, train=True, generator=gen)
    replay = torch.Generator().manual_seed(9)
    torch.rand((4, 24, 32), generator=replay)
    seed = torch.randint(0, 2**31, (1,), generator=replay, dtype=torch.int32)
    torch.rand((4, 24, 64), generator=replay)
    assert torch.equal(gen.get_state(), replay.get_state())
    x = tfr.features(params, codes, tm, train=True, generator=torch.Generator().manual_seed(9))
    assert x.shape == (4, 24, 64) and 0 <= int(seed) < 2**31


# --- the register-tiled kernels where they take the shape, the general ones elsewhere ---

F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize(
    "shape,dtype,taken",
    [
        ((100, 32, 4), F32, True),  # the model's shape
        ((100, 32, 4), BF16, True),
        ((1, 32, 4), F32, True),  # a single key
        ((128, 32, 4), F32, True),  # the f32 kernels' longest S
        ((129, 32, 4), F32, False),
        ((112, 32, 4), BF16, True),  # the bf16 kernels' longest S
        ((113, 32, 4), BF16, False),
        ((113, 32, 4), F32, True),
        ((100, 64, 4), F32, False),  # E above 32
        ((100, 64, 8), BF16, False),
        ((100, 64, 8), F32, False),  # the placement net's capacity
        ((100, 48, 2), F32, False),  # head width 24
        ((100, 32, 1), F32, True),  # head widths 32, 16 and 8
        ((100, 32, 2), BF16, True),
        ((100, 24, 3), F32, True),
        ((100, 32, 8), F32, False),  # head width 4
        ((100, 30, 4), F32, False),  # E not a multiple of H
        ((0, 32, 4), F32, False),
        ((100, 32, 4), torch.float16, False),
    ],
)
def test_kernel_takes_states_the_kernels_rules(shape, dtype, taken):
    """The predicate the entry points dispatch on: head width 8, 16 or 32
    and E <= 32; S <= 128 in f32, S <= 112 in bf16; no other dtype. Where
    it is false, the general kernels run. tests/test_torch_cuda.py holds it
    equal to the libraries' own rules."""
    S, E, heads = shape
    assert kernel_takes(S, E, heads, dtype) is taken


@pytest.mark.parametrize(
    "shape,dtype,backward,rows,smem",
    [
        ((100, 64, 8), F32, True, 64, 198592),  # placement training: two chunks of query rows
        ((100, 64, 8), F32, False, 64, 110016),  # two blocks an SM
        ((100, 64, 8), BF16, True, 64, 188544),
        ((100, 64, 4), F32, True, 48, 224512),
        ((129, 32, 4), F32, True, 64, 201984),  # three chunks, the last of one row
        ((100, 48, 2), F32, True, 32, 224320),  # head width 24
        ((152, 64, 8), F32, True, 16, 230784),  # the f32 backward's longest S at E = 64, H = 8
        ((153, 64, 8), F32, True, 0, 0),  # past it: the streamed build
        ((224, 64, 8), BF16, True, 16, 227456),
        ((225, 64, 8), BF16, True, 0, 0),
        ((44, 64, 1), F32, True, 48, 220288),  # head width 64
        ((45, 64, 1), F32, True, 0, 0),
        ((300, 64, 1), F32, False, 0, 0),
        ((512, 16, 2), BF16, False, 32, 190208),  # the longest row the row passes hold in registers
        ((513, 16, 2), BF16, False, 0, 0),
        ((1, 8, 1), F32, True, 16, 4176),
    ],
)
def test_wide_plan_states_the_on_chip_cutoff(shape, dtype, backward, rows, smem):
    """Which build of the general kernels takes a shape: the on-chip one
    with chunks of ``rows`` query rows where S <= 512 and its block fits
    232,448 bytes of shared memory, else (rows 0) the streamed one. tests/test_torch_cuda.py
    holds this mirror equal to the library's own plan."""
    S, E, heads = shape
    plan = attention_wide_plan(S, E, heads, dtype, backward)
    assert (plan["rows"], plan["smem_bytes"]) == (rows, smem)
    assert plan["threads"] == (0 if not rows else 512 if backward else 256)


def test_wide_plan_takes_the_most_rows_that_fit():
    """Over a grid of shapes: rows a multiple of 16 up to 64 and S rounded
    up to 16; the plan fits one block's shared memory and 16 more rows
    would not (or it already has 64, or all of S)."""
    checked = 0
    for S in (1, 15, 16, 17, 63, 64, 65, 100, 129, 200, 400, 600):
        for E, heads in ((64, 8), (64, 4), (48, 2), (36, 3), (64, 1), (128, 8)):
            for dtype in (F32, BF16):
                for backward in (False, True):
                    plan = attention_wide_plan(S, E, heads, dtype, backward)
                    q, most = plan["rows"], min(64, -(-S // 16) * 16) if S <= 512 else 0
                    if q:
                        assert q % 16 == 0 and q <= most and plan["smem_bytes"] <= 232448
                    if q < most:
                        assert _wide_bytes(S, E, heads, dtype == BF16, backward, q + 16) > 232448
                    checked += 1
    assert checked == 12 * 6 * 4


# (B, S, E, H) beyond the register-tiled kernels: S = 129, E = 64, a head
# width of 4, the placement net's E = 64 with 8 heads and a head width of
# 24, which the JAX kernels take as they take any other.
WIDE_SHAPES = {"S129": (2, 129, 32, 4), "E64": (2, 20, 64, 4), "d4": (2, 9, 32, 8), "E64H8": (2, 100, 64, 8),
               "d24": (2, 30, 48, 2)}


@pytest.mark.parametrize("entry", ["v1", "v2"])
@pytest.mark.parametrize("shape", list(WIDE_SHAPES.values()), ids=list(WIDE_SHAPES))
def test_entries_beyond_the_register_tiled_shapes_match_jax_grad(entry, shape):
    """At the shapes the general kernels serve, the entry points (their
    plain versions on the CPU) against the JAX fused_attention /
    fused_attention2 (the Pallas kernels in interpret mode, one tile of the
    whole batch) at rate 0, f32: the output to 2e-5, and the gradients
    with the tolerances of test_gradients_at_rate_0_match_jax_grad."""
    bsz, s, e, heads = shape
    x, w, r = _inputs(bsz, s, e=e)

    def run(x, w):
        if entry == "v1":
            return jax_fa(heads, 0.0, bsz, True, x, w, jnp.int32(0))
        return jax_fa2(heads, 0.0, bsz, bsz, True, x, w, jnp.int32(0))

    jw = {k: jnp.asarray(v) for k, v in w.items()}
    jout = run(jnp.asarray(x), jw)
    jdx, jdw = jax.grad(lambda x, w: jnp.sum(run(x, w) * r), argnums=(0, 1))(jnp.asarray(x), jw)
    tx, tw = _torch(x, w, torch.float32, grad=True)
    out = (fused_attention if entry == "v1" else fused_attention2)(tx, tw, heads)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=2e-5)
    got = torch.autograd.grad((out * torch.from_numpy(r)).sum(), [tx, *(tw[k] for k in KEYS)])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jdx), rtol=1e-3, atol=2e-4)
    gmax = max(float(np.abs(jdw[k]).max()) for k in KEYS)
    for k, g in zip(KEYS, got[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(jdw[k]), rtol=2e-3, atol=2e-4 * gmax, err_msg=k)


def _entry_spy(monkeypatch):
    calls = []
    for name in ("fused_attention", "fused_attention2"):
        entry = getattr(tfr, name)
        monkeypatch.setattr(tfr, name, lambda *a, _e=entry, _n=name, **kw: calls.append(_n) or _e(*a, **kw))
    return calls


@pytest.mark.parametrize("flag", list(FLAGS))
@pytest.mark.parametrize(
    "kw",
    [dict(), dict(embedding_dim=64), dict(max_length=129, hidden_dim=8),
     dict(max_length=113, bf16_frontend=True), dict(max_length=112, bf16_frontend=True)],
    ids=["model_shape", "E64", "S129", "S113_bf16", "S112_bf16"],
)
def test_features_takes_the_kernel_entry_at_every_shape(flag, kw, monkeypatch):
    """With a fused attention flag, ``features`` calls the kernel entry at
    every shape, as the JAX model calls its Pallas kernel whatever E and S
    are (the entry picks the register-tiled or the general kernels on the
    card); its features at eval equal those of the plain attention within
    the rounding of x's type (2e-5 in f32; bf16 rounds the projections
    once, the model's attention twice), and a training step runs."""
    tm = tcfg.ModelConfig(**{**SMALL, **FLAGS[flag], **kw})
    plain_cfg = tcfg.ModelConfig(**{**SMALL, **kw})
    calls = _entry_spy(monkeypatch)
    params = tfr.init(torch.Generator().manual_seed(0), tm, "cpu")
    codes = torch.from_numpy(_codes(4, tm.max_length, seed=8))
    with torch.no_grad():
        x = tfr.features(params, codes, tm)
        want = tfr.features(params, codes, plain_cfg)
    atol = 0.05 if tm.bf16_frontend else 2e-5
    torch.testing.assert_close(x.float(), want.float(), atol=atol, rtol=0)
    tt = tcfg.TrainConfig(batch_size=4)
    targets = torch.rand(4, tm.sheet_height, tm.sheet_width, generator=torch.Generator().manual_seed(1))
    _, loss = tstep.train_step(tstep.state_from_params(params, tt), codes, targets, 1e-3,
                               torch.Generator().manual_seed(2), tm, tt)
    assert bool(torch.isfinite(loss))
    assert len(calls) == 2, calls


# --- K9 ---------------------------------------------------------------------


@pytest.mark.parametrize("mu_bf16", [False, True], ids=["mu_f32", "mu_bf16"])
def test_fused_dw_adamw_xt_plain_matches_jax(mu_bf16):
    """K9's plain version against the JAX package's fused_dw_adamw of xt^T
    (its Pallas kernel in interpret mode) with b1 0.9, b2 0.99, wd 5e-4 at
    count 3, moments seeded non-zero. Tolerances of tests/test_torch_ops.py:
    w to 1e-7, nu and an f32 mu to 1e-5 of their largest value, a bf16 mu to
    one bf16 step plus 1e-5 of its largest value."""
    m, k, n = 256, 640, 384
    rng = np.random.default_rng(11 + mu_bf16)
    xt = np.maximum(rng.standard_normal((k, m)), 0).astype(np.float32)
    gm = (rng.standard_normal((m, n)) * 1e-3).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    mu = (rng.standard_normal((k, n)) * 1e-3).astype(np.float32)
    nu = (rng.uniform(size=(k, n)) * 1e-6).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if mu_bf16 else (jnp.float32, torch.float32)
    jw, jmu, jnu = jax_fused_dw_adamw(
        jnp.asarray(xt).T, jnp.asarray(gm), jnp.asarray(w), jnp.asarray(mu).astype(jdt), jnp.asarray(nu),
        jnp.float32(1e-3), 5e-4, 0.9, 0.99, jnp.int32(3),
    )
    tw, tmu, tnu = (torch.from_numpy(a.copy()) for a in (w, mu, nu))
    tmu = tmu.to(tdt)
    before = fused_dw_adamw_xt.launches
    got = fused_dw_adamw_xt(torch.from_numpy(xt), torch.from_numpy(gm), tw, tmu, tnu, 1e-3, 3)
    assert fused_dw_adamw_xt.launches == before and got[0] is tw and got[1] is tmu
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-7, rtol=0)
    jnu = np.asarray(jnu)
    np.testing.assert_allclose(tnu.numpy(), jnu, atol=1e-5 * np.abs(jnu).max(), rtol=0)
    jmu = np.asarray(jmu).astype(np.float32)
    np.testing.assert_allclose(tmu.float().numpy(), jmu, atol=1e-5 * np.abs(jmu).max(), rtol=2.0**-7 if mu_bf16 else 0.0)


def test_attention_backward_reference_is_autograd_of_the_plain_forward_in_f32():
    """In f32, where no rounding intervenes, the written-out backward equals
    autograd through the plain forward with the same mask, to 1e-5 of the
    largest value (dbk is rounding noise on both sides)."""
    x, w, r = _inputs(4)
    tx, tw = _torch(x, w, torch.float32, grad=True)
    mask = _mask(bsz=4)
    out = fused_attention_reference(tx, tw, H, mask=mask, rate=RATE)
    want = torch.autograd.grad((out * torch.from_numpy(r)).sum(), [tx, *(tw[k] for k in KEYS)])
    dx, dw = fused_attention_backward_reference(tx.detach(), torch.from_numpy(r), {k: v.detach() for k, v in tw.items()}, H, RATE, mask)
    torch.testing.assert_close(dx, want[0], atol=1e-5 * float(want[0].abs().max()), rtol=0)
    gmax = max(float(g.abs().max()) for g in want[1:])
    for k, g in zip(KEYS, want[1:]):
        assert float((dw[k] - g).abs().max()) <= 1e-5 * gmax, k
