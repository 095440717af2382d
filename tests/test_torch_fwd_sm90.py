"""K1's two-pass design and W's bf16 shadow on the CPU, against the JAX
package's ``_fwd_kernel``.

On the card K1 is ``round_bf16`` for x (rounded to bf16, zero-padded to a
multiple of 8 columns), W's bf16 shadow (the same pass on W, rebuilt only
when W has changed) and ``gemm_bf16_bias_clamp``, clamp(x16 @ w16 + b, 0, 1)
with bias and clamp in the GEMM's epilogue. On the CPU every wrapper takes
its plain version, and the shadow keeps its cache: these tests hold the
plain versions against the operand the Pallas kernel forms
(ai_font_renderer_tpu/ops/fused_output.py, ``_fwd_kernel``), against the
kernel in interpret mode and against its ``_reference``, and hold the
shadow to the weights it shadows. The CUDA kernels are held against the
same plain versions on the card by tests/test_torch_cuda.py.
"""

import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_font_renderer_tpu.ops.fused_output import _fwd_pallas
from ai_font_renderer_tpu.ops.fused_output import _reference as jax_output_reference
from ai_font_renderer_tpu_torch.ops import (
    bf16_shadow,
    fused_dw_adamw,
    fused_output,
    fused_output_fwd,
    fused_output_reference,
    gemm_bf16_bias_clamp,
    gemm_bf16_bias_clamp_reference,
    round_bf16,
    round_bf16_reference,
)
from ai_font_renderer_tpu_torch.ops.fused_output import padded_width


def _fwd_inputs(m, k, n, seed):
    """x, w, b as numpy f32, scaled so that about a third of the outputs
    clamp at 0 or 1."""
    rng = np.random.default_rng(seed)
    x = (np.maximum(rng.standard_normal((m, k)), 0) * 0.2).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(n) * 0.5).astype(np.float32)
    return x, w, b


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


@pytest.mark.parametrize("m,k", [(5, 3), (15, 202), (4, 6400), (130, 640)])
def test_k1_x_operand_pass_equals_pallas_cast_bit_for_bit(m, k):
    """round_bf16(x) is, bit for bit, the bf16 x that _fwd_kernel casts
    (fused_output.py:54-58), with zero pad columns up to a multiple of 8;
    the shadow of a W is the same pass on W."""
    rng = np.random.default_rng(m * k)
    x = (rng.standard_normal((m, k)) * 3.0).astype(np.float32)
    x16 = round_bf16(torch.from_numpy(x))
    assert x16.dtype == torch.bfloat16 and x16.shape == (m, padded_width(k))
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
    np.testing.assert_array_equal(_bits(x16[:, :k].contiguous()), want.view(np.int16))
    assert not x16[:, k:].any()
    w16 = bf16_shadow(torch.from_numpy(x))
    assert torch.equal(w16.view(torch.int16), x16.view(torch.int16))


def test_k1_gemm_plain_version_equals_pallas_interpret():
    """The GEMM's plain version on the padded operands against the Pallas
    _fwd_kernel in interpret mode at (M, K, N) = (128, 640, 1280), multiples
    of its 640-wide tiles (at multiples of 128 that are not of 640 the
    interpret run reads past the arrays and gives NaN): atol 1e-5, f32 sums
    of exact bf16 products in another order."""
    m, k, n = 128, 640, 1280
    x, w, b = _fwd_inputs(m, k, n, seed=1)
    want = np.asarray(_fwd_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                  bm=128, bn=640, bk=640, interpret=True))
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    got = gemm_bf16_bias_clamp_reference(round_bf16_reference(tx), round_bf16_reference(tw), tb, n)
    assert got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert got.min() == 0.0 and got.max() == 1.0  # the clamp engaged


@pytest.mark.parametrize("m,k,n", [(1, 200, 301), (15, 202, 384), (130, 64, 13), (15, 640, 1283)])
def test_k1_ragged_shapes_equal_jax_reference(m, k, n):
    """At ragged M (1, 15, 130) and N that is not a multiple of 8 the TPU
    path falls back to _reference; K1 on CPU tensors (the x pass, W's
    shadow and the GEMM's plain version, cut to [M, N]) agrees with it to
    1e-5, and so does the GEMM's plain version on the padded operands."""
    x, w, b = _fwd_inputs(m, k, n, seed=m + n)
    want = np.asarray(jax_output_reference(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    got = fused_output_fwd(tx, tw, tb)
    assert got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    plain = gemm_bf16_bias_clamp_reference(round_bf16(tx), bf16_shadow(tw), tb, n)
    np.testing.assert_allclose(plain.numpy(), want, atol=1e-5)
    assert torch.equal(got, fused_output_reference(tx, tw, tb))


def test_k1_cpu_wrappers_launch_nothing():
    """On CPU tensors K1, its GEMM, the operand pass and the shadow take
    their plain versions: no launch is counted (a shadow build is)."""
    x, w, b = (torch.from_numpy(a) for a in _fwd_inputs(9, 40, 24, seed=3))
    counts = (fused_output.launches, gemm_bf16_bias_clamp.launches, round_bf16.launches)
    builds = bf16_shadow.builds
    out = fused_output(x, w, b)
    direct = gemm_bf16_bias_clamp(round_bf16(x), bf16_shadow(w), b, 24)
    assert (fused_output.launches, gemm_bf16_bias_clamp.launches, round_bf16.launches) == counts
    assert bf16_shadow.builds == builds + 1
    assert torch.equal(out, direct) and torch.equal(out, fused_output_reference(x, w, b))


def _adamw(w):
    from ai_font_renderer_tpu_torch.config import TrainConfig
    from ai_font_renderer_tpu_torch.train.step import adamw_

    g = torch.full_like(w, 0.5)
    adamw_([w], [g], [torch.zeros_like(w)], [torch.zeros_like(w)], 1e-2, TrainConfig(), 1)


def _fused_dw_adamw(w):
    rng = np.random.default_rng(4)
    x16 = torch.from_numpy(rng.standard_normal((6, w.shape[0])).astype(np.float32)).to(torch.bfloat16)
    gm16 = torch.from_numpy(rng.standard_normal((6, w.shape[1])).astype(np.float32)).to(torch.bfloat16)
    fused_dw_adamw(x16, gm16, w, torch.zeros_like(w), torch.zeros_like(w), 1e-2, 0.0, 0.9, 0.99, 1)


@pytest.mark.parametrize("update,rebuilds", [(_adamw, 1), (_fused_dw_adamw, 0), (lambda w: w.mul_(2), 1)],
                         ids=["adamw_", "fused_dw_adamw", "mul_"])
def test_shadow_follows_in_place_updates_of_w(update, rebuilds):
    """After an in-place update of W (the trainer's adamw_ through views of
    W, the CPU fused_dw_adamw, a plain mul_) K1 reads the new weights: the
    shadow is rebuilt once, except after fused_dw_adamw, which writes the
    new shadow itself; a second call at the same version builds nothing."""
    x, w, b = (torch.from_numpy(a) for a in _fwd_inputs(7, 48, 40, seed=5))
    first = fused_output(x, w, b)
    builds = bf16_shadow.builds
    assert torch.equal(fused_output(x, w, b), first) and bf16_shadow.builds == builds
    update(w)
    got = fused_output(x, w, b)
    assert bf16_shadow.builds == builds + rebuilds
    assert torch.equal(got, fused_output_reference(x, w, b)) and not torch.equal(got, first)
    fused_output(x, w, b)
    assert bf16_shadow.builds == builds + rebuilds


def test_a_new_w_never_reads_a_freed_ws_shadow():
    """W's shadow is keyed on the tensor, not on its address: a W freed and
    a new one of the same shape (which the allocator may place at the same
    address, with the same version 0) get their own shadows."""
    x, w, b = (torch.from_numpy(a) for a in _fwd_inputs(7, 48, 40, seed=6))
    w1 = w.clone()
    fused_output(x, w1, b)
    del w1
    gc.collect()
    for scale in (2.0, -1.0, 0.5):
        w2 = w * scale
        builds = bf16_shadow.builds
        assert torch.equal(fused_output(x, w2, b), fused_output_reference(x, w2, b))
        assert bf16_shadow.builds == builds + 1
        del w2
        gc.collect()


def test_inference_weights_get_a_fresh_shadow_each_call():
    """A W made under inference mode has no version counter: it is never
    cached, so every call builds and none can read a stale shadow."""
    x, w, b = (torch.from_numpy(a) for a in _fwd_inputs(5, 24, 16, seed=7))
    with torch.inference_mode():
        wi = w.clone()
        builds = bf16_shadow.builds
        fused_output(x, wi, b)
        wi.mul_(3)
        got = fused_output(x, wi, b)
    assert bf16_shadow.builds == builds + 2
    assert torch.equal(got, fused_output_reference(x, w * 3, b))


def _tiny_model():
    from ai_font_renderer_tpu_torch.config import ModelConfig
    from ai_font_renderer_tpu_torch.models import font_renderer

    mcfg = ModelConfig(max_length=24, hidden_dim=32, sheet_height=20, sheet_width=60,
                       dropout_rate=0.0, fc_dropout_rate=0.0, use_pallas_output=True)
    return mcfg, font_renderer.init(torch.Generator().manual_seed(0), mcfg, "cpu")


def test_render_under_inference_mode_then_training_step():
    """A render (torch.inference_mode) builds W's shadow, and the next
    training step on the same parameters reads it and saves it for its
    backward: the shadow was built outside inference mode, so that does not
    raise. The step's forward builds nothing; its update moves W."""
    from ai_font_renderer_tpu_torch.config import TrainConfig
    from ai_font_renderer_tpu_torch.render import render_batch
    from ai_font_renderer_tpu_torch.train.step import state_from_params, train_step

    mcfg, params = _tiny_model()
    state = state_from_params(params, TrainConfig())
    builds = bf16_shadow.builds
    sheets = render_batch(state.params, ["HELLO", "AB"], mcfg)
    assert sheets.shape == (2, 20, 60) and bf16_shadow.builds == builds + 1
    gen = torch.Generator().manual_seed(1)
    codes = torch.randint(32, 127, (4, 24), generator=gen, dtype=torch.int32)
    targets = torch.rand(4, 20, 60, generator=gen)
    version = state.params["out_w"]._version
    state, loss = train_step(state, codes, targets, 1e-3, gen, mcfg, TrainConfig())
    assert np.isfinite(float(loss)) and bf16_shadow.builds == builds + 1
    assert state.params["out_w"]._version > version
    render_batch(state.params, ["HELLO"], mcfg)
    assert bf16_shadow.builds == builds + 2


def test_checkpoint_holds_no_shadow(tmp_path):
    """CheckpointManager.save writes the training state with torch.save,
    which pickles a tensor's Python attributes: the shadow lives in a
    separate table, so the saved tree holds no bf16 tensor of W's padded
    shape (the moments are kept in f32 here, so no state tensor has that
    dtype and shape either), and no tensor in it carries attributes."""
    from ai_font_renderer_tpu_torch.config import TrainConfig
    from ai_font_renderer_tpu_torch.train.step import state_from_params, train_step
    from ai_font_renderer_tpu_torch.utils.checkpoint import CheckpointManager

    mcfg, params = _tiny_model()
    tcfg = TrainConfig(adam_mu_bf16=False)
    state = state_from_params(params, tcfg)
    gen = torch.Generator().manual_seed(2)
    codes = torch.randint(32, 127, (4, 24), generator=gen, dtype=torch.int32)
    state, _ = train_step(state, codes, torch.rand(4, 20, 60, generator=gen), 1e-3, gen, mcfg, tcfg)
    w = state.params["out_w"]
    shadow_shape = tuple(bf16_shadow(w).shape)
    CheckpointManager(str(tmp_path)).save(0, state, state.params, {"lr": 1e-3})
    (path,) = tmp_path.glob("*/tree.pt")
    tree = torch.load(path, weights_only=False)

    def tensors(node):
        if isinstance(node, torch.Tensor):
            assert not vars(node)
            yield node
        elif isinstance(node, dict):
            for v in node.values():
                yield from tensors(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                yield from tensors(v)

    found = list(tensors(tree))
    assert found and not any(t.dtype == torch.bfloat16 and tuple(t.shape) == shadow_shape for t in found)
