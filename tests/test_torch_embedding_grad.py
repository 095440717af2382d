"""The gradients of the port's embedding gathers on the CPU
(``models/gather.py:gather_rows``, ``F.embedding`` there): the same bits in
every run, and the same bits as the JAX package's gathers' VJP
(ai_font_renderer_tpu/models/font_renderer.py:361 and placement.py:184-185),
at the flagship's training batch (B 1024, S 100, E 64, 128 codes). The
index form's backward adds across threads in no fixed order there, so a
resumed CPU run was no replay of the uninterrupted one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_font_renderer_tpu_torch.models.gather import gather_rows

B, S, E, V = 1024, 100, 64, 128
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, V, (B, S))
    table = rng.standard_normal(shape).astype(np.float32)
    cot = rng.standard_normal((B, S) + shape[1:]).astype(np.float32)
    return codes, table, cot


def _torch_grad(fn, table, cot, dt):
    t = torch.from_numpy(table).requires_grad_()
    fn(t).backward(torch.from_numpy(cot).to(dt))
    return t.grad.numpy()


@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
def test_flagship_embedding_gradient_is_one_pattern_and_jaxs(dtype):
    """d(embedding) of the frontend's gather of the table cast to the
    frontend's dtype: two runs give the same bits, and they equal the JAX
    gather's VJP."""
    dt, jdt = DTYPES[dtype]
    codes, table, cot = _inputs((V, E), 0)
    tc = torch.from_numpy(codes)
    runs = [_torch_grad(lambda w: gather_rows(w.to(dt), tc), table, cot, dt) for _ in range(2)]
    _, vjp = jax.vjp(lambda w: w.astype(jdt)[jnp.asarray(codes)], jnp.asarray(table))
    want = np.asarray(vjp(jnp.asarray(cot).astype(jdt))[0])
    assert runs[0].dtype == want.dtype == np.float32
    assert np.array_equal(runs[0], runs[1])
    assert np.array_equal(runs[0], want)


@pytest.mark.parametrize("which", ["place_adv", "place_kern"])
def test_placement_gathers_gradients_are_one_pattern_and_jaxs(which):
    """d(place_adv) and d(place_kern) of structured_x's gathers (f32): two
    runs give the same bits, equal to the JAX gathers' VJP."""
    codes, table, cot = _inputs((V,) if which == "place_adv" else (V, V), 1)
    tc = torch.from_numpy(codes)
    if which == "place_adv":
        def fn(t):
            return gather_rows(t, tc)

        def jfn(t):
            return t[jnp.asarray(codes)]
    else:
        cot = cot[:, :-1, 0]  # [B, S - 1]

        def fn(t):
            return gather_rows(t.reshape(-1), tc[:, :-1] * V + tc[:, 1:])

        def jfn(t):
            return t[jnp.asarray(codes[:, :-1]), jnp.asarray(codes[:, 1:])]
    runs = [_torch_grad(fn, table, cot, torch.float32) for _ in range(2)]
    _, vjp = jax.vjp(jfn, jnp.asarray(table))
    assert np.array_equal(runs[0], runs[1])
    assert np.array_equal(runs[0], np.asarray(vjp(jnp.asarray(cot))[0]))

