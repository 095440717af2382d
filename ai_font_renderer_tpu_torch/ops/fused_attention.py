"""Fused multi-head self-attention block with dropout, forward and backward:
the CUDA kernels, their plain versions and the autograd functions.

``fused_attention`` and ``fused_attention2`` are the port's counterparts of
the JAX package's two entry points (ai_font_renderer_tpu/ops/
fused_attention.py). Both are ``torch.autograd.Function``s, giving
gradients to x and to all eight weights, over three CUDA sources chosen by
x's shape and dtype. At the shapes the register-tiled kernels take
(``kernel_takes``: a head width of 8, 16 or 32, E <= 32, S <= 128 in f32
or S <= 112 in bf16), bf16 takes the tensor-core kernels of
csrc/attention_mma.cu (``attention_mma_fwd``, ``attention_mma_bwd``), f32
the CUDA-core kernels of csrc/fused_attention.cu (one cluster of H blocks
a sample, a block a head; f32 products on tensor cores would be TF32).
Every other shape takes the general kernels of csrc/attention_wide.cu
(``attention_wide_fwd``, ``attention_wide_bwd``: tiled GEMMs and a warp a
row), in either dtype, as the TPU kernels take any E and S. Either way:

* v1 (``fused_attention``): forward K5 (``_fwd_kernel``), backward K6
  (``_bwd_kernel``), which regenerates the dropout mask from the seed;
* v2 (``fused_attention2``): forward K7 (``_fwd2_kernel``), which also
  stores the keep mask as uint8 [B, H, S, S], backward K8 (``_bwd2_kernel``),
  which reads it.

Dropout on the probabilities draws from Philox4x32-10 keyed on the seed and
each probability's flat offset (ops/philox.py, csrc/philox.cuh), so both
versions, forward and backward, on the card and in the plain versions, see
the same mask for the same seed. The seed is a 1-element int32 tensor on
x's device that the kernels read from device memory; rate 0 needs none.

On CUDA tensors the functions launch the kernels, for any batch and
shape, or raise;
on CPU tensors they run the plain versions: the forward is the model's
attention math with the mask applied where the TPU kernel applies it, the
backward is the TPU kernel's backward written out line by line
(``fused_attention_backward_reference``). Each kernel keeps its launch
count: ``fused_attention.launches`` (K5), ``fused_attention2.launches``
(K7), ``fused_attention_backward.launches`` (K6) and
``fused_attention2_backward.launches`` (K8); ``attention_mma_fwd.launches``
and ``attention_mma_bwd.launches`` count the bf16 ones among them at the
register-tiled shapes, ``attention_wide_fwd.launches`` and
``attention_wide_bwd.launches`` those at every other shape.

The forward (K5 or K7, whichever build) is the ``torch.library`` operator
``afr::attention_fwd``, with a fake implementation that gives its outputs'
shapes: both entry points call it, through the autograd function when a
gradient is wanted and alone otherwise, and so does a graph that
``torch.export`` traced (utils/export.py). It picks kernel or plain version
by x's device when it runs, so its launches count inside an exported
program too.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from . import _build
from .philox import dropout_keep, keep_threshold

KEYS = ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo")
# Shared memory one block may use on sm_90 (232,448 bytes).
_SMEM_LIMIT = 232448

_P, _I = ctypes.c_void_p, ctypes.c_int
_WIDE_SIGNATURES = {
    "afr_attention_wide_fwd": ([_P] * 13 + [_I] * 6 + [ctypes.c_uint, ctypes.c_float, _P], _I),
    "afr_attention_wide_bwd": (
        [_P] * 15 + [_I] * 6 + [ctypes.c_uint, ctypes.c_float, ctypes.c_float, _P], _I,
    ),
    "afr_attention_wide_shape_ok": ([_I, _I, _I], _I),
    "afr_attention_wide_work_floats": ([_I] * 5, ctypes.c_longlong),
}
_MMA_SIGNATURES = {
    "afr_attention_mma_fwd": ([_P] * 12 + [_I] * 5 + [ctypes.c_uint, ctypes.c_float, _P], _I),
    "afr_attention_mma_bwd": (
        [_P] * 14 + [_I] * 5 + [ctypes.c_uint, ctypes.c_float, ctypes.c_float, _P], _I,
    ),
    "afr_attention_mma_shape_ok": ([_I, _I, _I], _I),
    "afr_attention_mma_fwd_smem_bytes": ([_I], ctypes.c_longlong),
    "afr_attention_mma_bwd_smem_bytes": ([_I], ctypes.c_longlong),
    "afr_attention_mma_blocks_per_sm": ([_I] * 4, _I),
}
_SIGNATURES = {
    "afr_fused_attention_fwd": ([_P] * 12 + [_I] * 5 + [ctypes.c_uint, ctypes.c_float, _P], _I),
    "afr_fused_attention_bwd": (
        [_P] * 14 + [_I] * 5 + [ctypes.c_uint, ctypes.c_float, ctypes.c_float, _P], _I,
    ),
    "afr_fused_attention_shape_ok": ([_I, _I, _I], _I),
    "afr_fused_attention_smem_bytes": ([_I, _I, _I], ctypes.c_longlong),
    "afr_fused_attention_bwd_smem_bytes": ([_I, _I, _I], ctypes.c_longlong),
    "afr_fused_attention_attributes": ([_I] * 4 + [ctypes.POINTER(ctypes.c_int)], _I),
}


def keep_in(rate: float, dtype: torch.dtype) -> float:
    """1 - rate rounded to ``dtype``: the TPU kernel divides the kept
    probabilities by the Python scalar keep, which JAX rounds to the
    probabilities' type (0.8 becomes 0.80078125 in bf16)."""
    return float(torch.tensor(1.0 - rate, dtype=dtype))


def fused_attention_reference(x: torch.Tensor, weights, heads: int, dropout=None, mask=None, rate: float = 0.0):
    """Plain multi-head self-attention, the math of the JAX package's
    models/font_renderer.py:attention. x [B, S, E] in f32 or bf16;
    ``weights`` holds wq/wk/wv/wo [E, E] (in -> out) and bq/bk/bv/bo [E].

    Projections run in x's dtype; the logits and softmax are f32 and the
    probabilities are rounded to x's dtype before P @ v, whose f32 sum is
    rounded back to x's dtype. ``dropout``, when given, maps the rounded
    probabilities [B, H, S, S] to their dropped-out values (the model's
    training path). ``mask`` (bool or uint8 [B, H, S, S]) with ``rate`` is
    the kernels' dropout instead: kept probabilities become p / keep in x's
    dtype (``keep_in``), the others 0.
    """
    B, S, E = x.shape
    d = E // heads
    dt = x.dtype

    def proj(w, b):
        return x @ weights[w].to(dt) + weights[b].to(dt)

    q = proj("wq", "bq").reshape(B, S, heads, d)
    k = proj("wk", "bk").reshape(B, S, heads, d)
    v = proj("wv", "bv").reshape(B, S, heads, d)
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) / math.sqrt(d)
    probs = torch.softmax(logits, dim=-1).to(dt)
    if dropout is not None:
        probs = dropout(probs)
    if mask is not None:
        # A 0-dim CPU tensor enters a CUDA op as a scalar: no copy to the
        # device, which would wait for the stream.
        keep = torch.tensor(keep_in(rate, dt), dtype=dt)
        probs = torch.where(mask.bool(), probs / keep, torch.zeros((), dtype=dt, device=x.device))
    out = torch.einsum("bhst,bthd->bshd", probs.float(), v.float()).to(dt)
    return out.reshape(B, S, E) @ weights["wo"].to(dt) + weights["bo"].to(dt)


def fused_attention_backward_reference(x, g, weights, heads: int, rate: float = 0.0, mask=None):
    """Plain backward of the fused attention block: the TPU kernel's
    ``_bwd_kernel`` (ai_font_renderer_tpu/ops/fused_attention.py:137-242)
    written out line by line, for the whole batch at once, with its
    roundings to x's dtype. ``mask`` (bool or uint8 [B, H, S, S]) is the
    keep mask at ``rate`` > 0. Returns (dx in x's dtype, {key: f32 grad})."""
    B, S, E = x.shape
    d = E // heads
    dt = x.dtype
    scale = float(np.float32(1.0 / d**0.5))

    def rnd(t):
        return t.to(dt).float()

    x2 = x.float().reshape(B * S, E)
    w = {k: rnd(weights[k]) for k in ("wq", "wk", "wv", "wo")}
    q = rnd(x2 @ w["wq"] + weights["bq"]).reshape(B, S, heads, d)
    k = rnd(x2 @ w["wk"] + weights["bk"]).reshape(B, S, heads, d)
    v = rnd(x2 @ w["wv"] + weights["bv"]).reshape(B, S, heads, d)

    g2 = g.to(dt).float().reshape(B * S, E)
    dattn = g2 @ w["wo"].T
    dbo = g2.sum(0)

    logits = torch.einsum("bshd,bthd->bhst", q, k) * scale
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs_sm = p / p.sum(-1, keepdim=True)  # f32, before dropout
    zero = torch.zeros((), device=x.device)
    if rate > 0.0:
        keep = mask.bool()
        probs_used = torch.where(keep, rnd(rnd(probs_sm) / keep_in(rate, dt)), zero)
    else:
        probs_used = rnd(probs_sm)
    dout = rnd(dattn).reshape(B, S, heads, d)
    attn = torch.einsum("bhst,bthd->bshd", probs_used, v)
    dprobs = torch.einsum("bshd,bthd->bhst", dout, v)
    dv = torch.einsum("bhst,bshd->bthd", probs_used, dout)
    if rate > 0.0:
        dprobs = torch.where(keep, dprobs / float(np.float32(1.0 - rate)), zero)
    inner = (dprobs * probs_sm).sum(-1, keepdim=True)
    dlogits = rnd(probs_sm * (dprobs - inner) * scale)
    dq = torch.einsum("bhst,bthd->bshd", dlogits, k)
    dk = torch.einsum("bhst,bshd->bthd", dlogits, q)

    attn, dq, dk, dv = (rnd(t.reshape(B * S, E)) for t in (attn, dq, dk, dv))
    grads = {
        "wq": x2.T @ dq, "wk": x2.T @ dk, "wv": x2.T @ dv, "wo": attn.T @ g2,
        "bq": dq.sum(0), "bk": dk.sum(0), "bv": dv.sum(0), "bo": dbo,
    }
    dx = (dq @ w["wq"].T + dk @ w["wk"].T) + dv @ w["wv"].T
    return dx.reshape(B, S, E).to(dt), grads


def _check_seed(seed, x: torch.Tensor, rate: float) -> None:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    if rate > 0.0 and (
        not isinstance(seed, torch.Tensor) or seed.numel() != 1
        or seed.dtype != torch.int32 or seed.device != x.device
    ):
        raise ValueError(f"dropout needs the seed as a 1-element int32 tensor on {x.device}")


def _check_cuda(x: torch.Tensor, weights, heads: int) -> None:
    """What the CUDA kernels take; raise on anything else."""
    if x.device.type != "cuda":
        raise ValueError(f"fused attention runs on cuda or cpu tensors, not {x.device}")
    if x.dim() != 3:
        raise ValueError(f"x must be [B, S, E], got {tuple(x.shape)}")
    E = x.shape[2]
    if x.dtype not in (torch.float32, torch.bfloat16) or not x.is_contiguous():
        raise ValueError("x must be a contiguous float32 or bfloat16 tensor")
    if heads < 1 or E % heads:
        raise ValueError(f"E = {E} must be a multiple of the {heads} heads")
    for k in KEYS:
        t = weights[k]
        shape = (E, E) if k.startswith("w") else (E,)
        if (
            tuple(t.shape) != shape or t.dtype != torch.float32
            or not t.is_contiguous() or t.device != x.device
        ):
            raise ValueError(f"{k} must be a contiguous float32 {shape} tensor on {x.device}")


def kernel_takes(S: int, E: int, heads: int, dtype: torch.dtype) -> bool:
    """Whether the register-tiled kernels take x [*, S, E] of ``dtype``
    with ``heads`` heads: a head width E/H of 8, 16 or 32 and E <= 32 in
    both sources; S <= 128 in f32 (csrc/fused_attention.cu ``shape_ok``),
    S <= 112 in bf16 (csrc/attention_mma.cu ``shape_ok``). The entry points
    launch the general kernels (csrc/attention_wide.cu) at every other
    shape. Loads no library."""
    if heads < 1 or E < 1 or E > 32 or E % heads or E // heads not in (8, 16, 32):
        return False
    return 1 <= S <= {torch.float32: 128, torch.bfloat16: 112}.get(dtype, 0)


def _check_f32(x, heads, backward: bool):
    """What the f32 CUDA-core kernels take beyond ``_check_cuda``; raise on
    anything else. Returns the library."""
    _, S, E = x.shape
    lib = _build.load("fused_attention", _SIGNATURES)
    if not lib.afr_fused_attention_shape_ok(S, E, heads):
        raise ValueError(
            f"the f32 attention kernels take a head width E/H of 8, 16 or 32, E <= 32 and "
            f"S <= 128, not S={S}, E={E}, H={heads}")
    smem = lib.afr_fused_attention_bwd_smem_bytes if backward else lib.afr_fused_attention_smem_bytes
    need = smem(S, E, heads)
    if need > _SMEM_LIMIT:
        raise ValueError(f"S={S}, E={E}, H={heads} needs {need} bytes of shared memory a block, "
                         f"more than the {_SMEM_LIMIT} one block has")
    return lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it where its data does not start on 16 bytes: the
    kernels move rows in 16-byte pieces."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _mode(rate: float, stored: bool) -> int:
    """Where the keep mask comes from: 0 rate 0, 1 drawn from the seed, 2
    stored (the forward stores it, the backward reads it)."""
    return 0 if rate == 0.0 else (2 if stored else 1)


def _launch_fwd(x, weights, heads, rate, seed, store_mask, entry):
    """K5 (or K7 with ``store_mask``) on CUDA tensors -> (out, mask or
    None): the general kernels at a shape the register-tiled ones do not
    take (``attention_wide_fwd``), else bf16 on the tensor cores
    (``attention_mma_fwd``) and f32 on the CUDA cores; adds one to
    ``entry.launches``."""
    _check_cuda(x, weights, heads)
    B, S, E = x.shape
    wide = not kernel_takes(S, E, heads, x.dtype)
    if wide or x.dtype == torch.bfloat16:
        launch = attention_wide_fwd if wide else attention_mma_fwd
        out, mask = launch(x, weights, heads, rate, seed, store_mask)
        entry.launches += int(B > 0)
        return out, mask
    mode = _mode(rate, store_mask)
    lib = _check_f32(x, heads, backward=False)
    x = _aligned(x)
    out = torch.empty_like(x)
    mask = torch.empty(B, heads, S, S, dtype=torch.uint8, device=x.device) if mode == 2 else None
    if B == 0:
        return out, mask
    with torch.cuda.device(x.device):
        rc = lib.afr_fused_attention_fwd(
            x.data_ptr(), *(weights[k].data_ptr() for k in KEYS), out.data_ptr(),
            mask.data_ptr() if mask is not None else None,
            seed.data_ptr() if mode else None,
            B, S, E, heads, mode,
            keep_threshold(rate) if mode else 0, keep_in(rate, x.dtype) if mode else 1.0,
            _build.stream_handle(x.device),
        )
    if rc != 0:
        raise RuntimeError(f"fused attention kernel launch failed: CUDA error {rc}")
    entry.launches += 1
    return out, mask


def _split_grads(flat: torch.Tensor, E: int) -> dict:
    ee = E * E
    grads = {k: flat[i * ee : (i + 1) * ee].reshape(E, E) for i, k in enumerate(KEYS[:4])}
    grads.update({k: flat[4 * ee + i * E : 4 * ee + (i + 1) * E] for i, k in enumerate(KEYS[4:])})
    return grads


def _check_backward(x, g, heads, mask):
    """g in x's dtype, contiguous; raise on a g or mask that does not fit."""
    B, S, _ = x.shape
    g = g.to(x.dtype).contiguous()
    if g.shape != x.shape or g.device != x.device:
        raise ValueError(f"g must match x {tuple(x.shape)} on {x.device}, got {tuple(g.shape)} on {g.device}")
    if mask is not None and (
        tuple(mask.shape) != (B, heads, S, S) or mask.dtype != torch.uint8
        or not mask.is_contiguous() or mask.device != x.device
    ):
        raise ValueError(f"mask must be a contiguous uint8 {(B, heads, S, S)} tensor on {x.device}")
    return g


def _launch_bwd(x, g, weights, heads, rate, seed, mask, entry):
    """K6 (mask regenerated from ``seed``) or K8 (``mask`` read) on CUDA
    tensors -> (dx, grads): the general kernels at a shape the
    register-tiled ones do not take (``attention_wide_bwd``), else bf16 on
    the tensor cores (``attention_mma_bwd``) and f32 on the CUDA cores;
    adds one to ``entry.launches``. Each block writes its sample's
    parameter gradients; their sum over the batch is taken here, so no two
    runs differ in a bit."""
    _check_cuda(x, weights, heads)
    B, S, E = x.shape
    wide = not kernel_takes(S, E, heads, x.dtype)
    if wide or x.dtype == torch.bfloat16:
        launch = attention_wide_bwd if wide else attention_mma_bwd
        dx, grads = launch(x, g, weights, heads, rate, seed, mask)
        entry.launches += int(B > 0)
        return dx, grads
    g = _check_backward(x, g, heads, mask)
    lib = _check_f32(x, heads, backward=True)
    x, g = _aligned(x), _aligned(g)
    mask = _aligned(mask) if mask is not None else None
    dx = torch.empty_like(x)
    partials = torch.empty(B, 4 * E * E + 4 * E, dtype=torch.float32, device=x.device)
    if B == 0:
        return dx, _split_grads(partials.sum(0), E)
    mode = _mode(rate, mask is not None)
    with torch.cuda.device(x.device):
        rc = lib.afr_fused_attention_bwd(
            x.data_ptr(), g.data_ptr(), *(weights[k].data_ptr() for k in KEYS),
            mask.data_ptr() if mode == 2 else None, seed.data_ptr() if mode == 1 else None,
            dx.data_ptr(), partials.data_ptr(), B, S, E, heads, mode,
            keep_threshold(rate) if mode else 0, keep_in(rate, x.dtype),
            float(np.float32(1.0 - rate)), _build.stream_handle(x.device),
        )
    if rc != 0:
        raise RuntimeError(f"fused attention backward kernel launch failed: CUDA error {rc}")
    entry.launches += 1
    return dx, _split_grads(partials.sum(0), E)


def _check_mma(x, weights, heads):
    """What the tensor-core kernels take; raise on anything else."""
    _check_cuda(x, weights, heads)
    B, S, E = x.shape
    if x.dtype != torch.bfloat16:
        raise ValueError("the tensor-core attention kernels take bfloat16 x")
    lib = _build.load("attention_mma", _MMA_SIGNATURES)
    if not lib.afr_attention_mma_shape_ok(S, E, heads):
        raise ValueError(
            f"the bf16 attention kernels take a head width E/H of 8, 16 or 32, E <= 32 and "
            f"S <= 112, not S={S}, E={E}, H={heads}")
    return lib


def attention_mma_fwd(x, weights, heads: int, dropout_rate: float = 0.0, seed=None, store_mask: bool = False):
    """The bf16 attention forward on tensor cores (csrc/attention_mma.cu):
    the bf16 build of K5 and of K7 (``store_mask``: the keep mask is
    stored, uint8 [B, H, S, S]). x [B, S, E] bf16 -> (out, mask or None).
    On a CPU tensor the plain version. ``attention_mma_fwd.launches``
    counts its launches."""
    _check_seed(seed, x, dropout_rate)
    rate = float(dropout_rate)
    if x.device.type == "cpu":
        return _plain_forward(x, weights, heads, rate, seed, store_mask)
    lib = _check_mma(x, weights, heads)
    B, S, E = x.shape
    mode = _mode(rate, store_mask)
    out = torch.empty_like(x)
    mask = torch.empty(B, heads, S, S, dtype=torch.uint8, device=x.device) if mode == 2 else None
    if B == 0:
        return out, mask
    with torch.cuda.device(x.device):
        rc = lib.afr_attention_mma_fwd(
            x.data_ptr(), *(weights[k].data_ptr() for k in KEYS), out.data_ptr(),
            mask.data_ptr() if mask is not None else None, seed.data_ptr() if mode else None,
            B, S, E, heads, mode, keep_threshold(rate) if mode else 0,
            keep_in(rate, x.dtype) if mode else 1.0, _build.stream_handle(x.device),
        )
    if rc != 0:
        raise RuntimeError(f"bf16 attention forward launch failed: CUDA error {rc}")
    attention_mma_fwd.launches += 1
    return out, mask


def attention_mma_bwd(x, g, weights, heads: int, dropout_rate: float = 0.0, seed=None, mask=None):
    """The bf16 attention backward on tensor cores (csrc/attention_mma.cu):
    the bf16 build of K8 (``mask`` read) and of K6 (the mask regenerated
    from ``seed``). x, g [B, S, E] -> (dx bf16, {key: f32 gradient}). On a
    CPU tensor the plain version. ``attention_mma_bwd.launches`` counts its
    launches."""
    rate = float(dropout_rate)
    if x.device.type == "cpu":
        return _plain_backward(x, g, weights, heads, rate, seed, mask)
    lib = _check_mma(x, weights, heads)
    g = _check_backward(x, g, heads, mask)
    mode = _mode(rate, mask is not None)
    if mode == 1:
        _check_seed(seed, x, rate)
    B, S, E = x.shape
    dx = torch.empty_like(x)
    partials = torch.empty(B, 4 * E * E + 4 * E, dtype=torch.float32, device=x.device)
    if B == 0:
        return dx, _split_grads(partials.sum(0), E)
    with torch.cuda.device(x.device):
        rc = lib.afr_attention_mma_bwd(
            x.data_ptr(), g.data_ptr(), *(weights[k].data_ptr() for k in KEYS),
            mask.data_ptr() if mode == 2 else None, seed.data_ptr() if mode == 1 else None,
            dx.data_ptr(), partials.data_ptr(), B, S, E, heads, mode,
            keep_threshold(rate) if mode else 0, keep_in(rate, x.dtype),
            float(np.float32(1.0 - rate)), _build.stream_handle(x.device),
        )
    if rc != 0:
        raise RuntimeError(f"bf16 attention backward launch failed: CUDA error {rc}")
    attention_mma_bwd.launches += 1
    return dx, _split_grads(partials.sum(0), E)


def _plain_forward(x, weights, heads, rate, seed, store_mask):
    """The plain forward of every build of K5/K7 on a CPU tensor -> (out,
    the uint8 mask when ``store_mask`` and rate > 0, else None)."""
    mask = _keep_mask(x, heads, rate, seed) if rate > 0.0 else None
    out = fused_attention_reference(x, weights, heads, mask=mask, rate=rate)
    return out, mask.to(torch.uint8) if store_mask and mask is not None else None


def _plain_backward(x, g, weights, heads, rate, seed, mask):
    """The plain backward of every build of K6/K8 on a CPU tensor: the
    ``mask`` given, or drawn from ``seed``."""
    if rate > 0.0 and mask is None:
        _check_seed(seed, x, rate)
        mask = _keep_mask(x, heads, rate, seed)
    return fused_attention_backward_reference(x, g, weights, heads, rate, mask)


def _check_wide(x, weights, heads):
    """What the general kernels take; raise on anything else."""
    _check_cuda(x, weights, heads)
    _, S, E = x.shape
    lib = _build.load("attention_wide", _WIDE_SIGNATURES)
    if not lib.afr_attention_wide_shape_ok(S, E, heads):
        raise ValueError(f"the general attention kernels take S rows of keys within one block's shared "
                         f"memory, not S={S}, E={E}, H={heads}")
    return lib


def _workspace(lib, x, heads, backward):
    B, S, E = x.shape
    n = lib.afr_attention_wide_work_floats(B, S, E, heads, int(backward))
    return torch.empty(n, dtype=torch.float32, device=x.device)


def attention_wide_fwd(x, weights, heads: int, dropout_rate: float = 0.0, seed=None, store_mask: bool = False):
    """The attention forward at any shape (csrc/attention_wide.cu), f32 or
    bf16: the general build of K5 and of K7 (``store_mask``: the keep mask
    is stored, uint8 [B, H, S, S]). x [B, S, E] -> (out, mask or None). On
    a CPU tensor the plain version. ``attention_wide_fwd.launches`` counts
    its launches."""
    _check_seed(seed, x, dropout_rate)
    rate = float(dropout_rate)
    if x.device.type == "cpu":
        return _plain_forward(x, weights, heads, rate, seed, store_mask)
    lib = _check_wide(x, weights, heads)
    B, S, E = x.shape
    mode = _mode(rate, store_mask)
    out = torch.empty_like(x)
    mask = torch.empty(B, heads, S, S, dtype=torch.uint8, device=x.device) if mode == 2 else None
    if B == 0:
        return out, mask
    work = _workspace(lib, x, heads, False)
    with torch.cuda.device(x.device):
        rc = lib.afr_attention_wide_fwd(
            x.data_ptr(), *(weights[k].data_ptr() for k in KEYS), out.data_ptr(),
            mask.data_ptr() if mask is not None else None, seed.data_ptr() if mode else None,
            work.data_ptr(), B, S, E, heads, int(x.dtype == torch.bfloat16), mode,
            keep_threshold(rate) if mode else 0, keep_in(rate, x.dtype) if mode else 1.0,
            _build.stream_handle(x.device),
        )
    if rc != 0:
        raise RuntimeError(f"general attention forward launch failed: CUDA error {rc}")
    attention_wide_fwd.launches += 1
    return out, mask


def attention_wide_bwd(x, g, weights, heads: int, dropout_rate: float = 0.0, seed=None, mask=None):
    """The attention backward at any shape (csrc/attention_wide.cu), f32 or
    bf16: the general build of K8 (``mask`` read) and of K6 (the mask
    regenerated from ``seed``). x, g [B, S, E] -> (dx in x's dtype, {key:
    f32 gradient}). On a CPU tensor the plain version.
    ``attention_wide_bwd.launches`` counts its launches."""
    rate = float(dropout_rate)
    if x.device.type == "cpu":
        return _plain_backward(x, g, weights, heads, rate, seed, mask)
    lib = _check_wide(x, weights, heads)
    g = _check_backward(x, g, heads, mask)
    mode = _mode(rate, mask is not None)
    if mode == 1:
        _check_seed(seed, x, rate)
    B, S, E = x.shape
    dx = torch.empty_like(x)
    partials = torch.empty(B, 4 * E * E + 4 * E, dtype=torch.float32, device=x.device)
    if B == 0:
        return dx, _split_grads(partials.sum(0), E)
    work = _workspace(lib, x, heads, True)
    with torch.cuda.device(x.device):
        rc = lib.afr_attention_wide_bwd(
            x.data_ptr(), g.data_ptr(), *(weights[k].data_ptr() for k in KEYS),
            mask.data_ptr() if mode == 2 else None, seed.data_ptr() if mode == 1 else None,
            dx.data_ptr(), partials.data_ptr(), work.data_ptr(), B, S, E, heads,
            int(x.dtype == torch.bfloat16), mode, keep_threshold(rate) if mode else 0,
            keep_in(rate, x.dtype), float(np.float32(1.0 - rate)), _build.stream_handle(x.device),
        )
    if rc != 0:
        raise RuntimeError(f"general attention backward launch failed: CUDA error {rc}")
    attention_wide_bwd.launches += 1
    return dx, _split_grads(partials.sum(0), E)


def attention_mma_attributes(S: int = 100, E: int = 32, heads: int = 4) -> dict:
    """The tensor-core kernels as the card holds them at this shape (one
    block per sample, one warp per 16 rows): block size, dynamic shared
    memory and blocks per SM (occupancy), forward and backward."""
    lib = _build.load("attention_mma", _MMA_SIGNATURES)
    threads = 32 * ((S + 15) // 16)
    return {
        name: {"threads": threads, "smem_bytes": smem(S),
               "blocks_per_sm": lib.afr_attention_mma_blocks_per_sm(which, S, E, heads)}
        for which, (name, smem) in enumerate((("fwd", lib.afr_attention_mma_fwd_smem_bytes),
                                               ("bwd", lib.afr_attention_mma_bwd_smem_bytes)))
    }


def fused_attention_attributes(S: int = 100, E: int = 32, heads: int = 4) -> dict:
    """The f32 CUDA-core kernels as the card holds them at this shape, for
    each source of the mask (``none``: rate 0, ``regen``: v1, ``stored``:
    v2), forward and backward: block size, dynamic shared memory,
    registers and local (spill) bytes a thread, cluster size, blocks per SM
    and clusters the card runs at once."""
    lib = _build.load("fused_attention", _SIGNATURES)
    keys = ("threads", "smem_bytes", "registers", "local_bytes", "cluster", "blocks_per_sm",
            "active_clusters")
    out = {}
    for which in range(6):
        vals = (ctypes.c_int * len(keys))()
        rc = lib.afr_fused_attention_attributes(which, S, E, heads, vals)
        if rc != 0:
            raise RuntimeError(f"f32 attention kernel attributes: CUDA error {rc}")
        name = f"{('fwd', 'bwd')[which // 3]}_{('none', 'regen', 'stored')[which % 3]}"
        out[name] = dict(zip(keys, vals))
    return out


def _keep_mask(x, heads, rate, seed):
    """The plain keep mask of x's probabilities, from the seed."""
    B, S, _ = x.shape
    return dropout_keep(seed, (B, heads, S, S), rate)


def fused_attention_backward(x, g, weights, heads: int, dropout_rate: float = 0.0, seed=None):
    """K6: the v1 backward, the mask regenerated from ``seed``. x, g
    [B, S, E] -> (dx in x's dtype, {key: f32 gradient})."""
    _check_seed(seed, x, dropout_rate)
    if x.device.type == "cpu":
        return _plain_backward(x, g, weights, heads, dropout_rate, seed, None)
    return _launch_bwd(x, g, weights, heads, dropout_rate, seed, None, fused_attention_backward)


def fused_attention2_backward(x, g, weights, heads: int, dropout_rate: float = 0.0, mask=None):
    """K8: the v2 backward, reading the keep mask (uint8 [B, H, S, S]) that
    the forward stored."""
    if dropout_rate > 0.0 and mask is None:
        raise ValueError("the v2 backward at a rate above 0 needs the forward's mask")
    if x.device.type == "cpu":
        return fused_attention_backward_reference(x, g, weights, heads, dropout_rate, mask)
    return _launch_bwd(x, g, weights, heads, dropout_rate, None, mask, fused_attention2_backward)


def _forward(x, weights, heads, rate, seed, stored):
    """(out, the uint8 mask when ``stored`` and rate > 0, else None): K5 or
    K7 on a CUDA tensor, the plain version on a CPU tensor, through the
    operator ``afr::attention_fwd``."""
    out, mask = torch.ops.afr.attention_fwd(x, *(weights[k] for k in KEYS), heads, rate, seed, stored)
    return out, mask if _mode(rate, stored) == 2 else None


@torch.library.custom_op("afr::attention_fwd", mutates_args=())
def _attention_fwd_op(
    x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor, wv: torch.Tensor, wo: torch.Tensor,
    bq: torch.Tensor, bk: torch.Tensor, bv: torch.Tensor, bo: torch.Tensor,
    heads: int, rate: float, seed: Optional[torch.Tensor], store_mask: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The attention forward as an operator, as an exported graph calls it:
    K7 with ``store_mask``, else K5 (counted on ``fused_attention2.launches``
    or ``fused_attention.launches``) on a CUDA tensor, through the kernel
    that ``kernel_takes`` picks; the plain version on a CPU tensor. Returns
    (out, mask): the stored uint8 mask [B, H, S, S] when ``store_mask`` and
    rate > 0, else an empty uint8 tensor (an operator returns no None)."""
    weights = dict(zip(KEYS, (wq, wk, wv, wo, bq, bk, bv, bo)))
    if x.device.type != "cpu":
        entry = fused_attention2 if store_mask else fused_attention
        out, mask = _launch_fwd(x, weights, heads, rate, seed, store_mask, entry)
    else:
        out, mask = _plain_forward(x, weights, heads, rate, seed, store_mask)
    return out, x.new_empty((0,), dtype=torch.uint8) if mask is None else mask


@_attention_fwd_op.register_fake
def _(x, wq, wk, wv, wo, bq, bk, bv, bo, heads, rate, seed, store_mask):
    B, S, _ = x.shape
    mask_shape = (B, heads, S, S) if _mode(rate, store_mask) == 2 else (0,)
    return torch.empty_like(x), x.new_empty(mask_shape, dtype=torch.uint8)


class _FusedAttention(torch.autograd.Function):
    """out = attention(x, weights) with dropout; gradients to x and the
    eight weights. ``stored`` selects v2 (K7 stores the mask, K8 reads it)
    over v1 (K5, and K6 regenerates the mask)."""

    @staticmethod
    def forward(ctx, x, seed, rate, heads, stored, *w):
        out, mask = _forward(x, dict(zip(KEYS, w)), heads, rate, seed, stored)
        ctx.heads, ctx.rate, ctx.stored = heads, rate, stored
        ctx.save_for_backward(x, seed, mask, *w)
        if mask is not None:
            ctx.mark_non_differentiable(mask)
        return out, mask

    @staticmethod
    def backward(ctx, g, _g_mask):
        x, seed, mask, *w = ctx.saved_tensors
        weights = dict(zip(KEYS, w))
        if ctx.stored:
            dx, grads = fused_attention2_backward(x, g, weights, ctx.heads, ctx.rate, mask)
        else:
            dx, grads = fused_attention_backward(x, g, weights, ctx.heads, ctx.rate, seed)
        return (dx, None, None, None, None, *(grads[k] for k in KEYS))


def _apply(x, weights, heads, dropout_rate, seed, stored):
    _check_seed(seed, x, dropout_rate)
    x, rate = x.contiguous(), float(dropout_rate)
    seed = seed if rate > 0.0 else None
    w = [weights[k] for k in KEYS]
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *w)):
        return _FusedAttention.apply(x, seed, rate, heads, stored, *w)
    # No gradient wanted (inference, or a tracer such as torch.export's):
    # the forward operator alone.
    return _forward(x, dict(zip(KEYS, w)), heads, rate, seed, stored)


def fused_attention(x: torch.Tensor, weights, heads: int, dropout_rate: float = 0.0, seed=None) -> torch.Tensor:
    """v1 entry point: [B, S, E] -> [B, S, E] in x's dtype, dropout at
    ``dropout_rate`` from ``seed`` (a 1-element int32 tensor on x's device;
    rate 0 needs none). Forward K5, backward K6.
    ``fused_attention.launches`` counts K5 launches."""
    return _apply(x, weights, heads, dropout_rate, seed, False)[0]


def fused_attention2(x: torch.Tensor, weights, heads: int, dropout_rate: float = 0.0, seed=None,
                     return_mask: bool = False):
    """v2 entry point: as ``fused_attention``, with forward K7, which stores
    the keep mask (uint8 [B, H, S, S], None at rate 0) for the backward, K8.
    ``return_mask`` returns (out, mask). ``fused_attention2.launches`` counts
    K7 launches."""
    out, mask = _apply(x, weights, heads, dropout_rate, seed, True)
    return (out, mask) if return_mask else out


fused_attention.launches = 0
fused_attention2.launches = 0
fused_attention_backward.launches = 0
fused_attention2_backward.launches = 0
attention_mma_fwd.launches = 0
attention_mma_bwd.launches = 0
attention_wide_fwd.launches = 0
attention_wide_bwd.launches = 0
