"""Fused multi-head self-attention block (forward, no dropout): the CUDA
kernel and its plain version.

``fused_attention`` and ``fused_attention2`` are the port's counterparts of
the JAX package's two entry points (ai_font_renderer_tpu/ops/
fused_attention.py, TPU kernels _fwd_kernel K5 and _fwd2_kernel K7). Those
differ only in how the dropout mask travels to the backward, and at rate 0
there is none, so both launch the same kernel, csrc/fused_attention.cu, on a
CUDA tensor, for any batch, or raise. Each keeps its own launch count. On a
CPU tensor they run the plain version, which is the model's attention math.

Training through these kernels comes with slice 3 of the port, the
attention training slice: dropout (rate > 0) from a counter-based Philox in
the kernel, and the backward kernels (K6, K8) behind a
``torch.autograd.Function``. Until then both entry points raise on a rate
above 0 and on any input that requires a gradient, rather than return a
tensor through which no gradient flows.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

KEYS = ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo")
# Shared memory one block may use on sm_90 (232,448 bytes).
_SMEM_LIMIT = 232448

_SIGNATURES = {
    "afr_fused_attention_fwd": ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p], ctypes.c_int),
    "afr_fused_attention_smem_bytes": ([ctypes.c_int, ctypes.c_int], ctypes.c_longlong),
}


def fused_attention_reference(x: torch.Tensor, weights, heads: int, dropout=None) -> torch.Tensor:
    """Plain multi-head self-attention, the math of the JAX package's
    models/font_renderer.py:attention. x [B, S, E] in f32 or bf16;
    ``weights`` holds wq/wk/wv/wo [E, E] (in -> out) and bq/bk/bv/bo [E].

    Projections run in x's dtype; the logits and softmax are f32 and the
    probabilities are rounded to x's dtype before P @ v, whose f32 sum is
    rounded back to x's dtype. ``dropout``, when given, maps the rounded
    probabilities [B, H, S, S] to their dropped-out values (the model's
    training path).
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
    out = torch.einsum("bhst,bthd->bshd", probs.float(), v.float()).to(dt)
    return out.reshape(B, S, E) @ weights["wo"].to(dt) + weights["bo"].to(dt)


_SLICE_3 = (
    "comes with slice 3 of the port, the attention training slice "
    "(Philox dropout in the kernel, K6/K8 backward)"
)


def _check_trainable(x: torch.Tensor, weights, dropout_rate: float) -> None:
    """Raise on what the forward-only kernel cannot give: dropout, or a
    gradient to any input."""
    if dropout_rate != 0.0:
        raise NotImplementedError(f"dropout inside the fused attention kernel {_SLICE_3}; rate must be 0")
    if torch.is_grad_enabled() and (x.requires_grad or any(weights[k].requires_grad for k in KEYS)):
        raise NotImplementedError(
            f"a gradient through the fused attention kernel {_SLICE_3}; "
            "run it under torch.no_grad(), or train with fused_attention=False "
            "and fused_attention_v2=False"
        )


def _launch(x: torch.Tensor, weights, heads: int, entry) -> torch.Tensor:
    """Launch the kernel on a CUDA tensor and add one to ``entry.launches``."""
    if x.device.type != "cuda":
        raise ValueError(f"fused attention runs on cuda or cpu tensors, not {x.device}")
    if x.dim() != 3:
        raise ValueError(f"x must be [B, S, E], got {tuple(x.shape)}")
    B, S, E = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16) or not x.is_contiguous():
        raise ValueError("x must be a contiguous float32 or bfloat16 tensor")
    if E % heads or 32 % (E // heads):
        raise ValueError(f"head width E/H = {E}/{heads} must divide 32")
    for k in KEYS:
        t = weights[k]
        shape = (E, E) if k.startswith("w") else (E,)
        if (
            tuple(t.shape) != shape or t.dtype != torch.float32
            or not t.is_contiguous() or t.device != x.device
        ):
            raise ValueError(f"{k} must be a contiguous float32 {shape} tensor on {x.device}")
    lib = _build.load("fused_attention", _SIGNATURES)
    if lib.afr_fused_attention_smem_bytes(S, E) > _SMEM_LIMIT:
        raise ValueError(f"S={S}, E={E} needs more shared memory than one block has")
    out = torch.empty_like(x)
    if B == 0:
        return out
    with torch.cuda.device(x.device):
        rc = lib.afr_fused_attention_fwd(
            x.data_ptr(), *(weights[k].data_ptr() for k in KEYS), out.data_ptr(),
            B, S, E, heads, 0 if x.dtype == torch.float32 else 1,
            _build.stream_handle(x.device),
        )
    if rc != 0:
        raise RuntimeError(f"fused attention kernel launch failed: CUDA error {rc}")
    entry.launches += 1
    return out


def fused_attention(x: torch.Tensor, weights, heads: int, dropout_rate: float = 0.0) -> torch.Tensor:
    """v1 entry point (K5): [B, S, E] -> [B, S, E] in x's dtype.
    ``fused_attention.launches`` counts kernel launches."""
    _check_trainable(x, weights, dropout_rate)
    if x.device.type == "cpu":
        return fused_attention_reference(x, weights, heads)
    return _launch(x, weights, heads, fused_attention)


def fused_attention2(x: torch.Tensor, weights, heads: int, dropout_rate: float = 0.0) -> torch.Tensor:
    """v2 entry point (K7), the same kernel at rate 0.
    ``fused_attention2.launches`` counts kernel launches."""
    _check_trainable(x, weights, dropout_rate)
    if x.device.type == "cpu":
        return fused_attention_reference(x, weights, heads)
    return _launch(x, weights, heads, fused_attention2)


fused_attention.launches = 0
fused_attention2.launches = 0
