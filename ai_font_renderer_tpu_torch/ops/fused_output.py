"""Fused output projection clamp(x @ W + b, 0, 1): the CUDA kernel and its
plain version.

``fused_output`` launches csrc/fused_output.cu on a CUDA tensor, for every
shape, or raises; it takes the plain version only for tensors on the CPU.
It replaces the TPU kernel ai_font_renderer_tpu/ops/fused_output.py:
_fwd_kernel (K1). Unlike the TPU path, which runs its kernel only when M, K
and N are multiples of 128 and otherwise falls back to plain ops, the CUDA
kernel masks the ragged edge itself. Forward only: the backward (K2, K3)
comes with the training slice as a ``torch.autograd.Function``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_SIGNATURES = {
    "afr_fused_output_fwd": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p], ctypes.c_int),
}


def fused_output_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: bf16-rounded operands, an f32 product (TF32 off), bias,
    clamp. A bf16 x bf16 product is exact in f32, so this differs from the
    kernel only in the order of the f32 sums."""
    z = x.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float() + b
    return z.clamp(0.0, 1.0)


def fused_output(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """clamp(bf16(x) @ bf16(w) + b, 0, 1) in f32. x [M, K], w [K, N], b [N],
    all float32. ``fused_output.launches`` counts kernel launches."""
    if x.device.type == "cpu":
        return fused_output_reference(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"fused_output runs on cuda or cpu tensors, not {x.device}")
    if x.dim() != 2 or w.dim() != 2 or b.dim() != 1:
        raise ValueError(f"expected x [M,K], w [K,N], b [N]; got {x.shape}, {w.shape}, {b.shape}")
    m, k = x.shape
    k2, n = w.shape
    if k != k2 or b.shape[0] != n:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}, b {tuple(b.shape)}")
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name} must be a contiguous float32 tensor on {x.device}")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    with torch.cuda.device(x.device):
        rc = _build.load("fused_output", _SIGNATURES).afr_fused_output_fwd(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
            m, k, n, _build.stream_handle(x.device),
        )
    if rc != 0:
        raise RuntimeError(f"fused_output kernel launch failed: CUDA error {rc}")
    fused_output.launches += 1
    return out


fused_output.launches = 0
