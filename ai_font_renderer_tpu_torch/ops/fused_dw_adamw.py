"""Fused dW = x^T @ gm plus the AdamW update of W: the CUDA kernel and its
plain version.

``fused_dw_adamw`` launches csrc/fused_dw_adamw.cu on CUDA tensors, for every
shape, or raises; it takes the plain version only for tensors on the CPU.
It replaces the TPU kernel ai_font_renderer_tpu/ops/fused_dw_adamw.py:
_kernel (K4): the output projection's gradient is summed tile by tile and
each tile updates the same tiles of w, mu and nu at once, so the 491.5 MB
f32 gradient never reaches device memory. w, mu and nu are updated IN PLACE
(the JAX kernel aliases them to its outputs); the function returns them.
The kernel writes them behind PyTorch's back, so each launch bumps their
autograd version counters as an in-place op would: that is how W's bf16
shadow (ops/fused_output.py, ``bf16_shadow``) sees that W has changed.

The update is optax's AdamW as the JAX kernel writes it, in f32:

    mu <- b1*mu + (1-b1)*dW          (stored in mu's dtype, nearest even)
    nu <- b2*nu + (1-b2)*dW^2
    w  <- w - lr * (mu*c1 / (sqrt(nu*c2) + eps) + wd*w)

with c1 = 1/(1-b1^t), c2 = 1/(1-b2^t) computed in float32 on the host from
the step count t after its increment (``bias_corrections``).

``fused_dw_adamw_xt`` is K9, the TPU kernel tools/ab_kernel_micro.py:
_kernel_xt: the same update with x already transposed, xt [K, M], and the
tool's fixed b1 = 0.9, b2 = 0.99 and wd = 5e-4. It is the second entry point
of the same CUDA source.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float] * 7 + [ctypes.c_void_p], ctypes.c_int)
_SIGNATURES = {"afr_fused_dw_adamw": _ARGS, "afr_fused_dw_adamw_xt": _ARGS}
# K9's hyperparameters, fixed as tools/ab_kernel_micro.py:121-124 fixes them.
XT_B1, XT_B2, XT_WD = 0.9, 0.99, 5e-4


def bias_corrections(b1: float, b2: float, count: int) -> tuple[float, float]:
    """(c1, c2) = (1/(1-b1^t), 1/(1-b2^t)) in float32, as the JAX kernel's
    caller computes them (ops/fused_dw_adamw.py:137-139)."""
    t = np.float32(count)
    one = np.float32(1.0)
    c1 = one / (one - np.float32(b1) ** t)
    c2 = one / (one - np.float32(b2) ** t)
    return float(c1), float(c2)


def fused_dw_adamw_reference(x, gm, w, mu, nu, lr, wd, b1, b2, count, eps=1e-8):
    """Plain version, in place: dW = bf16(x)^T @ bf16(gm) as an f32 product
    (TF32 off), then the kernel's f32 update. Returns (w, mu, nu)."""
    c1, c2 = bias_corrections(b1, b2, count)
    dw = x.to(torch.bfloat16).float().T @ gm.to(torch.bfloat16).float()
    one = np.float32(1.0)
    m = mu.float() * b1 + float(one - np.float32(b1)) * dw
    v = nu * b2 + float(one - np.float32(b2)) * dw * dw
    w -= lr * ((m * c1) / (torch.sqrt(v * c2) + eps) + wd * w)
    mu.copy_(m)
    nu.copy_(v)
    return w, mu, nu


def fused_dw_adamw(x, gm, w, mu, nu, lr, wd, b1, b2, count, eps=1e-8):
    """Fused dW + AdamW of the output projection, in place.

    x [M, K] and gm [M, N]: the projection's input and its masked cotangent,
    bf16 (anything else is rounded to bf16 first, as the JAX wrapper does).
    w [K, N] f32, mu [K, N] f32 or bf16, nu [K, N] f32. ``count`` is the
    step count t after its increment. Returns (w, mu, nu), the same tensors.
    ``fused_dw_adamw.launches`` counts kernel launches.
    """
    if count < 1:
        raise ValueError(f"count is the step after its increment and starts at 1, got {count}")
    if x.device.type == "cpu":
        return fused_dw_adamw_reference(x, gm, w, mu, nu, lr, wd, b1, b2, count, eps)
    _launch("afr_fused_dw_adamw", x, gm, w, mu, nu, lr, wd, b1, b2, count, eps, transposed=False)
    fused_dw_adamw.launches += 1
    return w, mu, nu


def fused_dw_adamw_xt_reference(xt, gm, w, mu, nu, lr, count):
    """Plain version of K9: ``fused_dw_adamw_reference`` of xt^T."""
    return fused_dw_adamw_reference(xt.T, gm, w, mu, nu, lr, XT_WD, XT_B1, XT_B2, count)


def fused_dw_adamw_xt(xt, gm, w, mu, nu, lr, count):
    """K9: the fused dW + AdamW with xt [K, M] (x transposed) bf16, b1 0.9,
    b2 0.99 and wd 5e-4; otherwise as ``fused_dw_adamw``, in place.
    ``fused_dw_adamw_xt.launches`` counts kernel launches."""
    if count < 1:
        raise ValueError(f"count is the step after its increment and starts at 1, got {count}")
    if xt.device.type == "cpu":
        return fused_dw_adamw_xt_reference(xt, gm, w, mu, nu, lr, count)
    _launch("afr_fused_dw_adamw_xt", xt, gm, w, mu, nu, lr, XT_WD, XT_B1, XT_B2, count, 1e-8, transposed=True)
    fused_dw_adamw_xt.launches += 1
    return w, mu, nu


def _launch(entry, x, gm, w, mu, nu, lr, wd, b1, b2, count, eps, transposed):
    """Check the operands and launch ``entry`` on CUDA tensors, or raise.
    x is [M, K], or [K, M] when ``transposed``."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_dw_adamw runs on cuda or cpu tensors, not {x.device}")
    x = x.to(torch.bfloat16).contiguous()
    gm = gm.to(torch.bfloat16).contiguous()
    if x.dim() != 2 or gm.dim() != 2 or x.shape[1 if transposed else 0] != gm.shape[0]:
        want = "xt [K,M]" if transposed else "x [M,K]"
        raise ValueError(f"expected {want}, gm [M,N]; got {tuple(x.shape)}, {tuple(gm.shape)}")
    if gm.device != x.device:
        raise ValueError(f"gm must be on {x.device}, not {gm.device}")
    k, m = x.shape if transposed else x.shape[::-1]
    n = gm.shape[1]
    for name, t, dtypes in (
        ("w", w, (torch.float32,)),
        ("mu", mu, (torch.float32, torch.bfloat16)),
        ("nu", nu, (torch.float32,)),
    ):
        if tuple(t.shape) != (k, n):
            raise ValueError(f"shape mismatch: {name} is {tuple(t.shape)}, expected {(k, n)}")
        if t.dtype not in dtypes or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name} must be a contiguous {dtypes} tensor on {x.device}")
    if m == 0:
        raise ValueError("fused_dw_adamw needs at least one row")
    c1, c2 = bias_corrections(b1, b2, count)
    with torch.cuda.device(x.device):
        lib = _build.load("fused_dw_adamw", _SIGNATURES)
        rc = getattr(lib, entry)(
            x.data_ptr(), gm.data_ptr(), w.data_ptr(), mu.data_ptr(), nu.data_ptr(),
            m, k, n, int(mu.dtype == torch.bfloat16),
            lr, wd, b1, b2, c1, c2, eps, _build.stream_handle(x.device),
        )
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")
    torch.autograd.graph.increment_version((w, mu, nu))


fused_dw_adamw.launches = 0
fused_dw_adamw_xt.launches = 0
