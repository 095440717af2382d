"""Fused dW = x^T @ gm plus the AdamW update of W: the CUDA kernel and its
plain versions.

``fused_dw_adamw`` launches csrc/fused_dw_adamw.cu on CUDA tensors, for every
shape, or raises; it takes the plain version only for tensors on the CPU.
It replaces the TPU kernel ai_font_renderer_tpu/ops/fused_dw_adamw.py:
_kernel (K4): the output projection's gradient is summed on the tensor
cores (the TMA + wgmma GEMM of csrc/sm90_gemm.cuh that K3 runs) and each
element of it updates the same element of w, mu and nu at once, so the
491.5 MB f32 gradient never reaches device memory. w, mu and nu are updated
IN PLACE (the JAX kernel aliases them to its outputs); the function returns
them. The kernel writes them behind PyTorch's back, so each launch bumps
their autograd version counters as an in-place op would.

W's bf16 shadow (ops/fused_output.py, ``bf16_shadow``): when W has a current
shadow (K1 or K2 read W since its last change), the update also writes the
new W's bf16, ``round_bf16(w)``, into a new buffer, which becomes W's shadow
at its new version, so the next K1 builds none. A W without a current
shadow gets none.

The update is optax's AdamW as the JAX kernel writes it, in f32:

    mu <- b1*mu + (1-b1)*dW          (stored in mu's dtype, nearest even)
    nu <- b2*nu + (1-b2)*dW^2
    w  <- w - lr * (mu*c1 / (sqrt(nu*c2) + eps) + wd*w)

with c1 = 1/(1-b1^t), c2 = 1/(1-b2^t) computed in float32 on the host from
the step count t after its increment (``bias_corrections``).

The kernel reads its operands as bf16 rows a multiple of 8 elements apart:
x and gm are taken as they are when they already are such (the trainer
hands over K1's x16 and K2's gm16), go through the operand pass
(``round_bf16``) when they are float32, and are rounded and padded
otherwise. On CPU tensors the wrappers run the plain version
(``fused_dw_adamw_reference``) and, for a W with a current shadow, write
``round_bf16_reference`` of the new W as its shadow.

``fused_dw_adamw_xt`` is K9, the TPU kernel tools/ab_kernel_micro.py:
_kernel_xt: the same update with x already transposed, xt [K, M], and the
tool's fixed b1 = 0.9, b2 = 0.99 and wd = 5e-4. It is the second entry point
of the same CUDA source, with a K-major A operand.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .fused_output import _write_shadow, padded_width, round_bf16, round_bf16_reference

_PTR, _INT, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = ([_PTR] * 6 + [_INT] * 7 + [_F32] * 7 + [_PTR], ctypes.c_int)
_SIGNATURES = {
    "afr_fused_dw_adamw": _ARGS,
    "afr_fused_dw_adamw_xt": _ARGS,
    "afr_fused_dw_adamw_attrs": ([_PTR], ctypes.c_int),
}
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
    Writes W's new bf16 shadow when W has a current one (module note).
    ``fused_dw_adamw.launches`` counts kernel launches.
    """
    _update(fused_dw_adamw, "afr_fused_dw_adamw", x, gm, w, mu, nu, lr, wd, b1, b2, count, eps,
            transposed=False)
    return w, mu, nu


def fused_dw_adamw_xt_reference(xt, gm, w, mu, nu, lr, count):
    """Plain version of K9: ``fused_dw_adamw_reference`` of xt^T."""
    return fused_dw_adamw_reference(xt.T, gm, w, mu, nu, lr, XT_WD, XT_B1, XT_B2, count)


def fused_dw_adamw_xt(xt, gm, w, mu, nu, lr, count):
    """K9: the fused dW + AdamW with xt [K, M] (x transposed) bf16, b1 0.9,
    b2 0.99 and wd 5e-4; otherwise as ``fused_dw_adamw``, in place.
    ``fused_dw_adamw_xt.launches`` counts kernel launches."""
    _update(fused_dw_adamw_xt, "afr_fused_dw_adamw_xt", xt, gm, w, mu, nu, lr, XT_WD, XT_B1, XT_B2,
            count, 1e-8, transposed=True)
    return w, mu, nu


def _operand(t: torch.Tensor) -> torch.Tensor:
    """t [rows, cols] as the kernel reads it: bf16 rows a multiple of 8
    elements apart, 16-byte aligned. A bf16 tensor that is one already (a
    column slice of a padded operand too) is taken as it is, a float32 one
    goes through the operand pass, anything else is rounded to bf16 and
    zero-padded."""
    if (t.dtype == torch.bfloat16 and t.stride(1) == 1 and t.stride(0) % 8 == 0
            and t.stride(0) >= t.shape[1] and t.data_ptr() % 16 == 0):
        return t
    if t.dtype == torch.float32:
        return round_bf16(t.contiguous())
    rows, cols = t.shape
    out = torch.zeros((rows, padded_width(cols)), dtype=torch.bfloat16, device=t.device)
    out[:, :cols] = t
    return out


def _update(counter, entry, x, gm, w, mu, nu, lr, wd, b1, b2, count, eps, transposed):
    """Check the tensors and update w, mu and nu in place: the kernel
    ``entry`` on CUDA tensors (counted on ``counter``), the plain version on
    CPU tensors. x is [M, K], or [K, M] when ``transposed``."""
    if count < 1:
        raise ValueError(f"count is the step after its increment and starts at 1, got {count}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_dw_adamw runs on cuda or cpu tensors, not {x.device}")
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
    if m == 0 and x.device.type == "cuda":
        raise ValueError("fused_dw_adamw needs at least one row")
    if x.device.type == "cpu":
        def plain(w16):
            fused_dw_adamw_reference(x.T if transposed else x, gm, w, mu, nu, lr, wd, b1, b2, count, eps)
            if w16 is not None:
                w16.copy_(round_bf16_reference(w))

        _write_shadow(w, plain)
        return

    a16, gm16 = _operand(x), _operand(gm)
    c1, c2 = bias_corrections(b1, b2, count)

    def launch(w16):
        with torch.cuda.device(x.device):
            lib = _build.load("fused_dw_adamw", _SIGNATURES)
            rc = getattr(lib, entry)(
                a16.data_ptr(), gm16.data_ptr(), w.data_ptr(), mu.data_ptr(), nu.data_ptr(),
                None if w16 is None else w16.data_ptr(),
                m, k, n, a16.stride(0), gm16.stride(0), 0 if w16 is None else w16.stride(0),
                int(mu.dtype == torch.bfloat16), lr, wd, b1, b2, c1, c2, eps,
                _build.stream_handle(x.device),
            )
        if rc != 0:
            raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")
        torch.autograd.graph.increment_version((w, mu, nu))

    _write_shadow(w, launch)
    counter.launches += 1


def dw_adamw_attributes(device="cuda") -> dict:
    """The kernel as built for the card, as the training step launches it
    (K4, bf16 mu, W's shadow written): registers a thread, static and
    dynamic shared memory a block (bytes), threads a block, ring stages, and
    the tile (bm x bn)."""
    attrs = (ctypes.c_int * 7)()
    with torch.cuda.device(device):
        rc = _build.load("fused_dw_adamw", _SIGNATURES).afr_fused_dw_adamw_attrs(attrs)
    if rc != 0:
        raise RuntimeError(f"afr_fused_dw_adamw_attrs failed: CUDA error {rc}")
    keys = ("registers", "static_smem", "dynamic_smem", "threads", "stages", "bm", "bn")
    return dict(zip(keys, attrs))


fused_dw_adamw.launches = 0
fused_dw_adamw_xt.launches = 0
