"""What the reference of every architecture shares: plain f32 numerics, the
control's lower precision, and optax's AdamW, in plain PyTorch."""

from __future__ import annotations

import numpy as np
import torch


def plain_numerics() -> None:
    """Full f32 products: no TF32, no reduced-precision bf16 sums."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a power-of-two scale that maps its
    largest magnitude within 448; the values stay exact in bf16. The
    gradient passes through unchanged."""
    amax = t.detach().abs().amax().float().clamp(min=1e-30)
    scale = torch.exp2(torch.ceil(torch.log2(amax / 448.0)))
    q = (t.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q.to(t.dtype) - t).detach()


class Numerics:
    """The dtypes and roundings of one configuration's computation."""

    def __init__(self, m: dict, lower: str | None = None):
        if lower not in (None, "fp8"):
            raise ValueError(f"lower={lower!r}: None or 'fp8'")
        self.dt = torch.bfloat16 if m.get("bf16_frontend") else torch.float32
        self.proj_dt = torch.bfloat16 if m.get("bf16_matmul", True) else torch.float32
        self.lower = lower

    def op(self, t: torch.Tensor, dt=None) -> torch.Tensor:
        """``t`` as a matrix operand in ``dt`` (the frontend dtype)."""
        t = t.to(dt or self.dt)
        return fp8(t) if self.lower == "fp8" else t




def _bias_correction(decay: float, count: int) -> float:
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


@torch.no_grad()
def adamw_(params: dict, grads: dict, mu: dict, nu: dict, lr: float, count: int, t: dict,
           fused: tuple = ()) -> None:
    """optax's adamw (scale_by_adam -> add_decayed_weights -> scale by -lr)
    in place, f32; a bf16 first moment decays by b1 rounded to bf16, as
    optax multiplies a moment by a scalar of its own dtype. The leaves in
    ``fused`` take the fused dW + AdamW update's formula instead (the JAX
    package's ops/fused_dw_adamw.py): the moment decays by b1 in f32 and the
    bias corrections are multiplied in as 1 / (1 - b^t)."""
    b1, b2, wd, eps = t["adam_b1"], t["adam_b2"], t["weight_decay"], 1e-8
    bc1, bc2 = _bias_correction(b1, count), _bias_correction(b2, count)
    c1, c2 = float(np.float32(1.0 / (1.0 - b1**count))), float(np.float32(1.0 / (1.0 - b2**count)))
    for k, p in params.items():
        g = grads[k]
        if k in fused:
            m_new = mu[k].float() * b1 + float(np.float32(1.0) - np.float32(b1)) * g
            nu[k].mul_(b2).add_(float(np.float32(1.0) - np.float32(b2)) * g * g)
            u = (m_new * c1) / (torch.sqrt(nu[k] * c2) + eps)
        else:
            b1_in = float(torch.tensor(b1, dtype=mu[k].dtype))
            m_new = mu[k].float() * b1_in + (1 - b1) * g
            nu[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            u = (m_new / bc1) / ((nu[k] / bc2).sqrt() + eps)
        p.add_(u + wd * p, alpha=-lr)
        mu[k].copy_(m_new)
