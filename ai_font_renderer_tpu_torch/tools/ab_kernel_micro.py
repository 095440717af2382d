"""Microbench: the fused dW + AdamW kernels alone against the library's dW
GEMM + AdamW alone; the home of K9.

The port of tools/ab_kernel_micro.py. At the flagship shapes, x [1024, 6400]
bf16, gm [1024, 19200] bf16 (times 1e-4), W [6400, 19200] f32 from a seed,
zero moments, lr 1e-3, b1 0.9, b2 0.99, wd 5e-4, eps 1e-8, step count 3:

  * the library path: dW = x^T gm in one torch.mm (bf16 in, f32 out), then
    torch._fused_adamw_ on w, mu and nu (its moments all in one dtype, so
    its mu is f32);
  * K4 (ops.fused_dw_adamw, bf16 mu), w, mu and nu updated in place;
  * with ``xt`` as the fourth argument, also K9 (ops.fused_dw_adamw_xt) on
    xt = x^T [6400, 1024], the kernel tools/ab_kernel_micro.py:_kernel_xt
    ported (csrc/fused_dw_adamw.cu, ``afr_fused_dw_adamw_xt``).

Each is chained over 10 updates of one state (every update reads the w the
last one wrote), best of 3 windows, the window closed by a device sync.

    python -m ai_font_renderer_tpu_torch.tools.ab_kernel_micro [bm bk bn [xt]] [--device cpu]

The JAX tool's three arguments choose the Pallas kernel's tiles. The CUDA
kernels' tiles are fixed by the build (csrc/sm90_gemm.cuh), so the port
prints that and times the one build. Prints one line a variant, then one
JSON line of the times in ms per update.
"""

from __future__ import annotations

import json
import sys

import torch

from ..ops.fused_dw_adamw import XT_B1, XT_B2, XT_WD, fused_dw_adamw, fused_dw_adamw_xt
from . import _common

M, K, N = 1024, 6400, 19200
LR, COUNT, EPS = 1e-3, 3, 1e-8


def timeit(label, fn, x, gm, w, mu, nu, device, iters=10):
    """ms per update of ``fn(x, gm, w, mu, nu)``, which updates w, mu and nu
    in place: the state chain makes every update depend on the last."""
    best = _common.best_s(lambda: fn(x, gm, w, mu, nu), iters, 3, device)
    ms = 1e3 * best / iters
    print(f"{label}: {ms:.2f} ms", flush=True)
    return ms


def dw_product(x: torch.Tensor, gm: torch.Tensor) -> torch.Tensor:
    """x^T @ gm in f32 from bf16 operands: one cuBLAS GEMM on the card, an
    f32 product of the same (exact) values on the CPU."""
    if x.device.type == "cuda":
        return torch.mm(x.t(), gm, out_dtype=torch.float32)
    return x.float().t() @ gm.float()


def library_update(x, gm, w, mu, nu, lr=LR, count=COUNT):
    """The library path, in place: dW, then torch._fused_adamw_ (decoupled
    weight decay, optax's arithmetic in another order) with f32 moments."""
    step = torch.tensor(float(count), device=w.device)
    torch._fused_adamw_([w], [dw_product(x, gm)], [mu], [nu], [], [step], lr=lr, beta1=XT_B1, beta2=XT_B2,
                        weight_decay=XT_WD, eps=EPS, amsgrad=False, maximize=False)
    return w, mu, nu


def k4_update(x, gm, w, mu, nu, lr=LR, count=COUNT):
    return fused_dw_adamw(x, gm, w, mu, nu, lr, XT_WD, XT_B1, XT_B2, count, EPS)


def k9_update(xt, gm, w, mu, nu, lr=LR, count=COUNT):
    return fused_dw_adamw_xt(xt, gm, w, mu, nu, lr, count)


def inputs(m: int, k: int, n: int, device, seed: int = 0) -> tuple:
    """(x [m, k] bf16, gm [m, n] bf16 * 1e-4, w [k, n] f32 * 0.01) from
    ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(m, k, generator=g, device=device).to(torch.bfloat16)
    gm = (torch.randn(m, n, generator=g, device=device) * 1e-4).to(torch.bfloat16)
    w = torch.randn(k, n, generator=g, device=device) * 0.01
    return x, gm, w


def main(argv: list[str] | None = None, m: int = M, k: int = K, n: int = N, iters: int = 10) -> dict:
    rest, dev, _ = _common.start(sys.argv[1:] if argv is None else argv)
    x, gm, w0 = inputs(m, k, n, dev)
    zeros = lambda dt: torch.zeros(k, n, device=dev, dtype=dt)  # noqa: E731
    out = {}
    out["library"] = timeit("library dW GEMM + AdamW (in place, f32 moments)", library_update, x, gm,
                            w0.clone(), zeros(torch.float32), zeros(torch.float32), dev, iters)
    if len(rest) >= 3:
        print(f"tiles ({rest[0]},{rest[1]},{rest[2]}) requested: the CUDA kernel's tiles are fixed by the build "
              "(csrc/sm90_gemm.cuh), so the one build is timed", flush=True)
    out["fused"] = timeit("fused kernel K4 (bf16 mu)", k4_update, x, gm, w0.clone(), zeros(torch.bfloat16),
                          zeros(torch.float32), dev, iters)
    if len(rest) > 3 and rest[3] == "xt":
        out["fused_xt"] = main_xt(x, gm, w0, dev, iters)
    print(json.dumps({"ms_per_update": out, "shape": {"M": m, "K": k, "N": n}, "iters": iters}), flush=True)
    return out


def main_xt(x, gm, w0, device, iters: int = 10) -> float:
    """K9 on xt = x^T [K, M], as the JAX tool's ``main_xt``."""
    k, n = w0.shape
    xt = x.t().contiguous()
    return timeit("fused XT K9 (bf16 mu)", k9_update, xt, gm, w0.clone(),
                  torch.zeros(k, n, device=device, dtype=torch.bfloat16), torch.zeros(k, n, device=device),
                  device, iters)


if __name__ == "__main__":
    main()
