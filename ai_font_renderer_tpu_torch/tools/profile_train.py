"""Component-level timing of the train step on the card.

The port of tools/profile_train.py: each piece of the step timed alone with
``utils.profiling.timed`` (calls, then a device sync), to attribute the
step's budget and to check that K1's forward agrees with the plain forward:
the forward in eval and in train mode, K1's forward (its max abs error
against the plain forward printed), the projection GEMM alone, the
attention alone, the dropout mask at the attention probabilities' size
(the port's Philox bits, ops/philox.py), 20 chained train steps plain and
with ``use_pallas_output`` (K1/K2/K3), and the AdamW update alone over
every parameter (123M at full width).

    python -m ai_font_renderer_tpu_torch.tools.profile_train [--kernels K] [--device cpu]

``--kernels`` sets the kernel flags of the first forwards and of the plain
train step (tools/_common.py).
"""

from __future__ import annotations

import sys
import time

import torch

from ..config import ModelConfig, TrainConfig, replace
from ..models import font_renderer
from ..ops.philox import dropout_keep
from ..train import optim
from ..train.step import state_from_params, train_step
from ..utils.profiling import timed
from . import _common
from .ab_kernel_micro import dw_product

B = 1024


def timeit(name, fn, *args, iters=20):
    dt = timed(fn, *args, iters=iters, warmup=1)
    print(f"{name:38s} {dt * 1e3:8.3f} ms", flush=True)
    return dt


def _steps_ms(state, codes, targets, mcfg, tcfg, device, steps=20) -> float:
    """ms per step of ``steps`` chained steps after one warm one."""
    gen = torch.Generator(device=device).manual_seed(0)
    state, _ = train_step(state, codes, targets, 1e-3, gen, mcfg, tcfg)
    _common.sync(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        state, loss = train_step(state, codes, targets, 1e-3, gen, mcfg, tcfg)
    float(loss)
    return (time.perf_counter() - t0) / steps * 1e3


def main(argv: list[str] | None = None, mcfg: ModelConfig = ModelConfig(), batch: int = B, iters: int = 20,
         steps: int = 20) -> dict:
    rest, dev, kernels = _common.start(sys.argv[1:] if argv is None else argv)
    mcfg, tcfg = _common.with_kernels(kernels, mcfg, TrainConfig())
    g = torch.Generator(device=dev).manual_seed(0)
    params = font_renderer.init(g, mcfg, dev)
    codes = torch.randint(65, 91, (batch, mcfg.max_length), generator=g, device=dev, dtype=torch.int32)
    targets = torch.rand(batch, mcfg.sheet_height, mcfg.sheet_width, generator=g, device=dev)
    out = {}

    with torch.no_grad():
        out["fwd eval"] = timeit("fwd eval", lambda: font_renderer.apply(params, codes, mcfg), iters=iters)
        out["fwd train (dropout)"] = timeit(
            "fwd train (dropout)", lambda: font_renderer.apply(params, codes, mcfg, train=True, generator=g),
            iters=iters)
        mcfg_p = replace(mcfg, use_pallas_output=True)
        a = font_renderer.apply(params, codes, mcfg_p)
        b = font_renderer.apply(params, codes, replace(mcfg, use_pallas_output=False))
        out["k1_vs_plain_max_abs_err"] = float((a - b).abs().max())
        print(f"K1-vs-plain fwd max abs err: {out['k1_vs_plain_max_abs_err']:.2e}", flush=True)
        out["fwd eval (K1 fused)"] = timeit("fwd eval (K1 fused)", lambda: font_renderer.apply(params, codes, mcfg_p),
                                            iters=iters)

        k = mcfg.max_length * mcfg.hidden_dim
        flat = torch.randn(batch, k, generator=g, device=dev).to(torch.bfloat16)
        w16 = params["out_w"].to(torch.bfloat16)
        out["out GEMM alone (bf16)"] = timeit("out GEMM alone (bf16)", lambda: dw_product(flat.t(), w16),
                                              iters=iters)

        x = torch.randn(batch, mcfg.max_length, mcfg.embedding_dim, generator=g, device=dev)
        out["attention alone"] = timeit("attention alone", lambda: font_renderer.attention(params, x, mcfg),
                                        iters=iters)

        seed = torch.randint(0, 2**31 - 1, (1,), generator=g, device=dev, dtype=torch.int32)
        shape = (batch, mcfg.num_heads, mcfg.max_length, mcfg.max_length)
        out["dropout keep mask philox"] = timeit(
            f"keep mask {list(shape)} philox", lambda: dropout_keep(seed, shape, 0.2), iters=iters)

    for tag, m in (("plain", replace(mcfg, use_pallas_output=False)), ("K1/K2/K3", mcfg_p)):
        ms = _steps_ms(state_from_params(params, tcfg), codes, targets, m, tcfg, dev, steps)
        out[f"train step {tag}"] = ms / 1e3
        print(f"{'train step ' + tag:38s} {ms:8.3f} ms", flush=True)

    # The AdamW update alone: every parameter, unit gradients, in place.
    p = {kk: v.clone() for kk, v in params.items()}
    grads = {kk: torch.ones_like(v) for kk, v in p.items()}
    mu = {kk: torch.zeros_like(v, dtype=torch.bfloat16) for kk, v in p.items()}
    nu = {kk: torch.zeros_like(v) for kk, v in p.items()}
    keys = list(p)
    count = [0]

    def opt_only():
        count[0] += 1
        with torch.no_grad():
            optim.adam_([p[kk] for kk in keys], [grads[kk] for kk in keys], [mu[kk] for kk in keys],
                        [nu[kk] for kk in keys], 1e-3, count[0], tcfg.adam_b1, tcfg.adam_b2, tcfg.weight_decay)

    n_par = font_renderer.param_count(params)
    out["AdamW update alone"] = timeit(f"AdamW update alone ({n_par / 1e6:.0f}M f32)", opt_only, iters=iters)
    return out


if __name__ == "__main__":
    main()
