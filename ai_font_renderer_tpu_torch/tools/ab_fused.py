"""A/B: the standard train step against the fused dW + AdamW step (K1, K2
and K4) at the flagship shapes.

The port of tools/ab_fused.py. Each variant runs 20-step train+eval epochs
(the state threads through; the epoch ends in a fetch of its train loss),
the variants alternating: standard (warm), fused (warm), then a fresh
standard and a fresh fused; best of 4 epochs each. The eval pass (2
batches) is the same in both, so the difference is the train step's.

    python -m ai_font_renderer_tpu_torch.tools.ab_fused [--kernels K] [--device cpu]

``--kernels`` adds kernel flags to both variants (tools/_common.py).
"""

from __future__ import annotations

import sys
import time

import torch

from ..config import ModelConfig, TrainConfig
from ..train.step import train_eval_epoch
from . import _common
from .ab_profiles import fresh_state, random_corpus


def main(argv: list[str] | None = None, mcfg: ModelConfig = ModelConfig(), batch: int | None = None,
         steps: int = 20, rounds: int = 4) -> dict:
    rest, dev, kernels = _common.start(sys.argv[1:] if argv is None else argv)
    tcfg = TrainConfig() if batch is None else TrainConfig(batch_size=batch)
    std_m, std_t = _common.with_kernels(kernels, mcfg, tcfg)
    fus_m, fus_t = _common.with_kernels("fused", std_m, std_t)
    b = tcfg.batch_size
    n = 4 * b
    ds = random_corpus(mcfg, n, dev)
    batch_idx = torch.arange(steps * b, device=dev).reshape(steps, b) % n
    val_idx = batch_idx[:2]
    val_w = torch.ones(2, b, device=dev)
    out = {}

    def run(label, m, t, seed):
        state = fresh_state(m, t, dev, seed)

        def epoch(r):
            nonlocal state
            state, tl, _ = train_eval_epoch(state, ds, batch_idx, val_idx, val_w, 1e-3,
                                            torch.Generator(device=dev).manual_seed(r), m, t)
            float(tl)

        epoch(100)  # warm
        best = float("inf")
        for r in range(rounds):
            t0 = time.perf_counter()
            epoch(r)
            best = min(best, time.perf_counter() - t0)
        print(f"{label}: {1e3 * best / steps:.2f} ms/step (epoch best {best:.3f}s)", flush=True)
        out[label.strip()] = 1e3 * best / steps

    run("standard (warm)", std_m, std_t, 0)
    run("fused    (warm)", fus_m, fus_t, 0)
    run("standard", std_m, std_t, 1)
    run("fused   ", fus_m, fus_t, 1)
    return out


if __name__ == "__main__":
    main()
