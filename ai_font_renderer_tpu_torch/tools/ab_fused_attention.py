"""A/B: the fused attention kernels against the plain attention frontend.

The port of tools/ab_fused_attention.py, at the flagship shapes (B 1024, S
100, E 32, H 4):

  1. correctness: the forward (eval mode, no dropout) with
     ``fused_attention`` (K5, and K6 for its gradients; f32) against the
     plain attention, and the gradients of a scalar loss with respect to
     the weights, relative to each one's largest value;
  2. the forward-only latency of the full model, chained (each output
     perturbs the next call's codes), best of 3 windows of 30 calls;
  3. the train-step latency of 20-step ``train_epoch`` runs with the flag
     on and off, each with and without the fast profile (bf16 frontend,
     bits dropout), best of 4 epochs.

``ModelConfig.fused_attention_tile`` (the Pallas kernel's batch tile) is
accepted by the port's config and changes nothing: the CUDA kernels take
any batch, and their dropout mask does not depend on a tile.

    python -m ai_font_renderer_tpu_torch.tools.ab_fused_attention [--device cpu]
"""

from __future__ import annotations

import sys
import time

import torch

from ..config import ModelConfig, TrainConfig, replace
from ..models import font_renderer
from ..train.step import train_epoch
from . import _common
from .ab_profiles import fresh_state, random_corpus

GRAD_KEYS = ("wq", "wk", "wv", "wo", "out_w", "embedding")


def chain_fwd(mcfg, params, codes, device, iters=30, rounds=3) -> float:
    """Seconds per chained forward call: each output's first row perturbs
    the next call's codes."""
    box = [codes]

    @torch.no_grad()
    def f():
        out = font_renderer.apply(params, box[0], mcfg)
        delta = (out[:, :1, : mcfg.max_length] * 7).to(torch.int32).reshape(box[0].shape)
        box[0] = (box[0] + delta) % 26 + 65

    return _common.best_s(f, iters, rounds, device) / iters


def epoch_time(mcfg, tcfg, device, steps=20, rounds=4) -> float:
    """Seconds per step of ``train_epoch`` on random data, best of
    ``rounds`` epochs after a warm one."""
    b = tcfg.batch_size
    n = 4 * b
    ds = random_corpus(mcfg, n, device, seed=7)
    batch_idx = torch.arange(steps * b, device=device).reshape(steps, b) % n
    state = fresh_state(mcfg, tcfg, device)
    best = float("inf")
    for i in range(rounds + 1):
        t0 = time.perf_counter()
        state, loss = train_epoch(state, ds, batch_idx, 1e-3, torch.Generator(device=device).manual_seed(i),
                                  mcfg, tcfg)
        float(loss)
        if i:
            best = min(best, time.perf_counter() - t0)
    return best / steps


def correctness(params, codes, base, fused) -> dict:
    """The forward and the gradients of mean(out^2) under ``base`` and
    ``fused``, eval mode (no dropout): both outputs, both gradients, the
    forward's max |difference| and each weight's gradient difference
    relative to its largest value."""
    leaves = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    outs, grads = [], []
    for cfg in (base, fused):
        out = font_renderer.apply(leaves, codes, cfg)
        keys = [k for k in GRAD_KEYS if k in leaves]
        g = torch.autograd.grad((out * out).mean(), [leaves[k] for k in keys])
        outs.append(out.detach())
        grads.append(dict(zip(keys, g)))
    ga, gb = grads
    return {
        "out": outs,
        "grads": grads,
        "fwd_diff": float((outs[0] - outs[1]).abs().max()),
        "grad_rel": {k: float((ga[k] - gb[k]).abs().max() / (ga[k].abs().max() + 1e-12)) for k in ga},
    }


def main(argv: list[str] | None = None, mcfg: ModelConfig = ModelConfig(), batch: int = 1024, iters: int = 30,
         rounds: int = 3, steps: int = 20, epochs: int = 4) -> dict:
    rest, dev, _ = _common.start(sys.argv[1:] if argv is None else argv)
    base = replace(mcfg, fused_attention=False)
    fused = replace(mcfg, fused_attention=True)
    print(f"fused_attention_tile={fused.fused_attention_tile}: accepted, no effect in the port (the CUDA kernels "
          "take any batch; the dropout mask does not depend on a tile)", flush=True)
    params = font_renderer.init(torch.Generator(device=dev).manual_seed(0), base, dev)
    codes = torch.randint(65, 91, (batch, base.max_length), generator=torch.Generator(device=dev).manual_seed(1),
                          device=dev, dtype=torch.int32)

    # 1. correctness (eval-mode forward + gradients, dropout inactive)
    c = correctness(params, codes, base, fused)
    print(f"fwd max|diff| = {c['fwd_diff']:.3e}")
    print("grad rel max diffs:", {k: f"{v:.2e}" for k, v in c["grad_rel"].items()}, flush=True)

    # 2. forward latency
    dt_a = chain_fwd(base, params, codes, dev, iters, rounds)
    dt_b = chain_fwd(fused, params, codes, dev, iters, rounds)
    print(f"fwd apply:  plain {dt_a*1e3:.3f} ms   fused {dt_b*1e3:.3f} ms", flush=True)

    # 3. train-step latency on the epoch path
    tcfg = TrainConfig(batch_size=batch)
    steps_ms = {}
    for tag, flag in (("plain", False), ("fused", True)):
        for fast in (False, True):
            m = replace(mcfg, fused_attention=flag, bf16_frontend=fast, bits_dropout=fast)
            dt = epoch_time(m, tcfg, dev, steps, epochs)
            steps_ms[f"{tag} fast={fast}"] = dt * 1e3
            print(f"train step [{tag} fast={fast}]: {dt*1e3:.2f} ms", flush=True)
    return {"fwd_diff": c["fwd_diff"], "grad_rel": c["grad_rel"], "fwd_ms": {"plain": dt_a * 1e3, "fused": dt_b * 1e3},
            "train_step_ms": steps_ms}


if __name__ == "__main__":
    main()
