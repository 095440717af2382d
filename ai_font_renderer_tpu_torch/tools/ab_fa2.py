"""A/B: the v2 attention kernels (stored-mask dropout) against the plain
attention and v1.

The port of tools/ab_fa2.py, at the flagship shapes (B 1024, S 100, E 32,
H 4):

  1. correctness: the forward (eval mode, no dropout) with
     ``fused_attention_v2`` (K7, and K8 for its gradients) against the
     plain attention, and the gradients of mean(out^2) with respect to wq,
     wk, wv, wo, out_w and the embedding, each relative to its largest
     value;
  2. the train-step latency of ``train_epoch`` for the plain attention, v1
     (K5/K6) and v2 (K7/K8), each in the parity and the fast profile (bf16
     frontend, bits dropout);
  3. the eval-mode forward of the plain attention and v1, chained, in
     glyphs/s.

The JAX tool sweeps the Pallas kernels' batch tiles (``fused_attention_tile``
8/32/64/128, ``fa2_tile_fwd``/``fa2_tile_bwd`` 16/8, 32/16, 64/32). The CUDA
kernels take no tile (config.py), so each distinct path runs once, and its
tag names the JAX rows it stands for. One JSON line of the results closes
the output.

    python -m ai_font_renderer_tpu_torch.tools.ab_fa2 [--device cpu]
"""

from __future__ import annotations

import json
import sys

import torch

from ..config import ModelConfig, TrainConfig, replace
from ..models import font_renderer
from . import _common
from .ab_fused_attention import chain_fwd, correctness, epoch_time

# tag -> (ModelConfig flags, the JAX tool's rows it stands for)
TRAIN_PATHS = {
    "plain": ({}, "xla"),
    "v1": ({"fused_attention": True}, "v1 t8, v1 t32"),
    "v2": ({"fused_attention_v2": True}, "v2 f16/b8, v2 f32/b16, v2 f64/b32"),
}
EVAL_PATHS = {
    "plain": ({}, "xla"),
    "v1": ({"fused_attention": True}, "v1 t32, v1 t64, v1 t128"),
}


def main(argv: list[str] | None = None, mcfg: ModelConfig = ModelConfig(), batch: int = 1024, iters: int = 50,
         rounds: int = 3, steps: int = 20, epochs: int = 4, params: dict | None = None,
         codes: torch.Tensor | None = None) -> dict:
    """``params``/``codes``: given weights and codes instead of those drawn
    from seeds 0 and 1."""
    _, dev, _ = _common.start(sys.argv[1:] if argv is None else argv)
    base = replace(mcfg, fused_attention=False, fused_attention_v2=False)
    v2 = replace(base, fused_attention_v2=True)
    if params is None:
        params = font_renderer.init(torch.Generator(device=dev).manual_seed(0), base, dev)
    if codes is None:
        codes = torch.randint(65, 91, (batch, base.max_length), generator=torch.Generator(device=dev).manual_seed(1),
                              device=dev, dtype=torch.int32)
    batch = codes.shape[0]

    # 1. correctness (eval mode: dropout inactive)
    c = correctness(params, codes, base, v2)
    print(f"fwd max|diff| = {c['fwd_diff']:.3e}")
    print("grad rel max diffs:", {k: f"{v:.2e}" for k, v in c["grad_rel"].items()}, flush=True)

    # 2. train-step latency on the epoch path
    tcfg = TrainConfig(batch_size=batch)
    step_ms = {}
    for fast in (False, True):
        for tag, (kw, rows) in TRAIN_PATHS.items():
            m = replace(base, bf16_frontend=fast, bits_dropout=fast, **kw)
            dt = epoch_time(m, tcfg, dev, steps, epochs)
            step_ms[f"{tag} fast={fast}"] = dt * 1e3
            print(f"train step [{tag} ({rows}) fast={fast}]: {dt*1e3:.2f} ms", flush=True)

    # 3. eval-mode forward (the serving path): dropout is inactive, so v1 is
    # the kernel that serves.
    eval_gps = {}
    for tag, (kw, rows) in EVAL_PATHS.items():
        dt = chain_fwd(replace(base, **kw), params, codes, dev, iters, rounds)
        eval_gps[tag] = batch * base.max_length / dt
        print(f"eval fwd [{tag} ({rows})]: {dt*1e3:.3f} ms/batch = {eval_gps[tag] / 1e6:.1f}M glyphs/sec",
              flush=True)
    out = {"fwd_diff": c["fwd_diff"], "grad_rel": c["grad_rel"], "train_step_ms": step_ms,
           "eval_glyphs_per_sec": eval_gps}
    print(json.dumps(out), flush=True)
    return {**out, "out": c["out"], "grads": c["grads"]}


if __name__ == "__main__":
    main()
