"""A/B the serving tiers: fp32, fp + bf16 frontend, int8, int8 + bf16.

The port of tools/ab_serving_tiers.py, at the flagship shapes (B 1024, S
100, weights from a seed): each tier's forward chained (each output
perturbs the next call's codes), best of 3 windows of 50 calls, in
glyphs/s (bench_inference's chain). The int8 tiers quantize out_w per output column and the
activations per row (ops/quantized.py: ``apply_quantized_int8``, the int8
product). ``--kernels`` sets the kernel flags of every tier (``output,
attention``: the atlas's K1 and f32 K5; the int8 tiers have no K1). Each
tier's sheets on the first batch are compared with fp32's (max and mean
|difference|). One JSON line of the results closes the output.

    python -m ai_font_renderer_tpu_torch.tools.ab_serving_tiers [--kernels K] [--device cpu]
"""

from __future__ import annotations

import json
import sys

import torch

from ..config import ModelConfig, replace
from ..models import font_renderer
from ..ops.quantized import apply_quantized_int8, quantize_params
from . import _common
from .bench_inference import chain_time, make_chain


def tiers(mcfg: ModelConfig) -> dict:
    """tag -> (uses the int8 bundle, apply_fn), the JAX tool's four tiers."""
    fast = replace(mcfg, bf16_frontend=True)
    return {
        "fp32": (False, lambda p, c: font_renderer.apply(p, c, mcfg)),
        "fp+bf16": (False, lambda p, c: font_renderer.apply(p, c, fast)),
        "int8": (True, lambda p, c: apply_quantized_int8(p, c, mcfg)),
        "int8+bf16": (True, lambda p, c: apply_quantized_int8(p, c, fast)),
    }


def main(argv: list[str] | None = None, mcfg: ModelConfig = ModelConfig(), batch: int = 1024, iters: int = 50,
         rounds: int = 3, params: dict | None = None, codes: torch.Tensor | None = None) -> dict:
    """``params``/``codes``: given weights and codes instead of those drawn
    from seeds 0 and 1."""
    _, dev, kernels = _common.start(sys.argv[1:] if argv is None else argv)
    base, _ = _common.with_kernels(kernels, mcfg, None)
    if params is None:
        params = font_renderer.init(torch.Generator(device=dev).manual_seed(0), base, dev)
    q8 = quantize_params(params)
    if codes is None:
        codes = torch.randint(65, 91, (batch, base.max_length), generator=torch.Generator(device=dev).manual_seed(1),
                              device=dev, dtype=torch.int32)
    batch = codes.shape[0]
    sheets, rows = {}, {}
    for tag, (int8, fn) in tiers(base).items():
        p, step = (q8 if int8 else params), make_chain(fn, base)
        sheets[tag] = step(p, codes)[0]
        dt = chain_time(step, p, codes, dev, iters, rounds)
        diff = (sheets[tag] - sheets["fp32"]).abs()
        rows[tag] = {"ms_per_batch": dt * 1e3, "glyphs_per_sec": batch * base.max_length / dt,
                     "max_abs_diff_vs_fp32": float(diff.max()), "mean_abs_diff_vs_fp32": float(diff.mean())}
        print(f"{tag:10s}: {dt*1e3:.3f} ms/batch = {batch * base.max_length / dt / 1e6:.1f}M glyphs/sec", flush=True)
    print(json.dumps({"kernels": kernels, "tiers": rows}), flush=True)
    return {"tiers": rows, "sheets": sheets}


if __name__ == "__main__":
    main()
