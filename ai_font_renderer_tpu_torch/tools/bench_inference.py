"""Inference throughput: the f32-frontend / bf16-GEMM forward against int8
serving (ops/quantized.py).

The port of tools/bench_inference.py. Chained timing (each call's output
perturbs the next call's codes; the window ends in a device sync), best of
3 windows of 50 calls at batch 1024: the default forward (``bf16``), the
int8 weights with bf16 activations (``int8w``) and int8 weights and
activations (``int8x8``, the int8 product). One JSON line a mode, with the
JAX tool's keys.

    python -m ai_font_renderer_tpu_torch.tools.bench_inference [--kernels K] [--device cpu]

``--kernels output`` runs the ``bf16`` mode's projection through K1.
"""

from __future__ import annotations

import json
import sys

import torch

from ..config import ModelConfig
from ..models import font_renderer
from ..ops.quantized import apply_quantized, apply_quantized_int8, quantize_params
from . import _common


def make_chain(apply_fn, mcfg):
    """step(params, codes) -> (out, next codes), the next codes perturbed by
    the output's first row."""

    @torch.no_grad()
    def f(p, c):
        out = apply_fn(p, c)
        delta = (out[:, :1, : mcfg.max_length] * 7).to(torch.int32).reshape(c.shape)
        return out, (c + delta) % 26 + 65

    return f


def chain_time(fn, params, codes, device, iters=50, rounds=3) -> float:
    """Seconds per chained call of ``fn``, best of ``rounds`` windows."""
    box = [codes]

    def run():
        box[0] = fn(params, box[0])[1]

    return _common.best_s(run, iters, rounds, device) / iters


def modes(mcfg: ModelConfig, params: dict) -> dict:
    """{mode: (chained step, its params)}: ``full`` and ``int8`` (int8
    weights and activations), the two modes both tools time."""
    served = quantize_params(params)
    return {
        "full": (make_chain(lambda p, c: font_renderer.apply(p, c, mcfg), mcfg), params),
        "int8w": (make_chain(lambda p, c: apply_quantized(p, c, mcfg), mcfg), served),
        "int8": (make_chain(lambda p, c: apply_quantized_int8(p, c, mcfg), mcfg), served),
    }


def main(argv: list[str] | None = None, mcfg: ModelConfig = ModelConfig(), batch: int = 1024, iters: int = 50,
         rounds: int = 3) -> list[dict]:
    rest, dev, kernels = _common.start(sys.argv[1:] if argv is None else argv)
    mcfg, _ = _common.with_kernels(kernels, mcfg, None)
    params = font_renderer.init(torch.Generator(device=dev).manual_seed(0), mcfg, dev)
    codes = torch.randint(65, 91, (batch, mcfg.max_length), generator=torch.Generator(device=dev).manual_seed(1),
                          device=dev, dtype=torch.int32)
    chains = modes(mcfg, params)
    rows = []
    for tag, mode in (("bf16", "full"), ("int8w", "int8w"), ("int8x8", "int8")):
        fn, p = chains[mode]
        dt = chain_time(fn, p, codes, dev, iters, rounds)
        rows.append({
            "metric": f"inference_{tag}_glyphs_per_sec",
            "value": batch * mcfg.max_length / dt,
            "unit": "glyphs/sec",
            f"ms_per_batch_{batch}": dt * 1e3,
        })
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
