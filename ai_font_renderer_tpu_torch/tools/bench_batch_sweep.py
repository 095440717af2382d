"""Serving-throughput batch sweep: is batch 1024 the right headline shape?

The port of tools/bench_batch_sweep.py: the default forward (``full``) and
the int8 x int8 forward (``int8``) at batches 256 to 8192, with the chained
timing of tools/bench_inference.py (best of 3 windows of 30 calls). One JSON
line a (mode, batch): ms per batch and glyphs/s, or the error (running out
of device memory at a large batch is a result too).

    python -m ai_font_renderer_tpu_torch.tools.bench_batch_sweep [--kernels K] [--device cpu]
"""

from __future__ import annotations

import json
import sys

import torch

from ..config import ModelConfig
from ..models import font_renderer
from . import _common
from .bench_inference import chain_time, modes

BATCHES = (256, 512, 1024, 2048, 4096, 8192)


def main(argv: list[str] | None = None, mcfg: ModelConfig = ModelConfig(), batches=BATCHES, iters: int = 30,
         rounds: int = 3) -> list[dict]:
    rest, dev, kernels = _common.start(sys.argv[1:] if argv is None else argv)
    mcfg, _ = _common.with_kernels(kernels, mcfg, None)
    params = font_renderer.init(torch.Generator(device=dev).manual_seed(0), mcfg, dev)
    chains = modes(mcfg, params)
    rows = []
    for batch in batches:
        codes = torch.randint(65, 91, (batch, mcfg.max_length), generator=torch.Generator(device=dev).manual_seed(1),
                              device=dev, dtype=torch.int32)
        for mode in ("full", "int8"):
            fn, p = chains[mode]
            try:
                dt = chain_time(fn, p, codes, dev, iters, rounds)
            except torch.OutOfMemoryError as e:
                rows.append({"mode": mode, "batch": batch, "error": str(e)[:120]})
            else:
                rows.append({"mode": mode, "batch": batch, "ms_per_batch": dt * 1e3,
                             "glyphs_per_sec": batch * mcfg.max_length / dt})
            print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
