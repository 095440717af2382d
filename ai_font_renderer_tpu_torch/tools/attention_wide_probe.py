"""Where the time of the general attention kernels (csrc/attention_wide.cu)
goes on the card: the device time of each of their launches (the GEMMs,
the row passes, the bias sums), from torch.profiler, at batch 1024.

    python -m ai_font_renderer_tpu_torch.tools.attention_wide_probe
    python -m ai_font_renderer_tpu_torch.tools.attention_wide_probe --shape 129 32 4

Prints one JSON line per (dtype, direction): the whole call's time from CUDA
events, and each kernel's device time per call and number of launches.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..device import resolve_device
from ..ops.fused_attention import attention_wide_bwd, attention_wide_fwd
from ..ops.philox import dropout_keep

RATE = 0.2


def _weights(e: int, g: torch.Generator) -> dict:
    w = {k: (torch.rand(e, e, generator=g, device="cuda") * 2 - 1) * 0.3 for k in ("wq", "wk", "wv", "wo")}
    w.update({k: torch.randn(e, generator=g, device="cuda") * 0.1 for k in ("bq", "bk", "bv", "bo")})
    return w


def _event_ms(fn, iters: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _kernel_ms(fn, iters: int = 5) -> dict:
    """{kernel name: [device ms per call, launches per call]} of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        if us > 0:
            out[ev.key[:60]] = [us / 1e3 / iters, ev.count / iters]
    return dict(sorted(out.items(), key=lambda kv: -kv[1][0]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", nargs=3, type=int, default=(100, 64, 4), metavar=("S", "E", "H"))
    ap.add_argument("--batch", type=int, default=1024)
    args = ap.parse_args()
    resolve_device("cuda")
    s, e, heads = args.shape
    g = torch.Generator(device="cuda").manual_seed(0)
    w = _weights(e, g)
    seed = torch.tensor([3], dtype=torch.int32, device="cuda")
    mask = dropout_keep(seed, (args.batch, heads, s, s), RATE).to(torch.uint8)
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn(args.batch, s, e, generator=g, device="cuda").to(dt)
        gy = torch.randn(args.batch, s, e, generator=g, device="cuda").to(dt)
        for name, fn in (("fwd", lambda: attention_wide_fwd(x, w, heads, RATE, seed, True)),
                         ("bwd", lambda: attention_wide_bwd(x, gy, w, heads, RATE, None, mask))):
            row = {"shape": f"B={args.batch},S={s},E={e},H={heads}", "dtype": str(dt), "call": name,
                   "ms": _event_ms(fn), "kernels": _kernel_ms(fn)}
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
