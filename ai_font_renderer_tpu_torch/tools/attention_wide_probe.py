"""Where the time of the general attention kernels (csrc/attention_wide.cu)
goes on the card, at batch 1024 and dropout 0.2 (mask stored, then read):
the build each call takes (the on-chip ``wide_fwd``/``wide_bwd``, one
launch a call, with its query rows a chunk, shared memory and blocks an
SM; or past the on-chip cutoff the streamed build's GEMMs, row passes and
bias sums), and the device time of each launch from torch.profiler.

    python -m ai_font_renderer_tpu_torch.tools.attention_wide_probe
    python -m ai_font_renderer_tpu_torch.tools.attention_wide_probe --shape 129 32 4 --shape 100 64 8
    python -m ai_font_renderer_tpu_torch.tools.attention_wide_probe --phases --shape 100 64 8

Prints one JSON line per (shape, dtype, direction): the whole call's time
from CUDA events, the plan, and each kernel's device time per call and
number of launches. ``--phases`` builds the source with clock64() marks
after the on-chip kernels' sample loads and block barriers (into
_build/probe/), runs each call once through it and prints, for the first
1024 blocks, the median cycles a block spends in each phase, summed over
heads and chunks.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import re
import subprocess

import numpy as np
import torch

from ..device import resolve_device
from ..ops import _build
from ..ops.fused_attention import attention_wide_attributes, attention_wide_bwd, attention_wide_fwd
from ..ops.philox import dropout_keep

# The module (``ops.fused_attention`` is also the name of an entry point).
fa = importlib.import_module("ai_font_renderer_tpu_torch.ops.fused_attention")

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


# The phases each kernel's marks close, in the order of its barriers.
PHASES = {
    "wide_fwd": ["load x", "stage the head's W columns", "q, k, v", "logits + keep bits", "row pass",
                 "P v", "stage Wo", "out"],
    "wide_bwd": ["load x, g", "stage the head's W", "q, k, v, dout", "logits, dP + keep bits", "row pass",
                 "attn, dq, dv, dk", "weight gradients + dx", "dbo"],
}
_MARK = ("#define MARK(k) if (threadIdx.x == 0 && blockIdx.x < 1024) { const long long now_ = clock64(); "
         "g_cycles[blockIdx.x][k] += now_ - t_last_; t_last_ = now_; }\n"
         "__device__ long long g_cycles[1024][16];\n")


def _marked_source() -> str:
    """attention_wide.cu with MARK(k) after each block barrier of the
    on-chip kernels (and after their sample loads), k numbering the phases
    of PHASES per kernel, and the readers of the marks' sums."""
    src = (_build.SRC_DIR / "attention_wide.cu").read_text()
    src = src.replace('#include "philox.cuh"\n', '#include "philox.cuh"\n' + _MARK, 1)
    for name, phases in PHASES.items():
        start = src.index(f" {name}(OnChipArgs a) {{")
        end = src.index("\n}\n", start)
        body = src[start:end]
        body = body.replace("unsigned char block_smem[];\n",
                            "unsigned char block_smem[];\n  long long t_last_ = clock64();\n", 1)
        body = re.sub(r"(  load_sample<T>\((?:xs|gs), G.ldE, a.(?:x|g), b, G\);\n)(?!  load_sample)",
                      r"\1  __syncthreads();\n", body, count=1)
        marks = iter(range(len(phases)))
        body = re.sub(r"__syncthreads\(\);", lambda m: f"__syncthreads(); MARK({next(marks)})", body)
        body += f"\n  MARK({next(marks)})"
        if next(marks, None) is not None:
            raise RuntimeError(f"{name} has fewer barriers than PHASES names")
        src = src[:start] + body + src[end:]
    return src + (
        '\nextern "C" int afr_probe_cycles(long long* p) {\n'
        "  return (int)cudaMemcpyFromSymbol(p, g_cycles, sizeof(g_cycles));\n}\n"
        '\nextern "C" int afr_probe_clear() {\n  static long long zero[1024][16];\n'
        "  return (int)cudaMemcpyToSymbol(g_cycles, zero, sizeof(zero));\n}\n")


def _build_marked() -> ctypes.CDLL:
    out = _build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / "attention_wide_phases.cu", out / "libattention_wide_phases.so"
    cu.write_text(_marked_source())
    cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", str(_build.SRC_DIR), "-o", str(so), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    for fn, (argtypes, restype) in fa._WIDE_SIGNATURES.items():
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, restype
    lib.afr_probe_cycles.argtypes = [ctypes.c_void_p]
    return lib


def phases(shapes, batch: int) -> None:
    """Per-phase cycles of the on-chip kernels: the marked library stands
    in for attention_wide while each call runs once after a warm one."""
    lib = _build_marked()
    _build._libs["attention_wide"] = lib
    g = torch.Generator(device="cuda").manual_seed(0)
    seed = torch.tensor([3], dtype=torch.int32, device="cuda")
    for s, e, heads in shapes:
        w = _weights(e, g)
        mask = dropout_keep(seed, (batch, heads, s, s), RATE).to(torch.uint8)
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(batch, s, e, generator=g, device="cuda").to(dt)
            gy = torch.randn(batch, s, e, generator=g, device="cuda").to(dt)
            for name, fn in (("wide_fwd", lambda: attention_wide_fwd(x, w, heads, RATE, seed, True)),
                             ("wide_bwd", lambda: attention_wide_bwd(x, gy, w, heads, RATE, None, mask))):
                fn()
                torch.cuda.synchronize()
                if lib.afr_probe_clear():
                    raise RuntimeError("clearing the marks failed")
                fn()
                torch.cuda.synchronize()
                cycles = np.zeros((1024, 16), np.int64)
                if lib.afr_probe_cycles(cycles.ctypes.data):
                    raise RuntimeError("reading the marks failed")
                cycles = cycles[:min(batch, 1024)]
                med = {p: float(np.median(cycles[:, k])) for k, p in enumerate(PHASES[name])}
                print(json.dumps({"shape": f"B={batch},S={s},E={e},H={heads}", "dtype": str(dt), "kernel": name,
                                  "cycles_a_block": sum(med.values()), "by_phase": med}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", nargs=3, type=int, action="append", metavar=("S", "E", "H"),
                    help="repeat for more shapes (default 100 64 4)")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--phases", action="store_true", help="per-phase cycles of the on-chip kernels instead")
    args = ap.parse_args()
    resolve_device("cuda")
    if args.phases:
        phases(args.shape or [(100, 64, 4)], args.batch)
        return 0
    g = torch.Generator(device="cuda").manual_seed(0)
    seed = torch.tensor([3], dtype=torch.int32, device="cuda")
    for s, e, heads in args.shape or [(100, 64, 4)]:
        w = _weights(e, g)
        mask = dropout_keep(seed, (args.batch, heads, s, s), RATE).to(torch.uint8)
        plans = attention_wide_attributes(s, e, heads)
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(args.batch, s, e, generator=g, device="cuda").to(dt)
            gy = torch.randn(args.batch, s, e, generator=g, device="cuda").to(dt)
            for name, fn in (("fwd", lambda: attention_wide_fwd(x, w, heads, RATE, seed, True)),
                             ("bwd", lambda: attention_wide_bwd(x, gy, w, heads, RATE, None, mask))):
                row = {"shape": f"B={args.batch},S={s},E={e},H={heads}", "dtype": str(dt), "call": name,
                       "plan": plans[f"{name}_{str(dt).replace('torch.', '')}"],
                       "ms": _event_ms(fn), "kernels": _kernel_ms(fn)}
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
