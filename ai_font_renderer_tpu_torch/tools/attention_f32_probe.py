"""Layout choices and per-phase times of the f32 attention kernels
(csrc/fused_attention.cu) on the card, at the model's S = 100, E = 32,
H = 4.

    python -m ai_font_renderer_tpu_torch.tools.attention_f32_probe            # every variant
    python -m ai_font_renderer_tpu_torch.tools.attention_f32_probe --phases   # per-phase cycles

Each variant is the source with a few lines replaced (VARIANTS), built with
nvcc beside the others into ai_font_renderer_tpu_torch/_build/probe/,
checked against the plain versions at B = 1024 (rate 0.2; v1 = v2, K6 = K8)
and timed with CUDA events, in the order listed and then in reverse, so
that every variant is timed twice. ``--phases`` builds the source with
clock64() marks at the kernels' barriers and prints, for the first 1024
blocks of a launch, the median cycles between marks.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..ops import _build
from ..ops.philox import dropout_keep, keep_threshold

# The module (``ops.fused_attention`` is also the name of its entry point).
fa = importlib.import_module("ai_font_renderer_tpu_torch.ops.fused_attention")
SRC = _build.SRC_DIR / "fused_attention.cu"
OUT = _build.BUILD_DIR / "probe"
S, E, H, RATE = 100, 32, 4, 0.2
FWD_BOUND = "FWD_THREADS, 5"
BWD_BOUND = "BWD_THREADS, 3"
CP_ASYNC = '    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(d), "l"(src + f));'
# name -> [(text of the source, its replacement)]
VARIANTS = {
    "final": [],
    "fwd_8_warps": [("FWD_WARPS = 4;", "FWD_WARPS = 8;"), (FWD_BOUND, "FWD_THREADS, 1")],
    "fwd_uncapped": [(FWD_BOUND, "FWD_THREADS, 1")],
    "fwd_rate0_uncapped": [(FWD_BOUND, "FWD_THREADS, MODE == MASK_NONE ? 1 : 5")],
    "bwd_2_blocks": [(BWD_BOUND, "BWD_THREADS, 2")],
    "bwd_4_blocks": [(BWD_BOUND, "BWD_THREADS, 4")],
    "sync_loads": [(CP_ASYNC, "    (void)d;\n    st4(dst + (f / E) * LX + f % E, ld4(src + f));")],
}
_MARK = (
    "#define MARK(k) if (threadIdx.x == 0 && blockIdx.x < 1024) g_phase[blockIdx.x][k] = clock64();\n"
    "__device__ long long g_phase[1024][12];\n")
# (text, the text with marks): MARK(k) at the kernels' barriers, k in the
# order of the phases; 9 at the end.
_PHASES = [
    ("  cg::cluster_group cluster = cg::this_cluster();\n",
     "  cg::cluster_group cluster = cg::this_cluster();\n  MARK(0)\n"),
    ("  cp_async_wait();\n  __syncthreads();\n", "  cp_async_wait();\n  __syncthreads();\n  MARK(1)\n"),
    ("  float kr[4][D], vr[4][D];\n", "  MARK(2)\n  float kr[4][D], vr[4][D];\n"),
    ("  // Row pass: one warp per query row, a lane per 4 keys.\n", "  MARK(2)\n"),
    ("  cluster.sync();  // every block's out_h is complete\n",
     "  MARK(3)\n  cluster.sync();  // every block's out_h is complete\n  MARK(4)\n"),
    ("  cluster.sync();  // no block leaves while another reads its shared memory\n",
     "  MARK(5)\n  cluster.sync();\n  MARK(9)\n"),
    ("  // dk and dv: each warp's partials", "  MARK(3)\n  // dk and dv: each warp's partials"),
    ("  // dx_h = [dq|dk|dv]", "  MARK(4)\n  // dx_h = [dq|dk|dv]"),
    ("  cluster.sync();  // every block's dx_h is complete\n", "  MARK(5)\n  cluster.sync();\n  MARK(6)\n"),
    ("  cluster_rows_sum(cluster, pdx, nullptr, a.dx + base, S, E, H, h, tid, BWD_THREADS);\n  cluster.sync();\n",
     "  cluster_rows_sum(cluster, pdx, nullptr, a.dx + base, S, E, H, h, tid, BWD_THREADS);\n  MARK(7)\n"
     "  cluster.sync();\n  MARK(9)\n"),
]


def _timed_source() -> str:
    src = SRC.read_text().replace('#include "philox.cuh"\n', '#include "philox.cuh"\n' + _MARK, 1)
    src = _patched(_PHASES, src)
    return src + ('\nextern "C" int afr_probe_phases(long long* p) {\n'
                  '  return (int)cudaMemcpyFromSymbol(p, g_phase, sizeof(g_phase));\n}\n')


def _build_variant(name: str, src: str) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    cu.write_text(src)
    cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", "-I", str(_build.SRC_DIR), "-o", str(so), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    regs = [line.split("Used ")[1] for line in proc.stderr.splitlines() if "Used" in line]
    print(f"[{name}] ptxas, every kernel: {json.dumps(sorted(set(regs)))}", flush=True)
    lib = ctypes.CDLL(str(so))
    for fn, (argtypes, restype) in fa._SIGNATURES.items():
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, restype
    return lib


def _patched(reps, src=None) -> str:
    src = SRC.read_text() if src is None else src
    for text, new in reps:
        if text not in src:
            raise RuntimeError(f"the source no longer has {text!r}")
        src = src.replace(text, new)
    return src


def _time_ms(fn, iters: int) -> float:
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


class _Bench:
    """Inputs from a seed at B = 15, 64 and 1024, and raw launches of a
    variant's forward and backward on them."""

    def __init__(self):
        g = torch.Generator(device="cuda").manual_seed(2)
        self.w = {k: (torch.rand(E, E, generator=g, device="cuda") * 2 - 1) * 0.3 for k in fa.KEYS[:4]}
        self.w.update({k: torch.randn(E, generator=g, device="cuda") * 0.1 for k in fa.KEYS[4:]})
        self.seed = torch.tensor([7], dtype=torch.int32, device="cuda")
        self.data = {}
        for b in (15, 64, 1024):
            x, gy = (torch.randn(b, S, E, generator=g, device="cuda") for _ in range(2))
            mask = dropout_keep(self.seed, (b, H, S, S), RATE).to(torch.uint8)
            self.data[b] = dict(x=x, g=gy, mask=mask, out=torch.empty_like(x), dx=torch.empty_like(x),
                                part=torch.empty(b, 4 * E * E + 4 * E, device="cuda"), m2=torch.empty_like(mask))

    def fwd(self, lib, b, mode):
        d, st = self.data[b], torch.cuda.current_stream().cuda_stream
        rc = lib.afr_fused_attention_fwd(
            d["x"].data_ptr(), *(self.w[k].data_ptr() for k in fa.KEYS), d["out"].data_ptr(),
            d["m2"].data_ptr() if mode == 2 else None, self.seed.data_ptr(), b, S, E, H, mode,
            keep_threshold(RATE), 1.0 - RATE, st)
        if rc:
            raise RuntimeError(f"forward launch: CUDA error {rc}")
        return d["out"]

    def bwd(self, lib, b, mode):
        d, st = self.data[b], torch.cuda.current_stream().cuda_stream
        rc = lib.afr_fused_attention_bwd(
            d["x"].data_ptr(), d["g"].data_ptr(), *(self.w[k].data_ptr() for k in fa.KEYS),
            d["mask"].data_ptr() if mode == 2 else None, self.seed.data_ptr(), d["dx"].data_ptr(),
            d["part"].data_ptr(), b, S, E, H, mode, keep_threshold(RATE), 1.0 - RATE, 1.0 - RATE, st)
        if rc:
            raise RuntimeError(f"backward launch: CUDA error {rc}")
        return d["dx"], d["part"]

    def check(self, name, lib):
        d = self.data[1024]
        out1 = self.fwd(lib, 1024, 1).clone()
        out2 = self.fwd(lib, 1024, 2).clone()
        want = fa.fused_attention_reference(d["x"], self.w, H, mask=d["mask"], rate=RATE)
        dx1, p1 = (t.clone() for t in self.bwd(lib, 1024, 1))
        dx2, p2 = self.bwd(lib, 1024, 2)
        wdx, wdw = fa.fused_attention_backward_reference(d["x"], d["g"], self.w, H, RATE, d["mask"])
        grads = fa._split_grads(p1.sum(0), E)
        wmax = max(float(v.abs().max()) for v in wdw.values())
        row = {"fwd_err": float((out1 - want).abs().max()), "v1_eq_v2": torch.equal(out1, out2),
               "mask_eq": torch.equal(d["m2"], d["mask"]),
               "dx_rel": float((dx1 - wdx).abs().max() / wdx.abs().max()),
               "dw_rel": max(float((grads[k] - wdw[k]).abs().max()) for k in wdw) / wmax,
               "k6_eq_k8": torch.equal(dx1, dx2) and torch.equal(p1, p2)}
        print(f"[{name}] check {json.dumps(row)}", flush=True)
        if not (row["fwd_err"] <= 1e-4 and row["dx_rel"] <= 1e-4 and row["dw_rel"] <= 1e-4
                and row["v1_eq_v2"] and row["mask_eq"] and row["k6_eq_k8"]):
            raise AssertionError(f"{name} disagrees with the plain versions")

    def times(self, lib) -> dict:
        t = {f"fwd rate 0 B={b}": _time_ms(lambda: self.fwd(lib, b, 0), 50) for b in (15, 64, 1024)}
        for mode, (f, k) in ((1, ("K5", "K6")), (2, ("K7", "K8"))):
            t[f"{f} rate {RATE} B=1024"] = _time_ms(lambda: self.fwd(lib, 1024, mode), 50)
            t[f"{k} rate {RATE} B=1024"] = _time_ms(lambda: self.bwd(lib, 1024, mode), 20)
        return t


def variants(names) -> None:
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(lambda n: _build_variant(n, _patched(VARIANTS[n])), names)))
    bench = _Bench()
    for name, lib in libs.items():
        bench.check(name, lib)
    runs = {name: [] for name in names}
    for order in (names, names[::-1]):
        for name in order:
            runs[name].append(bench.times(libs[name]))
    for name, (a, b) in runs.items():
        print(f"[{name}] ms, two runs: {json.dumps({k: [a[k], b[k]] for k in a})}", flush=True)


def phases() -> None:
    lib = _build_variant("phases", _timed_source())
    lib.afr_probe_phases.argtypes = [ctypes.c_void_p]
    bench = _Bench()
    cases = [("fwd rate 0 B=15", lambda: bench.fwd(lib, 15, 0), 15 * H),
             ("fwd rate 0 B=1024", lambda: bench.fwd(lib, 1024, 0), 1024),
             (f"K5 rate {RATE} B=1024", lambda: bench.fwd(lib, 1024, 1), 1024)]
    cases += [(f"{k} rate {r} B=1024", lambda m=m: bench.bwd(lib, 1024, m), 1024)
              for k, r, m in (("bwd", 0.0, 0), ("K6", RATE, 1), ("K8", RATE, 2))]
    for name, fn, blocks in cases:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        p = np.zeros((1024, 12), np.int64)
        if lib.afr_probe_phases(p.ctypes.data):
            raise RuntimeError("reading the marks failed")
        p = p[:blocks]
        marks = [k for k in range(12) if p[:, k].any()]
        cycles = {f"{a}->{b}": float(np.median(p[:, b] - p[:, a])) for a, b in zip(marks, marks[1:])}
        print(f"[phases] {name}: median cycles between marks {json.dumps(cycles)}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", action="store_true", help="per-phase cycles instead of the variants")
    ap.add_argument("--variants", default=",".join(VARIANTS), help="comma-separated names of VARIANTS")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attention_f32_probe: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    if args.phases:
        phases()
    else:
        variants(args.variants.split(","))
    return 0


if __name__ == "__main__":
    sys.exit(main())
