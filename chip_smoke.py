#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check what comes out.

    python3 chip_smoke.py
    python3 chip_smoke.py --step-memory   # only the peak memory of one training step
    python3 chip_smoke.py --serve-repeats N   # only phase 4's requests, on N servers

Phases, each of which raises on failure, each with its seconds:

1. The card's name and power limit (nvidia-smi); build every CUDA kernel of
   the port from csrc/ (one nvcc per source, all at once), with the build
   time, ptxas's registers and shared memory for each kernel, the K2
   and K3 GEMMs' launch shapes and dynamic shared memory, the bf16
   attention kernels' (csrc/attention_mma.cu) block size, dynamic shared
   memory and blocks per SM, and the f32 attention kernels'
   (csrc/fused_attention.cu: a cluster of H blocks a sample) registers,
   spills, shared memory, cluster size, blocks per SM and clusters in
   flight, for each source of the dropout mask; the general attention
   kernels (csrc/attention_wide.cu) build with them.
2. Each kernel against its plain PyTorch version on the card, at the shapes
   the main paths give it: max abs error against the stated tolerance,
   and times from CUDA events for the kernel, the plain version, one
   PyTorch library call computing the same function (a yardstick the port
   never calls), and the least time the card could take (bytes over
   3.35 TB/s or operations over the peak rate of their type). K1 and the
   attention forward at the serving shapes; K2, K3 and K4 at M = 200 and
   1024 rows of the 6400 x 19200 projection, with the kernels of K2 and
   K3 checked and timed alone: the bf16 operand pass bit for bit (the
   masked cotangent, W and x), K2's TMA + wgmma GEMM on K-major operands
   and K3's on MN-major ones (a persistent grid of 128 x 256 tiles); the
   attention forward with
   dropout 0.2 (K5 in f32 and bf16, K7 in bf16 and f32; in bf16 both are
   the tensor-core forward, K5's without storing the mask), K7's stored
   mask byte for byte against the plain Philox mask, and the backward
   kernels K6 and K8 at batch 1024 in f32 and bf16 (bf16: the tensor-core
   backward); the general attention kernels, which take the shapes the
   register-tiled ones do not, at E = 64 and at S = 129 (batch 1024,
   dropout 0.2, f32 and bf16, forward and backward, the stored mask byte
   for byte); K4 at M = 200 and 1024 with bf16 mu and at 1024 with f32
   mu, and K9 (K4 on a transposed x) at M = 1024, each on a W with a bf16
   shadow, which the update must rewrite bit for bit (the TMA + wgmma GEMM
   of K3 with the AdamW update as its epilogue; times with and without the
   shadow, against the dW product + torch._fused_adamw_), then the K4/K9
   A/B of tools/ab_kernel_micro.py, whose launches are K9's main path.
3. Render: full-width (123M-parameter) weights from a seed, saved and
   loaded through the port's npz format, the 15 test strings rendered to
   BMPs with both kernels on, the sheets checked against the plain path on
   the same weights, then a 4096-sheet atlas timed in glyphs/s.
4. Serve: a RenderServer on a unix socket (batch 64, v2 attention, bf16
   frontend) answers 3 requests of different lengths, one longer than a
   batch; the replies must equal a direct render of the same strings.
   Beside the latencies it prints what could stall all three: garbage
   collector pauses, new allocator segments, the dispatcher's render calls.
5. Train at full width (default ModelConfig, batch 1024, weights from a
   seed): the FiraCode corpus of 20480 samples (16 steps per epoch; only
   the corpus is cut) from the port's fontgen, its first 4096 u8 sheets
   checked against the numpy oracle; three epochs with use_pallas_output
   (K1/K2/K3) and three with use_pallas_output + fused_dw_adamw (K1, K2,
   K4); then attention training through the attention kernels at dropout
   0.2: three epochs of `attn_v1` (K1, K2, K4 and K5/K6, f32 frontend) and
   three of `attn_v2_fast` (the fast profile: bf16 frontend, bits dropout,
   hand-rolled step with remat "dots", and K7/K8); the train loss must fall
   and the val loss be finite, and W's bf16 shadow be built once a run
   where K4 writes it (`fused`, `attn_v1`), once a step plus one in
   `output`. Then one step with kernels against the
   plain step on the same weights and batch (dropout off) for each
   configuration, the trained weights through the npz file and rendered
   against the plain path, steps/s of each configuration, and a profile of
   one step.
6. Data and weights, through the CLI in this process: `fontgen` for 2048
   FiraCode samples (data.txt the corpus; the BMPs read back onto the card
   by `device_dataset_from_disk` bit-equal to `build_device_dataset`) and
   256 Montserrat ones (the BMPs equal to `synthesize_prop_host`);
   Montserrat training at full width with `fused` (K1, K2, K4), the corpus
   cut to 8192 samples, 2 epochs, its first 1024 sheets bit-equal to the
   oracle, the loss falling, W's shadow built once, steps/s beside phase
   5's FiraCode `fused`; `eval` of phase 5's `fused` weights on its corpus
   (4096 val sheets) with `--kernels none` and `output` (val MSE within
   1e-4 relative, K1 only in the second); `render --truth` for both fonts,
   hinted and not; the weights through a `.pth`, rendered with phase 3's
   flags (K1, f32 K5) bit-equal to the npz's render; then a full-width
   model at E = 64 and at S = 129 with each fused attention flag: two
   steps at dropout 0.2 and one without against the plain step, through
   the general attention kernels.
7. One JSON line listing every kernel (K1-K9, the operand pass, the
   GEMMs of K2 and K3, the bf16 attention forward and backward on
   tensor cores, and the general attention forward and backward) with its
   launches on the
   main paths (phases 3, 4, 5 and 6 and the K4/K9 A/B; counts are set to 0
   just before each drive and read just after), its error and its times.

The last line of output is {"ok": true, "device": {...}}. Without a CUDA
device, or without the package beside this script, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet, dense): the bounds below are
# stated against these, beside the card's own power limit.
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_CUDA_CORE_FLOPS = 67e12

K1_TOL = 1e-4  # f32 sums over K = 6400 of exact bf16 products, in another order
# K2/K3/K4: f32 sums of exact bf16 products over N = 19200 (K2) or M rows
# (K3, K4) in another order, relative to the largest value of the result.
GRAD_REL_TOL = 1e-4
K4_W_TOL = 1e-6  # w after one update: far below the 1e-3 learning rate
K4_MU_REL_TOL = 2.0**-7  # a bf16 mu may round to the other neighbour: one bf16 step
STEP_LOSS_REL_TOL = 1e-4  # one training step, kernels vs the plain path
# mu/(1-b1) after one step from zero moments is dW: bf16 storage (2^-8) and
# the cotangent's mask where outputs sit within an ulp of a bound.
STEP_DW_REL_TOL = 1e-2
ATTN_TOL = {torch.float32: 1e-4, torch.bfloat16: 0.05}  # bf16: one rounding of O(1) values
DROPOUT = 0.2  # the model's attention dropout rate
# K6/K8 against the plain backward, relative to the largest value (dx: its
# own; the weights: the largest of the eight, since dbk is 0 in exact
# arithmetic). f32: sums in another order. bf16: dlogits, dq, dk, dv and attn
# are rounded to bf16, and an f32 value that differs in its last bits may
# round to the other bf16 neighbour (2^-8 relative).
ATTN_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# One step through the attention kernels against the plain step, dropout
# off, f32 moments: the attention weights' mu/(1-b1) (their gradient)
# relative to the largest of the eight. f32 frontend: sums in another order,
# through K1/K2's bf16 products and the clamp mask. bf16 frontend: the
# kernels round q/k/v once after f32 sums and the bias, the plain attention
# after the bf16 product and again after the bias, so the step loss moves
# by bf16 roundings too.
STEP_ATTN_GRAD_TOL = {"f32": 1e-3, "bf16": 5e-2}
STEP_LOSS_BF16_TOL = 1e-2
SHEET_TOL = 1e-4  # rendered sheets, kernels on vs the plain path (f32 frontend)
# eval's val MSE with K1 (bf16 products) against the plain projection (bf16
# products too): the same products in another order of sums.
EVAL_REL_TOL = 1e-4
# About 0.15 s at the H100's clock: longer than the host takes to queue one
# timing loop, so the timed calls run back to back on the device.
SPIN_CYCLES = 300_000_000


def _nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` per call over ``iters`` calls, from CUDA
    events after ``warmup`` calls. A spin kernel first holds the stream
    while the host queues every call, so the events time the device's work
    alone and not the pace of the host's Python."""
    for _ in range(warmup):
        fn()
    while True:
        torch.cuda.synchronize()
        spin = torch.cuda.Event(enable_timing=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        spin.record()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        queued_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        if queued_ms < spin.elapsed_time(start):
            return start.elapsed_time(end) / iters
        # The host waited for the spin: a stream holds about a thousand
        # pending launches, and a plain version of many small ops fills
        # that queue. Queue fewer calls.
        if iters <= 4:
            raise RuntimeError(f"the host needs {queued_ms:.0f} ms to queue {iters} calls")
        iters //= 2


def _bound(bytes_moved: float, ops: float, peak_ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _attn_peak(dt) -> float:
    """Peak rate for the attention kernels' products. In bf16 every operand
    of every product is rounded to bf16 first (f32 sums), so tensor cores
    would give the same results: the bf16 tensor rate. In f32 the CUDA
    cores' rate."""
    return BF16_TENSOR_FLOPS if dt == torch.bfloat16 else F32_CUDA_CORE_FLOPS


def phase_build() -> float:
    from ai_font_renderer_tpu_torch.ops import _build, attention_mma_attributes, fused_attention_attributes
    from ai_font_renderer_tpu_torch.ops.fused_dw_adamw import dw_adamw_attributes
    from ai_font_renderer_tpu_torch.ops.fused_output import gemm_attributes

    t0 = time.perf_counter()
    reports = _build.build()
    seconds = time.perf_counter() - t0
    # ptxas -v: each entry function (mangled) and its registers, shared
    # memory, stack and spills.
    for name, log in reports.items():
        for line in log.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                print(f"[build] {name}.cu {line.strip()}", flush=True)
    # The GEMMs' shared memory is dynamic, which ptxas does not report.
    for kind, name in (("k1", "K1"), ("tn", "K2"), ("mn", "K3")):
        print(f"[build] {name} GEMM as loaded: {json.dumps(gemm_attributes(kind))}", flush=True)
    print(f"[build] K4 GEMM + AdamW (bf16 mu, W's shadow written) as loaded: "
          f"{json.dumps(dw_adamw_attributes())}", flush=True)
    print(f"[build] bf16 attention (K5-K8 in bf16, tensor cores) at S=100, E=32, H=4: "
          f"{json.dumps(attention_mma_attributes())}", flush=True)
    print(f"[build] f32 attention (K5-K8 in f32, CUDA cores, a cluster of H blocks a sample) at "
          f"S=100, E=32, H=4: {json.dumps(fused_attention_attributes())}", flush=True)
    print(f"[build] kernels built in {seconds:.2f} s", flush=True)
    return seconds


def check_fused_output(ms_list=(15, 64, 1024), k=6400, n=19200) -> tuple[list[dict], ...]:
    """K1 vs its plain version at the serving path's row counts, and its
    kernels alone: W's bf16 shadow (the operand pass on W, what a rebuild
    costs) and the x pass bit for bit against their plain version, and the
    GEMM with bias and clamp against its plain version.
    Returns K1's rows, its GEMM's rows and the operand-pass rows."""
    from ai_font_renderer_tpu_torch.ops.fused_output import (
        bf16_shadow,
        fused_output,
        fused_output_reference,
        gemm_bf16_bias_clamp,
        gemm_bf16_bias_clamp_reference,
        padded_width,
        round_bf16,
        round_bf16_reference,
    )

    g = torch.Generator(device="cuda").manual_seed(1)
    bound = 1.0 / k**0.5
    w = (torch.rand(k, n, generator=g, device="cuda") * 2 - 1) * bound
    b = (torch.rand(n, generator=g, device="cuda") * 2 - 1) * bound
    kpad, npad = padded_width(k), padded_width(n)
    rows, gemm_rows, round_rows = [], [], []

    w16 = bf16_shadow(w)
    passes = [(f"w K={k},N={n}", w, w16)]
    for m in ms_list:
        x = torch.relu(torch.randn(m, k, generator=g, device="cuda"))
        if m < 1024:  # x's pass at M = 1024 is K3's row
            passes.append((f"x M={m},K={k}", x, round_bf16(x)))
        got = fused_output(x, w, b)
        want = fused_output_reference(x, w, b)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not err <= K1_TOL:
            raise AssertionError(f"fused_output M={m}: max abs err {err} > {K1_TOL}")
        del got, want
        x16 = round_bf16(x)
        lib_x16, lib_w16 = x.to(torch.bfloat16), w.to(torch.bfloat16)
        iters = 20 if m < 256 else 10
        ops = 2 * m * k * n
        ggot = gemm_bf16_bias_clamp(x16, w16, b, n)
        gwant = gemm_bf16_bias_clamp_reference(x16, w16, b, n)
        torch.cuda.synchronize()
        gerr = float((ggot - gwant).abs().max())
        if not gerr <= K1_TOL:
            raise AssertionError(f"K1 GEMM M={m}: max abs err {gerr} > {K1_TOL}")
        del ggot
        gemm_ms = time_ms(lambda: gemm_bf16_bias_clamp(x16, w16, b, n), iters)
        gbound_ms, gbound_by = _bound(2 * m * kpad + 2 * k * npad + 4 * n + 4 * m * n, ops,
                                      BF16_TENSOR_FLOPS)
        grow = {
            "shape": f"M={m},K={k},N={n}",
            "max_abs_err": gerr,
            "tol": K1_TOL,
            "ms": gemm_ms,
            "plain_ms": time_ms(lambda: gemm_bf16_bias_clamp_reference(x16, w16, b, n), max(3, iters // 4)),
            # cuBLAS on the same bf16 operands, bias in its epilogue, f32
            # out, then the clamp: the same function.
            "library_ms": time_ms(
                lambda: torch.addmm(b, x16, w16, out_dtype=torch.float32).clamp_(0.0, 1.0), iters
            ),
            "bound_ms": gbound_ms,
            "bound_by": gbound_by,
            "tflops": ops / gemm_ms / 1e9,
        }
        print(f"[K1 gemm_bf16_bias_clamp] {json.dumps(grow)}", flush=True)
        gemm_rows.append(grow)
        del gwant

        # With the shadow held, as on the main path, K1 reads x, W's bf16
        # copy and b and writes out.
        bound_ms, bound_by = _bound(4 * (m * k + n + m * n) + 2 * k * npad, ops, BF16_TENSOR_FLOPS)
        row = {
            "shape": f"M={m},K={k},N={n}",
            "max_abs_err": err,
            "tol": K1_TOL,
            "ms": time_ms(lambda: fused_output(x, w, b), iters),
            "prep_ms": time_ms(lambda: round_bf16(x), iters),
            "gemm_ms": gemm_ms,
            "gemm_tflops": grow["tflops"],
            "plain_ms": time_ms(lambda: fused_output_reference(x, w, b), max(3, iters // 4)),
            # cuBLAS bf16 GEMM with the bias in its epilogue and f32 out,
            # x and W cast to bf16 once outside the timed region, then the
            # clamp.
            "library_ms": time_ms(
                lambda: torch.addmm(b, lib_x16, lib_w16, out_dtype=torch.float32).clamp_(0.0, 1.0), iters
            ),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            # The bound of a call on a changed W, which must read W in f32
            # (the shadow's rebuild, row "w" of the operand pass).
            "f32_w_bound_ms": _bound(4 * (m * k + k * n + n + m * n), ops, BF16_TENSOR_FLOPS)[0],
        }
        print(f"[K1 fused_output] {json.dumps(row)}", flush=True)
        rows.append(row)
        del x16, lib_x16, lib_w16

    for shape, src, got in passes:
        want = round_bf16_reference(src)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
            raise AssertionError(f"K1 operand pass {shape}: differs from its plain version")
        r, c = src.shape
        bound_ms, bound_by = _bound(4 * r * c + 2 * r * padded_width(c), 0, BF16_TENSOR_FLOPS)
        row = {
            "shape": shape,
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "tol": "bit for bit",
            "ms": time_ms(lambda: round_bf16(src), 10),
            "plain_ms": time_ms(lambda: round_bf16_reference(src), 5),
            # N and K are multiples of 8: no pad, the pass is one cast.
            "library_ms": time_ms(lambda: src.to(torch.bfloat16), 10),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
        }
        if src is w:
            # A rebuild through the shadow's cache: W's version moved.
            row["shadow_build_ms"] = time_ms(
                lambda: (torch.autograd.graph.increment_version(w), bf16_shadow(w)), 10)
        print(f"[K1 round_bf16] {json.dumps(row)}", flush=True)
        round_rows.append(row)
        del want
    return rows, gemm_rows, round_rows


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _k2_parts(cot, out, w, m, k, n, round_rows, gemm_rows) -> dict:
    """K2's kernels on K2's inputs: the masked operand pass bit for bit
    against its plain version (W's operand is its bf16 shadow, K1's row),
    the GEMM on those operands against its plain version; their rows for
    the kernels line, and K2's own extra fields: prep_ms (the masked pass:
    the shadow is built once while W is unchanged), gemm_ms, gemm_tflops,
    and library_with_casts_ms (the mask, the two casts and torch.mm: the
    same two-pass work in PyTorch)."""
    from ai_font_renderer_tpu_torch.ops.fused_output import (
        bf16_shadow,
        clamp_mask,
        gemm_bf16_tn,
        gemm_bf16_tn_reference,
        padded_width,
        round_bf16,
        round_bf16_reference,
    )

    npad = padded_width(n)
    gm16, w16 = round_bf16(cot, out), bf16_shadow(w)
    want = round_bf16_reference(cot, out)
    torch.cuda.synchronize()
    if not torch.equal(gm16.view(torch.int16), want.view(torch.int16)):
        raise AssertionError(f"K2 operand pass gm M={m},N={n}: differs from its plain version")
    bound_ms, bound_by = _bound(8 * m * n + 2 * m * npad, 0, BF16_TENSOR_FLOPS)
    row = {
        "shape": f"gm M={m},N={n}",
        "max_abs_err": float((gm16.float() - want.float()).abs().max()),
        "tol": "bit for bit",
        "ms": time_ms(lambda: round_bf16(cot, out), 10),
        "plain_ms": time_ms(lambda: round_bf16_reference(cot, out), 5),
        # The same masked bf16 operand in PyTorch, unpadded: the mask, the
        # product and the cast.
        "library_ms": time_ms(lambda: (cot * ((out > 0) & (out < 1))).to(torch.bfloat16), 10),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
    }
    print(f"[K2 round_bf16] {json.dumps(row)}", flush=True)
    round_rows.append(row)
    del want

    got, want = gemm_bf16_tn(gm16, w16), gemm_bf16_tn_reference(gm16, w16)
    torch.cuda.synchronize()
    rel = _rel(got, want)
    if not rel <= GRAD_REL_TOL:
        raise AssertionError(f"K2 GEMM M={m}: max err {rel} of the largest value > {GRAD_REL_TOL}")
    gemm_ms = time_ms(lambda: gemm_bf16_tn(gm16, w16), 20)
    bound_ms, bound_by = _bound(2 * (m + k) * npad + 4 * m * k, 2 * m * k * npad, BF16_TENSOR_FLOPS)
    row = {
        "shape": f"M={m},K={k},N={n}",
        "max_abs_err": float((got - want).abs().max()),
        "rel_err": rel,
        "tol": f"{GRAD_REL_TOL} of max |plain|",
        "ms": gemm_ms,
        "plain_ms": time_ms(lambda: gemm_bf16_tn_reference(gm16, w16), 3),
        # cuBLAS on the same bf16 operands, f32 out: the same function.
        "library_ms": time_ms(lambda: torch.mm(gm16, w16.t(), out_dtype=torch.float32), 20),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "tflops": 2 * m * k * n / gemm_ms / 1e9,
    }
    print(f"[K2 gemm_bf16_tn] {json.dumps(row)}", flush=True)
    gemm_rows.append(row)
    del got, want
    return {
        "prep_ms": time_ms(lambda: round_bf16(cot, out), 10),
        "gemm_ms": gemm_ms,
        "gemm_tflops": row["tflops"],
        "library_with_casts_ms": time_ms(lambda: torch.mm(
            torch.where(clamp_mask(out), cot, 0.0).to(torch.bfloat16), w.to(torch.bfloat16).t(),
            out_dtype=torch.float32), 10),
    }


def _k3_parts(x, cot, out, m, k, n, round_rows, mn_rows) -> dict:
    """K3's kernels on K3's inputs: x's operand pass bit for bit against its
    plain version (the masked pass is K2's, checked there), the MN-major
    GEMM on x16 and gm16 against its plain version; their rows for the
    kernels line, and K3's own extra fields: prep_ms (both passes), gemm_ms,
    gemm_tflops, and library_with_casts_ms (the mask, the two casts and
    torch.mm: the same two-pass work in PyTorch)."""
    from ai_font_renderer_tpu_torch.ops.fused_output import (
        clamp_mask,
        gemm_bf16_mn,
        gemm_bf16_mn_reference,
        padded_width,
        round_bf16,
        round_bf16_reference,
    )

    kpad, npad = padded_width(k), padded_width(n)
    x16, gm16 = round_bf16(x), round_bf16(cot, out)
    want = round_bf16_reference(x)
    torch.cuda.synchronize()
    if not torch.equal(x16.view(torch.int16), want.view(torch.int16)):
        raise AssertionError(f"K3 operand pass x M={m},K={k}: differs from its plain version")
    bound_ms, bound_by = _bound(4 * m * k + 2 * m * kpad, 0, BF16_TENSOR_FLOPS)
    row = {
        "shape": f"x M={m},K={k}",
        "max_abs_err": float((x16.float() - want.float()).abs().max()),
        "tol": "bit for bit",
        "ms": time_ms(lambda: round_bf16(x), 10),
        "plain_ms": time_ms(lambda: round_bf16_reference(x), 5),
        # K is a multiple of 8: no pad, the pass is one cast.
        "library_ms": time_ms(lambda: x.to(torch.bfloat16), 10),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
    }
    print(f"[K3 round_bf16] {json.dumps(row)}", flush=True)
    round_rows.append(row)
    del want

    got, want = gemm_bf16_mn(x16, gm16, k, n), gemm_bf16_mn_reference(x16, gm16, k, n)
    torch.cuda.synchronize()
    rel = _rel(got, want)
    if not rel <= GRAD_REL_TOL:
        raise AssertionError(f"K3 GEMM M={m}: max err {rel} of the largest value > {GRAD_REL_TOL}")
    gemm_ms = time_ms(lambda: gemm_bf16_mn(x16, gm16, k, n), 20)
    bound_ms, bound_by = _bound(2 * m * (kpad + npad) + 4 * k * n, 2 * m * k * n, BF16_TENSOR_FLOPS)
    row = {
        "shape": f"M={m},K={k},N={n}",
        "max_abs_err": float((got - want).abs().max()),
        "rel_err": rel,
        "tol": f"{GRAD_REL_TOL} of max |plain|",
        "ms": gemm_ms,
        "plain_ms": time_ms(lambda: gemm_bf16_mn_reference(x16, gm16, k, n), 3),
        # cuBLAS on the same bf16 operands, f32 out: the same function.
        "library_ms": time_ms(lambda: torch.mm(x16.t(), gm16, out_dtype=torch.float32), 20),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "tflops": 2 * m * k * n / gemm_ms / 1e9,
    }
    print(f"[K3 gemm_bf16_mn] {json.dumps(row)}", flush=True)
    mn_rows.append(row)
    del got, want
    return {
        "prep_ms": time_ms(lambda: (round_bf16(x), round_bf16(cot, out)), 10),
        "gemm_ms": gemm_ms,
        "gemm_tflops": row["tflops"],
        "library_with_casts_ms": time_ms(lambda: torch.mm(
            x.to(torch.bfloat16).t(), torch.where(clamp_mask(out), cot, 0.0).to(torch.bfloat16),
            out_dtype=torch.float32), 10),
    }


def check_backward(round_rows: list, ms_list=(200, 1024), k=6400, n=19200) -> tuple[list[dict], ...]:
    """K2 (dX) and K3 (dW) vs their plain versions at the training path's
    row counts (the batch of 1024, and a ragged 200), and the kernels of
    each (operand pass, GEMM) alone on its inputs; the operand-pass rows
    go on ``round_rows``."""
    from ai_font_renderer_tpu_torch.ops.fused_output import (
        fused_output_dw,
        fused_output_dw_reference,
        fused_output_dx,
        fused_output_dx_reference,
        fused_output_reference,
    )

    g = torch.Generator(device="cuda").manual_seed(3)
    bound = 1.0 / k**0.5
    w = (torch.rand(k, n, generator=g, device="cuda") * 2 - 1) * bound
    b = (torch.rand(n, generator=g, device="cuda") * 2 - 1) * bound
    w16 = w.to(torch.bfloat16)
    dx_rows, dw_rows, gemm_rows, mn_rows = [], [], [], []
    for m in ms_list:
        x = torch.relu(torch.randn(m, k, generator=g, device="cuda"))
        out = fused_output_reference(x, w, b)
        cot = torch.randn(m, n, generator=g, device="cuda") * (2.0 / (m * n))
        gm16 = torch.where((out > 0) & (out < 1), cot, 0.0).to(torch.bfloat16)
        x16 = x.to(torch.bfloat16)
        bound_ms, bound_by = _bound(4 * (2 * m * n + k * n + m * k), 2 * m * k * n, BF16_TENSOR_FLOPS)
        for name, fn, ref, args, lib, rows in (
            ("K2 fused_output_dx", fused_output_dx, fused_output_dx_reference, (cot, out, w),
             lambda: torch.mm(gm16, w16.t(), out_dtype=torch.float32), dx_rows),
            ("K3 fused_output_dw", fused_output_dw, fused_output_dw_reference, (x, cot, out),
             lambda: torch.mm(x16.t(), gm16, out_dtype=torch.float32), dw_rows),
        ):
            got, want = fn(*args), ref(*args)
            torch.cuda.synchronize()
            rel = _rel(got, want)
            if not rel <= GRAD_REL_TOL:
                raise AssertionError(f"{name} M={m}: max err {rel} of the largest value > {GRAD_REL_TOL}")
            row = {
                "shape": f"M={m},K={k},N={n}",
                "max_abs_err": float((got - want).abs().max()),
                "rel_err": rel,
                "tol": f"{GRAD_REL_TOL} of max |plain|",
                "ms": time_ms(lambda: fn(*args), 10),
                "plain_ms": time_ms(lambda: ref(*args), 3),
                # cuBLAS on operands masked and cast to bf16 outside the
                # timed region: the product alone, f32 out.
                "library_ms": time_ms(lib, 10),
                "bound_ms": bound_ms,
                "bound_by": bound_by,
            }
            del got, want
            if rows is dx_rows:
                row.update(_k2_parts(cot, out, w, m, k, n, round_rows, gemm_rows))
            else:
                row.update(_k3_parts(x, cot, out, m, k, n, round_rows, mn_rows))
            print(f"[{name}] {json.dumps(row)}", flush=True)
            rows.append(row)
    return dx_rows, dw_rows, gemm_rows, mn_rows


def _k4_bounds(m, k, n, mu_bytes) -> dict:
    """K4's (and K9's) bound without and with W's shadow: x16 and gm16 read
    once; w and nu read and written in f32, mu in its own type; the shadow
    written in bf16; 2*M*K*N operations on the bf16 tensor cores."""
    state = k * n * (8 + 2 * mu_bytes + 8)
    bound_ms, bound_by = _bound(2 * m * k + 2 * m * n + state, 2 * m * k * n, BF16_TENSOR_FLOPS)
    shadow_ms, shadow_by = _bound(2 * m * k + 2 * m * n + state + 2 * k * n, 2 * m * k * n, BF16_TENSOR_FLOPS)
    return {"bound_ms": bound_ms, "bound_by": bound_by, "bound_shadow_ms": shadow_ms,
            "bound_shadow_by": shadow_by, "state_bytes": state}


def _check_k4_update(name, run, run_ref, w, mu, nu) -> float:
    """One update of (w, mu, nu) by ``run`` on a W with a current bf16
    shadow against ``run_ref`` on clones, with K4's tolerances; the shadow
    the kernel wrote must be W's new shadow (no rebuild) and equal the
    operand pass on the new W bit for bit. Returns w's max abs error."""
    from ai_font_renderer_tpu_torch.ops import bf16_shadow, round_bf16, round_bf16_reference

    ref = [t.clone() for t in (w, mu, nu)]
    bf16_shadow(w)
    run(w, mu, nu)
    run_ref(*ref)
    torch.cuda.synchronize()
    w_err = float((w - ref[0]).abs().max())
    mu_err = float(((mu.float() - ref[1].float()).abs() - K4_MU_REL_TOL * ref[1].float().abs()).max())
    nu_rel = _rel(nu, ref[2])
    if not (w_err <= K4_W_TOL and mu_err <= 1e-5 * float(ref[1].float().abs().max()) and nu_rel <= GRAD_REL_TOL):
        raise AssertionError(f"{name}: w err {w_err}, mu excess {mu_err}, nu rel {nu_rel}")
    builds = bf16_shadow.builds
    w16 = bf16_shadow(w)
    if bf16_shadow.builds != builds:
        raise AssertionError(f"{name}: W's shadow was rebuilt after the update that should write it")
    if not (torch.equal(w16, round_bf16(w)) and torch.equal(w16, round_bf16_reference(w))):
        raise AssertionError(f"{name}: the shadow the update wrote differs from round_bf16(w)")
    return w_err


def _time_k4(row, run, run_ref, library, w, mu, nu) -> None:
    """Times of ``run`` without W's shadow (a clone of W, which has none)
    and with it (W, whose shadow the checked update wrote), of the plain
    version and of the library calls, and the state's rate; into ``row``."""
    lib_w, lib_m, lib_v = w.clone(), mu.float(), nu.clone()
    w_plain = w.clone()
    row["ms"] = time_ms(lambda: run(w_plain, mu, nu), 10)
    row["shadow_ms"] = time_ms(lambda: run(w, mu, nu), 10)
    del w_plain
    state = (w.clone(), mu.clone(), nu.clone())
    row["plain_ms"] = time_ms(lambda: run_ref(*state), 3)
    del state
    # The dW product in cuBLAS (bf16 in, f32 out) and torch._fused_adamw_
    # with f32 moments (decoupled weight decay); then also W's bf16 copy.
    row["library_ms"] = time_ms(lambda: library(lib_w, lib_m, lib_v), 10)
    row["library_shadow_ms"] = time_ms(lambda: (library(lib_w, lib_m, lib_v), lib_w.to(torch.bfloat16)), 10)
    row["state_gb_per_s"] = row["state_bytes"] / (row["ms"] * 1e-3) / 1e9


def check_dw_adamw(ms_list=(200, 1024), k=6400, n=19200) -> list[dict]:
    """K4 vs its plain version at step 5, moments seeded non-zero (at t = 1
    Adam's update is lr*sign(dW), which flips on rounding noise); bf16 mu as
    the trainer keeps it at each row count, then f32 mu at the largest. W
    has a bf16 shadow, which the update must rewrite bit for bit."""
    from ai_font_renderer_tpu_torch.ops.fused_dw_adamw import fused_dw_adamw, fused_dw_adamw_reference

    g = torch.Generator(device="cuda").manual_seed(4)
    hyper = (1e-3, 5e-4, 0.9, 0.99)
    rows = []
    for m, mu_dtype in [*((m, torch.bfloat16) for m in ms_list), (ms_list[-1], torch.float32)]:
        x16 = torch.relu(torch.randn(m, k, generator=g, device="cuda")).to(torch.bfloat16)
        gm16 = (torch.randn(m, n, generator=g, device="cuda") * (2.0 / (m * n))).to(torch.bfloat16)
        w = (torch.rand(k, n, generator=g, device="cuda") * 2 - 1) / k**0.5
        mu = (torch.randn(k, n, generator=g, device="cuda") * 1e-7).to(mu_dtype)
        nu = torch.rand(k, n, generator=g, device="cuda") * 1e-14 + 1e-16
        step_t = torch.tensor(5.0, device="cuda")
        mu_name = "bf16" if mu_dtype == torch.bfloat16 else "f32"

        def run(w_, mu_, nu_):
            fused_dw_adamw(x16, gm16, w_, mu_, nu_, *hyper, 5)

        def run_ref(w_, mu_, nu_):
            fused_dw_adamw_reference(x16, gm16, w_, mu_, nu_, *hyper, 5)

        def library(w_, m_, v_):
            dw = torch.mm(x16.t(), gm16, out_dtype=torch.float32)
            torch._fused_adamw_([w_], [dw], [m_], [v_], [], [step_t], lr=hyper[0], beta1=hyper[2],
                                beta2=hyper[3], weight_decay=hyper[1], eps=1e-8, amsgrad=False, maximize=False)

        w_err = _check_k4_update(f"K4 M={m} mu={mu_name}", run, run_ref, w, mu, nu)
        row = {
            "shape": f"M={m},K={k},N={n},mu={mu_name}",
            "max_abs_err": w_err,
            "tol": f"w {K4_W_TOL}; mu one bf16 step; nu {GRAD_REL_TOL} of max; shadow bit for bit",
            **_k4_bounds(m, k, n, mu.element_size()),
        }
        _time_k4(row, run, run_ref, library, w, mu, nu)
        print(f"[K4 fused_dw_adamw] {json.dumps(row)}", flush=True)
        rows.append(row)
        del w, mu, nu
    return rows


def _attn_weights(g, e=32):
    xavier = (6.0 / (e + e)) ** 0.5

    def u(shape, bound):
        return (torch.rand(shape, generator=g, device="cuda") * 2 - 1) * bound

    w = {k: u((e, e), xavier) for k in ("wq", "wk", "wv")}
    w["wo"] = u((e, e), 1.0 / e**0.5)
    w.update({k: u((e,), 0.1) for k in ("bq", "bk", "bv", "bo")})
    return w


def _attn_library(e, heads, w, dt):
    """PyTorch's multi-head attention (SDPA inside) on weights cast to
    ``dt`` outside the timed region, packed as it takes them."""
    in_w = torch.cat([w["wq"].T, w["wk"].T, w["wv"].T]).contiguous().to(dt)
    in_b = torch.cat([w["bq"], w["bk"], w["bv"]]).to(dt)
    wo, bo = w["wo"].T.contiguous().to(dt), w["bo"].to(dt)

    def mha(xt, rate, training, params=(in_w, in_b, wo, bo)):
        return torch.nn.functional.multi_head_attention_forward(
            xt, xt, xt, e, heads, params[0], params[1], None, None, False, rate, params[2], params[3],
            training=training, need_weights=False,
        )[0]

    return mha, (in_w, in_b, wo, bo)


def check_fused_attention(batches=(15, 64, 1024), s=100, e=32, heads=4) -> list[dict]:
    """The attention kernel vs its plain version, f32 and bf16, through both
    entry points (one kernel); each dtype is timed through the entry point
    the main path uses for it: v1 in f32 (render), v2 in bf16 (serve)."""
    from ai_font_renderer_tpu_torch.ops.fused_attention import (
        fused_attention,
        fused_attention2,
        fused_attention_reference,
    )

    g = torch.Generator(device="cuda").manual_seed(2)
    w = _attn_weights(g, e)
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        mha, _ = _attn_library(e, heads, w, dt)
        fn = fused_attention if dt == torch.float32 else fused_attention2
        for bsz in batches:
            x = torch.randn(bsz, s, e, generator=g, device="cuda").to(dt)
            got = fused_attention(x, w, heads)
            got2 = fused_attention2(x, w, heads)
            want = fused_attention_reference(x, w, heads)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            tol = ATTN_TOL[dt]
            if got.dtype != dt or not err <= tol or not torch.equal(got, got2):
                raise AssertionError(
                    f"fused attention B={bsz} {dt}: max abs err {err} (tol {tol}), "
                    f"v1 and v2 equal: {torch.equal(got, got2)}"
                )
            xt = x.transpose(0, 1)
            iters = 50
            item = x.element_size()
            ops = bsz * (8 * s * e * e + 4 * s * s * e)
            bound_ms, bound_by = _bound(
                2 * bsz * s * e * item + 4 * (4 * e * e + 4 * e), ops, _attn_peak(dt)
            )
            row = {
                "shape": f"B={bsz},S={s},E={e},H={heads},{str(dt).replace('torch.', '')}",
                "max_abs_err": err,
                "tol": tol,
                "ms": time_ms(lambda: fn(x, w, heads), iters),
                "plain_ms": time_ms(lambda: fused_attention_reference(x, w, heads), iters),
                # One call to PyTorch's multi-head attention (SDPA inside),
                # weights cast to x's dtype once outside the timed region.
                "library_ms": time_ms(lambda: mha(xt, 0.0, False), iters),
                "bound_ms": bound_ms,
                "bound_by": bound_by,
            }
            print(f"[K5/K7 fused_attention] {json.dumps(row)}", flush=True)
            rows.append(row)
    return rows


def check_attention_dropout(bsz=1024, s=100, e=32, heads=4) -> list[dict]:
    """K5 (v1) and K7 (v2) at dropout 0.2 against the plain version fed the
    same seed (its Philox gives the same mask, so values compare, with
    ATTN_TOL); K7's stored mask byte for byte against the plain mask; K5's
    output bit for bit against K7's in f32, so K5 drew K7's mask."""
    from ai_font_renderer_tpu_torch.ops.fused_attention import (
        fused_attention,
        fused_attention2,
        fused_attention_reference,
    )
    from ai_font_renderer_tpu_torch.ops.philox import dropout_keep

    g = torch.Generator(device="cuda").manual_seed(12)
    w = _attn_weights(g, e)
    seed = torch.tensor([20240917], dtype=torch.int32, device="cuda")
    shape = (bsz, heads, s, s)
    rows = []
    # K5 in bf16 is K7's kernel with the mask drawn and not stored: its
    # time beside K7's shows what the mask's store costs.
    for name, dt in (("K5 v1", torch.float32), ("K7 v2", torch.bfloat16), ("K5 v1", torch.bfloat16),
                     ("K7 v2", torch.float32)):
        x = torch.randn(bsz, s, e, generator=g, device="cuda").to(dt)
        v2 = name.startswith("K7")
        out2, mask = fused_attention2(x, w, heads, DROPOUT, seed, return_mask=True)
        out = out2 if v2 else fused_attention(x, w, heads, DROPOUT, seed)
        plain_mask = dropout_keep(seed, shape, DROPOUT)
        want = fused_attention_reference(x, w, heads, mask=plain_mask, rate=DROPOUT)
        torch.cuda.synchronize()
        err = float((out.float() - want.float()).abs().max())
        tol = ATTN_TOL[dt]
        masks_equal = torch.equal(mask, plain_mask.to(torch.uint8))
        keep_rate = float(mask.float().mean())
        if not (err <= tol and masks_equal and torch.equal(out, out2)):
            raise AssertionError(
                f"{name} dropout {dt}: max abs err {err} (tol {tol}), stored mask equals the plain "
                f"mask: {masks_equal}, K5 equals K7: {torch.equal(out, out2)}")
        fn = fused_attention2 if v2 else fused_attention
        item = x.element_size()
        mask_bytes = bsz * heads * s * s if v2 else 0
        # The products only: the Philox integer work has no rate in the
        # table of peaks and is left out of the bound.
        bound_ms, bound_by = _bound(2 * bsz * s * e * item + 4 * (4 * e * e + 4 * e) + mask_bytes,
                                    bsz * (8 * s * e * e + 4 * s * s * e), _attn_peak(dt))
        mha, _ = _attn_library(e, heads, w, dt)
        xt = x.transpose(0, 1)
        with torch.no_grad():
            library_ms = time_ms(lambda: mha(xt, DROPOUT, True), 50)
        row = {
            "shape": f"B={bsz},S={s},E={e},H={heads},{str(dt).replace('torch.', '')},dropout={DROPOUT}",
            "max_abs_err": err,
            "tol": tol,
            "keep_rate": keep_rate,
            "mask": "stored" if v2 else "drawn",
            "mask_equal": masks_equal,
            "ms": time_ms(lambda: fn(x, w, heads, DROPOUT, seed), 50),
            # The plain mask (Philox in int64 tensor ops) and the plain
            # forward: what the kernel computes.
            "plain_ms": time_ms(lambda: fused_attention_reference(
                x, w, heads, mask=dropout_keep(seed, shape, DROPOUT), rate=DROPOUT), 10),
            # PyTorch's attention forward with its own dropout, no grad.
            "library_ms": library_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
        }
        print(f"[{name} fused_attention dropout] keep rate {keep_rate:.6f} (expected "
              f"{1 - DROPOUT}); stored mask equals the plain Philox mask: {masks_equal}; "
              f"{json.dumps(row)}", flush=True)
        rows.append((name, row))
        del out, out2, mask, plain_mask, want
    return rows


def check_attention_backward(bsz=1024, s=100, e=32, heads=4) -> tuple[list[dict], list[dict]]:
    """K6 (mask regenerated) and K8 (mask read) at dropout 0.2 against
    fused_attention_backward_reference with the plain mask, f32 and bf16,
    within ATTN_BWD_TOL; K6 and K8 must give the same bits. The library
    time is PyTorch's attention forward + backward under autograd with
    dropout 0.2, set against K5+K6 (v1) and K7+K8 (v2)."""
    from ai_font_renderer_tpu_torch.ops.fused_attention import (
        fused_attention,
        fused_attention2,
        fused_attention2_backward,
        fused_attention_backward,
        fused_attention_backward_reference,
    )
    from ai_font_renderer_tpu_torch.ops.philox import dropout_keep

    g = torch.Generator(device="cuda").manual_seed(13)
    w = _attn_weights(g, e)
    seed = torch.tensor([7], dtype=torch.int32, device="cuda")
    shape = (bsz, heads, s, s)
    mask = dropout_keep(seed, shape, DROPOUT).to(torch.uint8)
    k6_rows, k8_rows = [], []
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn(bsz, s, e, generator=g, device="cuda").to(dt)
        gy = torch.randn(bsz, s, e, generator=g, device="cuda").to(dt)
        k6 = fused_attention_backward(x, gy, w, heads, DROPOUT, seed)
        k8 = fused_attention2_backward(x, gy, w, heads, DROPOUT, mask)
        want_dx, want_dw = fused_attention_backward_reference(x, gy, w, heads, DROPOUT, mask)
        torch.cuda.synchronize()
        dx_rel = _rel(k6[0].float(), want_dx.float())
        wmax = max(float(v.abs().max()) for v in want_dw.values())
        w_rel = max(float((k6[1][k] - want_dw[k]).abs().max()) for k in want_dw) / wmax
        same = torch.equal(k6[0], k8[0]) and all(torch.equal(k6[1][k], k8[1][k]) for k in want_dw)
        tol = ATTN_BWD_TOL[dt]
        if not (dx_rel <= tol and w_rel <= tol and same):
            raise AssertionError(f"K6/K8 {dt}: dx rel err {dx_rel}, weight grads rel err {w_rel} "
                                 f"(tol {tol}); K6 and K8 give the same bits: {same}")
        item = x.element_size()
        mha, params = _attn_library(e, heads, w, dt)
        lib_params = [p.clone().requires_grad_() for p in params]
        xt = x.transpose(0, 1).detach().requires_grad_()
        gt = gy.transpose(0, 1)
        library_ms = time_ms(lambda: torch.autograd.grad(
            mha(xt, DROPOUT, True, lib_params), [xt, *lib_params], gt), 20)
        tag = str(dt).replace("torch.", "")
        for name, got, fn, args, fwd, plain, mask_bytes, rows in (
            ("K6 fused_attention_bwd", k6, fused_attention_backward, (x, gy, w, heads, DROPOUT, seed),
             fused_attention,
             lambda: fused_attention_backward_reference(
                 x, gy, w, heads, DROPOUT, dropout_keep(seed, shape, DROPOUT)), 0, k6_rows),
            ("K8 fused_attention2_bwd", k8, fused_attention2_backward, (x, gy, w, heads, DROPOUT, mask),
             fused_attention2,
             lambda: fused_attention_backward_reference(x, gy, w, heads, DROPOUT, mask), mask.numel(), k8_rows),
        ):
            # x and g read, dx written, the weights read and their eight
            # gradients written (the per-sample sums are the kernel's own
            # choice), K8's mask read; products: 11 [S,E]x[E,E] and 6
            # [S,S]x[S,d] per head.
            bound_ms, bound_by = _bound(
                3 * bsz * s * e * item + 2 * 4 * (4 * e * e + 4 * e) + mask_bytes,
                bsz * (22 * s * e * e + 12 * s * s * e), _attn_peak(dt),
            )
            ms = time_ms(lambda: fn(*args), 20)
            fwd_ms = time_ms(lambda: fwd(x, w, heads, DROPOUT, seed), 20)
            row = {
                "shape": f"B={bsz},S={s},E={e},H={heads},{tag},dropout={DROPOUT}",
                "max_abs_err": float((got[0].float() - want_dx.float()).abs().max()),
                "dx_rel_err": dx_rel,
                "dw_rel_err": w_rel,
                "tol": f"{tol} of max |plain|",
                "ms": ms,
                "plain_ms": time_ms(plain, 5),
                # Forward + backward of PyTorch's attention with dropout
                # under autograd: compare with fwd_plus_bwd_ms.
                "library_ms": library_ms,
                "fwd_plus_bwd_ms": fwd_ms + ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
            }
            print(f"[{name}] {json.dumps(row)}", flush=True)
            rows.append(row)
        del k6, k8, want_dx, want_dw, lib_params, xt
    return k6_rows, k8_rows


# The general attention kernels' shapes in the kernel checks and on the
# main path: E = 64 (head width 16) and S = 129, each past both
# register-tiled kernels.
WIDE_SHAPES = ((100, 64, 4), (129, 32, 4))
# The general kernels' bf16 forward against the plain one, relative to the
# largest |plain| value as the backward's: q, k, v and out are rounded once
# here and twice (after the product, after the bias) in the plain version,
# and with E = 64 or S = 300 an output may round 4 bf16 steps away.
WIDE_FWD_BF16_REL_TOL = 2e-2


def check_attention_wide(bsz=1024, shapes=WIDE_SHAPES) -> tuple[list[dict], list[dict]]:
    """The general attention kernels (csrc/attention_wide.cu) at the shapes
    the register-tiled ones do not take, at dropout 0.2, f32 and bf16: the
    forward with the mask stored (K7's general build) and drawn (K5's)
    against the plain forward fed the plain mask, the stored mask byte for
    byte; the backward with the mask read (K8's) and regenerated (K6's)
    against fused_attention_backward_reference within ATTN_BWD_TOL, the
    two giving the same bits."""
    from ai_font_renderer_tpu_torch.ops.fused_attention import (
        attention_wide_bwd,
        attention_wide_fwd,
        fused_attention_backward_reference,
        fused_attention_reference,
    )
    from ai_font_renderer_tpu_torch.ops.philox import dropout_keep

    g = torch.Generator(device="cuda").manual_seed(14)
    seed = torch.tensor([11], dtype=torch.int32, device="cuda")
    fwd_rows, bwd_rows = [], []
    for s, e, heads in shapes:
        w = _attn_weights(g, e)
        mask_shape = (bsz, heads, s, s)
        mask = dropout_keep(seed, mask_shape, DROPOUT).to(torch.uint8)
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(bsz, s, e, generator=g, device="cuda").to(dt)
            gy = torch.randn(bsz, s, e, generator=g, device="cuda").to(dt)
            drawn, _ = attention_wide_fwd(x, w, heads, DROPOUT, seed)
            stored, got_mask = attention_wide_fwd(x, w, heads, DROPOUT, seed, store_mask=True)
            want = fused_attention_reference(x, w, heads, mask=mask, rate=DROPOUT)
            k6 = attention_wide_bwd(x, gy, w, heads, DROPOUT, seed)
            k8 = attention_wide_bwd(x, gy, w, heads, DROPOUT, None, mask)
            want_dx, want_dw = fused_attention_backward_reference(x, gy, w, heads, DROPOUT, mask)
            torch.cuda.synchronize()
            err = float((drawn.float() - want.float()).abs().max())
            if dt == torch.float32:
                fwd_ok, tol = err <= ATTN_TOL[dt], ATTN_TOL[dt]
            else:
                tol = f"{WIDE_FWD_BF16_REL_TOL} of max |plain|"
                fwd_ok = err <= WIDE_FWD_BF16_REL_TOL * float(want.float().abs().max())
            masks_equal = torch.equal(got_mask, mask)
            dx_rel = _rel(k6[0].float(), want_dx.float())
            wmax = max(float(v.abs().max()) for v in want_dw.values())
            w_rel = max(float((k6[1][k] - want_dw[k]).abs().max()) for k in want_dw) / wmax
            same = torch.equal(k6[0], k8[0]) and all(torch.equal(k6[1][k], k8[1][k]) for k in want_dw)
            btol = ATTN_BWD_TOL[dt]
            if not (fwd_ok and masks_equal and torch.equal(drawn, stored) and dx_rel <= btol
                    and w_rel <= btol and same):
                raise AssertionError(
                    f"general attention S={s} E={e} {dt}: forward max abs err {err} (tol {tol}), mask "
                    f"equal {masks_equal}, drawn equals stored {torch.equal(drawn, stored)}; backward dx "
                    f"rel {dx_rel}, weights rel {w_rel} (tol {btol}), K6 equals K8 {same}")
            item = x.element_size()
            tag = f"B={bsz},S={s},E={e},H={heads},{str(dt).replace('torch.', '')},dropout={DROPOUT}"
            mha, params = _attn_library(e, heads, w, dt)
            xt = x.transpose(0, 1)
            with torch.no_grad():
                lib_fwd = time_ms(lambda: mha(xt, DROPOUT, True), 20)
            lib_params = [p.clone().requires_grad_() for p in params]
            xg = xt.detach().requires_grad_()
            lib_bwd = time_ms(lambda: torch.autograd.grad(
                mha(xg, DROPOUT, True, lib_params), [xg, *lib_params], gy.transpose(0, 1)), 10)
            weight_bytes = 4 * (4 * e * e + 4 * e)
            bound_ms, bound_by = _bound(2 * bsz * s * e * item + weight_bytes + mask.numel(),
                                        bsz * (8 * s * e * e + 4 * s * s * e), _attn_peak(dt))
            fwd_ms = time_ms(lambda: attention_wide_fwd(x, w, heads, DROPOUT, seed, True), 20)
            row = {
                "shape": tag, "max_abs_err": err, "tol": tol, "mask_equal": masks_equal,
                "ms": fwd_ms,
                "plain_ms": time_ms(lambda: fused_attention_reference(
                    x, w, heads, mask=dropout_keep(seed, mask_shape, DROPOUT), rate=DROPOUT), 5),
                "library_ms": lib_fwd, "bound_ms": bound_ms, "bound_by": bound_by,
            }
            print(f"[K5/K7 general attention_wide_fwd] {json.dumps(row)}", flush=True)
            fwd_rows.append(row)
            bound_ms, bound_by = _bound(3 * bsz * s * e * item + 2 * weight_bytes + mask.numel(),
                                        bsz * (22 * s * e * e + 12 * s * s * e), _attn_peak(dt))
            bwd_ms = time_ms(lambda: attention_wide_bwd(x, gy, w, heads, DROPOUT, None, mask), 10)
            row = {
                "shape": tag,
                "max_abs_err": float((k6[0].float() - want_dx.float()).abs().max()),
                "dx_rel_err": dx_rel, "dw_rel_err": w_rel, "tol": f"{btol} of max |plain|",
                "ms": bwd_ms,
                "plain_ms": time_ms(lambda: fused_attention_backward_reference(
                    x, gy, w, heads, DROPOUT, mask), 5),
                # Forward + backward of PyTorch's attention with dropout
                # under autograd: compare with fwd_plus_bwd_ms.
                "library_ms": lib_bwd, "fwd_plus_bwd_ms": fwd_ms + bwd_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
            }
            print(f"[K6/K8 general attention_wide_bwd] {json.dumps(row)}", flush=True)
            bwd_rows.append(row)
            del drawn, stored, got_mask, want, k6, k8, want_dx, want_dw, lib_params, xg
    return fwd_rows, bwd_rows


def check_dw_adamw_xt(m=1024, k=6400, n=19200) -> list[dict]:
    """K9 (K4 with x transposed to [K, M]; b1 0.9, b2 0.99, wd 5e-4 fixed)
    against its plain version at step 5 with seeded moments and bf16 mu,
    with K4's tolerances and K4's shadow check."""
    from ai_font_renderer_tpu_torch.ops.fused_dw_adamw import (
        XT_B1,
        XT_B2,
        XT_WD,
        fused_dw_adamw_xt,
        fused_dw_adamw_xt_reference,
    )

    g = torch.Generator(device="cuda").manual_seed(14)
    xt = torch.relu(torch.randn(k, m, generator=g, device="cuda")).to(torch.bfloat16)
    gm16 = (torch.randn(m, n, generator=g, device="cuda") * (2.0 / (m * n))).to(torch.bfloat16)
    w = (torch.rand(k, n, generator=g, device="cuda") * 2 - 1) / k**0.5
    mu = (torch.randn(k, n, generator=g, device="cuda") * 1e-7).to(torch.bfloat16)
    nu = torch.rand(k, n, generator=g, device="cuda") * 1e-14 + 1e-16
    step_t = torch.tensor(5.0, device="cuda")

    def run(w_, mu_, nu_):
        fused_dw_adamw_xt(xt, gm16, w_, mu_, nu_, 1e-3, 5)

    def run_ref(w_, mu_, nu_):
        fused_dw_adamw_xt_reference(xt, gm16, w_, mu_, nu_, 1e-3, 5)

    def library(w_, m_, v_):
        dw = torch.mm(xt, gm16, out_dtype=torch.float32)
        torch._fused_adamw_([w_], [dw], [m_], [v_], [], [step_t], lr=1e-3, beta1=XT_B1, beta2=XT_B2,
                            weight_decay=XT_WD, eps=1e-8, amsgrad=False, maximize=False)

    w_err = _check_k4_update(f"K9 M={m}", run, run_ref, w, mu, nu)
    row = {
        "shape": f"M={m},K={k},N={n},mu=bf16,xt",
        "max_abs_err": w_err,
        "tol": f"w {K4_W_TOL}; mu one bf16 step; nu {GRAD_REL_TOL} of max; shadow bit for bit",
        **_k4_bounds(m, k, n, mu.element_size()),
    }
    _time_k4(row, run, run_ref, library, w, mu, nu)
    print(f"[K9 fused_dw_adamw_xt] {json.dumps(row)}", flush=True)
    return [row]


def phase_ab_xt(m=1024, k=6400, n=19200, iters=10) -> dict:
    """The K4/K9 A/B of tools/ab_kernel_micro.py (main and main_xt), the
    only path that runs K9: x [M, K] and xt [K, M] bf16, gm * 1e-4, w
    random, zero moments (mu bf16), step 3, each chained over ``iters``
    updates of one state, timed in turns K4, K9, K9, K4 by CUDA events."""
    from ai_font_renderer_tpu_torch.ops.fused_dw_adamw import (
        XT_B1,
        XT_B2,
        XT_WD,
        fused_dw_adamw,
        fused_dw_adamw_xt,
    )

    g = torch.Generator(device="cuda").manual_seed(15)
    x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
    xt = x.T.contiguous()
    gm = (torch.randn(m, n, generator=g, device="cuda") * 1e-4).to(torch.bfloat16)
    w = torch.randn(k, n, generator=g, device="cuda") * 0.01
    mu = torch.zeros(k, n, device="cuda", dtype=torch.bfloat16)
    nu = torch.zeros(k, n, device="cuda")
    runs = {
        "K4": lambda: fused_dw_adamw(x, gm, w, mu, nu, 1e-3, XT_WD, XT_B1, XT_B2, 3),
        "K9": lambda: fused_dw_adamw_xt(xt, gm, w, mu, nu, 1e-3, 3),
    }
    torch.cuda.synchronize()
    _reset_counts()
    times = {"K4": [], "K9": []}
    for name in ("K4", "K9", "K9", "K4"):
        times[name].append(time_ms(runs[name], iters))
    counts = _counts()
    ab = {name: sum(t) / len(t) for name, t in times.items()}
    print(f"[ab_xt] K4 (x [M,K]) vs K9 (xt [K,M]) at M={m}: ms per update {json.dumps(ab)}, "
          f"runs {json.dumps(times)}; launches {counts}", flush=True)
    if counts["fused_dw_adamw_xt"] <= 0:
        raise AssertionError(f"the A/B never launched K9: {counts}")
    return counts


def _kernel_fns():
    from ai_font_renderer_tpu_torch import ops

    return {
        "fused_output": ops.fused_output,
        "gemm_bf16_bias_clamp": ops.gemm_bf16_bias_clamp,
        "fused_attention": ops.fused_attention,
        "fused_attention2": ops.fused_attention2,
        "fused_output_dx": ops.fused_output_dx,
        "round_bf16": ops.round_bf16,
        "gemm_bf16_tn": ops.gemm_bf16_tn,
        "fused_output_dw": ops.fused_output_dw,
        "gemm_bf16_mn": ops.gemm_bf16_mn,
        "fused_dw_adamw": ops.fused_dw_adamw,
        "fused_attention_backward": ops.fused_attention_backward,
        "fused_attention2_backward": ops.fused_attention2_backward,
        "attention_mma_fwd": ops.attention_mma_fwd,
        "attention_mma_bwd": ops.attention_mma_bwd,
        "attention_wide_fwd": ops.attention_wide_fwd,
        "attention_wide_bwd": ops.attention_wide_bwd,
        "fused_dw_adamw_xt": ops.fused_dw_adamw_xt,
    }


def _reset_counts():
    from ai_font_renderer_tpu_torch.ops import bf16_shadow

    for fn in _kernel_fns().values():
        fn.launches = 0
    bf16_shadow.builds = 0


def _counts() -> dict:
    return {name: fn.launches for name, fn in _kernel_fns().items()}


def _builds() -> int:
    """Rebuilds of W's bf16 shadow since the last _reset_counts."""
    from ai_font_renderer_tpu_torch.ops import bf16_shadow

    return bf16_shadow.builds


def _atlas_strings(n: int, length: int, seed: int = 0) -> list[str]:
    rng = np.random.default_rng(seed)
    letters = np.array(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ "))
    return ["".join(row) for row in letters[rng.integers(0, len(letters), (n, length))]]


def _profile_atlas(params, strings, mcfg) -> None:
    """Where one atlas render spends its time: the host's string encoding,
    the wall time, and the device's kernel time by kernel (torch.profiler)."""
    from torch.autograd import DeviceType

    from ai_font_renderer_tpu_torch.fontgen.layout import encode_codes
    from ai_font_renderer_tpu_torch.render import render_atlas

    t0 = time.perf_counter()
    encode_codes(strings, mcfg.max_length)
    encode_ms = (time.perf_counter() - t0) * 1e3
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        render_atlas(params, strings, mcfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    print(f"[profile] atlas 4096: wall {wall_ms:.2f} ms (profiled), device kernels "
          f"{busy_ms:.2f} ms, busy share {busy_ms / wall_ms:.3f}, host encode {encode_ms:.2f} ms",
          flush=True)
    for e in top:
        print(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms  {e.count:4d}x  {e.key[:90]}",
              flush=True)


def _render_test_strings(params, mcfg, out_dir: str, tag: str) -> None:
    """The 15 test strings to BMPs with the kernels of ``mcfg`` on; the
    sheets must match the plain path on the same weights within SHEET_TOL
    and the BMPs within one gray level."""
    from ai_font_renderer_tpu_torch.cli import TEST_STRINGS
    from ai_font_renderer_tpu_torch.config import replace
    from ai_font_renderer_tpu_torch.fontgen.bmp import read_bmp
    from ai_font_renderer_tpu_torch.render import render_batch, render_strings

    paths = render_strings(params, TEST_STRINGS, out_dir, mcfg)
    if len(paths) != len(TEST_STRINGS):
        raise AssertionError(f"{len(paths)} BMPs for {len(TEST_STRINGS)} strings")
    images = np.stack([read_bmp(p) for p in paths])
    if images.shape != (15, 80, 240):
        raise AssertionError(f"BMPs decode to {images.shape}, want (15, 80, 240)")
    plain_cfg = replace(mcfg, use_pallas_output=False, fused_attention=False, fused_attention_v2=False)
    plain = render_batch(params, TEST_STRINGS, plain_cfg)
    kern = render_batch(params, TEST_STRINGS, mcfg)
    sheet_err = float(np.abs(kern - plain).max())
    bmp_err = float(np.abs(images - np.round(np.clip(plain, 0, 1) * 255) / 255).max())
    if not (np.isfinite(kern).all() and sheet_err <= SHEET_TOL and bmp_err <= 1 / 255 + 1e-6):
        raise AssertionError(f"{tag}: sheets vs plain path: max err {sheet_err}, BMP err {bmp_err}")
    print(f"[{tag}] 15 BMPs 80x240; sheets vs plain path max abs err {sheet_err:.3g} "
          f"(tol {SHEET_TOL}), BMPs within {bmp_err * 255:.2f} gray levels", flush=True)


def phase_render(workdir: str, card: str) -> tuple[dict, dict]:
    from ai_font_renderer_tpu_torch.config import ModelConfig
    from ai_font_renderer_tpu_torch.models import font_renderer
    from ai_font_renderer_tpu_torch.render import render_atlas
    from ai_font_renderer_tpu_torch.utils.checkpoint import load_params_with_config, save_params

    cfg = ModelConfig(use_pallas_output=True, fused_attention=True)
    t0 = time.perf_counter()
    params = font_renderer.init(torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
    path = os.path.join(workdir, "font_renderer.npz")
    save_params(params, path, cfg)
    loaded, mcfg = load_params_with_config(path, base=cfg, device="cuda")
    n_params = font_renderer.param_count(loaded)
    for k, v in params.items():
        if not torch.equal(v, loaded[k]):
            raise AssertionError(f"npz round trip changed {k}")
    print(
        f"[render] {n_params} parameters, init + save + load {time.perf_counter() - t0:.2f} s",
        flush=True,
    )
    del params

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    _render_test_strings(loaded, mcfg, os.path.join(workdir, "renders"), "render")
    strings_counts, strings_builds = _counts(), _builds()

    strings = _atlas_strings(4096, mcfg.max_length)
    torch.cuda.synchronize()
    _reset_counts()
    warm = render_atlas(loaded, strings, mcfg)  # also fills the allocator's cache
    torch.cuda.synchronize()
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        atlas = render_atlas(loaded, strings, mcfg)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    atlas_counts, atlas_builds = _counts(), _builds()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    if atlas.shape != (4096, 80, 240) or not bool(torch.isfinite(atlas).all()):
        raise AssertionError(f"atlas {tuple(atlas.shape)} not finite or misshapen")
    if not torch.equal(atlas, warm):
        raise AssertionError("the atlas differs between two runs")
    gps = sorted(4096 * mcfg.max_length / t for t in runs)
    print(f"[render] atlas 4096 sheets x {mcfg.max_length} glyphs: glyphs/s runs "
          f"{gps}, median {gps[len(gps) // 2]} ({card})", flush=True)
    _profile_atlas(loaded, strings, mcfg)
    counts = {k: strings_counts[k] + atlas_counts[k] for k in strings_counts}
    print(f"[render] launches: test strings {strings_counts}, atlas {atlas_counts}", flush=True)
    print(f"[render] W's bf16 shadow built {strings_builds} times for the test strings, {atlas_builds} "
          f"for the atlas; peak device memory of the test strings and the atlas {peak_mib:.1f} MiB "
          f"({card})", flush=True)
    if strings_builds + atlas_builds > 1:
        raise AssertionError(f"render built W's shadow {strings_builds + atlas_builds} times, want once")
    for name in ("fused_output", "gemm_bf16_bias_clamp", "fused_attention"):
        if counts[name] <= 0:
            raise AssertionError(f"render never launched {name}: {counts}")
    return loaded, counts


SERVE_REQUESTS = {
    "short": ["HELLO", "SERVE ME", ""],
    "mid": _atlas_strings(17, 40, seed=1),
    "long": _atlas_strings(150, 100, seed=2),  # more than one 64-string batch
}


def _serve_config():
    from ai_font_renderer_tpu_torch.config import ModelConfig

    return ModelConfig(use_pallas_output=True, fused_attention_v2=True, bf16_frontend=True)


def _serve_once(params, sock: str) -> tuple[dict, dict, dict]:
    """One server of batch 64 and the three SERVE_REQUESTS sent at once:
    (replies, latency ms from send to last reply byte, stalls). ``stalls``
    holds what could hold back all three at once, from just before the sends
    to the last reply: the garbage collector's pauses ([generation, ms]),
    the caching allocator's new device segments and retries, and each of the
    dispatcher's render calls as [host ms since the sends, ms it took]."""
    from ai_font_renderer_tpu_torch.render.server import RenderServer, request_render

    srv = RenderServer(params, _serve_config(), socket_path=sock, batch_size=64)
    srv.start()
    replies, latency_ms, errors, gc_ms, dispatch_ms, gc_t0 = {}, {}, [], [], [], []
    render = srv.batcher._render

    def timed_render(strings):
        t0 = time.perf_counter()
        out = render(strings)
        dispatch_ms.append([round((t0 - origin) * 1e3, 3), round((time.perf_counter() - t0) * 1e3, 3)])
        return out

    def on_gc(phase, info):
        if phase == "start":
            gc_t0[:] = [time.perf_counter()]
        else:
            gc_ms.append([info["generation"], round((time.perf_counter() - gc_t0[0]) * 1e3, 3)])

    def client(name):
        try:
            t0 = time.perf_counter()
            replies[name] = request_render(sock, SERVE_REQUESTS[name])
            latency_ms[name] = round((time.perf_counter() - t0) * 1e3, 3)
        except Exception as e:  # reported below, after the join
            errors.append((name, repr(e)))

    srv.batcher._render = timed_render
    mem0 = torch.cuda.memory_stats()
    gc.callbacks.append(on_gc)
    try:
        threads = [threading.Thread(target=client, args=(n,)) for n in SERVE_REQUESTS]
        origin = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"serve clients failed: {errors}")
    finally:
        gc.callbacks.remove(on_gc)
        srv.stop()
    mem1 = torch.cuda.memory_stats()
    stalls = {
        "gc_ms": gc_ms,
        "new_segments": mem1["segment.all.allocated"] - mem0["segment.all.allocated"],
        "alloc_retries": mem1["num_alloc_retries"] - mem0["num_alloc_retries"],
        "dispatch_ms": dispatch_ms,
    }
    return replies, latency_ms, stalls


def phase_serve(params, workdir: str) -> dict:
    from ai_font_renderer_tpu_torch.render import render_batch_u8_async

    _reset_counts()
    replies, latency_ms, stalls = _serve_once(params, os.path.join(workdir, "afr.sock"))
    counts, builds = _counts(), _builds()
    for name, strings in SERVE_REQUESTS.items():
        header, payloads = replies[name]
        got = np.stack([np.frombuffer(p, np.uint8).reshape(80, 240) for p in payloads])
        want = render_batch_u8_async(params, strings, _serve_config()).cpu().numpy()
        if header["count"] != len(strings) or not np.array_equal(got, want):
            diff = int(np.abs(got.astype(int) - want.astype(int)).max())
            raise AssertionError(f"serve reply {name} differs from a direct render (max {diff})")
    print(f"[serve] 3 concurrent requests ({[len(v) for v in SERVE_REQUESTS.values()]} strings) equal "
          f"direct renders; latency ms {latency_ms}; stalls {json.dumps(stalls)}; launches {counts}; "
          f"W's bf16 shadow built {builds} times", flush=True)
    if builds > 1:
        raise AssertionError(f"serve built W's shadow {builds} times, want once at most")
    for name in ("fused_output", "gemm_bf16_bias_clamp", "fused_attention2", "attention_mma_fwd"):
        if counts[name] <= 0:
            raise AssertionError(f"serve never launched {name}: {counts}")
    print(f"[serve] bf16 attention forward on tensor cores launched {counts['attention_mma_fwd']} times",
          flush=True)
    return counts


def _steps_per_s(state, ds, batch_idx, mcfg, tcfg, steps: int = 8) -> float:
    """Training steps per second on the card: host clock around ``steps``
    steps after two warm ones, ending in a synchronize."""
    from ai_font_renderer_tpu_torch.train.step import train_step

    gen = torch.Generator(device="cuda").manual_seed(7)
    for i in range(2):
        train_step(state, *ds.gather_batch(batch_idx[i]), 1e-3, gen, mcfg, tcfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        train_step(state, *ds.gather_batch(batch_idx[i % len(batch_idx)]), 1e-3, gen, mcfg, tcfg)
    torch.cuda.synchronize()
    return steps / (time.perf_counter() - t0)


def step_memory() -> int:
    """``--step-memory``: torch.cuda.max_memory_allocated over one
    full-width training step at batch 1024 (after a warm one) in the plain,
    ``output`` and ``fused`` configurations, weights from a seed and a
    random batch (no corpus), so the figure is the model, its state and the
    step alone; then over one 1024-sheet atlas chunk rendered with K1 and
    the attention forward (weights, W's bf16 shadow, activations)."""
    from ai_font_renderer_tpu_torch.config import ModelConfig, TrainConfig, replace
    from ai_font_renderer_tpu_torch.models import font_renderer
    from ai_font_renderer_tpu_torch.render import render_atlas
    from ai_font_renderer_tpu_torch.train.step import state_from_params, train_step

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    print(_nvidia_smi(), flush=True)
    base = ModelConfig(use_pallas_output=True)
    params = font_renderer.init(torch.Generator(device="cuda").manual_seed(0), base, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    codes = torch.randint(32, 127, (1024, base.max_length), generator=gen, device="cuda", dtype=torch.int32)
    targets = torch.rand(1024, base.sheet_height, base.sheet_width, generator=gen, device="cuda")
    peaks = {}
    for name, mcfg, tcfg in (("plain", replace(base, use_pallas_output=False), TrainConfig()),
                             ("output", base, TrainConfig()),
                             ("fused", base, TrainConfig(fused_dw_adamw=True))):
        state = state_from_params(params, tcfg)
        train_step(state, codes, targets, 1e-3, gen, mcfg, tcfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        train_step(state, codes, targets, 1e-3, gen, mcfg, tcfg)
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() / 2**20
        del state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    render_atlas(params, _atlas_strings(1024, base.max_length), replace(base, fused_attention=True))
    torch.cuda.synchronize()
    peaks["render"] = torch.cuda.max_memory_allocated() / 2**20
    print(f"[step memory] peak MiB of one step at batch 1024 and of one 1024-sheet render: "
          f"{json.dumps(peaks)}", flush=True)
    return 0


def serve_repeats(repeats: int) -> int:
    """``--serve-repeats N``: the serve phase's three requests on N servers
    one after the other, after what precedes the serve phase on the main
    path (weights from its seed, the test strings and a profiled atlas
    render with K1 and the v1 attention), each run's latencies beside its
    stalls (see _serve_once). Uses no counter of the kernels, so it runs on
    an earlier tree of the port too."""
    from ai_font_renderer_tpu_torch.config import ModelConfig
    from ai_font_renderer_tpu_torch.models import font_renderer
    from ai_font_renderer_tpu_torch.render import render_batch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    card = _nvidia_smi()
    print(card, flush=True)
    mcfg = ModelConfig(use_pallas_output=True, fused_attention=True)
    params = font_renderer.init(torch.Generator(device="cuda").manual_seed(0), mcfg, "cuda")
    render_batch(params, ["HELLO"] * 15, mcfg)
    _profile_atlas(params, _atlas_strings(4096, mcfg.max_length), mcfg)
    with tempfile.TemporaryDirectory() as workdir:
        for i in range(repeats):
            _, latency_ms, stalls = _serve_once(params, os.path.join(workdir, "afr.sock"))
            print(f"[serve {i}] latency ms {json.dumps(latency_ms)}; stalls {json.dumps(stalls)} ({card})",
                  flush=True)
    return 0


def _profile_step(state, ds, idx, mcfg, tcfg, name: str) -> None:
    """One training step under torch.profiler: wall time, device kernel
    time, busy share, and the kernels that take the most device time."""
    from torch.autograd import DeviceType

    from ai_font_renderer_tpu_torch.train.step import train_step

    gen = torch.Generator(device="cuda").manual_seed(8)
    batch = ds.gather_batch(idx)
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        train_step(state, *batch, 1e-3, gen, mcfg, tcfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    print(f"[profile] train step ({name}): wall {wall_ms:.2f} ms (profiled), device kernels "
          f"{busy_ms:.2f} ms in {launches} launches, busy share {busy_ms / wall_ms:.3f}", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms  {e.count:4d}x  {e.key[:90]}",
              flush=True)


def _attention_step_checks(results, batch, base, fast) -> None:
    """One step through the attention kernels against the plain step of
    the same kind (fused, or hand-rolled without remat) on the trained
    weights of that configuration and the same batch, dropout off, f32
    moments so that mu/(1-b1) after one step is the gradient: the loss, and
    the gradients of wq..bo relative to the largest of the eight."""
    from ai_font_renderer_tpu_torch.config import TrainConfig, replace
    from ai_font_renderer_tpu_torch.ops.fused_attention import KEYS
    from ai_font_renderer_tpu_torch.train.step import state_from_params, train_step

    off = dict(dropout_rate=0.0, fc_dropout_rate=0.0)
    f32_mu = dict(adam_mu_bf16=False)
    cases = {
        # name: (frontend, kernel (model, train) configs, plain configs)
        "attn_v1": ("f32", (replace(base, fused_attention=True, **off), TrainConfig(fused_dw_adamw=True, **f32_mu)),
                    (replace(base, use_pallas_output=False, **off), TrainConfig(fused_dw_adamw=True, **f32_mu))),
        "attn_v2_fast": ("bf16", (replace(fast, **off), TrainConfig(handrolled_bwd=True, remat_frontend="dots", **f32_mu)),
                         (replace(fast, fused_attention_v2=False, **off), TrainConfig(handrolled_bwd=True, **f32_mu))),
    }
    one_minus_b1 = float(np.float32(1) - np.float32(0.9))
    for name, (front, kern, plain) in cases.items():
        out = []
        for mcfg, tcfg in (kern, plain):
            state = state_from_params(results[name].params, tcfg)
            state, loss = train_step(state, *batch, 1e-3, torch.Generator(device="cuda"), mcfg, tcfg)
            out.append((float(loss), {k: state.mu[k] / one_minus_b1 for k in KEYS}))
            del state
        (loss, grads), (ref_loss, ref_grads) = out
        loss_rel = abs(loss - ref_loss) / ref_loss
        scale = max(float(v.abs().max()) for v in ref_grads.values())
        grad_rel = max(float((grads[k] - ref_grads[k]).abs().max()) for k in KEYS) / scale
        loss_tol = STEP_LOSS_REL_TOL if front == "f32" else STEP_LOSS_BF16_TOL
        grad_tol = STEP_ATTN_GRAD_TOL[front]
        print(f"[train] one step, {name} vs plain ({front} frontend): loss {loss:.8f} vs {ref_loss:.8f} "
              f"(rel {loss_rel:.3g}, tol {loss_tol}); gradient of wq..bo max err {grad_rel:.3g} of the "
              f"largest (tol {grad_tol})", flush=True)
        if not (loss_rel <= loss_tol and grad_rel <= grad_tol):
            raise AssertionError(f"one step {name} vs plain: loss rel {loss_rel}, grad rel {grad_rel}")


def phase_train(workdir: str, card: str) -> tuple[dict, dict]:
    """Phase 5: the trainer at full width through ``train()``, in four
    kernel configurations, then the checks around it."""
    from ai_font_renderer_tpu_torch.config import FIRACODE_PATH, ModelConfig, TrainConfig, replace
    from ai_font_renderer_tpu_torch.fontgen import bake_atlas, build_device_dataset, build_layouts
    from ai_font_renderer_tpu_torch.fontgen.dataset import split_sizes
    from ai_font_renderer_tpu_torch.fontgen.sheets import synthesize_sheets_host
    from ai_font_renderer_tpu_torch.models import font_renderer
    from ai_font_renderer_tpu_torch.train import train
    from ai_font_renderer_tpu_torch.train.step import state_from_params, train_step
    from ai_font_renderer_tpu_torch.utils.checkpoint import load_params_with_config, save_params

    n_samples, epochs = 20480, 3
    steps_per_epoch = split_sizes(n_samples, TrainConfig().validation_split)[0] // 1024
    t0 = time.perf_counter()
    atlas = bake_atlas(FIRACODE_PATH)
    _, grids = build_layouts(atlas, n_samples)
    ds = build_device_dataset(atlas, n_samples, device="cuda")
    torch.cuda.synchronize()
    t_data = time.perf_counter() - t0
    host = np.round(synthesize_sheets_host(atlas, grids[:4096]) * 255).astype(np.uint8)
    dev = ds.targets_u8[:4096].cpu().numpy()
    diff = np.abs(dev.astype(np.int16) - host.astype(np.int16))
    print(f"[train] corpus {n_samples} FiraCode sheets on the card in {t_data:.2f} s; first 4096 u8 "
          f"sheets vs numpy oracle: {int((diff > 0).sum())} bytes differ, max {int(diff.max())} "
          "gray levels", flush=True)
    if diff.max() > 1:
        raise AssertionError(f"synthesized sheets differ from the oracle by {int(diff.max())} levels")

    base = ModelConfig(use_pallas_output=True)
    fast = ModelConfig(bf16_frontend=True, bits_dropout=True, fused_attention_v2=True)
    run = dict(num_epochs=epochs, num_samples=n_samples, checkpoint_every=0)
    configs = {
        "output": (base, TrainConfig(**run)),
        "fused": (base, TrainConfig(**run, fused_dw_adamw=True)),
        # Attention training through the kernels, dropout 0.2 in both.
        "attn_v1": (replace(base, fused_attention=True), TrainConfig(**run, fused_dw_adamw=True)),
        "attn_v2_fast": (fast, TrainConfig(**run, handrolled_bwd=True, remat_frontend="dots")),
    }
    attention_kernels = {"attn_v1": ("fused_attention", "fused_attention_backward"),
                         "attn_v2_fast": ("fused_attention2", "fused_attention2_backward",
                                          "attention_mma_fwd", "attention_mma_bwd")}
    counts = {k: 0 for k in _counts()}
    results = {}
    for name, (mcfg, tcfg) in configs.items():
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        res = train(ds, mcfg, tcfg, log=lambda msg, name=name: print(f"[train {name}] {msg}", flush=True))
        torch.cuda.synchronize()
        run_counts, builds = _counts(), _builds()
        seconds = time.perf_counter() - t0
        counts = {k: counts[k] + run_counts[k] for k in counts}
        losses = [round(h["train_loss"], 6) for h in res.history]
        vals = [h["val_loss"] for h in res.history]
        steps = len(res.history) * steps_per_epoch
        print(f"[train {name}] {epochs} epochs in {seconds:.2f} s; train loss {losses}; val loss "
              f"{[round(v, 6) for v in vals]}; launches {run_counts}; W's bf16 shadow built {builds} "
              f"times in {steps} steps", flush=True)
        if not (losses[-1] < losses[0] and all(np.isfinite(vals))):
            raise AssertionError(f"train {name}: the train loss did not fall or val is not finite")
        # K4 writes W's new shadow with W: one build a run. Otherwise every
        # step's update of W makes the next K1 build one.
        most = 1 if tcfg.fused_dw_adamw else steps + 1
        if builds > most:
            raise AssertionError(f"train {name} built W's shadow {builds} times in {steps} steps, "
                                 f"want at most {most}")
        for kernel in attention_kernels.get(name, ()):
            if run_counts[kernel] <= 0:
                raise AssertionError(f"train {name} never launched {kernel}: {run_counts}")
        if name == "attn_v2_fast":
            print(f"[train {name}] bf16 attention on tensor cores: forward launched "
                  f"{run_counts['attention_mma_fwd']} times, backward {run_counts['attention_mma_bwd']}",
                  flush=True)
        results[name] = res
    for kernel in ("fused_output", "gemm_bf16_bias_clamp", "fused_output_dx", "round_bf16", "gemm_bf16_tn",
                   "fused_output_dw", "gemm_bf16_mn", "fused_dw_adamw"):
        if counts[kernel] <= 0:
            raise AssertionError(f"training never launched {kernel}: {counts}")

    # One step with kernels against the plain step: same weights, same
    # batch, dropout off, fresh moments.
    params = results["fused"].params
    idx = torch.arange(1024, device="cuda")
    batch = ds.gather_batch(idx)
    no_drop = replace(base, dropout_rate=0.0, fc_dropout_rate=0.0)
    plain_m, plain_t = replace(no_drop, use_pallas_output=False), TrainConfig()
    step_checks = {}
    for name, mcfg, tcfg in (("plain", plain_m, plain_t), ("output", no_drop, configs["output"][1]),
                             ("fused", no_drop, configs["fused"][1])):
        state = state_from_params(params, tcfg)
        state, loss = train_step(state, *batch, 1e-3, torch.Generator(device="cuda"), mcfg, tcfg)
        mu_w = state.mu_w if name == "fused" else state.mu["out_w"]
        step_checks[name] = (float(loss), mu_w.float() / float(np.float32(1) - np.float32(0.9)))
        del state
    ref_loss, ref_dw = step_checks.pop("plain")
    for name, (loss, dw) in step_checks.items():
        loss_rel = abs(loss - ref_loss) / ref_loss
        dw_rel = _rel(dw, ref_dw)
        print(f"[train] one step, {name} vs plain: loss {loss:.8f} vs {ref_loss:.8f} (rel {loss_rel:.3g}, "
              f"tol {STEP_LOSS_REL_TOL}); mu/(1-b1) of out_w max err {dw_rel:.3g} of its largest "
              f"value (tol {STEP_DW_REL_TOL})", flush=True)
        if not (loss_rel <= STEP_LOSS_REL_TOL and dw_rel <= STEP_DW_REL_TOL):
            raise AssertionError(f"one step {name} vs plain: loss rel {loss_rel}, dW rel {dw_rel}")
    del step_checks, ref_dw
    _attention_step_checks(results, batch, base, fast)

    path = os.path.join(workdir, "trained.npz")
    save_params(params, path, base)
    loaded, mcfg = load_params_with_config(path, base=base, device="cuda")
    _render_test_strings(loaded, mcfg, os.path.join(workdir, "trained_renders"), "train render")

    g = torch.Generator(device="cuda").manual_seed(9)
    batch_idx = torch.randint(0, n_samples, (8, 1024), generator=g, device="cuda")
    rates = {}
    for name, mcfg, tcfg in (("plain", replace(base, use_pallas_output=False), TrainConfig()),
                             *((k, *v) for k, v in configs.items())):
        state = state_from_params(params, tcfg)
        rates[name] = _steps_per_s(state, ds, batch_idx, mcfg, tcfg)
        if name != "plain":
            _profile_step(state, ds, batch_idx[0], mcfg, tcfg, name)
        del state
    print(f"[train] steps/s at batch 1024: {json.dumps(rates)} ({card})", flush=True)
    return counts, rates


def _cli(argv: list[str], tag: str) -> tuple[int, list[str]]:
    """Run the port's CLI in this process -> (exit code, its output lines),
    each line echoed with ``tag``."""
    import contextlib
    import io

    from ai_font_renderer_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    lines = buf.getvalue().splitlines()
    for line in lines:
        print(f"[{tag}] | {line}", flush=True)
    return rc, lines


def _check_fontgen(workdir: str) -> None:
    """6a: ``fontgen`` for 2048 FiraCode samples (data.txt the corpus, the
    BMPs read back onto the card bit-equal to the device dataset) and for
    256 Montserrat samples (the BMPs equal to the numpy oracle's u8)."""
    from ai_font_renderer_tpu_torch.config import FIRACODE_PATH, MONTSERRAT_PATH
    from ai_font_renderer_tpu_torch.fontgen import (
        bake_atlas,
        bake_prop_atlas,
        build_device_dataset,
        encode_prop_grids,
        generate_corpus,
        read_bmp,
        synthesize_prop_host,
    )
    from ai_font_renderer_tpu_torch.fontgen.dataset import device_dataset_from_disk

    out = os.path.join(workdir, "fontgen_firacode")
    t0 = time.perf_counter()
    rc, _ = _cli(["fontgen", "--num-samples", "2048", "--out", out], "fontgen")
    t_gen = time.perf_counter() - t0
    with open(os.path.join(out, "data.txt")) as f:
        if rc != 0 or f.read() != "\n".join(generate_corpus(2048)):
            raise AssertionError(f"fontgen FiraCode: exit {rc} or data.txt is not the corpus")
    t0 = time.perf_counter()
    disk = device_dataset_from_disk(out, 2048, device="cuda")
    t_read = time.perf_counter() - t0
    built = build_device_dataset(bake_atlas(FIRACODE_PATH), 2048, device="cuda")
    if not (torch.equal(disk.targets_u8, built.targets_u8) and torch.equal(disk.codes, built.codes)):
        raise AssertionError("fontgen FiraCode: the BMPs read back differ from the device dataset")
    out = os.path.join(workdir, "fontgen_montserrat")
    t0 = time.perf_counter()
    rc, _ = _cli(["fontgen", "--num-samples", "256", "--out", out, "--font", MONTSERRAT_PATH], "fontgen")
    t_prop = time.perf_counter() - t0
    atlas = bake_prop_atlas(MONTSERRAT_PATH)
    want = np.round(synthesize_prop_host(atlas, encode_prop_grids(generate_corpus(256), atlas)) * 255)
    got = np.stack([read_bmp(os.path.join(out, f"{i + 1}.bmp")) for i in range(256)])
    if rc != 0 or not np.array_equal(np.round(got * 255), want):
        raise AssertionError(f"fontgen Montserrat: exit {rc} or the BMPs differ from the numpy oracle")
    print(f"[data] fontgen: 2048 FiraCode samples written in {t_gen:.2f} s, read back onto the card in "
          f"{t_read:.2f} s, u8 equal to build_device_dataset; 256 Montserrat samples in {t_prop:.2f} s, "
          "BMPs equal to synthesize_prop_host", flush=True)


def _train_montserrat(card: str, firacode_fused: float) -> dict:
    """6b: Montserrat at full width through --kernels fused (K1, K2, K4):
    the corpus cut to 8192 samples, 2 epochs -> the launches."""
    from ai_font_renderer_tpu_torch.config import MONTSERRAT_PATH, ModelConfig, TrainConfig
    from ai_font_renderer_tpu_torch.fontgen import (
        bake_prop_atlas,
        build_device_dataset_prop,
        encode_prop_grids,
        generate_corpus,
        synthesize_prop_host,
    )
    from ai_font_renderer_tpu_torch.fontgen.proportional import _synth, prop_synth_operands
    from ai_font_renderer_tpu_torch.train import train
    from ai_font_renderer_tpu_torch.train.step import state_from_params

    n_samples, epochs, chunk = 8192, 2, 1024
    print(f"[data] Montserrat corpus cut from 150000 to {n_samples} samples "
          f"({int(n_samples * 0.8) // 1024} steps of 1024 an epoch), {epochs} epochs", flush=True)
    t0 = time.perf_counter()
    atlas = bake_prop_atlas(MONTSERRAT_PATH)
    t_bake = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = build_device_dataset_prop(atlas, n_samples, synth_batch=chunk, device="cuda")
    torch.cuda.synchronize()
    t_data = time.perf_counter() - t0
    cells_gb = chunk * atlas.n_lines * atlas.n_slots * atlas.cell_h * atlas.cell_w * 4 / 1e9
    t0 = time.perf_counter()
    grids = encode_prop_grids(generate_corpus(chunk), atlas)
    t_layout = time.perf_counter() - t0
    host = np.round(synthesize_prop_host(atlas, grids) * 255)
    diff = int((ds.targets_u8[:chunk].cpu().numpy() != host.astype(np.uint8)).sum())
    ops, grids_dev = prop_synth_operands(atlas, torch.device("cuda")), torch.from_numpy(grids).cuda()
    synth_ms = time_ms(lambda: _synth(*ops, grids_dev), 3)
    print(f"[data] Montserrat atlas {tuple(atlas.table.shape)} (stride {atlas.stride}, {atlas.n_slots} "
          f"slots, {atlas.n_lines} lines) baked in {t_bake:.2f} s; {n_samples} sheets laid out and "
          f"synthesized on the card in {t_data:.2f} s; a chunk of {chunk}: layout on the host "
          f"{t_layout:.3f} s, synthesis on the card {synth_ms:.3f} ms (CUDA events), gathered cells "
          f"{cells_gb:.3f} GB; first {chunk} u8 sheets vs numpy oracle: {diff} bytes differ ({card})",
          flush=True)
    if diff:
        raise AssertionError(f"Montserrat sheets differ from the oracle in {diff} bytes")

    mcfg = ModelConfig(use_pallas_output=True)
    tcfg = TrainConfig(num_epochs=epochs, num_samples=n_samples, checkpoint_every=0, fused_dw_adamw=True)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    res = train(ds, mcfg, tcfg, log=lambda msg: print(f"[data montserrat] {msg}", flush=True))
    torch.cuda.synchronize()
    counts, builds = _counts(), _builds()
    losses = [h["train_loss"] for h in res.history]
    vals = [h["val_loss"] for h in res.history]
    print(f"[data] Montserrat fused: {epochs} epochs in {time.perf_counter() - t0:.2f} s; train loss "
          f"{losses}; val loss {vals}; launches {counts}; W's bf16 shadow built {builds} times", flush=True)
    if not (losses[-1] < losses[0] and all(np.isfinite(vals))):
        raise AssertionError("Montserrat: the train loss did not fall or val is not finite")
    if builds > 1:
        raise AssertionError(f"Montserrat built W's shadow {builds} times, want once")
    for kernel in ("fused_output", "gemm_bf16_bias_clamp", "fused_output_dx", "round_bf16", "gemm_bf16_tn",
                   "fused_dw_adamw"):
        if counts[kernel] <= 0:
            raise AssertionError(f"Montserrat training never launched {kernel}: {counts}")
    g = torch.Generator(device="cuda").manual_seed(9)
    batch_idx = torch.randint(0, n_samples, (8, 1024), generator=g, device="cuda")
    rate = _steps_per_s(state_from_params(res.params, tcfg), ds, batch_idx, mcfg, tcfg)
    print(f"[data] steps/s at batch 1024, fused: Montserrat {rate}, FiraCode (phase 5) {firacode_fused} "
          f"({card})", flush=True)
    return counts


def _check_eval(weights: str) -> dict:
    """6c: ``eval`` of phase 5's fused weights on its 20480-sample corpus
    (4096 val sheets), with --kernels none and output -> the launches."""
    runs, counts = {}, {}
    for kernels in ("none", "output"):
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        rc, lines = _cli(["eval", "--weights", weights, "--num-samples", "20480", "--kernels", kernels], "eval")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts[kernels] = _counts()
        result = json.loads(lines[-1]) if rc == 0 and lines else {}
        keys = ["val_mse", "val_psnr_db", "val_samples", "test_strings_mse", "test_strings_psnr_db", "weights"]
        if list(result) != keys or result["val_samples"] != 4096:
            raise AssertionError(f"eval --kernels {kernels}: exit {rc}, {result}")
        runs[kernels] = result
        print(f"[data] eval --kernels {kernels}: {seconds:.2f} s; K1 launched "
              f"{counts[kernels]['fused_output']} times", flush=True)
    rel = abs(runs["output"]["val_mse"] - runs["none"]["val_mse"]) / runs["none"]["val_mse"]
    print(f"[data] eval val_mse none {runs['none']['val_mse']} vs output {runs['output']['val_mse']} "
          f"(rel {rel:.3g}, tol {EVAL_REL_TOL})", flush=True)
    if rel > EVAL_REL_TOL:
        raise AssertionError(f"eval: val_mse with K1 differs by {rel} relative")
    if counts["none"]["fused_output"] != 0 or counts["output"]["fused_output"] <= 0:
        raise AssertionError(f"eval: K1 launches none {counts['none']}, output {counts['output']}")
    return {k: counts["none"][k] + counts["output"][k] for k in counts["none"]}


def _check_truth(workdir: str) -> None:
    """6d: ``render --truth`` of the test strings for both fonts, with and
    without --hinted: 15 BMPs each (host work)."""
    from ai_font_renderer_tpu_torch.config import FIRACODE_PATH, MONTSERRAT_PATH

    for font in (FIRACODE_PATH, MONTSERRAT_PATH):
        for hinted in ([], ["--hinted"]):
            out = os.path.join(workdir, f"truth_{os.path.basename(font)}{'_hinted' if hinted else ''}")
            t0 = time.perf_counter()
            rc, _ = _cli(["render", "--truth", "--font", font, "--out", out, *hinted], "truth")
            seconds = time.perf_counter() - t0
            files = sorted(os.listdir(out)) if rc == 0 else []
            if files != sorted(f"string_{i}.bmp" for i in range(15)):
                raise AssertionError(f"render --truth {font} {hinted}: exit {rc}, files {files}")
            print(f"[data] render --truth {os.path.basename(font)} {' '.join(hinted)}: 15 BMPs in "
                  f"{seconds:.2f} s", flush=True)


def _check_pth(workdir: str, weights: str) -> dict:
    """6e: phase 5's fused weights through a .pth, rendered with phase 3's
    flags (K1, f32 K5): the sheets equal the npz's bit for bit -> the
    launches of the .pth render."""
    from ai_font_renderer_tpu_torch.cli import TEST_STRINGS
    from ai_font_renderer_tpu_torch.config import replace
    from ai_font_renderer_tpu_torch.render import render_batch
    from ai_font_renderer_tpu_torch.utils.checkpoint import load_params_with_config, save_params

    flags = dict(use_pallas_output=True, fused_attention=True)
    params, mcfg = load_params_with_config(weights, device="cuda")
    pth = os.path.join(workdir, "trained.pth")
    save_params(params, pth)
    from_npz = render_batch(params, TEST_STRINGS, replace(mcfg, **flags))
    del params
    torch.cuda.synchronize()
    _reset_counts()
    params, pcfg = load_params_with_config(pth, device="cuda")
    from_pth = render_batch(params, TEST_STRINGS, replace(pcfg, **flags))
    torch.cuda.synchronize()
    counts = _counts()
    print(f"[data] .pth render of the test strings: launches {counts}; sheets equal the npz's: "
          f"{np.array_equal(from_pth, from_npz)}", flush=True)
    if not np.array_equal(from_pth, from_npz) or from_pth.shape != (15, 80, 240):
        raise AssertionError("the .pth render differs from the npz render")
    for name in ("fused_output", "gemm_bf16_bias_clamp", "fused_attention"):
        if counts[name] <= 0:
            raise AssertionError(f"the .pth render never launched {name}: {counts}")
    return counts


def _train_wide_shapes(card: str) -> dict:
    """6f: a full-width model at the shapes the register-tiled attention
    kernels do not take (E = 64; S = 129), with each fused attention flag:
    two training steps at dropout 0.2 through the general kernels, then one
    step with dropout off against the plain step on the same weights and
    batch (loss, and the attention weights' gradients, as phase 5's
    attention step checks) -> the launches."""
    from ai_font_renderer_tpu_torch.config import ModelConfig, TrainConfig, replace
    from ai_font_renderer_tpu_torch.models import font_renderer
    from ai_font_renderer_tpu_torch.ops.fused_attention import KEYS
    from ai_font_renderer_tpu_torch.train.step import state_from_params, train_step

    bsz = 256
    one_minus_b1 = float(np.float32(1) - np.float32(0.9))
    counts = {k: 0 for k in _counts()}
    for (s, e, heads), flag in ((shape, flag) for shape in WIDE_SHAPES
                                for flag in ("fused_attention", "fused_attention_v2")):
        mcfg = ModelConfig(max_length=s, embedding_dim=e, num_heads=heads, **{flag: True})
        gen = torch.Generator(device="cuda").manual_seed(s + e)
        params = font_renderer.init(gen, mcfg, "cuda")
        codes = torch.randint(32, 127, (bsz, s), generator=gen, device="cuda", dtype=torch.int32)
        targets = torch.rand(bsz, mcfg.sheet_height, mcfg.sheet_width, generator=gen, device="cuda")
        tcfg = TrainConfig(batch_size=bsz, adam_mu_bf16=False)
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        state = state_from_params(params, tcfg)
        losses = []
        for _ in range(2):
            state, loss = train_step(state, codes, targets, 1e-3, gen, mcfg, tcfg)
            losses.append(float(loss))
        del state
        off = dict(dropout_rate=0.0, fc_dropout_rate=0.0)
        out = []
        for cfg in (replace(mcfg, **off), replace(mcfg, fused_attention=False, fused_attention_v2=False, **off)):
            state, loss = train_step(state_from_params(params, tcfg), codes, targets, 1e-3,
                                     torch.Generator(device="cuda"), cfg, tcfg)
            out.append((float(loss), {k: state.mu[k] / one_minus_b1 for k in KEYS}))
            del state
        torch.cuda.synchronize()
        run = _counts()
        counts = {k: counts[k] + run[k] for k in counts}
        (loss, grads), (ref_loss, ref_grads) = out
        loss_rel = abs(loss - ref_loss) / ref_loss
        scale = max(float(v.abs().max()) for v in ref_grads.values())
        grad_rel = max(float((grads[k] - ref_grads[k]).abs().max()) for k in KEYS) / scale
        entry = "fused_attention2" if flag == "fused_attention_v2" else "fused_attention"
        print(f"[data] S={s}, E={e}, H={heads}, {flag}: losses at dropout 0.2 {losses} in "
              f"{time.perf_counter() - t0:.2f} s; one step vs plain, dropout off: loss {loss:.8f} vs "
              f"{ref_loss:.8f} (rel {loss_rel:.3g}, tol {STEP_LOSS_REL_TOL}), gradient of wq..bo max err "
              f"{grad_rel:.3g} of the largest (tol {STEP_ATTN_GRAD_TOL['f32']}); launches {entry} "
              f"{run[entry]}, attention_wide_fwd {run['attention_wide_fwd']}, attention_wide_bwd "
              f"{run['attention_wide_bwd']} ({card})", flush=True)
        if not (all(np.isfinite(losses)) and loss_rel <= STEP_LOSS_REL_TOL
                and grad_rel <= STEP_ATTN_GRAD_TOL["f32"]):
            raise AssertionError(f"S={s} E={e} {flag}: losses {losses}, loss rel {loss_rel}, grad rel {grad_rel}")
        if min(run[entry], run["attention_wide_fwd"], run["attention_wide_bwd"]) < 3:
            raise AssertionError(f"S={s} E={e} {flag}: three steps did not take the general kernels: {run}")
        del params, codes, targets
    return counts


def phase_data(workdir: str, card: str, firacode_fused: float) -> dict:
    """Phase 6: data and weights through the port's entry points: fontgen,
    Montserrat training, eval, render --truth and .pth weights; then
    training at the attention shapes the general kernels serve -> the
    launches of its main paths."""
    weights = os.path.join(workdir, "trained.npz")  # phase 5's fused weights
    seconds = {}
    t0 = time.perf_counter()
    _check_fontgen(workdir)
    seconds["fontgen"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    counts = [_train_montserrat(card, firacode_fused)]
    seconds["montserrat"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    counts.append(_check_eval(weights))
    seconds["eval"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _check_truth(workdir)
    seconds["truth"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    counts.append(_check_pth(workdir, weights))
    seconds["pth"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    counts.append(_train_wide_shapes(card))
    seconds["wide_shapes"] = time.perf_counter() - t0
    print(f"[data] seconds by check: {json.dumps({k: round(v, 2) for k, v in seconds.items()})}", flush=True)
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def _kernel_entry(name, source, replaces, rows, headline, launches, shadow=False) -> dict:
    """The kernels line's entry: the row ``headline``'s numbers, or with
    ``shadow`` those of its variant that writes W's bf16 shadow (the one
    the training step launches)."""
    head = next(r for r in rows if r["shape"] == headline)
    if shadow:
        head = {**head, "ms": head["shadow_ms"], "bound_ms": head["bound_shadow_ms"],
                "bound_by": head["bound_shadow_by"], "library_ms": head["library_shadow_ms"]}
        headline += ",shadow"
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "shape": headline,
        "by_shape": rows,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    import ai_font_renderer_tpu_torch  # noqa: F401  (fails outside the repo)
    from ai_font_renderer_tpu_torch.device import resolve_device

    t_start = time.perf_counter()
    resolve_device("cuda")
    card = _nvidia_smi()
    print(card, flush=True)
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}", flush=True)
    phase_times = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_times[name] = round(time.perf_counter() - t0, 2)
        print(f"[phase] {name}: {phase_times[name]} s", flush=True)
        return out

    timed("build", phase_build)
    k1_rows, k1_gemm_rows, round_rows = timed("check K1", check_fused_output)
    attn_rows = timed("check attention", check_fused_attention)
    drop_rows = timed("check attention dropout", check_attention_dropout)
    k6_rows, k8_rows = timed("check K6/K8", check_attention_backward)
    wide_fwd_rows, wide_bwd_rows = timed("check general attention", check_attention_wide)
    dx_rows, dw_rows, gemm_rows, mn_rows = timed("check K2/K3", check_backward, round_rows)
    k4_rows = timed("check K4", check_dw_adamw)
    k9_rows = timed("check K9", check_dw_adamw_xt)

    with tempfile.TemporaryDirectory() as workdir:
        params, render_counts = timed("render", phase_render, workdir, card)
        serve_counts = timed("serve", phase_serve, params, workdir)
        del params
        train_counts, rates = timed("train", phase_train, workdir, card)
        data_counts = timed("data and weights", phase_data, workdir, card, rates["fused"])
    ab_counts = timed("ab_xt", phase_ab_xt)
    by_phase = {"render": render_counts, "serve": serve_counts, "train": train_counts, "data": data_counts}
    print(f"[launches] by phase: {json.dumps(by_phase)}", flush=True)
    launches = {k: sum(c[k] for c in by_phase.values()) for k in render_counts}
    launches["fused_dw_adamw_xt"] = ab_counts["fused_dw_adamw_xt"]

    src = "ai_font_renderer_tpu_torch/csrc/"
    kernels = [
        _kernel_entry(
            "fused_output_fwd", src + "fused_output.cu",
            "ai_font_renderer_tpu/ops/fused_output.py:47", k1_rows,
            "M=1024,K=6400,N=19200", launches["fused_output"],
        ),
        _kernel_entry(
            "gemm_bf16_bias_clamp (K1 GEMM)", src + "sm90_gemm.cuh",
            "ai_font_renderer_tpu/ops/fused_output.py:47", k1_gemm_rows,
            "M=1024,K=6400,N=19200", launches["gemm_bf16_bias_clamp"],
        ),
        _kernel_entry(
            "attention_f32_fwd (v1 entry point in f32, K5; a cluster of H blocks a sample)",
            src + "fused_attention.cu",
            "ai_font_renderer_tpu/ops/fused_attention.py:65",
            # The f32 rows: K5's, then K7's f32 build (the same kernel).
            [r for r in attn_rows if r["shape"].endswith("float32")]
            + [r for n, r in drop_rows if "float32" in r["shape"]],
            f"B=1024,S=100,E=32,H=4,float32,dropout={DROPOUT}", launches["fused_attention"],
        ),
        _kernel_entry(
            "fused_attention2_fwd (v2 entry point, K7)", src + "attention_mma.cu",
            "ai_font_renderer_tpu/ops/fused_attention.py:374",
            [r for r in attn_rows if r["shape"].endswith("bfloat16")]
            + [r for n, r in drop_rows if n.startswith("K7") and "bfloat16" in r["shape"]],
            f"B=1024,S=100,E=32,H=4,bfloat16,dropout={DROPOUT}", launches["fused_attention2"],
        ),
        _kernel_entry(
            "attention_f32_bwd (v1 in f32, mask regenerated, K6; a cluster of H blocks a sample)",
            src + "fused_attention.cu",
            "ai_font_renderer_tpu/ops/fused_attention.py:122",
            [r for r in k6_rows + k8_rows if "float32" in r["shape"]],
            f"B=1024,S=100,E=32,H=4,float32,dropout={DROPOUT}", launches["fused_attention_backward"],
        ),
        _kernel_entry(
            "fused_attention2_bwd (v2, mask read, K8)", src + "attention_mma.cu",
            "ai_font_renderer_tpu/ops/fused_attention.py:427",
            [r for r in k8_rows if "bfloat16" in r["shape"]],
            f"B=1024,S=100,E=32,H=4,bfloat16,dropout={DROPOUT}", launches["fused_attention2_backward"],
        ),
        _kernel_entry(
            "attention_mma_fwd (bf16 K5/K7 on tensor cores)", src + "attention_mma.cu",
            "ai_font_renderer_tpu/ops/fused_attention.py:374",
            [r for r in attn_rows if r["shape"].endswith("bfloat16")]
            + [r for n, r in drop_rows if r["shape"].endswith("bfloat16,dropout=0.2")],
            f"B=1024,S=100,E=32,H=4,bfloat16,dropout={DROPOUT}", launches["attention_mma_fwd"],
        ),
        _kernel_entry(
            "attention_mma_bwd (bf16 K6/K8 on tensor cores)", src + "attention_mma.cu",
            "ai_font_renderer_tpu/ops/fused_attention.py:427",
            [r for r in k8_rows + k6_rows if "bfloat16" in r["shape"]],
            f"B=1024,S=100,E=32,H=4,bfloat16,dropout={DROPOUT}", launches["attention_mma_bwd"],
        ),
        _kernel_entry(
            "attention_wide_fwd (K5/K7 at other shapes, f32 and bf16)", src + "attention_wide.cu",
            "ai_font_renderer_tpu/ops/fused_attention.py:65", wide_fwd_rows,
            f"B=1024,S=100,E=64,H=4,float32,dropout={DROPOUT}", launches["attention_wide_fwd"],
        ),
        _kernel_entry(
            "attention_wide_bwd (K6/K8 at other shapes, f32 and bf16)", src + "attention_wide.cu",
            "ai_font_renderer_tpu/ops/fused_attention.py:122", wide_bwd_rows,
            f"B=1024,S=100,E=64,H=4,float32,dropout={DROPOUT}", launches["attention_wide_bwd"],
        ),
        _kernel_entry(
            "fused_output_dx", src + "fused_output.cu",
            "ai_font_renderer_tpu/ops/fused_output.py:96", dx_rows,
            "M=1024,K=6400,N=19200", launches["fused_output_dx"],
        ),
        _kernel_entry(
            "round_bf16 (operand pass of K1, K2 and K3; W's shadow)", src + "fused_output.cu",
            "ai_font_renderer_tpu/ops/fused_output.py:96", round_rows,
            "w K=6400,N=19200", launches["round_bf16"],
        ),
        _kernel_entry(
            "gemm_bf16_tn (K2 GEMM)", src + "sm90_gemm.cuh",
            "ai_font_renderer_tpu/ops/fused_output.py:96", gemm_rows,
            "M=1024,K=6400,N=19200", launches["gemm_bf16_tn"],
        ),
        _kernel_entry(
            "fused_output_dw", src + "fused_output.cu",
            "ai_font_renderer_tpu/ops/fused_output.py:142", dw_rows,
            "M=1024,K=6400,N=19200", launches["fused_output_dw"],
        ),
        _kernel_entry(
            "gemm_bf16_mn (K3 GEMM)", src + "sm90_gemm.cuh",
            "ai_font_renderer_tpu/ops/fused_output.py:142", mn_rows,
            "M=1024,K=6400,N=19200", launches["gemm_bf16_mn"],
        ),
        _kernel_entry(
            "fused_dw_adamw", src + "fused_dw_adamw.cu",
            "ai_font_renderer_tpu/ops/fused_dw_adamw.py:55", k4_rows,
            "M=1024,K=6400,N=19200,mu=bf16", launches["fused_dw_adamw"], shadow=True,
        ),
        _kernel_entry(
            "fused_dw_adamw_xt (K9)", src + "fused_dw_adamw.cu",
            "tools/ab_kernel_micro.py:91", k9_rows,
            "M=1024,K=6400,N=19200,mu=bf16,xt", launches["fused_dw_adamw_xt"],
        ),
    ]
    print(f"[phase] seconds by phase: {json.dumps(phase_times)}", flush=True)
    print(f"[done] {time.perf_counter() - t_start:.1f} s in all", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--step-memory"]:
        sys.exit(step_memory())
    if sys.argv[1:2] == ["--serve-repeats"] and len(sys.argv) == 3:
        sys.exit(serve_repeats(int(sys.argv[2])))
    sys.exit(main())
