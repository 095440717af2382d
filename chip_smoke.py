#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check what comes out.

    python3 chip_smoke.py
    python3 chip_smoke.py --step-memory   # only the peak memory of one training step
    python3 chip_smoke.py --serve-repeats N   # only phase 4's requests, on N servers
    python3 chip_smoke.py --mesh-only       # only the build and phase 11, the device mesh
    python3 chip_smoke.py --tools-only      # only the build and phases 12 and 13, the tools

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
   shadow, against the dW product + torch._fused_adamw_).
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
7. Decoders and int8: (a) the conv decoders' f32 forward at the default
   plan (B = 15) on the card against the CPU, then `conv_ps` and `conv`
   trained at full width on phase 5's corpus (3 epochs each, batch 1024)
   through the f32 attention kernels (K5/K6), `conv_ps` also with the fast
   profile through K7/K8 and with no kernel; steps/s beside phase 5's
   linear `fused` and `attn_v1`; (b) the `conv_ps` npz through `render`
   and `eval`, the test strings with K5 against the plain path, one request
   through a RenderServer (bf16 frontend, K7) byte-equal to a direct
   render; (c) phase 5's `fused` weights in int8: the int32 accumulators
   at M = 15, 64 and 1024 equal to the f64 plain product, the times of the
   product (cuBLASLt's, through torch._int_mm), the activations'
   quantization, the epilogue and K1, the sheets within the JAX package's
   mean bound of the default forward and each pixel within the
   quantization's bound of exact f32 products, `render --int8`, the
   4096-sheet atlas in int8 beside K1's, phase 4's requests on an int8
   server byte-equal to a direct int8 render.
8. The implicit render path on the committed artifacts (artifacts/*/:
   SIREN bank hidden 128, 4 layers, cell 64; placement net E 64, H 8,
   hidden 128), both fonts: (a) the 15 test strings through each pair
   (soft decode) within 1e-4 of golden_mse.json per string and under the
   mean bound, the kerned engine-layout oracle under its bound, both
   against the CPU's sheets, two card renders bit-equal; (b) `render
   --implicit --placement` in this process with `--hard-placement`,
   `--monotone-placement`, `--baked 4`, `--phased 8` and `--scale 4`, 15
   BMPs each, and the argmax and monotone line indices on the card equal
   to the CPU's; (c) the nets with each fused attention flag at B = 15 and
   1024 against the plain attention, through the general attention
   forward (E = 64, H = 8), and that forward alone at B = 1024, rate 0,
   f32 and bf16, timed; (d) glyphs/s of the fully neural render (exact at
   256 sheets, baked 4 at 1024, phased 8 at 1024 and 4096, each split into
   host, net, bake and composite) and of the engine-layout phased render
   at 1024, and the exact compose's peak device memory.
9. Export (utils/export.py, the CLI's `export`): (a) phase 3's weights
   exported with K1 and the f32 K5 as operators in the graph, loaded onto
   the card: the 15 test strings u8-equal to the direct render (and
   `render --exported`'s BMPs within a gray level of phase 3's), the same
   weights exported with no kernel (f32 W), batches 1, 15, 64 and 1024
   from the one artifact, each one launch of K1 and of the f32 K5 kernel,
   the 4096-sheet atlas (codes encoded once) in glyphs/s through the
   artifact and through the same ops eagerly, in turns, each profiled
   once, beside phase 3's, the artifacts' MB and their export and load
   seconds; (b) phase 5's
   weights exported in int8, u8-equal to the direct int8 render; phase
   4's serve config (bf16 frontend, K1, K7) exported and served by `serve
   --exported` in a subprocess, phase 4's requests byte-equal to
   render_exported, latencies beside phase 4's; (c) both committed pairs
   exported soft, FiraCode also with --monotone-placement and with the
   net's attention through the general K5 forward: the test strings
   u8-equal to the direct card render, the soft ones within
   golden_mse.json; (d) the standalone runner in a subprocess on the
   card, its BMPs equal to `render --exported`'s.
10. Placement and implicit training (train/placement_cli.py,
   train/implicit.py): (a) `train-placement` through the CLI in this
   process: FiraCode at the committed nets' capacity (line head 5, E 64,
   H 8, hidden 128) with `--kernels attention`, 20480 samples, 2 epochs at
   batch 1024 (the val RMSE must fall), the full SIREN bank for 300 steps,
   the joint fine-tune for 100 steps at batch 64 with a checkpoint at step
   50 (the e2e rows finite), then that fine-tune resumed from step 50 (the
   last pixel MSE within 1e-4 relative and the first equal; whether the
   tuned files are bit-equal is printed), Montserrat's structured head
   with `--kernels attention_v2` and FiraCode at the CLI's default dims (E
   32, H 4: the cluster kernels) with `--kernels attention`, 10240
   samples, 1 epoch each; the stage seconds and steps/s; (b) one
   supervised step (batch 1024) and one joint fine-tune step (batch 64)
   with each fused attention flag against the plain attention at dropout
   0, at E 64, H 8 (the general build) and E 32, H 4 (the cluster
   kernels): loss within STEP_LOSS_REL_TOL, the attention weights'
   gradients within STEP_ATTN_GRAD_TOL["f32"] of the largest; steps/s of
   the supervised step with each flag at dropout 0.2, one profiled step,
   the fine-tune step's steps/s and peak device memory; (c) train_siren
   at full size, train_multifont on both fonts and train_siren in SDF mode
   on 16 glyphs, 200 steps each, the loss falling, steps/s; (d) the
   general attention forward and backward at B 1024, S 100, E 64, H 8,
   rate 0.2, f32, against their plain versions, timed beside the library
   and the bound.
11. The device mesh (parallel/): (a) a step through the mesh code on a
   (1, 1) mesh with the output kernels at dropout 0.2, its loss, parameters
   and moments bit-equal to the plain step's, and the steps/s of both in
   turns (P M M P), the median of the per-turn ratios (each mesh run over
   the plain run beside it) within 3%; (b) two ranks of this script (`--mesh-rank`) share the
   card over gloo (NCCL refuses two ranks on one device), full width,
   batch 1024, 512 a rank: the (2, 1) and (1, 2) meshes with K1/K2/K3 on
   each rank (at (1, 2) on a column shard, N = 9600), the explicit DP step
   with `attn_v1`'s model (K1/K2/K3, K5/K6 in f32) and with `attn_v2_fast`'s
   (K7/K8 in bf16); each at dropout 0 against the one-process step on the
   same weights and batch (loss rtol 2e-5, out_b atol 2e-5, every leaf's
   gradient within MESH_GRAD_REL_TOL of its largest), then at dropout 0.2,
   where the loss must fall, and steps/s; (c) the (1, 2) run's checkpoint,
   written by rank 0 in the one-device format, restored on one device with
   the ranks' parameters bit for bit; (d) `--mesh 2,1` on one card exits 1
   with make_mesh's message. `--mesh-only` runs the build and this phase
   alone.
12. The measurement tools (ai_font_renderer_tpu_torch/tools/), each in
   this process at its JAX tool's shapes, only iteration counts cut, every
   JSON line it prints parsed: ab_kernel_micro (K9's home: the library dW
   + AdamW, K4 and K9, which must launch), trace_step of the `fused`,
   `attn_v1` and `attn_v2_fast` steps (each device's busy + idle within
   1e-3 ms of its span), profile_train, ab_profiles, roofline_bwd,
   ab_fused, ab_fused_attention, bench_inference, bench_batch_sweep,
   bench_serve (a reply byte-equal to a direct render) and
   bench_neural_render; the seconds of each. `--tools-only` runs the build
   and phases 12 and 13.
13. The rest of the tools, each in this process at its JAX tool's shapes
   (batch 1024, full widths; only iterations, steps and corpora cut, the
   runners' corpora to 4096 samples and 1 epoch), every JSON line parsed
   and checked: ab_fa2 (v2 against the plain attention within the
   attention bounds; K5/K6 and K7/K8 launched), ab_serving_tiers with K1 and
   f32 K5 (each tier's sheets within the int8 mean bound of fp32's),
   ab_hard_decode on both committed pairs (the soft decode's per-string MSE
   within 1e-4 of golden_mse.json), eval_decode_modes through the general
   attention forward, bench_sdf_atlas over FiraCode's whole printable
   Unicode, render_implicit_demo, run_extended_configs (configs 2-5), the
   Montserrat runners (converged with `fused`, conv with K5/K6, conv_ps
   with K7/K8, conv_ps --wide, and hc: 307M parameters, its first loss
   finite), fast60, h2h_ours on a `fontgen` disk dataset of 512,
   refresh_artifacts --dry-run (its e2e MSE within 1e-4 of the golden mean,
   the exported artifact u8-equal to the direct render), summarize_run on
   the converged run, round4_task5 (two traces, busy + idle = span); the
   seconds of each.
14. One JSON line listing every kernel (K1-K9, the operand pass, the
   GEMMs of K2 and K3, the bf16 attention forward and backward on
   tensor cores, and the general attention forward and backward) with its
   launches on the main paths (phases 3-13, both mesh ranks' included;
   counts are set to 0 just before each drive and read just after), its
   error and its times.

Every profiled call (the atlas, a training step, a placement step, the
joint fine-tune step) goes through utils/profiling.trace and must hold
each port kernel as many times as its launch counter rose during it.

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
    from ai_font_renderer_tpu_torch.ops import (
        _build,
        attention_mma_attributes,
        attention_wide_attributes,
        fused_attention_attributes,
    )
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
    for s, e, heads in WIDE_SHAPES + tuple(shape for shape, _ in WIDE_EXTRA):
        print(f"[build] general attention (K5-K8 at other shapes) at S={s}, E={e}, H={heads}: rows a chunk of "
              f"the on-chip build (0: streamed), shared memory, threads, blocks an SM: "
              f"{json.dumps(attention_wide_attributes(s, e, heads))}", flush=True)
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
# register-tiled kernels, in both dtypes; and (WIDE_EXTRA) the placement
# net's E = 64, H = 8 in bf16 (phase 10 times it in f32) and a head width
# of 24, not a power of two, in both.
WIDE_SHAPES = ((100, 64, 4), (129, 32, 4))
WIDE_EXTRA = (((100, 64, 8), (torch.bfloat16,)), ((100, 48, 2), (torch.float32, torch.bfloat16)))
# The general kernels' bf16 forward against the plain one, relative to the
# largest |plain| value as the backward's: q, k, v and out are rounded once
# here and twice (after the product, after the bias) in the plain version,
# and with E = 64 or S = 300 an output may round 4 bf16 steps away.
WIDE_FWD_BF16_REL_TOL = 2e-2


def check_attention_wide(bsz=1024, shapes=WIDE_SHAPES, dtypes=(torch.float32, torch.bfloat16), extra=WIDE_EXTRA
                         ) -> tuple[list[dict], list[dict]]:
    """The general attention kernels (csrc/attention_wide.cu) at the shapes
    the register-tiled ones do not take, at dropout 0.2, in ``dtypes``: the
    forward with the mask stored (K7's general build) and drawn (K5's)
    against the plain forward fed the plain mask, the stored mask byte for
    byte; the backward with the mask read (K8's) and regenerated (K6's)
    against fused_attention_backward_reference within ATTN_BWD_TOL, the
    two giving the same bits; then the ``extra`` shapes in their own
    dtypes. Each row carries the build's plan (query rows a chunk, 0 for
    the streamed build)."""
    from ai_font_renderer_tpu_torch.ops.fused_attention import (
        attention_wide_bwd,
        attention_wide_fwd,
        attention_wide_plan,
        fused_attention_backward_reference,
        fused_attention_reference,
    )
    from ai_font_renderer_tpu_torch.ops.philox import dropout_keep

    g = torch.Generator(device="cuda").manual_seed(14)
    seed = torch.tensor([11], dtype=torch.int32, device="cuda")
    fwd_rows, bwd_rows = [], []
    for (s, e, heads), dts in [(shape, dtypes) for shape in shapes] + list(extra):
        w = _attn_weights(g, e)
        mask_shape = (bsz, heads, s, s)
        mask = dropout_keep(seed, mask_shape, DROPOUT).to(torch.uint8)
        for dt in dts:
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
                "chunk_rows": attention_wide_plan(s, e, heads, dt, False)["rows"],
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
                "chunk_rows": attention_wide_plan(s, e, heads, dt, True)["rows"],
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


def phase_ab_xt() -> dict:
    """The K4/K9 A/B of ai_font_renderer_tpu_torch/tools/ab_kernel_micro.py,
    K9's home and the only path that runs it, at its full shapes with the
    JAX tool's tile arguments and ``xt`` -> its launches."""
    from ai_font_renderer_tpu_torch.tools import ab_kernel_micro

    torch.cuda.synchronize()
    _reset_counts()
    ab_kernel_micro.main(["256", "640", "384", "xt"])
    torch.cuda.synchronize()
    counts = _counts()
    if counts["fused_dw_adamw_xt"] <= 0 or counts["fused_dw_adamw"] <= 0:
        raise AssertionError(f"ab_kernel_micro never launched K9 or K4: {counts}")
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
        "gather_rows_backward": ops.gather_rows_backward,
    }


def _reset_counts():
    from ai_font_renderer_tpu_torch.ops import bf16_shadow, gather_rows_backward

    for fn in _kernel_fns().values():
        fn.launches = 0
    gather_rows_backward.ordered_launches = 0
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
    from ai_font_renderer_tpu_torch.fontgen.layout import encode_codes
    from ai_font_renderer_tpu_torch.render import render_atlas

    t0 = time.perf_counter()
    encode_codes(strings, mcfg.max_length)
    encode_ms = (time.perf_counter() - t0) * 1e3
    _profile_fn(f"atlas {len(strings)} (host encode {encode_ms:.2f} ms)", lambda: render_atlas(params, strings, mcfg),
                top=6)


def _profile_fn(tag: str, fn, top: int = 5) -> dict:
    """One profiled call of ``fn`` through utils.profiling.trace, ending in
    a sync: its wall time, the device's kernel time, launches and busy
    share, and the kernels that took most, all from the Chrome trace's
    kernel records, beside how many of them the profiler's own table
    (``prof.events()``) holds and how many of the trace's opening kernels
    it kept; the trace must hold each port kernel as many times as its
    launch counter rose during the call. Returns {port kernel: launches}."""
    from torch.autograd import DeviceType

    from ai_font_renderer_tpu_torch.utils.profiling import (
        OPENING_KERNELS,
        check_launches,
        device_kernels,
        launch_counts,
        opening_kernels,
        trace,
        trace_events,
    )

    with tempfile.TemporaryDirectory() as log_dir:
        with trace(log_dir) as prof:
            before = launch_counts()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            after = launch_counts()
        events = trace_events(log_dir)
    kernels = device_kernels(events)
    table = [e for e in prof.events()
             if e.device_type == DeviceType.CUDA and not e.name.startswith(("Memcpy", "Memset"))
             and "spin_kernel" not in e.name]
    by_name = {}
    for k in kernels:
        us, n = by_name.get(k["name"], (0.0, 0))
        by_name[k["name"]] = (us + k["dur"], n + 1)
    busy_ms = sum(us for us, _ in by_name.values()) / 1e3
    print(f"[profile] {tag}: wall {wall_ms:.2f} ms (profiled), device kernels {busy_ms:.2f} ms in {len(kernels)} "
          f"launches (the profiler's table holds {len(table)}), busy share {busy_ms / wall_ms:.3f}; the trace kept "
          f"{opening_kernels(events)} of its {OPENING_KERNELS} opening kernels", flush=True)
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"[profile]   {us / 1e3:9.3f} ms  {n:4d}x  {name[:90]}", flush=True)
    try:
        launched = check_launches([k["name"] for k in kernels], before, after)
    except AssertionError:
        # What the trace holds of the port's launches: the runtime calls
        # that launched them and the kernels' records, in time order.
        ours = [(e["ts"], e.get("cat"), e["name"][:60]) for e in events
                if e.get("ph") == "X" and (e.get("cat") == "cuda_runtime" and "LaunchKernelEx" in e["name"]
                                           or "attention" in e["name"] or "sm90::" in e["name"])]
        print(f"[profile]   trace records of the port's launches: {json.dumps(sorted(ours))}", flush=True)
        raise
    print(f"[profile]   every port kernel's launches in the trace, as counted: {json.dumps(launched)}", flush=True)
    return launched


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


def phase_render(workdir: str, card: str) -> tuple[dict, dict, float]:
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
    atlas_gps = gps[len(gps) // 2]
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
    return loaded, counts, atlas_gps


SERVE_REQUESTS = {
    "short": ["HELLO", "SERVE ME", ""],
    "mid": _atlas_strings(17, 40, seed=1),
    "long": _atlas_strings(150, 100, seed=2),  # more than one 64-string batch
}


def _serve_config():
    from ai_font_renderer_tpu_torch.config import ModelConfig

    return ModelConfig(use_pallas_output=True, fused_attention_v2=True, bf16_frontend=True)


def _serve_once(params, sock: str, int8: bool = False) -> tuple[dict, dict, dict]:
    """One server of batch 64 (``int8``: serving the projection in int8)
    and the three SERVE_REQUESTS sent at once:
    (replies, latency ms from send to last reply byte, stalls). ``stalls``
    holds what could hold back all three at once, from just before the sends
    to the last reply: the garbage collector's pauses ([generation, ms]),
    the caching allocator's new device segments and retries, and each of the
    dispatcher's render calls as [host ms since the sends, ms it took]."""
    from ai_font_renderer_tpu_torch.render.server import RenderServer, request_render

    srv = RenderServer(params, _serve_config(), socket_path=sock, batch_size=64, int8=int8)
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


def phase_serve(params, workdir: str) -> tuple[dict, dict]:
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
    return counts, latency_ms


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
    ``output`` and ``fused`` configurations and with the ``conv_ps``
    decoder (plain), weights from a seed and a random batch (no corpus), so
    the figure is the model, its state and the step alone (the linear
    model's weights stay allocated during the conv_ps step); then over one
    1024-sheet atlas chunk rendered with K1 and the attention forward
    (weights, W's bf16 shadow, activations)."""
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
    conv = ModelConfig(decoder="conv_ps")
    state = state_from_params(font_renderer.init(torch.Generator(device="cuda").manual_seed(0), conv, "cuda"),
                              TrainConfig())
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        train_step(state, codes, targets, 1e-3, gen, conv, TrainConfig())
    torch.cuda.synchronize()
    peaks["conv_ps"] = torch.cuda.max_memory_allocated() / 2**20
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
    stalls (see _serve_once). It reads no counter of the kernels but the
    atlas profile's launch check, so it runs on a tree of the port that
    has utils/profiling.py."""
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
    """One training step under _profile_fn, the 12 kernels that take the
    most device time."""
    from ai_font_renderer_tpu_torch.train.step import train_step

    gen = torch.Generator(device="cuda").manual_seed(8)
    batch = ds.gather_batch(idx)
    torch.cuda.synchronize()
    _profile_fn(f"train step ({name})", lambda: train_step(state, *batch, 1e-3, gen, mcfg, tcfg), top=12)


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


def phase_train(workdir: str, card: str) -> tuple[dict, dict, object]:
    """Phase 5: the trainer at full width through ``train()``, in four
    kernel configurations, then the checks around it -> (launches, steps/s
    by configuration, the corpus)."""
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
    return counts, rates, ds


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


# Phase 7: the conv decoders and int8 serving. f32 conv decoder, card (cuDNN,
# TF32 off) against the CPU: sums in another order; TF32 would show as about
# 1e-3.
CONV_FWD_TOL = 1e-5
# int8 sheets against the model's default forward: the JAX package's own
# bounds (tests/test_quantized.py:56-57); the mean is held to its bound,
# the most is printed beside its own (see _int8_serving).
INT8_MAX_TOL, INT8_MEAN_TOL = 4 / 255, 0.5 / 255
INT8_TENSOR_OPS = 1979e12  # dense int8 tensor-core peak, the same data sheet


def _conv_forward_check(card: str) -> None:
    """7a: each conv decoder's f32 forward at the default plan on the 15
    test strings, on the card against the CPU with the same parameters:
    before the clamp and after it."""
    from ai_font_renderer_tpu_torch.cli import TEST_STRINGS
    from ai_font_renderer_tpu_torch.config import ModelConfig
    from ai_font_renderer_tpu_torch.fontgen.layout import encode_codes
    from ai_font_renderer_tpu_torch.models import font_renderer

    codes = torch.from_numpy(encode_codes(TEST_STRINGS, 100))
    for decoder in ("conv", "conv_ps"):
        mcfg = ModelConfig(decoder=decoder, bf16_matmul=False)
        params = font_renderer.init(torch.Generator().manual_seed(11), mcfg, "cpu")
        dev = {k: v.cuda() for k, v in params.items()}
        flat = font_renderer.frontend(params, codes, mcfg)
        got = font_renderer.conv_decode(dev, flat.cuda(), mcfg).cpu()
        err = float((got - font_renderer.conv_decode(params, flat, mcfg)).abs().max())
        sheets = font_renderer.apply(dev, codes.cuda(), mcfg).cpu()
        sheet_err = float((sheets - font_renderer.apply(params, codes, mcfg)).abs().max())
        print(f"[decoders] {decoder} f32 forward, B=15, card vs CPU: before the clamp max abs err {err:.3g}, "
              f"sheets {sheet_err:.3g} (tol {CONV_FWD_TOL}); {font_renderer.param_count(params)} parameters",
              flush=True)
        if not (tuple(got.shape) == (15, 80, 240) and err <= CONV_FWD_TOL and sheet_err <= CONV_FWD_TOL):
            raise AssertionError(f"{decoder} forward on the card: err {err}, sheets {sheet_err}, {tuple(got.shape)}")


def _train_conv(ds, workdir: str, card: str, rates: dict) -> tuple[dict, str]:
    """7a: the conv decoders trained at full width through train() on
    phase 5's corpus, 3 epochs each, then steps/s and a profiled step ->
    (launches, the path of the conv_ps npz)."""
    from ai_font_renderer_tpu_torch.config import ModelConfig, TrainConfig
    from ai_font_renderer_tpu_torch.train import train
    from ai_font_renderer_tpu_torch.train.step import state_from_params
    from ai_font_renderer_tpu_torch.utils.checkpoint import save_params

    n_samples = ds.num_samples
    tcfg = TrainConfig(num_epochs=3, num_samples=n_samples, checkpoint_every=0)
    v1 = ("fused_attention", "fused_attention_backward")
    configs = {
        "conv_ps_attn_v1": (ModelConfig(decoder="conv_ps", fused_attention=True), v1),
        "conv_ps_attn_v2_fast": (ModelConfig(decoder="conv_ps", bf16_frontend=True, bits_dropout=True,
                                             fused_attention_v2=True),
                                 ("fused_attention2", "fused_attention2_backward", "attention_mma_fwd",
                                  "attention_mma_bwd")),
        "conv_attn_v1": (ModelConfig(decoder="conv", fused_attention=True), v1),
        "conv_ps_plain": (ModelConfig(decoder="conv_ps"), ()),
    }
    counts = {k: 0 for k in _counts()}
    results = {}
    for name, (mcfg, kernels) in configs.items():
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        res = train(ds, mcfg, tcfg, log=lambda msg, name=name: print(f"[decoders {name}] {msg}", flush=True))
        torch.cuda.synchronize()
        run = _counts()
        counts = {k: counts[k] + run[k] for k in counts}
        losses = [h["train_loss"] for h in res.history]
        vals = [h["val_loss"] for h in res.history]
        print(f"[decoders {name}] 3 epochs in {time.perf_counter() - t0:.2f} s; train loss {losses}; val loss "
              f"{vals}; launches {({k: run[k] for k in kernels})}", flush=True)
        if not (losses[-1] < losses[0] and all(np.isfinite(vals))):
            raise AssertionError(f"{name}: the train loss did not fall or val is not finite")
        for kernel in kernels:
            if run[kernel] <= 0:
                raise AssertionError(f"{name} never launched {kernel}: {run}")
        if run["fused_output"] or run["fused_dw_adamw"]:
            raise AssertionError(f"{name} launched a kernel of the linear projection: {run}")
        results[name] = res
    path = os.path.join(workdir, "conv_ps.npz")
    save_params(results["conv_ps_attn_v1"].params, path, configs["conv_ps_attn_v1"][0])
    g = torch.Generator(device="cuda").manual_seed(9)
    batch_idx = torch.randint(0, n_samples, (8, 1024), generator=g, device="cuda")
    conv_rates = {}
    for name, (mcfg, _) in configs.items():
        state = state_from_params(results[name].params, tcfg)
        conv_rates[name] = _steps_per_s(state, ds, batch_idx, mcfg, tcfg)
        if name in ("conv_ps_attn_v1", "conv_attn_v1"):
            _profile_step(state, ds, batch_idx[0], mcfg, tcfg, name)
        del state
    print(f"[decoders] steps/s at batch 1024: {json.dumps(conv_rates)}; phase 5's linear fused "
          f"{rates['fused']}, attn_v1 {rates['attn_v1']} ({card})", flush=True)
    return counts, path


def _conv_cli(workdir: str, path: str) -> dict:
    """7b: the conv_ps checkpoint through the CLI's render and eval, the
    test strings with the f32 attention kernel (and f32 conv stages)
    against the plain path, and
    one request through serve's RenderServer (bf16 frontend, K7) against a
    direct render -> the launches."""
    from ai_font_renderer_tpu_torch.cli import TEST_STRINGS
    from ai_font_renderer_tpu_torch.config import replace
    from ai_font_renderer_tpu_torch.fontgen.bmp import read_bmp
    from ai_font_renderer_tpu_torch.render import render_batch, render_batch_u8_async
    from ai_font_renderer_tpu_torch.render.server import RenderServer, request_render
    from ai_font_renderer_tpu_torch.utils.checkpoint import load_params_with_config

    torch.cuda.synchronize()
    _reset_counts()
    out = os.path.join(workdir, "conv_renders")
    t0 = time.perf_counter()
    rc, _ = _cli(["render", "--weights", path, "--out", out], "decoders render")
    t_render = time.perf_counter() - t0
    files = sorted(os.listdir(out)) if rc == 0 else []
    if files != sorted(f"string_{i}.bmp" for i in range(15)):
        raise AssertionError(f"render of the conv_ps npz: exit {rc}, files {files}")
    params, mcfg = load_params_with_config(path, device="cuda")
    if (mcfg.decoder, mcfg.decoder_grid, mcfg.decoder_channels) != ("conv_ps", (5, 20), (128, 128, 64, 32, 16)):
        raise AssertionError(f"the conv_ps npz's __config__ reads back as {mcfg}")
    want = np.round(np.clip(render_batch(params, TEST_STRINGS, mcfg), 0, 1) * 255)
    bmps = np.stack([np.round(read_bmp(os.path.join(out, f"string_{i}.bmp")) * 255) for i in range(15)])
    if np.abs(bmps - want).max() > 1:
        raise AssertionError("the CLI's conv BMPs differ from a direct render")
    t0 = time.perf_counter()
    rc, lines = _cli(["eval", "--weights", path, "--num-samples", "20480"], "decoders eval")
    t_eval = time.perf_counter() - t0
    result = json.loads(lines[-1]) if rc == 0 and lines else {}
    if result.get("val_samples") != 4096 or not np.isfinite(result.get("val_mse", np.nan)):
        raise AssertionError(f"eval of the conv_ps npz: exit {rc}, {result}")
    # f32 stages: bf16 ones would round the kernel's and the plain path's
    # frontends, equal to f32 rounding, onto other bf16 neighbours.
    _render_test_strings(params, replace(mcfg, fused_attention=True, bf16_matmul=False),
                         os.path.join(workdir, "conv_k5"), "decoders render K5")
    scfg = replace(mcfg, fused_attention_v2=True, bf16_frontend=True)
    sock = os.path.join(workdir, "conv.sock")
    strings = SERVE_REQUESTS["mid"]
    srv = RenderServer(params, scfg, socket_path=sock, batch_size=64)
    srv.start()
    try:
        header, payloads = request_render(sock, strings)
    finally:
        srv.stop()
    torch.cuda.synchronize()
    counts = _counts()
    got = np.stack([np.frombuffer(p, np.uint8).reshape(80, 240) for p in payloads])
    # The server renders fixed batches of 64, padded with empty strings;
    # cuDNN may take other algorithms at another batch size, so the reply
    # is held to a direct render of that same batch.
    padded = strings + [""] * (64 - len(strings))
    direct = render_batch_u8_async(params, padded, scfg).cpu().numpy()[: len(strings)]
    alone = render_batch_u8_async(params, strings, scfg).cpu().numpy()
    batch_diff = int(np.abs(alone.astype(int) - direct.astype(int)).max())
    print(f"[decoders] conv_ps npz: render 15 BMPs in {t_render:.2f} s (__config__ {mcfg.decoder}, "
          f"{mcfg.decoder_grid}, {mcfg.decoder_channels}); eval {t_eval:.2f} s: {json.dumps(result)}; serve "
          f"{len(strings)} strings byte-equal to a direct render of the server's batch: "
          f"{np.array_equal(got, direct)} (a render of the {len(strings)} alone differs by up to {batch_diff} "
          f"gray levels); launches {counts}", flush=True)
    if header["count"] != len(strings) or not np.array_equal(got, direct) or batch_diff > 1:
        raise AssertionError("the conv serve reply differs from a direct render")
    for name in ("fused_attention", "fused_attention2", "attention_mma_fwd"):
        if counts[name] <= 0:
            raise AssertionError(f"the conv render and serve never launched {name}: {counts}")
    return counts


def _int8_product_rows(params, served, card) -> list[dict]:
    """7c: the int8 product on the frontend's activations of real strings
    at M = 15, 64 and 1024: its int32 accumulators against the f64 plain
    product (equal), and the times of the product, the activations'
    quantization, the epilogue and K1 on the same activations."""
    from ai_font_renderer_tpu_torch.cli import TEST_STRINGS
    from ai_font_renderer_tpu_torch.config import ModelConfig
    from ai_font_renderer_tpu_torch.fontgen.layout import encode_codes
    from ai_font_renderer_tpu_torch.models import font_renderer
    from ai_font_renderer_tpu_torch.ops.fused_output import fused_output
    from ai_font_renderer_tpu_torch.ops.quantized import (
        int8_product,
        int8_product_reference,
        quantize_activations,
    )

    mcfg = ModelConfig(fused_attention=True)
    w_q, s, b = served["out_w_q"], served["out_w_scale"], served["out_b"]
    k, n = w_q.shape
    rows = []
    for m, strings in ((15, TEST_STRINGS), (64, SERVE_REQUESTS["long"][:64]),
                       (1024, _atlas_strings(1024, 100, seed=3))):
        codes = torch.from_numpy(encode_codes(strings, 100)).cuda()
        with torch.no_grad():
            flat = font_renderer.frontend(served, codes, mcfg)
        a_q, a_s = quantize_activations(flat)
        acc = int8_product(a_q, w_q)
        ref = int8_product_reference(a_q, w_q)
        torch.cuda.synchronize()
        if not torch.equal(acc, ref):
            raise AssertionError(f"int8 accumulators at M={m} differ from the f64 product in "
                                 f"{int((acc != ref).sum())} places")
        iters = 20 if m < 256 else 10
        bound_ms, bound_by = _bound(k * n + m * k + 4 * m * n, 2 * m * k * n, INT8_TENSOR_OPS)
        row = {
            "shape": f"M={m},K={k},N={n}",
            "max_abs_err": 0.0,
            "largest_acc": int(acc.abs().max()),
            "ms": time_ms(lambda: int8_product(a_q, w_q), iters),
            "plain_ms": time_ms(lambda: int8_product_reference(a_q, w_q), 3),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "quantize_ms": time_ms(lambda: quantize_activations(flat), iters),
            "epilogue_ms": time_ms(lambda: torch.clamp(acc.float() * (a_s[:, None] * s[None, :]) + b, 0.0, 1.0),
                                   iters),
            "k1_ms": time_ms(lambda: fused_output(flat, params["out_w"], params["out_b"]), iters),
            # The same product on W_q as stored (row-major): what _int_mm
            # takes without the column-major copy.
            "row_major": _int_mm_row_major(a_q, w_q, iters),
        }
        print(f"[int8 product] {json.dumps(row)} ({card})", flush=True)
        rows.append(row)
        del acc, ref
    return rows


def _int_mm_row_major(a_q, w_q, iters) -> str:
    """Whether torch._int_mm takes a row-major W_q on this card, and its
    ms if it does; a measurement only: the port always hands it the
    column-major copy."""
    a = a_q if a_q.shape[0] > 16 else torch.nn.functional.pad(a_q, (0, 0, 0, 17 - a_q.shape[0]))
    try:
        torch._int_mm(a, w_q)
        torch.cuda.synchronize()
    except RuntimeError as e:
        return f"refused: {str(e).splitlines()[0][:120]}"
    return f"{time_ms(lambda: torch._int_mm(a, w_q), iters):.4f} ms"


def _int8_error_bound(params, served, strings, mcfg) -> np.ndarray:
    """ops.quantized.int8_error_bound for these strings' sheets, plus 1e-4
    for the f32 sums of both paths (K1_TOL's reason)."""
    from ai_font_renderer_tpu_torch.fontgen.layout import encode_codes
    from ai_font_renderer_tpu_torch.models import font_renderer
    from ai_font_renderer_tpu_torch.ops.quantized import int8_error_bound

    codes = torch.from_numpy(encode_codes(strings, mcfg.max_length)).cuda()
    with torch.no_grad():
        flat = font_renderer.frontend(served, codes, mcfg)
    bound = int8_error_bound(flat, params["out_w"], served["out_w_scale"]) + K1_TOL
    return bound.reshape(len(strings), mcfg.sheet_height, mcfg.sheet_width).cpu().numpy()


def _int8_serving(workdir: str, card: str, k1_atlas_gps: float) -> tuple[dict, list[dict]]:
    """7c: phase 5's fused weights in int8: the accumulators and times of
    the product, the sheets against the plain f32 path, `render --int8`,
    the 4096-sheet atlas beside K1's, and phase 4's requests on an int8
    server -> (the launches, the product's rows)."""
    from ai_font_renderer_tpu_torch.cli import TEST_STRINGS
    from ai_font_renderer_tpu_torch.config import replace
    from ai_font_renderer_tpu_torch.fontgen.bmp import read_bmp
    from ai_font_renderer_tpu_torch.ops import quantized
    from ai_font_renderer_tpu_torch.render import render_atlas, render_batch, render_batch_u8_async
    from ai_font_renderer_tpu_torch.utils.checkpoint import load_params_with_config

    weights = os.path.join(workdir, "trained.npz")
    params, mcfg = load_params_with_config(weights, device="cuda")
    served = quantized.quantize_params(params)
    rows = _int8_product_rows(params, served, card)

    strings = TEST_STRINGS + _atlas_strings(1024, 100, seed=4)
    q = render_batch(served, strings, mcfg)
    # tests/test_quantized.py:56-57 hold the int8 sheets to the model's
    # default forward (bf16 operands, f32 sums): 4/255 at most and 0.5/255
    # on average, on a narrow model from a seed. The mean holds here; the
    # most does not (4.3-4.7 gray levels on the trained full-width model,
    # PERF.md, where the JAX package's int8 path gives the same sheets), so
    # each pixel is held to the quantization's own bound against exact f32
    # products instead.
    ref = render_batch(params, strings, mcfg)
    f32 = render_batch(params, strings, replace(mcfg, bf16_matmul=False))
    diff, diff32 = np.abs(q - ref), np.abs(q - f32)
    over = float((diff32 - _int8_error_bound(params, served, strings, mcfg)).max())
    print(f"[int8] {len(strings)} sheets (the 15 test strings first) vs the default forward: max "
          f"{diff.max() * 255:.3f} gray levels (the test strings {diff[:15].max() * 255:.3f}; the JAX package's "
          f"test bound {INT8_MAX_TOL * 255:.0f}), mean {diff.mean() * 255:.4f} (tol {INT8_MEAN_TOL * 255}); vs "
          f"exact f32 products: max {diff32.max() * 255:.3f}, mean {diff32.mean() * 255:.4f}, largest excess over "
          f"the quantization bound {over:.3g} (tol 0)", flush=True)
    if not (np.isfinite(q).all() and diff.mean() < INT8_MEAN_TOL and over <= 0):
        raise AssertionError(f"int8 sheets: mean {diff.mean()}, over the quantization bound by {over}")

    counts = {k: 0 for k in _counts()}
    int8_launches, k1_in_int8 = {}, 0
    torch.cuda.synchronize()
    _reset_counts()
    quantized.int8_product.launches = 0
    out = os.path.join(workdir, "int8_renders")
    rc, _ = _cli(["render", "--weights", weights, "--int8", "--out", out], "int8 render")
    torch.cuda.synchronize()
    run = _counts()
    counts = {k: counts[k] + run[k] for k in counts}
    int8_launches["render"] = quantized.int8_product.launches
    k1_in_int8 += run["fused_output"]
    if rc != 0 or sorted(os.listdir(out)) != sorted(f"string_{i}.bmp" for i in range(15)):
        raise AssertionError(f"render --int8: exit {rc}")
    bmps = np.stack([np.round(read_bmp(os.path.join(out, f"string_{i}.bmp")) * 255) for i in range(15)])
    if np.abs(bmps - np.round(np.clip(q[:15], 0, 1) * 255)).max() > 1:
        raise AssertionError("render --int8 BMPs differ from the direct int8 render")

    atlas_strings = _atlas_strings(4096, 100)
    rcfg = replace(mcfg, fused_attention=True)
    gps = {}
    for name, p, cfg in (("int8", served, rcfg), ("K1", params, replace(rcfg, use_pallas_output=True))):
        torch.cuda.synchronize()
        _reset_counts()
        quantized.int8_product.launches = 0
        warm = render_atlas(p, atlas_strings, cfg)
        torch.cuda.synchronize()
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            atlas = render_atlas(p, atlas_strings, cfg)
            torch.cuda.synchronize()
            runs.append(4096 * 100 / (time.perf_counter() - t0))
        run = _counts()
        counts = {k: counts[k] + run[k] for k in counts}
        if name == "int8":
            int8_launches["atlas"] = quantized.int8_product.launches
            k1_in_int8 += run["fused_output"]
        if atlas.shape != (4096, 80, 240) or not bool(torch.isfinite(atlas).all()) or not torch.equal(atlas, warm):
            raise AssertionError(f"{name} atlas misshapen, not finite or not repeatable")
        gps[name] = sorted(runs)
    del warm, atlas
    print(f"[int8] atlas 4096 sheets: glyphs/s int8 {gps['int8']}, median {gps['int8'][2]}; K1 on the same "
          f"weights {gps['K1']}, median {gps['K1'][2]}; phase 3's K1 atlas median {k1_atlas_gps} ({card})",
          flush=True)
    _profile_atlas(served, atlas_strings, rcfg)

    torch.cuda.synchronize()
    _reset_counts()
    quantized.int8_product.launches = 0
    replies, latency_ms, stalls = _serve_once(params, os.path.join(workdir, "int8.sock"), int8=True)
    torch.cuda.synchronize()
    run = _counts()
    counts = {k: counts[k] + run[k] for k in counts}
    int8_launches["serve"] = quantized.int8_product.launches
    k1_in_int8 += run["fused_output"]
    for name, strs in SERVE_REQUESTS.items():
        header, payloads = replies[name]
        got = np.stack([np.frombuffer(p, np.uint8).reshape(80, 240) for p in payloads])
        want = render_batch_u8_async(served, strs, _serve_config()).cpu().numpy()
        if header["count"] != len(strs) or not np.array_equal(got, want):
            raise AssertionError(f"int8 serve reply {name} differs from a direct int8 render")
    print(f"[int8] serve: 3 concurrent requests equal direct int8 renders; latency ms {latency_ms}; stalls "
          f"{json.dumps(stalls)}; int8 products launched {json.dumps(int8_launches)}; launches {counts}",
          flush=True)
    if min(int8_launches.values()) <= 0:
        raise AssertionError(f"an int8 path never launched the int8 product: {int8_launches}")
    if k1_in_int8:
        raise AssertionError(f"the int8 paths launched K1 {k1_in_int8} times")
    for name in ("fused_attention", "attention_mma_fwd"):
        if counts[name] <= 0:
            raise AssertionError(f"int8 serving never launched {name}: {counts}")
    return counts, rows


def phase_decoders(workdir: str, card: str, ds, rates: dict, k1_atlas_gps: float) -> tuple[dict, list[dict]]:
    """Phase 7: the conv decoders (forward, training, the CLI) and int8
    serving -> (the launches of its main paths, the int8 product's rows)."""
    seconds = {}
    t0 = time.perf_counter()
    _conv_forward_check(card)
    seconds["conv_forward"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    counts, path = _train_conv(ds, workdir, card, rates)
    counts = [counts]
    seconds["conv_train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    counts.append(_conv_cli(workdir, path))
    seconds["conv_cli"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    int8_counts, rows = _int8_serving(workdir, card, k1_atlas_gps)
    counts.append(int8_counts)
    seconds["int8"] = time.perf_counter() - t0
    print(f"[decoders] seconds by check: {json.dumps({k: round(v, 2) for k, v in seconds.items()})}", flush=True)
    return {k: sum(c[k] for c in counts) for k in counts[0]}, rows


# Phase 8: the implicit render path on the committed artifacts. The
# learned sheets on the card against the CPU: tests/test_torch_implicit.py's
# bound against the JAX package (the structured head's soft decode moves a
# midpoint by about 1e-3 px when its logits move by 1e-5, and a glyph edge
# its coverage by about as much). The engine-layout sheets: f32 sums in
# another order through sin(30 x).
IMPLICIT_SHEET_TOL = 5e-3
IMPLICIT_ORACLE_TOL = 1e-4
GOLDEN_TOL = 1e-4  # per-string MSE against golden_mse.json (tests/test_artifacts.py)
LEARNED_BOUND = {"firacode": 0.009, "montserrat": 0.010}
ORACLE_BOUND = {"firacode": 0.0042, "montserrat": 0.0031}
# The placement net through the attention kernels against the plain
# attention, relative to the largest |plain| value: f32 sums in another
# order, through the soft decode.
PLACEMENT_REL_TOL = 1e-4
LINE_MARGIN = 1e-4  # line indices compared where the CPU's top-two margin exceeds it
IMPLICIT_FONTS = ("firacode", "montserrat")


def _implicit_paths(font: str) -> tuple[str, str, str]:
    from ai_font_renderer_tpu_torch.config import FIRACODE_PATH, MONTSERRAT_PATH

    art = os.path.join(os.path.dirname(os.path.abspath(__file__)), "artifacts", font)
    font_path = FIRACODE_PATH if font == "firacode" else MONTSERRAT_PATH
    return os.path.join(art, "siren_finetuned.npz"), os.path.join(art, "placement_finetuned.npz"), font_path


def _implicit_pair(font: str, device: str):
    """(bank params, SirenConfig, charset, net params, net config) on ``device``."""
    from ai_font_renderer_tpu_torch.utils.checkpoint import load_params_with_config, load_siren

    bank, net, _ = _implicit_paths(font)
    sp, scfg, charset = load_siren(bank, device=device)
    pp, pcfg = load_params_with_config(net, device=device)
    return sp, scfg, charset, pp, pcfg


def _implicit_locks(card: str) -> None:
    """8a: the 15 test strings through each committed pair on the card (soft
    decode): each string's MSE within 1e-4 of golden_mse.json and the mean
    under its bound, the kerned engine-layout oracle under its bound, both
    against the CPU's sheets, and a second card render bit-equal."""
    from ai_font_renderer_tpu_torch.cli import TEST_STRINGS
    from ai_font_renderer_tpu_torch.fontgen.dataset import bake_font_atlas, unit_ground_truth
    from ai_font_renderer_tpu_torch.render.implicit_sheet import render_implicit_sheets, render_learned_sheets

    for font in IMPLICIT_FONTS:
        bank, _, font_path = _implicit_paths(font)
        with open(os.path.join(os.path.dirname(bank), "golden_mse.json")) as f:
            golden = json.load(f)["per_string_mse"]
        gt = unit_ground_truth(bake_font_atlas(font_path, proportional=font == "montserrat"), TEST_STRINGS)
        sheets, oracle = {}, {}
        for dev in ("cuda", "cpu"):
            sp, scfg, charset, pp, pcfg = _implicit_pair(font, dev)
            sheets[dev] = render_learned_sheets(sp, pp, TEST_STRINGS, font_path, scfg, pcfg, charset=charset)
            oracle[dev] = render_implicit_sheets(sp, TEST_STRINGS, font_path, scfg, charset=charset).cpu().numpy()
            if dev == "cuda":
                again = render_learned_sheets(sp, pp, TEST_STRINGS, font_path, scfg, pcfg, charset=charset)
                oracle_again = render_implicit_sheets(sp, TEST_STRINGS, font_path, scfg, charset=charset)
                repeat_equal = torch.equal(again, sheets[dev]) and np.array_equal(
                    oracle_again.cpu().numpy(), oracle[dev])
            sheets[dev] = sheets[dev].cpu().numpy()
        got = sheets["cuda"]
        mse = [float(np.mean((got[i] - gt[i]) ** 2)) for i in range(len(TEST_STRINGS))]
        delta = float(np.max(np.abs(np.array(mse) - np.array(golden))))
        mean = float(np.mean((got - gt) ** 2))
        oracle_mse = float(np.mean((oracle["cuda"] - gt) ** 2))
        err = float(np.abs(got - sheets["cpu"]).max())
        oracle_err = float(np.abs(oracle["cuda"] - oracle["cpu"]).max())
        print(f"[implicit] {font}: learned MSE {mean:.6f} (bound {LEARNED_BOUND[font]}), per-string "
              f"delta to golden {delta:.3g} (tol {GOLDEN_TOL}); kerned oracle MSE {oracle_mse:.6f} (bound "
              f"{ORACLE_BOUND[font]}); card vs CPU: learned {err:.3g} (tol {IMPLICIT_SHEET_TOL}), oracle "
              f"{oracle_err:.3g} (tol {IMPLICIT_ORACLE_TOL}); two card renders bit-equal {repeat_equal} ({card})",
              flush=True)
        if not (got.shape == (15, 80, 240) and np.isfinite(got).all() and delta < GOLDEN_TOL
                and mean < LEARNED_BOUND[font] and oracle_mse < ORACLE_BOUND[font]
                and err <= IMPLICIT_SHEET_TOL and oracle_err <= IMPLICIT_ORACLE_TOL and repeat_equal):
            raise AssertionError(f"implicit {font}: the locks or the card-vs-CPU check failed (above)")


def _line_indices(pp, pcfg, codes: torch.Tensor) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(argmax lines, monotone lines, top-two margin) of the net on codes."""
    from ai_font_renderer_tpu_torch.models import font_renderer, placement

    with torch.inference_mode():
        out = placement._head(font_renderer.features(pp, codes, pcfg), pp["place_w"], pp["place_b"])
        off, col = (3, 2) if placement.head_structured(pp) else (2, 1)
        llog = out[..., off:]
        mono = placement.monotone_lines(llog, torch.sigmoid(out[..., col]))
        top2 = llog.topk(2, dim=-1).values
    return llog.argmax(-1).cpu().numpy(), mono.cpu().numpy(), (top2[..., 0] - top2[..., 1]).cpu().numpy()


def _implicit_variants(workdir: str, card: str) -> None:
    """8b: the decode and layout variants through the CLI in this process
    (15 BMPs each), and the hard and monotone line indices on the card
    against the CPU's: the argmax wherever the CPU's top-two margin exceeds
    LINE_MARGIN, the monotone path on every string with no slot under it."""
    from ai_font_renderer_tpu_torch.cli import TEST_STRINGS
    from ai_font_renderer_tpu_torch.fontgen.bmp import read_bmp
    from ai_font_renderer_tpu_torch.fontgen.layout import encode_codes

    variants = (["--hard-placement"], ["--monotone-placement"], ["--baked", "4"], ["--phased", "8"],
                ["--scale", "4"])
    strings = TEST_STRINGS + _atlas_strings(1024, 100, seed=8)
    codes = torch.from_numpy(encode_codes(strings, 100))
    for font in IMPLICIT_FONTS:
        bank, net, font_path = _implicit_paths(font)
        for extra in variants:
            out = os.path.join(workdir, "implicit", font, "_".join(a.lstrip("-") for a in extra))
            t0 = time.perf_counter()
            rc, _ = _cli(["render", "--implicit", bank, "--placement", net, "--font", font_path, "--out", out,
                          *extra], f"implicit {font} {' '.join(extra)}")
            bmps = sorted(os.listdir(out)) if rc == 0 else []
            shape = read_bmp(os.path.join(out, "string_0.bmp")).shape if bmps else None
            print(f"[implicit] {font} {' '.join(extra)}: rc {rc}, {len(bmps)} BMPs of {shape}, "
                  f"{time.perf_counter() - t0:.2f} s", flush=True)
            if rc != 0 or len(bmps) != 15:
                raise AssertionError(f"render --implicit {font} {extra}: rc {rc}, {len(bmps)} BMPs")
        lines = {}
        for dev in ("cuda", "cpu"):
            _, _, _, pp, pcfg = _implicit_pair(font, dev)
            lines[dev] = _line_indices(pp, pcfg, codes.to(dev))
        (hard, mono, _), (hard_c, mono_c, margin) = lines["cuda"], lines["cpu"]
        sure = margin > LINE_MARGIN
        whole = sure.all(axis=1)
        hard_bad = int((hard != hard_c)[sure].sum())
        mono_bad = int((mono != mono_c)[whole].sum())
        print(f"[implicit] {font}: line indices card vs CPU on {len(strings)} strings: argmax differs on "
              f"{hard_bad} of {int(sure.sum())} slots past the margin ({int((~sure).sum())} under it), "
              f"monotone on {mono_bad} slots of {int(whole.sum())} strings with no slot under it; the test "
              f"strings' equal: argmax {np.array_equal(hard[:15], hard_c[:15])}, monotone "
              f"{np.array_equal(mono[:15], mono_c[:15])}", flush=True)
        if hard_bad or mono_bad or not (np.array_equal(hard[:15], hard_c[:15])
                                        and np.array_equal(mono[:15], mono_c[:15])):
            raise AssertionError(f"implicit {font}: line indices on the card differ from the CPU's")


def _placement_through_kernels(card: str) -> tuple[dict, list[dict]]:
    """8c: the committed nets with each fused attention flag against the
    plain attention at B = 15 (the test strings) and 1024: midpoints and
    logits within PLACEMENT_REL_TOL of the largest |plain| value, through
    the general forward (E = 64, H = 8 is past the register-tiled kernels).
    Then that forward alone at B = 1024 and rate 0 (serving), f32 and bf16,
    against its plain version, timed beside the library and the bound ->
    (the launches of the runs with the flags, the timing rows)."""
    from ai_font_renderer_tpu_torch.cli import TEST_STRINGS
    from ai_font_renderer_tpu_torch.config import replace
    from ai_font_renderer_tpu_torch.fontgen.layout import encode_codes
    from ai_font_renderer_tpu_torch.models import placement
    from ai_font_renderer_tpu_torch.ops.fused_attention import (
        KEYS,
        attention_wide_fwd,
        fused_attention_reference,
        kernel_takes,
    )

    batches = {15: TEST_STRINGS, 1024: _atlas_strings(1024, 100, seed=9)}
    totals = None
    for font in IMPLICIT_FONTS:
        _, _, _, pp, pcfg = _implicit_pair(font, "cuda")
        if kernel_takes(pcfg.max_length, pcfg.embedding_dim, pcfg.num_heads, torch.float32):
            raise AssertionError(f"{font}: the register-tiled kernels take the net's shape; phase 8 expects "
                                 "the general ones")
        for bsz, strings in batches.items():
            codes = torch.from_numpy(encode_codes(strings, pcfg.max_length)).cuda()
            with torch.inference_mode():
                want = placement.apply(pp, codes, pcfg)
                torch.cuda.synchronize()
                for flag in ("fused_attention", "fused_attention_v2"):
                    _reset_counts()
                    got = placement.apply(pp, codes, replace(pcfg, **{flag: True}))
                    torch.cuda.synchronize()
                    counts = _counts()
                    totals = counts if totals is None else {k: totals[k] + counts[k] for k in totals}
                    errs = [float((g - w).abs().max()) / float(w.abs().max()) for g, w in zip(got, want)]
                    print(f"[implicit] {font} net, B={bsz}, {flag}: midpoints rel err {errs[0]:.3g}, logits "
                          f"rel err {errs[1]:.3g} (tol {PLACEMENT_REL_TOL}); launches "
                          f"attention_wide_fwd {counts['attention_wide_fwd']}", flush=True)
                    if max(errs) > PLACEMENT_REL_TOL or counts["attention_wide_fwd"] <= 0:
                        raise AssertionError(f"{font} placement net with {flag} at B={bsz}: errs {errs}, {counts}")

    # The forward alone at the net's shape, weights of the Montserrat net.
    bsz, s, e, heads = 1024, pcfg.max_length, pcfg.embedding_dim, pcfg.num_heads
    w = {k: pp[k] for k in KEYS}
    g = torch.Generator(device="cuda").manual_seed(15)
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn(bsz, s, e, generator=g, device="cuda").to(dt)
        got, _ = attention_wide_fwd(x, w, heads)
        want = fused_attention_reference(x, w, heads)
        err = float((got.float() - want.float()).abs().max())
        if dt == torch.float32:
            ok, tol = err <= ATTN_TOL[dt], ATTN_TOL[dt]
        else:
            tol = f"{WIDE_FWD_BF16_REL_TOL} of max |plain|"
            ok = err <= WIDE_FWD_BF16_REL_TOL * float(want.float().abs().max())
        if not ok:
            raise AssertionError(f"general attention forward at S={s}, E={e}, H={heads} {dt}: err {err} (tol {tol})")
        mha, _ = _attn_library(e, heads, w, dt)
        xt = x.transpose(0, 1)
        with torch.no_grad():
            library_ms = time_ms(lambda: mha(xt, 0.0, False), 20)
        bound_ms, bound_by = _bound(2 * bsz * s * e * x.element_size() + 4 * (4 * e * e + 4 * e),
                                    bsz * (8 * s * e * e + 4 * s * s * e), _attn_peak(dt))
        row = {
            "shape": f"B={bsz},S={s},E={e},H={heads},{str(dt).replace('torch.', '')},dropout=0",
            "max_abs_err": err, "tol": tol,
            "ms": time_ms(lambda: attention_wide_fwd(x, w, heads), 20),
            "plain_ms": time_ms(lambda: fused_attention_reference(x, w, heads), 10),
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        }
        print(f"[K5/K7 general attention_wide_fwd, the placement net's shape] {json.dumps(row)} ({card})",
              flush=True)
        rows.append(row)
    return totals, rows


def _time_render(fn, runs: int = 5) -> list[float]:
    """Seconds of each of ``runs`` calls of ``fn`` (strings to a finished
    device tensor, a sync at the end) after one warm call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def _learned_split(sp, scfg, charset, pp, pcfg, strings, font_path, baked=0, phased=0) -> dict:
    """ms of render_learned_sheets' parts, each ending in a sync: the host
    (font, layout, encoding, the charset's slots), the placement net (with
    the origins and the visibility), the bake and the composite."""
    from ai_font_renderer_tpu_torch.fontgen.layout import encode_codes
    from ai_font_renderer_tpu_torch.fontgen.ttf import TrueTypeFont
    from ai_font_renderer_tpu_torch.models import placement
    from ai_font_renderer_tpu_torch.render import implicit_sheet as tis

    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lay = tis.build_layout(TrueTypeFont.load(font_path), cell=scfg.cell, max_glyphs=pcfg.max_length)
        codes = torch.from_numpy(encode_codes(strings, pcfg.max_length)).cuda()
        ids, known = tis.known_slots(strings, charset, pcfg.max_length)
        ids, known = torch.from_numpy(ids).cuda(), torch.from_numpy(known).cuda()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mids, logits = placement.apply(pp, codes, pcfg)
        origins = tis.origins_from_midpoints(mids, lay)
        valid = known & (torch.sigmoid(logits) > 0.5)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if phased:
            bank = tis.bake_bank_phased(sp, scfg, lay, phases=phased)
        elif baked:
            bank = tis.bake_bank(sp, scfg, supersample=baked)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        if phased:
            tis.compose_phased(bank, ids, origins, valid, scfg, lay, phased, composite="matmul")
        elif baked:
            tis.compose_baked(bank, ids, origins, valid, scfg, lay, baked)
        else:
            tis.compose(sp, ids, origins, valid, scfg, lay)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
    return {"host_ms": (t1 - t0) * 1e3, "net_ms": (t2 - t1) * 1e3, "bake_ms": (t3 - t2) * 1e3,
            "composite_ms": (t4 - t3) * 1e3}


def _implicit_rates(card: str) -> None:
    """8d: glyphs/s (N x 100 glyph slots a run over its seconds, as phase
    3 counts them; the median of 5) of render_learned_sheets on the
    Montserrat pair (the structured head) exact at 256 sheets, baked 4 at
    1024, phased 8 at 1024 and 4096, with each one's split; of
    render_implicit_sheets phased 8 at 1024 with its pen walk; and the peak
    device memory of the exact compose at 256 sheets."""
    from ai_font_renderer_tpu_torch.fontgen.ttf import TrueTypeFont
    from ai_font_renderer_tpu_torch.render import implicit_sheet as tis

    sp, scfg, charset, pp, pcfg = _implicit_pair("montserrat", "cuda")
    font_path = _implicit_paths("montserrat")[2]
    for name, n, kw in (("exact", 256, {}), ("baked4", 1024, {"baked": 4}), ("phased8", 1024, {"phased": 8}),
                        ("phased8", 4096, {"phased": 8})):
        strings = _atlas_strings(n, 100, seed=10)
        if name == "exact":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        runs = _time_render(lambda: tis.render_learned_sheets(sp, pp, strings, font_path, scfg, pcfg,
                                                              charset=charset, **kw))
        if name == "exact":
            peak_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
            print(f"[implicit] exact compose of {n} sheets: peak device memory {peak_mib:.1f} MiB above the "
                  f"weights ({card})", flush=True)
        gps = sorted(n * 100 / t for t in runs)
        split = _learned_split(sp, scfg, charset, pp, pcfg, strings, font_path, **kw)
        print(f"[implicit] render_learned_sheets {name} N={n}: glyphs/s runs {gps}, median {gps[len(gps) // 2]}; split "
              f"{json.dumps({k: round(v, 3) for k, v in split.items()})} ({card})", flush=True)
    strings = _atlas_strings(1024, 100, seed=11)
    runs = _time_render(lambda: tis.render_implicit_sheets(sp, strings, font_path, scfg, charset=charset, phased=8))
    gps = sorted(1024 * 100 / t for t in runs)
    t0 = time.perf_counter()
    font = TrueTypeFont.load(font_path)
    tis.place_glyphs(strings, font, tis.build_layout(font, cell=scfg.cell), charset=charset,
                     kerning=tis.font_kerning(font_path, charset))
    walk_ms = (time.perf_counter() - t0) * 1e3
    print(f"[implicit] render_implicit_sheets phased8 N=1024: glyphs/s runs {gps}, median {gps[len(gps) // 2]}; host pen "
          f"walk {walk_ms:.2f} ms of it ({card})", flush=True)


def phase_implicit(workdir: str, card: str) -> tuple[dict, list[dict]]:
    """Phase 8: the implicit render path -> (the launches of its runs
    through the attention kernels, the general forward's timing rows)."""
    seconds = {}
    t0 = time.perf_counter()
    _implicit_locks(card)
    seconds["locks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _implicit_variants(workdir, card)
    seconds["variants"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    counts, rows = _placement_through_kernels(card)
    seconds["kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _implicit_rates(card)
    seconds["rates"] = time.perf_counter() - t0
    print(f"[implicit] seconds by check: {json.dumps({k: round(v, 2) for k, v in seconds.items()})}", flush=True)
    return counts, rows


# Phase 9: the deployment artifacts (utils/export.py). An artifact runs the
# operators and ops of the direct render in the same order on the same
# device, so its uint8 sheets equal the direct render's bit for bit; the
# BMPs that `render --exported` writes round those u8 values, phase 3's
# BMPs the f32 sheets in f64, so a value within an f32 rounding of a half
# step may land one gray level away.
EXPORT_BATCHES = (1, 15, 64, 1024)


def _export(argv: list[str], tag: str) -> tuple[str, float, float]:
    """``export`` through the CLI in this process -> (artifact path,
    seconds, MB)."""
    out = argv[argv.index("--out") + 1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc, _ = _cli(["export", *argv], tag)
    seconds = time.perf_counter() - t0
    if rc != 0 or not os.path.exists(out):
        raise AssertionError(f"{tag}: export exited {rc}")
    return out, seconds, os.path.getsize(out) / 1e6


def _load_artifact(path: str):
    """(the artifact on the card, seconds to load it)."""
    from ai_font_renderer_tpu_torch.utils.export import load_exported

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    artifact = load_exported(path, "cuda")
    torch.cuda.synchronize()
    return artifact, time.perf_counter() - t0


def _u8_equal(tag: str, got: torch.Tensor, want: torch.Tensor) -> None:
    if got.shape != want.shape or got.dtype != torch.uint8 or not torch.equal(got, want):
        diff = int((got.int() - want.int()).abs().max()) if got.shape == want.shape else None
        raise AssertionError(f"{tag}: exported u8 sheets {tuple(got.shape)} differ from the direct render "
                             f"{tuple(want.shape)} (max {diff})")


def _exported_flagship(workdir: str, card: str, atlas_gps: float) -> tuple[dict, str]:
    """9a: phase 3's weights (K1 + f32 K5) through `export`, loaded onto the
    card: the test strings u8-equal to the direct render and `render
    --exported`'s BMPs beside phase 3's; the same weights with no kernel
    (f32 W); batches 1, 15, 64 and 1024 from the one artifact, each one
    launch of K1 and of the f32 K5 kernel; the 4096-sheet atlas in glyphs/s
    through the artifact and through the same ops eagerly, in turns, beside
    phase 3's -> (launches, path)."""
    from ai_font_renderer_tpu_torch.cli import TEST_STRINGS
    from ai_font_renderer_tpu_torch.config import ModelConfig
    from ai_font_renderer_tpu_torch.fontgen.bmp import read_bmp
    from ai_font_renderer_tpu_torch.fontgen.layout import encode_codes
    from ai_font_renderer_tpu_torch.render import render_atlas, render_batch_u8_async
    from ai_font_renderer_tpu_torch.render.render import _forward
    from ai_font_renderer_tpu_torch.utils.checkpoint import load_params_with_config
    from ai_font_renderer_tpu_torch.utils.export import render_exported_u8

    cfg = ModelConfig(use_pallas_output=True, fused_attention=True)
    weights = os.path.join(workdir, "font_renderer.npz")
    path, export_s, mb = _export(["--weights", weights, "--out", os.path.join(workdir, "flagship.pt2"),
                                  "--kernels", "output,attention"], "export flagship")
    artifact, load_s = _load_artifact(path)
    params, _ = load_params_with_config(weights, base=cfg, device="cuda")
    print(f"[export] flagship (K1 + f32 K5): {mb:.1f} MB (W's bf16 shadow in W's place), export "
          f"{export_s:.2f} s, load onto the card {load_s:.2f} s, operators {list(artifact.operators)} ({card})",
          flush=True)
    if artifact.operators != ("afr::attention_fwd", "afr::fused_output_fwd") or \
            (artifact.max_length, artifact.height, artifact.width) != (100, 80, 240):
        raise AssertionError(f"flagship artifact: operators {artifact.operators}, contract "
                             f"{(artifact.max_length, artifact.height, artifact.width)}")

    # The same weights with no kernel: f32 W, as the JAX artifact holds it.
    plain, plain_s, plain_mb = _export(["--weights", weights, "--out", os.path.join(workdir, "plain.pt2")],
                                       "export plain")
    plain, plain_load_s = _load_artifact(plain)
    _u8_equal("plain test strings", render_exported_u8(plain, TEST_STRINGS),
              render_batch_u8_async(params, TEST_STRINGS, ModelConfig()))
    print(f"[export] flagship with no kernel (f32 W): {plain_mb:.1f} MB, export {plain_s:.2f} s, load "
          f"{plain_load_s:.2f} s, operators {list(plain.operators)}; the test strings u8-equal to the plain "
          f"direct render ({card})", flush=True)
    if plain.operators:
        raise AssertionError(f"the artifact with no kernel calls {plain.operators}")
    del plain

    counts = {k: 0 for k in _counts()}

    def run(strings):
        torch.cuda.synchronize()
        _reset_counts()
        out = render_exported_u8(artifact, strings)
        torch.cuda.synchronize()
        got = _counts()
        for k in counts:
            counts[k] += got[k]
        return out, got

    got, _ = run(TEST_STRINGS)
    _u8_equal("flagship test strings", got, render_batch_u8_async(params, TEST_STRINGS, cfg))
    out = os.path.join(workdir, "exported_renders")
    rc, _ = _cli(["render", "--exported", path, "--out", out], "exported render")
    if rc != 0:
        raise AssertionError(f"render --exported exited {rc}")
    bmps = np.stack([read_bmp(os.path.join(out, f"string_{i}.bmp")) for i in range(15)])
    phase3 = np.stack([read_bmp(os.path.join(workdir, "renders", f"string_{i}.bmp")) for i in range(15)])
    levels = np.abs(np.round(bmps * 255) - np.round(phase3 * 255))
    print(f"[export] flagship: the test strings u8-equal to the direct render; `render --exported` BMPs vs "
          f"phase 3's: {int((levels > 0).sum())} of {levels.size} pixels differ, most {int(levels.max())} "
          f"gray levels (tol 1)", flush=True)
    if levels.max() > 1:
        raise AssertionError("render --exported BMPs more than one gray level from phase 3's")
    for b in EXPORT_BATCHES:
        strings = _atlas_strings(b, 100, seed=20 + b)
        got, launched = run(strings)
        _u8_equal(f"flagship batch {b}", got, render_batch_u8_async(params, strings, cfg))
        f32 = launched["fused_attention"] - launched["attention_mma_fwd"] - launched["attention_wide_fwd"]
        print(f"[export] flagship batch {b}: u8-equal to the direct render; launches K1 "
              f"{launched['fused_output']}, its GEMM {launched['gemm_bf16_bias_clamp']}, K5 "
              f"{launched['fused_attention']} (f32 kernel {f32})", flush=True)
        if (launched["fused_output"], launched["gemm_bf16_bias_clamp"], f32) != (1, 1, 1):
            raise AssertionError(f"flagship batch {b}: launches {launched}, want one K1 and one f32 K5")

    # The 4096-sheet atlas in calls of 1024 (as phase 3's render_atlas),
    # through the artifact and through the same ops called eagerly
    # (render._forward, then the u8 rounding), in turns.
    strings = _atlas_strings(4096, 100)
    codes = torch.from_numpy(encode_codes(strings, 100)).pin_memory()

    def atlas(fn):
        c = codes.to("cuda", non_blocking=True)
        return torch.cat([fn(c[i : i + 1024]) for i in range(0, 4096, 1024)])

    def eager(c):
        with torch.inference_mode():
            return torch.round(_forward(params, c, cfg) * 255.0).to(torch.uint8)

    paths = {"exported": artifact, "eager": eager}
    torch.cuda.synchronize()
    _reset_counts()
    warm = {name: atlas(fn) for name, fn in paths.items()}
    torch.cuda.synchronize()
    runs = {name: [] for name in paths}
    for r in range(5):
        for name in (("exported", "eager") if r % 2 else ("eager", "exported")):
            t0 = time.perf_counter()
            a = atlas(paths[name])
            torch.cuda.synchronize()
            runs[name].append(4096 * 100 / (time.perf_counter() - t0))
            if not torch.equal(a, warm[name]):
                raise AssertionError(f"the {name} atlas differs between two runs")
    got = _counts()
    for k in counts:
        counts[k] += got[k]
    _u8_equal("flagship atlas", warm["exported"], warm["eager"])
    _u8_equal("flagship atlas vs render_atlas", warm["exported"],
              torch.round(render_atlas(params, strings, cfg) * 255.0).to(torch.uint8))
    gps = {name: sorted(v) for name, v in runs.items()}
    print(f"[export] flagship atlas 4096 sheets in calls of 1024, u8 out, in turns: glyphs/s exported "
          f"{gps['exported']}, median {gps['exported'][2]}; the same ops eagerly {gps['eager']}, median "
          f"{gps['eager'][2]} (exported / eager {gps['exported'][2] / gps['eager'][2]:.4f}); phase 3's direct "
          f"render_atlas median {atlas_gps} (exported / it {gps['exported'][2] / atlas_gps:.4f}) ({card})",
          flush=True)
    for name, fn in paths.items():
        _profile_fn(f"export atlas {name}", lambda: atlas(fn))
    return counts, path


def _exported_int8_and_serve(workdir: str, card: str, serve_latency: dict) -> dict:
    """9b: phase 5's trained weights through `export --int8` (f32 K5), u8-equal
    to the direct int8 render; then phase 4's serve config (bf16 frontend,
    K1, K7) exported and served by `serve --exported` in a subprocess:
    phase 4's three requests byte-equal to render_exported, with their
    latencies beside phase 4's -> the launches of the int8 artifact's run."""
    import signal

    from ai_font_renderer_tpu_torch.cli import TEST_STRINGS
    from ai_font_renderer_tpu_torch.config import replace
    from ai_font_renderer_tpu_torch.ops import quantized
    from ai_font_renderer_tpu_torch.render import render_batch_u8_async
    from ai_font_renderer_tpu_torch.render.server import request_render
    from ai_font_renderer_tpu_torch.utils.checkpoint import load_params_with_config
    from ai_font_renderer_tpu_torch.utils.export import render_exported_u8

    trained = os.path.join(workdir, "trained.npz")
    path, export_s, mb = _export(["--weights", trained, "--int8", "--kernels", "attention", "--out",
                                  os.path.join(workdir, "int8.pt2")], "export int8")
    artifact, load_s = _load_artifact(path)
    params, mcfg = load_params_with_config(trained, device="cuda")
    served = quantized.quantize_params(params)
    del params
    torch.cuda.synchronize()
    _reset_counts()
    quantized.int8_product.launches = 0
    got = render_exported_u8(artifact, TEST_STRINGS)
    torch.cuda.synchronize()
    counts, int8_launches = _counts(), quantized.int8_product.launches
    _u8_equal("int8 test strings", got, render_batch_u8_async(served, TEST_STRINGS, replace(mcfg, fused_attention=True)))
    print(f"[export] int8 (f32 K5): {mb:.1f} MB, export {export_s:.2f} s, load {load_s:.2f} s; the test strings "
          f"u8-equal to the direct int8 render; int8 products {int8_launches}, K1 {counts['fused_output']}, K5 "
          f"{counts['fused_attention']} ({card})", flush=True)
    if int8_launches != 1 or counts["fused_output"] or counts["fused_attention"] != 1:
        raise AssertionError(f"int8 artifact: {int8_launches} int8 products, launches {counts}")
    del artifact, served

    weights = os.path.join(workdir, "font_renderer.npz")
    path, export_s, mb = _export(["--weights", weights, "--fast", "--kernels", "output,attention_v2", "--out",
                                  os.path.join(workdir, "serve.pt2")], "export serve")
    artifact, load_s = _load_artifact(path)
    sock = os.path.join(workdir, "exported.sock")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "ai_font_renderer_tpu_torch", "serve", "--exported", path,
                             "--socket", sock], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        while not os.path.exists(sock):
            if proc.poll() is not None or time.perf_counter() - t0 > 120:
                raise AssertionError(f"serve --exported did not start: {proc.stdout.read() if proc.poll() is not None else ''}")
            time.sleep(0.05)
        start_s = time.perf_counter() - t0
        request_render(sock, ["WARM UP"])
        replies, latency_ms, errors = {}, {}, []

        def client(name):
            try:
                t1 = time.perf_counter()
                replies[name] = request_render(sock, SERVE_REQUESTS[name])
                latency_ms[name] = round((time.perf_counter() - t1) * 1e3, 3)
            except Exception as e:  # reported below, after the join
                errors.append((name, repr(e)))

        threads = [threading.Thread(target=client, args=(n,)) for n in SERVE_REQUESTS]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"serve --exported clients failed: {errors}")
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            out, _ = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
    for line in out.splitlines():
        print(f"[export serve] | {line}", flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"serve --exported exited {proc.returncode}")
    for name, strings in SERVE_REQUESTS.items():
        header, payloads = replies[name]
        got = np.stack([np.frombuffer(p, np.uint8).reshape(80, 240) for p in payloads])
        want = render_exported_u8(artifact, strings).cpu().numpy()
        if header["count"] != len(strings) or not np.array_equal(got, want):
            raise AssertionError(f"serve --exported reply {name} differs from render_exported")
    print(f"[export] serve (bf16 frontend, K1, K7): {mb:.1f} MB, export {export_s:.2f} s, load {load_s:.2f} s; "
          f"`serve --exported` in a subprocess listening after {start_s:.2f} s; 3 concurrent requests "
          f"byte-equal to render_exported; latency ms {latency_ms}, phase 4's {serve_latency} ({card})", flush=True)
    return counts


def _exported_neural(workdir: str, card: str) -> dict:
    """9c: the committed pairs exported soft (both fonts), FiraCode also with
    --monotone-placement and with the net's attention through the kernels
    (--kernels attention): the test strings u8-equal to the direct card
    render, the soft ones within golden_mse.json per string and under the
    mean bound, the kernel artifact launching the general K5 forward ->
    the launches of its run."""
    from ai_font_renderer_tpu_torch.cli import TEST_STRINGS
    from ai_font_renderer_tpu_torch.config import replace
    from ai_font_renderer_tpu_torch.fontgen.dataset import bake_font_atlas, unit_ground_truth
    from ai_font_renderer_tpu_torch.render.implicit_sheet import render_learned_sheets
    from ai_font_renderer_tpu_torch.utils.export import render_exported_u8

    counts = {k: 0 for k in _counts()}
    cases = (("firacode", []), ("montserrat", []), ("firacode", ["--monotone-placement"]),
             ("firacode", ["--kernels", "attention"]))
    for font, extra in cases:
        bank, net, font_path = _implicit_paths(font)
        name = f"{font} {' '.join(extra) or 'soft'}"
        out = os.path.join(workdir, f"neural_{font}_{extra[-1].lstrip('-') if extra else 'soft'}.pt2")
        path, export_s, mb = _export(["--placement", net, "--implicit", bank, "--font", font_path, "--out", out,
                                      *extra], f"export {name}")
        artifact, load_s = _load_artifact(path)
        sp, scfg, charset, pp, pcfg = _implicit_pair(font, "cuda")
        kernels = "--kernels" in extra
        monotone = "--monotone-placement" in extra
        torch.cuda.synchronize()
        _reset_counts()
        got = render_exported_u8(artifact, TEST_STRINGS)
        torch.cuda.synchronize()
        run = _counts()
        for k in counts:
            counts[k] += run[k]
        with torch.inference_mode():
            want = render_learned_sheets(sp, pp, TEST_STRINGS, font_path, scfg,
                                         replace(pcfg, fused_attention=kernels), charset=charset, monotone=monotone)
        _u8_equal(f"neural {name}", got, torch.round(want * 255.0).to(torch.uint8))
        line = (f"[export] neural {name}: {mb:.1f} MB, export {export_s:.2f} s, load {load_s:.2f} s, "
                f"{artifact.sheets_per_call} sheets a call; the test strings u8-equal to the direct card render")
        if kernels:
            line += f"; attention_wide_fwd launched {run['attention_wide_fwd']} times"
            if run["attention_wide_fwd"] != 1 or artifact.operators != ("afr::attention_fwd",):
                raise AssertionError(f"neural {name}: operators {artifact.operators}, launches {run}")
        if not (kernels or monotone):
            with open(os.path.join(os.path.dirname(bank), "golden_mse.json")) as f:
                golden = json.load(f)["per_string_mse"]
            gt = unit_ground_truth(bake_font_atlas(font_path, proportional=font == "montserrat"), TEST_STRINGS)
            sheets = got.cpu().numpy().astype(np.float32) / 255.0
            mse = [float(np.mean((sheets[i] - gt[i]) ** 2)) for i in range(len(TEST_STRINGS))]
            delta = float(np.max(np.abs(np.array(mse) - np.array(golden))))
            mean = float(np.mean((sheets - gt) ** 2))
            line += (f"; learned MSE on the u8 grid {mean:.6f} (bound {LEARNED_BOUND[font]}), per-string delta "
                     f"to golden {delta:.3g} (tol {GOLDEN_TOL})")
            if not (delta < GOLDEN_TOL and mean < LEARNED_BOUND[font]):
                raise AssertionError(f"neural {name}: MSE {mean}, per-string delta {delta}")
        print(line + f" ({card})", flush=True)
    return counts


def _exported_standalone(workdir: str, path: str) -> None:
    """9d: the standalone runner in a subprocess on the card, from 9a's
    artifact: its BMPs equal `render --exported`'s."""
    from ai_font_renderer_tpu_torch.cli import TEST_STRINGS
    from ai_font_renderer_tpu_torch.fontgen.bmp import read_bmp

    root = os.path.dirname(os.path.abspath(__file__))
    tool = os.path.join(root, "ai_font_renderer_tpu_torch", "tools", "run_exported_standalone.py")
    out = os.path.join(workdir, "standalone")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, tool, path, out, *TEST_STRINGS], env=dict(os.environ, PYTHONPATH=root),
                         capture_output=True, text=True, timeout=300)
    for line in (res.stdout + res.stderr).splitlines():
        print(f"[export standalone] | {line}", flush=True)
    if res.returncode != 0:
        raise AssertionError(f"the standalone runner exited {res.returncode}")
    for i in range(len(TEST_STRINGS)):
        a = read_bmp(os.path.join(out, f"string_{i}.bmp"))
        b = read_bmp(os.path.join(workdir, "exported_renders", f"string_{i}.bmp"))
        if not np.array_equal(a, b):
            raise AssertionError(f"standalone string_{i}.bmp differs from render --exported's")
    print(f"[export] standalone runner on the card: 15 BMPs equal to `render --exported`'s, "
          f"{time.perf_counter() - t0:.2f} s with its interpreter's start", flush=True)


def phase_export(workdir: str, card: str, atlas_gps: float, serve_latency: dict) -> dict:
    """Phase 9: the deployment artifacts -> the launches of the in-process
    runs through them."""
    seconds = {}
    t0 = time.perf_counter()
    counts, path = _exported_flagship(workdir, card, atlas_gps)
    seconds["flagship"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    more = _exported_int8_and_serve(workdir, card, serve_latency)
    seconds["int8_and_serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    counts = {k: counts[k] + more[k] for k in counts}
    more = _exported_neural(workdir, card)
    counts = {k: counts[k] + more[k] for k in counts}
    seconds["neural"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _exported_standalone(workdir, path)
    seconds["standalone"] = time.perf_counter() - t0
    print(f"[export] seconds by check: {json.dumps({k: round(v, 2) for k, v in seconds.items()})}", flush=True)
    for name in ("fused_output", "gemm_bf16_bias_clamp", "fused_attention", "attention_wide_fwd"):
        if counts[name] <= 0:
            raise AssertionError(f"the exported programs never launched {name}: {counts}")
    return counts


# Phase 10: placement and implicit training (train/placement_cli.py,
# train/implicit.py). The committed nets' capacity (E 64, H 8, hidden 128)
# takes the general attention build; the CLI's default dims (E 32, H 4,
# hidden 64) the register-tiled f32 cluster kernels.
PLACEMENT_DIMS = {"E64,H8,hidden128": (64, 8, 128), "E32,H4,hidden64": (32, 4, 64)}
# A resumed fine-tune against the uninterrupted one: the tuned files
# bit-equal, and the last pixel MSE within this of each other, relative.
RESUME_REL_TOL = 1e-4


def _train_placement(argv: list[str], tag: str) -> tuple[list[dict], dict]:
    """`train-placement` in this process -> (its JSON lines, its stage
    seconds line)."""
    rc, lines = _cli(["train-placement", *argv], tag)
    if rc != 0:
        raise AssertionError(f"train-placement {tag} exited {rc}")
    rows = [json.loads(line) for line in lines if line.startswith("{")]
    return rows, next(r for r in rows if "stage_seconds" in r)


def _npz_diff(a: str, b: str) -> tuple[bool, float]:
    """(every array equal, largest |difference|) of two npz files."""
    with np.load(a) as za, np.load(b) as zb:
        keys = [k for k in za.files if za[k].dtype.kind == "f"]
        equal = za.files == zb.files and all(np.array_equal(za[k], zb[k]) for k in za.files)
        return equal, max(float(np.abs(za[k] - zb[k]).max()) for k in keys)


def _placement_chain(workdir: str, card: str) -> tuple[dict, dict]:
    """10a: the pipeline through the CLI in this process: FiraCode at the
    committed capacity with `--kernels attention` (supervised, SIREN bank,
    joint fine-tune with checkpoints, the evaluation rows), the fine-tune
    resumed from its step-50 checkpoint, Montserrat's structured head with
    `--kernels attention_v2`, and FiraCode at the CLI's default dims with
    `--kernels attention` -> (launches, rates)."""
    import shutil

    root = os.path.join(workdir, "placement")
    fira, resumed = os.path.join(root, "firacode"), os.path.join(root, "firacode_resumed")
    wide = ["--line-head", "5", "--embed-dim", "64", "--hidden-dim", "128", "--batch", "1024"]
    ft = ["--finetune-joint", "--finetune-steps", "100", "--finetune-samples", "4096", "--ft-checkpoint-every", "50"]
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    rows, stages = _train_placement(["--font", "firacode", "--kernels", "attention", "--samples", "20480", *wide,
                                     "--epochs", "2", "--e2e-steps", "300", *ft, "--out", fira], "placement firacode")
    seconds = {"firacode": time.perf_counter() - t0}
    epochs = [r for r in rows if "epoch" in r]
    e2e = next(r for r in rows if "end_to_end_neural_render_mse" in r)
    tuned = next(r for r in rows if "finetune_pixel_mse_last" in r)
    e2e_values = [e2e[k] for k in ("end_to_end_neural_render_mse", "engine_layout_oracle_mse",
                                   "engine_layout_oracle_tuned_mse", "siren_final_loss")]
    if not (len(epochs) == 2 and epochs[1]["val_rmse_px"] < epochs[0]["val_rmse_px"]
            and np.isfinite(e2e_values).all() and np.isfinite(tuned["finetune_pixel_mse_last"])):
        raise AssertionError(f"placement firacode: val rows {epochs}, e2e {e2e}, fine-tune {tuned}")
    st = stages["stage_seconds"]
    rates = {
        "supervised_steps_per_s": stages["supervised_steps"] / st["supervised_train"],
        "siren_steps_per_s": 300 / st["siren"],
        "finetune_steps_per_s": stages["finetune_steps"] / st["finetune"],
    }

    os.makedirs(resumed)
    shutil.copytree(os.path.join(fira, "ft_ckpt"), os.path.join(resumed, "ft_ckpt"))
    t0 = time.perf_counter()
    rows, _ = _train_placement(["--font", "firacode", "--kernels", "attention", "--samples", "20480", *wide,
                                "--epochs", "0", "--init-from", os.path.join(fira, "placement.npz"),
                                "--siren-from", os.path.join(fira, "siren.npz"), *ft, "--ft-resume",
                                "--out", resumed], "placement firacode resumed")
    seconds["firacode_resumed"] = time.perf_counter() - t0
    again = next(r for r in rows if "finetune_pixel_mse_last" in r)
    diffs = {name: _npz_diff(os.path.join(fira, name), os.path.join(resumed, name))
             for name in ("placement_finetuned.npz", "siren_finetuned.npz")}
    last_rel = abs(again["finetune_pixel_mse_last"] - tuned["finetune_pixel_mse_last"]) / tuned["finetune_pixel_mse_last"]
    print(f"[placement] --ft-resume from step 50 against the uninterrupted 100 steps: files bit-equal "
          f"{ {k: v[0] for k, v in diffs.items()} }, largest |difference| { {k: v[1] for k, v in diffs.items()} }; "
          f"last pixel MSE {again['finetune_pixel_mse_last']} vs {tuned['finetune_pixel_mse_last']} (rel {last_rel:.3g}, "
          f"tol {RESUME_REL_TOL}); first {again['finetune_pixel_mse_first']} vs {tuned['finetune_pixel_mse_first']}",
          flush=True)
    # The resume replays the run: the tuned files bit-equal (the gathers'
    # and the kernels' backward sum in a fixed order on the card).
    if not (last_rel <= RESUME_REL_TOL and again["finetune_pixel_mse_first"] == tuned["finetune_pixel_mse_first"]
            and all(equal for equal, _ in diffs.values())):
        raise AssertionError("the resumed fine-tune does not replay the uninterrupted one")

    for font, dims, kernels, extra in (("montserrat", wide, "attention_v2", ["--structured"]),
                                       ("firacode", ["--line-head", "5", "--batch", "1024"], "attention", [])):
        tag = f"{font} {'E64' if dims is wide else 'E32'} {kernels}"
        t0 = time.perf_counter()
        rows, stages = _train_placement(["--font", font, "--kernels", kernels, "--samples", "10240", *dims, *extra,
                                         "--epochs", "1", "--no-e2e", "--out", os.path.join(root, tag.replace(" ", "_"))],
                                        f"placement {tag}")
        seconds[tag] = time.perf_counter() - t0
        row = next(r for r in rows if "epoch" in r)
        if not all(np.isfinite(row[k]) for k in ("train_loss", "val_rmse_px", "val_line_acc")):
            raise AssertionError(f"placement {tag}: {row}")
        rates[f"supervised_steps_per_s {tag}"] = stages["supervised_steps"] / stages["stage_seconds"]["supervised_train"]
    torch.cuda.synchronize()
    counts = _counts()
    print(f"[placement] CLI runs' seconds {json.dumps({k: round(v, 2) for k, v in seconds.items()})}; launches "
          f"{json.dumps({k: v for k, v in counts.items() if v})} ({card})", flush=True)
    for name in ("fused_attention", "fused_attention2", "fused_attention_backward", "fused_attention2_backward",
                 "attention_wide_fwd", "attention_wide_bwd"):
        if counts[name] <= 0:
            raise AssertionError(f"placement training never launched {name}: {counts}")
    return counts, rates


def _placement_inputs(bsz: int):
    """A FiraCode batch: codes, midpoints and visibility of ``bsz`` corpus
    strings on the card, and the fine-tune's first 64: ids, valid and the
    ground truth."""
    from ai_font_renderer_tpu_torch.config import FIRACODE_PATH, PRINTABLE_ASCII, SheetSpec
    from ai_font_renderer_tpu_torch.fontgen.dataset import bake_font_atlas, synthesize_ground_truth
    from ai_font_renderer_tpu_torch.fontgen.layout import encode_codes
    from ai_font_renderer_tpu_torch.fontgen.textgen import generate_corpus
    from ai_font_renderer_tpu_torch.models import placement
    from ai_font_renderer_tpu_torch.render.implicit_sheet import known_slots
    from ai_font_renderer_tpu_torch.train.placement_cli import build_table

    strings = generate_corpus(bsz, base_seed=15)
    mids, vis = placement.placement_targets(strings, build_table(FIRACODE_PATH, SheetSpec(), PRINTABLE_ASCII, False))
    ids, valid = known_slots(strings[:64], PRINTABLE_ASCII, 100)
    gt = synthesize_ground_truth(bake_font_atlas(FIRACODE_PATH), strings[:64], on_device=True, device="cuda")
    cuda = [torch.from_numpy(a).cuda() for a in (encode_codes(strings, 100), mids, vis, ids, valid, gt)]
    return cuda[:3], cuda[3:]


def _placement_kernel_checks(workdir: str, card: str) -> dict:
    """10b: one supervised step's loss and gradients (batch 1024) and one
    joint fine-tune step's (batch 64, the bank 10a trained) with each fused
    attention flag against the plain attention, dropout off, at the
    committed capacity (general kernels) and the CLI's default dims
    (cluster kernels); then steps/s of the supervised step at dropout 0.2
    with each flag, a profiled supervised step, and the fine-tune step's
    steps/s and peak device memory -> rates."""
    from ai_font_renderer_tpu_torch.config import FIRACODE_PATH, ModelConfig, SheetSpec, replace
    from ai_font_renderer_tpu_torch.fontgen.ttf import TrueTypeFont
    from ai_font_renderer_tpu_torch.models import placement
    from ai_font_renderer_tpu_torch.ops.fused_attention import KEYS, kernel_takes
    from ai_font_renderer_tpu_torch.render.implicit_sheet import build_layout
    from ai_font_renderer_tpu_torch.train import optim
    from ai_font_renderer_tpu_torch.train import placement_cli as pc
    from ai_font_renderer_tpu_torch.utils.checkpoint import load_siren

    (codes, mids, vis), (ids, valid, gt) = _placement_inputs(1024)
    ft_codes = codes[:64]
    sp, scfg, _ = load_siren(os.path.join(workdir, "placement", "firacode", "siren.npz"), device="cuda")
    bank = pc.trainable(sp)
    lay = build_layout(TrueTypeFont.load(FIRACODE_PATH), SheetSpec(), scfg.cell, max_glyphs=100)
    flags = (None, "fused_attention", "fused_attention_v2")
    rates = {}
    for dims, (e, heads, hidden) in PLACEMENT_DIMS.items():
        base = replace(ModelConfig(), embedding_dim=e, num_heads=heads, hidden_dim=hidden)
        if kernel_takes(100, e, heads, torch.float32) != (e == 32):
            raise AssertionError(f"{dims}: kernel_takes does not pick the build phase 10 expects")
        params = pc.trainable(placement.init(torch.Generator().manual_seed(1), base, lines=5, device="cuda"))
        off = replace(base, dropout_rate=0.0, fc_dropout_rate=0.0)
        for kind in ("supervised", "finetune"):
            out = {}
            for flag in flags:
                cfg = replace(off, **{flag: True}) if flag else off
                if kind == "supervised":
                    loss = placement.loss_fn(params, codes, mids, vis, cfg, generator=torch.Generator(device="cuda"))
                    leaves = [params[k] for k in KEYS]
                else:
                    loss = pc.make_pixel_loss(cfg, scfg, lay)((params, bank), ft_codes, ids, valid, gt)
                    leaves = [params[k] for k in KEYS] + optim.tree_leaves(bank)
                grads = torch.autograd.grad(loss, leaves)
                out[flag] = (float(loss.detach()), dict(zip(KEYS, grads)))
            ref_loss, ref = out[None]
            scale = max(float(v.abs().max()) for v in ref.values())
            for flag in flags[1:]:
                loss, got = out[flag]
                loss_rel = abs(loss - ref_loss) / ref_loss
                grad_rel = max(float((got[k] - ref[k]).abs().max()) for k in KEYS) / scale
                print(f"[placement] {dims}, one {kind} step, {flag} vs plain attention (dropout off): loss {loss:.8g} "
                      f"vs {ref_loss:.8g} (rel {loss_rel:.3g}, tol {STEP_LOSS_REL_TOL}); gradient of wq..bo max err "
                      f"{grad_rel:.3g} of the largest (tol {STEP_ATTN_GRAD_TOL['f32']})", flush=True)
                if not (loss_rel <= STEP_LOSS_REL_TOL and grad_rel <= STEP_ATTN_GRAD_TOL["f32"]):
                    raise AssertionError(f"{dims} {kind} {flag}: loss rel {loss_rel}, grad rel {grad_rel}")
        # Steps/s of the supervised step at the model's dropout, each flag.
        for flag in flags:
            cfg = replace(base, **{flag: True}) if flag else base
            opt = optim.Adam(1e-3, weight_decay=1e-4)
            p = pc.trainable(params)
            state = opt.init(p)
            step = pc.make_supervised_step(cfg, opt)
            gen = torch.Generator(device="cuda").manual_seed(7)
            run = lambda: step(p, state, codes, mids, vis, None, None, None, gen)  # noqa: E731
            for _ in range(2):
                run()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                run()
            torch.cuda.synchronize()
            rates[f"supervised {dims} {flag or 'plain'}"] = 10 / (time.perf_counter() - t0)
            if flag == "fused_attention" and e == 64:
                _profile_fn(f"supervised placement step, B=1024, {dims}, fused_attention, dropout 0.2", run, top=12)
            del p, state
        # The joint fine-tune step at batch 64 with the kernels: steps/s and
        # its peak device memory.
        cfg = replace(base, fused_attention=True)
        tunable = (pc.trainable(params), pc.trainable(sp))
        opt = optim.Adam(1e-4)
        state = opt.init(tunable)
        step = pc.make_finetune_step(pc.make_pixel_loss(cfg, scfg, lay), opt)
        step(tunable, state, ft_codes, ids, valid, gt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        for _ in range(5):
            step(tunable, state, ft_codes, ids, valid, gt)
        torch.cuda.synchronize()
        rates[f"joint fine-tune {dims} fused_attention"] = 5 / (time.perf_counter() - t0)
        rates[f"joint fine-tune {dims} peak MiB above its inputs"] = (torch.cuda.max_memory_allocated() - base_mem) / 2**20
        if e == 64:
            _profile_fn(f"joint fine-tune step, B=64, {dims}, fused_attention, dropout 0.2",
                        lambda: step(tunable, state, ft_codes, ids, valid, gt), top=12)
        del tunable, state, params
    print(f"[placement] steps/s (10 after 2 warm; supervised at batch 1024, fine-tune at 64, 5 steps) and peak "
          f"memory: {json.dumps({k: round(v, 2) for k, v in rates.items()})} ({card})", flush=True)
    return rates


def _implicit_trainers(card: str) -> dict:
    """10c: train_siren at full size (95 glyphs, cell 64, hidden 128, 4
    layers, full batch), train_multifont on both fonts (2 x 95 glyphs) and
    train_siren in SDF mode on 16 glyphs, 200 steps each: the loss falls;
    steps/s over the run less its host targets' seconds."""
    from ai_font_renderer_tpu_torch.config import FIRACODE_PATH, MONTSERRAT_PATH, PRINTABLE_ASCII
    from ai_font_renderer_tpu_torch.fontgen.glyphs import rasterize_charset, sdf_charset
    from ai_font_renderer_tpu_torch.models.siren import SirenConfig
    from ai_font_renderer_tpu_torch.train.implicit import train_multifont, train_siren

    steps, rates = 200, {}
    sdf_chars = PRINTABLE_ASCII[33:49]
    runs = {
        "siren": (lambda: train_siren(FIRACODE_PATH, SirenConfig(), steps=steps, lr=3e-4, device="cuda"),
                  lambda: rasterize_charset(FIRACODE_PATH, PRINTABLE_ASCII, 64)),
        "multifont": (lambda: train_multifont([FIRACODE_PATH, MONTSERRAT_PATH], steps=steps, device="cuda"),
                      lambda: [rasterize_charset(f, PRINTABLE_ASCII, 64) for f in (FIRACODE_PATH, MONTSERRAT_PATH)]),
        "siren_sdf16": (lambda: train_siren(FIRACODE_PATH, SirenConfig(n_chars=16, mode="sdf"), charset=sdf_chars,
                                            steps=steps, device="cuda"),
                        lambda: sdf_charset(FIRACODE_PATH, sdf_chars, 64)),
    }
    for name, (train, targets) in runs.items():
        t0 = time.perf_counter()
        targets()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, losses, _ = train()
        total_s = time.perf_counter() - t0
        rates[name] = steps / (total_s - host_s)
        print(f"[implicit train] {name}: loss {losses[0]:.6f} -> {losses[-1]:.6f} in {steps} steps, {total_s:.2f} s "
              f"({host_s:.2f} s of it host targets): {rates[name]:.2f} steps/s ({card})", flush=True)
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"{name}: the loss did not fall: {losses[0]} -> {losses[-1]}")
    return rates


def _embedding_backward_forms(card: str) -> list[dict]:
    """10d: the embedding gathers' backward on the card at batch 1024,
    S 100, a 128-row table, the codes of 1024 corpus strings (a few rows,
    the padding first, take most of them), at the flagship's E 32 in f32
    and in bf16 (its bf16 frontend), hc307m's E 64 bf16 and the placement
    net's E 64 f32, in three forms:
    the kernels of csrc/gather_rows.cu that models/gather.py takes on the
    card, the index form that it took before (index_put_ with
    accumulation) and F.embedding, which it takes on the CPU. Device ms of
    the gather's forward and backward and whether three runs give the same
    bits (the card's form must); then the backward alone: the kernels (with
    their plan) against their byte bound, their plain version (which they
    must equal bit for bit; in bf16 the index form's bits too), the index
    form's index_put_ and F.embedding's backward, and each one's largest
    distance from the f64 sum. Returns the kernels' rows."""
    from ai_font_renderer_tpu_torch.fontgen.layout import encode_codes
    from ai_font_renderer_tpu_torch.fontgen.textgen import generate_corpus
    from ai_font_renderer_tpu_torch.models.gather import gather_rows
    from ai_font_renderer_tpu_torch.ops import gather_rows_backward, gather_rows_backward_reference, gather_rows_plan
    from ai_font_renderer_tpu_torch.utils.profiling import timed

    gen = torch.Generator(device="cuda").manual_seed(16)
    codes = torch.from_numpy(encode_codes(generate_corpus(1024, base_seed=15), 100)).long().cuda()
    flat = codes.reshape(-1)
    rows, kernel_rows = {}, []
    for tag, e, dt in (("flagship E32 f32", 32, torch.float32), ("flagship E32 bf16", 32, torch.bfloat16),
                       ("hc307m E64 bf16", 64, torch.bfloat16), ("placement E64 f32", 64, torch.float32)):
        table = torch.randn(128, e, generator=gen, device="cuda").requires_grad_()
        cot = torch.randn(1024, 100, e, generator=gen, device="cuda").to(dt)
        for form, gather in (("kernels, the card's", lambda t, dt=dt: gather_rows(t.to(dt), codes)),
                             ("index form", lambda t, dt=dt: t.to(dt)[codes]),
                             ("F.embedding", lambda t, dt=dt: torch.nn.functional.embedding(codes, t.to(dt)))):
            def run(gather=gather, cot=cot, table=table):
                return torch.autograd.grad(gather(table), table, cot)[0]

            grads = [run() for _ in range(3)]
            rows[f"{tag}, {form}"] = {"ms": time_ms(run, 20),
                                      "deterministic": all(torch.equal(grads[0], g) for g in grads[1:])}
        exact = torch.zeros(128, e, dtype=torch.float64, device="cuda").index_add_(
            0, flat, cot.reshape(-1, e).double())
        got = gather_rows_backward(codes, cot, 128, dt)
        plain = gather_rows_backward_reference(codes, cot, 128, dt)
        torch.cuda.synchronize()
        if not torch.equal(got, plain):
            raise AssertionError(f"{tag}: the gather kernels differ from their plain version by "
                                 f"{float((got.float() - plain.float()).abs().max())}")
        index = torch.zeros(128, e, dtype=dt, device="cuda").index_put_((codes,), cot, accumulate=True)
        if dt == torch.bfloat16 and not torch.equal(got, index):
            raise AssertionError(f"{tag}: the bf16 kernel differs from the index form's bits")
        library = torch.ops.aten.embedding_dense_backward(cot, codes, 128, -1, False)
        bound_ms, bound_by = _bound(cot.numel() * cot.element_size() + 8 * codes.numel() + 128 * e * cot.element_size(),
                                    codes.numel() * e, F32_CUDA_CORE_FLOPS)
        kernel_rows.append({
            "shape": f"B=1024,S=100,V=128,E={e},{str(dt).split('.')[-1]}",
            "max_abs_err": float((got.float() - plain.float()).abs().max()),
            "ms": time_ms(lambda: gather_rows_backward(codes, cot, 128, dt), 50),
            # The plain version syncs inside, which time_ms cannot queue: host clock.
            "plain_ms": 1e3 * timed(gather_rows_backward_reference, codes, cot, 128, dt, iters=1, warmup=0),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": time_ms(lambda: torch.ops.aten.embedding_dense_backward(cot, codes, 128, -1, False), 50),
            "index_form_ms": time_ms(
                lambda: torch.zeros(128, e, dtype=dt, device="cuda").index_put_((codes,), cot, accumulate=True), 5),
            "f64_err": {name: float((v.double() - exact).abs().max())
                        for name, v in (("kernels", got), ("index_form", index), ("library", library))},
            "plan": gather_rows_plan(codes.numel(), 128, e, dt),
        })
    print(f"[placement] embedding gathers' forward + backward at B=1024, S=100 (corpus codes), 128 rows, device ms and "
          f"whether 3 runs give the same bits: {json.dumps(rows)} ({card})", flush=True)
    print(f"[placement] the gathers' backward alone (gather_rows_bwd): {json.dumps(kernel_rows)} ({card})", flush=True)
    if not all(v["deterministic"] for k, v in rows.items() if "card" in k):
        raise AssertionError(f"the card's gather backward is not deterministic: {rows}")
    return kernel_rows


def phase_placement(workdir: str, card: str) -> tuple[dict, list[dict], list[dict], list[dict]]:
    """Phase 10: placement and implicit training, then 10d, the embedding
    gathers' backward forms -> (the launches of the CLI runs, the general
    attention's forward and backward rows at the placement net's training
    shape, the gathers' backward kernels' rows)."""
    seconds = {}
    t0 = time.perf_counter()
    counts, rates = _placement_chain(workdir, card)
    seconds["chain"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rates.update(_placement_kernel_checks(workdir, card))
    seconds["kernel_checks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rates.update(_implicit_trainers(card))
    seconds["implicit_trainers"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fwd_rows, bwd_rows = check_attention_wide(shapes=((100, 64, 8),), dtypes=(torch.float32,), extra=())
    seconds["general_attention"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gather_rows = _embedding_backward_forms(card)
    seconds["embedding_backward"] = time.perf_counter() - t0
    print(f"[placement] rates {json.dumps({k: round(v, 3) for k, v in rates.items()})} ({card})", flush=True)
    print(f"[placement] seconds by check: {json.dumps({k: round(v, 2) for k, v in seconds.items()})}", flush=True)
    return counts, fwd_rows, bwd_rows, gather_rows


# -- phase 11: the device mesh --------------------------------------------
MESH_BATCH = 1024
MESH_SEED = 11
# Against the one-process step on the same weights and batch, dropout 0
# (tests/test_parallel.py's bounds): the loss and out_b.
MESH_LOSS_RTOL = 2e-5
MESH_OUT_B_ATOL = 2e-5
# Every other parameter, through its gradient (mu/(1-b1) after one step
# from zero f32 moments), relative to the leaf's largest value (an
# attention weight's: the largest of the eight, since bk's gradient is 0 in
# exact arithmetic, rounding noise in both): the ranks sum the same
# products in another order (per-rank rows, the all-reduce, K1/K2/K3 on
# column shards). A bf16 frontend rounds its partial sums to bf16 where the
# one process rounds the whole batch's.
MESH_GRAD_REL_TOL = {"f32": 1e-3, "bf16": 5e-2}
MESH_RATE_TOL = 0.03  # (a): the mesh code's steps/s within 3% of the plain step's
# Steps at dropout 0.2 on one batch. The first update from fresh moments
# moves every weight by the learning rate and throws the loss up; after it
# the loss must fall.
MESH_FALL_STEPS = 5
MESH_TIME_STEPS = 6


def _mesh_configs() -> dict:
    """(b)'s runs: name -> (step, (data, model), mcfg, precision)."""
    from ai_font_renderer_tpu_torch.config import ModelConfig, replace

    base = ModelConfig(use_pallas_output=True)
    fast = ModelConfig(bf16_frontend=True, bits_dropout=True, fused_attention_v2=True)
    return {
        "output_2x1": ("sharded", (2, 1), base, "f32"),
        "output_1x2": ("sharded", (1, 2), base, "f32"),
        "attn_v1_dp": ("explicit", (2, 1), replace(base, fused_attention=True), "f32"),
        "attn_v2_fast_dp": ("explicit", (2, 1), fast, "bf16"),
    }


def _mesh_params():
    """Full-width weights from MESH_SEED, drawn on the CPU (the same in
    every process), on the card."""
    from ai_font_renderer_tpu_torch.config import ModelConfig
    from ai_font_renderer_tpu_torch.models import font_renderer

    params = font_renderer.init(torch.Generator().manual_seed(MESH_SEED), ModelConfig(), "cpu")
    return {k: v.cuda() for k, v in params.items()}


def _mesh_batch(path: str):
    with np.load(path) as z:
        codes, targets = torch.from_numpy(z["codes"]).cuda(), torch.from_numpy(z["targets_u8"]).cuda()
    return codes, targets.float() / 255.0


def _digests(params: dict) -> dict:
    import hashlib

    return {k: hashlib.sha256(v.detach().cpu().numpy().tobytes()).hexdigest()[:16] for k, v in params.items()}


def _grad_errors(mu: dict, ref_mu: dict, b1: float = 0.9) -> dict:
    """Each leaf's gradient (mu / (1 - b1)) against the reference's, as a
    share of the reference's largest value; the attention weights' as a
    share of the largest of the eight."""
    from ai_font_renderer_tpu_torch.ops.fused_attention import KEYS

    step = float(np.float32(1) - np.float32(b1))
    largest = {k: float(v.float().abs().max()) / step for k, v in ref_mu.items()}
    attn = max(largest[k] for k in KEYS)
    return {k: float((mu[k].float() - ref_mu[k].float()).abs().max()) / step
            / max(attn if k in KEYS else largest[k], 1e-30) for k in ref_mu}


def mesh_rank(job_path: str) -> int:
    """One rank of phase 11 (b)/(c), started by phase_mesh: each run of
    _mesh_configs through the mesh code at full width, batch MESH_BATCH
    split over the ranks; rank 0 then holds each against the one-process
    step and writes the report. Every rank writes its launches."""
    import torch.distributed as dist

    from ai_font_renderer_tpu_torch.config import TrainConfig, replace
    from ai_font_renderer_tpu_torch.device import resolve_device
    from ai_font_renderer_tpu_torch.parallel import mesh as pmesh
    from ai_font_renderer_tpu_torch.parallel import (
        gather_state, make_mesh, make_shard_map_train_step, shard_batch, shard_state,
    )
    from ai_font_renderer_tpu_torch.train.step import state_from_params, train_step
    from ai_font_renderer_tpu_torch.utils.checkpoint import CheckpointManager

    rank = pmesh.init_rank()
    resolve_device("cuda")
    with open(job_path) as f:
        job = json.load(f)
    codes_all, targets_all = _mesh_batch(job["batch"])
    params0 = _mesh_params()
    tcfg = TrainConfig(adam_mu_bf16=False)
    counts = {k: 0 for k in _kernel_fns()}
    report = {}

    for name, (kind, shape, mcfg, precision) in _mesh_configs().items():
        mesh = make_mesh(*shape)
        no_drop = replace(mcfg, dropout_rate=0.0, fc_dropout_rate=0.0)
        if kind == "sharded":
            codes, targets = shard_batch(mesh, codes_all, targets_all)

            def run(state, m, seed):
                return train_step(state, codes, targets, 1e-3, torch.Generator(device="cuda").manual_seed(seed),
                                  m, tcfg, mesh)

            def fresh():
                return shard_state(mesh, state_from_params(params0, tcfg))
        else:
            steps = {}

            def run(state, m, seed):
                if m not in steps:
                    steps[m] = make_shard_map_train_step(mesh, m, tcfg)
                return steps[m](state, codes_all, targets_all, 1e-3, seed)

            def fresh():
                return state_from_params(params0, tcfg)

        torch.cuda.synchronize()
        dist.barrier()
        _reset_counts()
        state, loss = run(fresh(), no_drop, 7)
        whole = gather_state(mesh, state) if kind == "sharded" else state
        got = {"loss": float(loss), "out_b": whole.params["out_b"].detach().clone(),
               "mu": {k: v.clone() for k, v in whole.mu.items()}}
        del state, whole
        state, falls = fresh(), []
        for i in range(MESH_FALL_STEPS):
            state, loss = run(state, mcfg, 100 + i)
            falls.append(float(loss))
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for i in range(MESH_TIME_STEPS):
            state, loss = run(state, mcfg, 200 + i)
        torch.cuda.synchronize()
        dist.barrier()
        rate = MESH_TIME_STEPS / (time.perf_counter() - t0)
        if name == "output_1x2":
            # (c): the mesh writes the one-device checkpoint format.
            CheckpointManager(job["checkpoint"]).save(1, state, state.params, {"epoch": 1}, mesh=mesh)
            report["checkpoint_digests"] = _digests(gather_state(mesh, state).params)
        torch.cuda.synchronize()
        run_counts = _counts()
        counts = {k: counts[k] + run_counts[k] for k in counts}
        shard = state.params["out_w"].shape[1]
        del state
        dist.barrier()
        if rank == 0:
            # The one-process step on the whole batch, same weights.
            ref, ref_loss = train_step(state_from_params(params0, tcfg), codes_all, targets_all, 1e-3,
                                       torch.Generator(device="cuda").manual_seed(7), no_drop, tcfg)
            errs = _grad_errors(got["mu"], ref.mu)
            report[name] = {
                "mesh": list(shape), "step": kind, "out_w_shard_columns": shard,
                "loss": got["loss"], "ref_loss": float(ref_loss),
                "loss_rel": abs(got["loss"] - float(ref_loss)) / float(ref_loss),
                "out_b_max_abs": float((got["out_b"] - ref.params["out_b"].detach()).abs().max()),
                "grad_rel": max(errs.values()), "grad_rel_leaf": max(errs, key=errs.get),
                "grad_tol": MESH_GRAD_REL_TOL[precision], "dropout_losses": falls, "steps_per_s": rate,
                "launches": {k: v for k, v in run_counts.items() if v},
            }
            del ref
        del got
        torch.cuda.empty_cache()
    with open(os.path.join(job["out"], f"counts_{rank}.json"), "w") as f:
        json.dump(counts, f)
    if rank == 0:
        with open(os.path.join(job["out"], "report.json"), "w") as f:
            json.dump(report, f)
    pmesh.finish_rank()
    return 0


def _plain_and_mesh_rates(params, codes, targets, mcfg, tcfg, mesh, runs: int = 24, steps: int = 20) -> dict:
    """Steps/s of the one-device step and the same step through the mesh
    code on a (1, 1) mesh, in turns (P M M P ...) on one state (a (1, 1)
    shard is the whole tensor), 2 x ``runs`` runs each, with every run's
    rate. Each mesh run is divided by the plain run beside it (M1 / P1, M2
    / P2 in each P M M P), and the median of those ratios is the result:
    the step is host-bound and the host drifts slower late in the script,
    so only runs taken side by side are compared. The collector, which
    scans every object the earlier phases left, is paused."""
    from ai_font_renderer_tpu_torch.parallel import shard_state
    from ai_font_renderer_tpu_torch.train.step import state_from_params, train_step

    plain = state_from_params(params, tcfg)
    states = {"plain": (plain, None), "mesh": (shard_state(mesh, plain), mesh)}
    gen = torch.Generator(device="cuda").manual_seed(5)
    rates = {"plain": [], "mesh": []}
    order = ["plain", "mesh", "mesh", "plain"] * runs
    gc.collect()
    gc.disable()
    try:
        for i, name in enumerate(order[:2] + order):
            state, m = states[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                train_step(state, codes, targets, 1e-3, gen, mcfg, tcfg, m)
            torch.cuda.synchronize()
            if i >= 2:
                rates[name].append(steps / (time.perf_counter() - t0))
    finally:
        gc.enable()
    # In order, plain[i] and mesh[i] are neighbours: P1 M1 | M2 P2.
    ratios = [m / p for m, p in zip(rates["mesh"], rates["plain"])]
    return {"ratio": float(np.median(ratios)), "plain": float(np.median(rates["plain"])),
            "mesh": float(np.median(rates["mesh"])), "ratios": ratios, "runs": rates}


def phase_mesh(workdir: str, card: str) -> dict:
    """Phase 11: the device mesh -> the launches of its runs (both ranks'
    and (a)'s)."""
    from ai_font_renderer_tpu_torch.config import ModelConfig, TrainConfig
    from ai_font_renderer_tpu_torch.parallel import launch, shard_state, single_device_mesh
    from ai_font_renderer_tpu_torch.train.step import state_from_params, train_step
    from ai_font_renderer_tpu_torch.utils.checkpoint import CheckpointManager

    rng = np.random.default_rng(MESH_SEED)
    codes_np = rng.integers(32, 91, (MESH_BATCH, 100)).astype(np.int32)
    targets_np = rng.integers(0, 256, (MESH_BATCH, 80, 240)).astype(np.uint8)
    targets_np[targets_np < 160] = 0  # mostly paper, some ink
    batch_path = os.path.join(workdir, "mesh_batch.npz")
    np.savez(batch_path, codes=codes_np, targets_u8=targets_np)
    codes, targets = _mesh_batch(batch_path)
    params = _mesh_params()

    # (a) A step through the mesh code on a (1, 1) mesh: bit for bit the
    # plain step, at the plain step's speed.
    mcfg, tcfg = ModelConfig(use_pallas_output=True), TrainConfig()
    mesh = single_device_mesh()
    torch.cuda.synchronize()
    _reset_counts()
    plain, plain_loss = train_step(state_from_params(params, tcfg), codes, targets, 1e-3,
                                   torch.Generator(device="cuda").manual_seed(7), mcfg, tcfg)
    on_mesh, mesh_loss = train_step(shard_state(mesh, state_from_params(params, tcfg)), codes, targets, 1e-3,
                                    torch.Generator(device="cuda").manual_seed(7), mcfg, tcfg, mesh)
    torch.cuda.synchronize()
    counts = _counts()
    unequal = [k for k in plain.params if not (torch.equal(plain.params[k], on_mesh.params[k])
                                               and torch.equal(plain.mu[k], on_mesh.mu[k])
                                               and torch.equal(plain.nu[k], on_mesh.nu[k]))]
    print(f"[mesh] (a) --mesh 1,1 step through the mesh code, output kernels, dropout 0.2: loss "
          f"{float(mesh_loss):.9g} vs the plain step's {float(plain_loss):.9g}; leaves not bit-equal {unequal}",
          flush=True)
    if not (torch.equal(plain_loss, mesh_loss) and not unequal):
        raise AssertionError(f"mesh (1,1) step differs from the plain step: {unequal}")
    del plain, on_mesh
    rates = _plain_and_mesh_rates(params, codes, targets, mcfg, tcfg, mesh)
    ratio = rates["ratio"]
    print(f"[mesh] (a) steps/s at batch {MESH_BATCH}: plain {rates['plain']:.3f}, through the (1,1) mesh "
          f"{rates['mesh']:.3f} (medians); the median of the per-turn ratios (each mesh run over the plain run "
          f"beside it) {ratio:.4f}x, tol {MESH_RATE_TOL}; every ratio "
          f"{json.dumps([round(r, 4) for r in rates['ratios']])}; every run "
          f"{json.dumps({k: [round(r, 2) for r in v] for k, v in rates['runs'].items()})} ({card})", flush=True)
    if abs(ratio - 1.0) > MESH_RATE_TOL:
        raise AssertionError(f"the (1,1) mesh step runs {ratio:.4f}x the plain step")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # (b) Two ranks on this card over gloo; (c) their (1,2) checkpoint.
    out = os.path.join(workdir, "mesh_out")
    os.makedirs(out, exist_ok=True)
    job = {"batch": batch_path, "checkpoint": os.path.join(workdir, "mesh_ckpt"), "out": out}
    with open(os.path.join(workdir, "mesh_job.json"), "w") as f:
        json.dump(job, f)
    t0 = time.perf_counter()
    code = launch([os.path.abspath(__file__), "--mesh-rank", os.path.join(workdir, "mesh_job.json")], 2, "cuda",
                  backend="gloo", timeout=300)
    print(f"[mesh] (b) two ranks on {torch.cuda.get_device_name(0)} over gloo: exit {code} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if code != 0:
        raise AssertionError(f"the mesh ranks exited {code}")
    with open(os.path.join(out, "report.json")) as f:
        report = json.load(f)
    for r in range(2):
        with open(os.path.join(out, f"counts_{r}.json")) as f:
            counts = {k: counts[k] + v for k, v in json.load(f).items()}
    failed = []
    for name, row in report.items():
        if name == "checkpoint_digests":
            continue
        print(f"[mesh] (b) {name}: {json.dumps(row)}", flush=True)
        if not (row["loss_rel"] <= MESH_LOSS_RTOL and row["out_b_max_abs"] <= MESH_OUT_B_ATOL
                and row["grad_rel"] <= row["grad_tol"] and row["dropout_losses"][-1] < row["dropout_losses"][1]):
            failed.append(name)
    if failed:
        raise AssertionError(f"mesh runs outside their bounds: {failed}")
    print(f"[mesh] (b) steps/s at batch {MESH_BATCH} (two ranks sharing the card, gloo): "
          f"{json.dumps({k: round(v['steps_per_s'], 3) for k, v in report.items() if k != 'checkpoint_digests'})} "
          f"({card})", flush=True)
    wanted = {"output_2x1": ("fused_output", "fused_output_dx", "fused_output_dw"),
              "output_1x2": ("fused_output", "fused_output_dx", "fused_output_dw"),
              "attn_v1_dp": ("fused_attention", "fused_attention_backward", "fused_output"),
              "attn_v2_fast_dp": ("fused_attention2", "fused_attention2_backward", "attention_mma_fwd",
                                  "attention_mma_bwd")}
    for name, kernels in wanted.items():
        missing = [k for k in kernels if not report[name]["launches"].get(k)]
        if missing:
            raise AssertionError(f"mesh {name} never launched {missing} on rank 0")

    # (c) The (1,2) checkpoint resumes on one device with equal parameters.
    _, state, _, host = CheckpointManager(job["checkpoint"]).restore(None, state_from_params(_mesh_params(),
                                                                                             TrainConfig()))
    got = _digests(state.params)
    print(f"[mesh] (c) the (1,2) checkpoint restored on one device: {len(got)} leaves, digests equal to the "
          f"ranks' gathered parameters: {got == report['checkpoint_digests']}", flush=True)
    if got != report["checkpoint_digests"]:
        raise AssertionError("the (1,2) checkpoint does not restore the ranks' parameters")
    del state

    # (d) A mesh larger than the card count exits 1 with make_mesh's message.
    rc, lines = _cli(["--train", "--mesh", "2,1", "--output", os.path.join(workdir, "mesh_refused")], "mesh (d)")
    if rc != 1 or not any("mesh 2x1 needs 2 > 1 devices" in line for line in lines):
        raise AssertionError(f"--mesh 2,1 on one card: exit {rc}, {lines}")
    return counts


# -- phase 12: the measurement tools ---------------------------------------
# trace_step's kernel sets: the training paths of phase 5 (PERF.md's names).
TRACE_PATHS = {"fused": ("parity", "fused"), "attn_v1": ("parity", "fused,attention"),
               "attn_v2_fast": ("fast_hr_rematdots", "attention_v2")}
SPAN_TOL_MS = 1e-3  # trace_step: busy + idle against the span


def _tool(name: str, fn) -> tuple[list, float]:
    """``fn()`` (a tool's main) in this process, its output kept and shown
    after it -> (its JSON lines, seconds). Every line that opens with "{"
    must parse as JSON."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            fn()
    finally:
        print(buf.getvalue(), end="", flush=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    rows = [json.loads(line) for line in buf.getvalue().splitlines() if line.startswith("{")]
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[tools] {name}: {seconds:.2f} s, {len(rows)} JSON lines parsed", flush=True)
    return rows, seconds


def phase_tools(workdir: str, card: str) -> dict:
    """Phase 12: each measurement tool of ai_font_renderer_tpu_torch/tools/
    in this process at the JAX tool's shapes, only the iteration counts cut
    -> the phase's launches. ab_kernel_micro (K9's home) must launch K9;
    trace_step runs the `fused`, `attn_v1` and `attn_v2_fast` steps, each
    device's busy + idle equal to its span."""
    from ai_font_renderer_tpu_torch.tools import (
        ab_fused,
        ab_fused_attention,
        ab_profiles,
        bench_batch_sweep,
        bench_inference,
        bench_neural_render,
        bench_serve,
        profile_train,
        roofline_bwd,
        trace_step,
    )

    seconds = {}
    _, seconds["ab_kernel_micro"] = _tool("ab_kernel_micro", phase_ab_xt)
    traces = {}
    for name, (profile, kernels) in TRACE_PATHS.items():
        rows, seconds[f"trace_step {name}"] = _tool(f"trace_step {name}", lambda p=profile, k=kernels: trace_step.main(
            [p, "--kernels", k], log_root=os.path.join(workdir, "traces")))
        row = rows[0]
        gpu = row.get("GPU 0")
        if not gpu or gpu["events"] <= 0 or abs(gpu["busy_ms"] + gpu["idle_ms"] - gpu["span_ms"]) > SPAN_TOL_MS:
            raise AssertionError(f"trace_step {name}: no device events, or busy + idle is not the span: {gpu}")
        traces[name] = {"busy_ms_per_step": gpu["busy_ms_per_step"], "idle_ms_per_step": gpu["idle_ms_per_step"],
                        "wall_ms_per_step_traced": row["wall_ms_per_step_traced"], **row["wall_ms_per_step"],
                        "longest_idle_gaps": gpu["longest_idle_gaps"]}
    runs = {
        "profile_train": lambda: profile_train.main([], iters=5, steps=5),
        "ab_profiles": lambda: ab_profiles.main(["fast", "fast_handrolled"], rounds=2),
        "roofline_bwd": lambda: roofline_bwd.main([], iters=5, windows=2),
        "ab_fused": lambda: ab_fused.main([], rounds=1),
        "ab_fused_attention": lambda: ab_fused_attention.main([], iters=10, rounds=2, epochs=1),
        "bench_inference": lambda: bench_inference.main([], iters=10, rounds=2),
        "bench_batch_sweep": lambda: bench_batch_sweep.main([], iters=5, rounds=1),
        "bench_serve": lambda: bench_serve.main(["4", "5", "64", "--format", "raw,zlib"]),
        "bench_neural_render": lambda: bench_neural_render.main(["--iters", "3"]),
    }
    for name, run in runs.items():
        _, seconds[name] = _tool(name, run)
    torch.cuda.synchronize()
    counts = _counts()
    print(f"[tools] trace_step per step (ms; {card}): {json.dumps(traces)}", flush=True)
    print(f"[tools] seconds by tool: {json.dumps({k: round(v, 2) for k, v in seconds.items()})}; "
          f"{sum(seconds.values()):.2f} s in all", flush=True)
    return counts


# -- phase 13: the rest of the tools ----------------------------------------
REST_SAMPLES = 4096  # the runners' corpora, cut from 150000 (4 steps of 1024 an epoch)


def _counted(name: str, fn) -> tuple[list, float, dict]:
    """:func:`_tool` with the launches of its run -> (JSON lines, seconds,
    launches)."""
    torch.cuda.synchronize()
    _reset_counts()
    rows, seconds = _tool(name, fn)
    return rows, seconds, _counts()


def _finite(*values) -> bool:
    return all(np.isfinite(v) for v in values)


def _rest_checks(name: str, rows: list, launches: dict, workdir: str) -> str:
    """Phase 13's check of one tool's JSON lines and launches -> what it
    held, for the log; raises on a failure."""
    from ai_font_renderer_tpu_torch.config import FIRACODE_PATH
    from ai_font_renderer_tpu_torch.fontgen.glyphs import unicode_charset

    def need(cond, what):
        if not cond:
            raise AssertionError(f"{name}: {what}: {json.dumps(rows)[:2000]}; launches {launches}")

    def launched(*kernels):
        missing = [k for k in kernels if launches[k] <= 0]
        need(not missing, f"never launched {missing}")

    if name == "ab_fa2":
        (row,) = rows
        grad = max(v for k, v in row["grad_rel"].items() if k != "out_w")
        need(grad <= STEP_ATTN_GRAD_TOL["f32"], f"v2 gradients {grad} > {STEP_ATTN_GRAD_TOL['f32']}")
        need(row["grad_rel"]["out_w"] <= STEP_DW_REL_TOL, f"v2 out_w gradient over {STEP_DW_REL_TOL}")
        need(len(row["train_step_ms"]) == 6 and _finite(*row["train_step_ms"].values()), "train-step rows")
        launched("fused_attention", "fused_attention_backward", "fused_attention2", "fused_attention2_backward",
                 "attention_mma_fwd", "attention_mma_bwd")
        return (f"v2 fwd max|diff| {row['fwd_diff']:.3g}; gradients {grad:.3g} of the largest (tol "
                f"{STEP_ATTN_GRAD_TOL['f32']}), out_w {row['grad_rel']['out_w']:.3g} (tol {STEP_DW_REL_TOL})")
    if name == "ab_serving_tiers":
        (row,) = rows
        means = {t: r["mean_abs_diff_vs_fp32"] for t, r in row["tiers"].items()}
        need(all(m < INT8_MEAN_TOL for m in means.values()), f"a tier's mean |diff| to fp32 over {INT8_MEAN_TOL}")
        launched("fused_output", "gemm_bf16_bias_clamp", "fused_attention", "attention_mma_fwd")
        return f"mean |diff| to fp32 {json.dumps(means)} (tol {INT8_MEAN_TOL})"
    if name == "ab_hard_decode":
        need(len(rows) == 2, "one record a committed pair")
        worst = 0.0
        for r in rows:
            with open(os.path.join(r["run"], "golden_mse.json")) as f:
                golden = json.load(f)["per_string_mse"]
            worst = max(worst, float(np.abs(np.array(r["e2e_render_mse_soft_per_string"]) - golden).max()))
            need(_finite(r["e2e_render_mse_hard"], r["e2e_render_mse_mono"]), "hard/mono MSE")
        need(worst <= GOLDEN_TOL, f"soft per-string MSE {worst} from golden_mse.json (tol {GOLDEN_TOL})")
        return f"soft per-string MSE within {worst:.3g} of golden_mse.json (tol {GOLDEN_TOL})"
    if name == "eval_decode_modes":
        need(len(rows) == 6 and all(_finite(r["val_rmse_px"], r["val_p99_px"]) and 0 <= r["val_line_acc"] <= 1
                                    for r in rows), "six finite records")
        launched("attention_wide_fwd")
        return "two nets x three decodes, through the general attention forward"
    if name == "bench_sdf_atlas":
        (row,) = rows
        need(row["charset_size"] == len(unicode_charset(FIRACODE_PATH)) and row["value"] > 0
             and _finite(row["final_sdf_mse"]), "the full charset's atlas")
        return f"{row['charset_size']} glyphs, {row['value']} glyphs/s"
    if name == "render_implicit_demo":
        (row,) = rows
        out = os.path.join(workdir, "rest", "torch_implicit_sheets")
        need(len(os.listdir(out)) == 30 and row["compose_glyphs_per_sec"] > 0
             and _finite(row["test_strings_mse_vs_truth"]), "30 BMPs, a rate, a finite MSE")
        return f"compose {row['compose_glyphs_per_sec']} glyphs/s"
    if name == "run_extended_configs":
        need([r["config"] for r in rows] == ["siren-implicit-64", "multifont-2ttf", "sdf-unicode-atlas",
                                             "montserrat-flagship"], "the four sections")
        need(_finite(rows[0]["atlas_mse"], rows[1]["atlas_mse"], rows[2]["final_sdf_mse"], rows[3]["best_val_loss"]),
             "finite losses")
        launched("fused_output", "fused_dw_adamw")
        return f"SDF atlas {rows[2]['atlas_glyphs_per_sec']} glyphs/s"
    if name.startswith("run_montserrat") or name in ("fast60", "h2h_ours"):
        need(rows and all(_finite(r["best_val_loss"]) for r in rows), "a finite val loss")
        if name == "run_montserrat_converged":
            launched("fused_output", "fused_output_dx", "fused_dw_adamw")
        if name == "run_montserrat_conv":
            launched("fused_attention", "fused_attention_backward", "attention_mma_fwd", "attention_mma_bwd")
        if name == "run_montserrat_conv_ps":
            launched("fused_attention2", "fused_attention2_backward", "attention_mma_fwd", "attention_mma_bwd")
        return f"best val {[r['best_val_loss'] for r in rows]}"
    if name == "refresh_artifacts":
        (row,) = rows
        with open(os.path.join(os.path.dirname(_implicit_paths("firacode")[0]), "golden_mse.json")) as f:
            golden = json.load(f)["mean_mse"]
        need(row["exported_u8_equal"], "the exported artifact's sheets differ from the direct render")
        need(abs(row["e2e_mse"] - golden) <= GOLDEN_TOL, f"e2e MSE {row['e2e_mse']} vs golden {golden}")
        return f"e2e MSE {row['e2e_mse']:.8f} (golden {golden}), exported u8-equal"
    if name == "summarize_run":
        (row,) = rows
        need(row["epochs"] >= 1 and _finite(row["best_val_loss"]), "a summary")
        return f"{row['epochs']} epochs, best val {row['best_val_loss']}"
    if name == "round4_task5":
        for row in rows:
            gpu = row.get("GPU 0")
            need(gpu and gpu["events"] > 0 and abs(gpu["busy_ms"] + gpu["idle_ms"] - gpu["span_ms"]) <= SPAN_TOL_MS,
                 "a trace without device events, or busy + idle is not the span")
        return "two traces, busy + idle = span"
    raise AssertionError(f"no check for {name}")


def _fa2_inputs():
    """ab_fa2's weights and codes, drawn as the tool draws them (seeds 0
    and 1), so that the check can bound its forward."""
    from ai_font_renderer_tpu_torch.config import ModelConfig
    from ai_font_renderer_tpu_torch.models import font_renderer

    params = font_renderer.init(torch.Generator(device="cuda").manual_seed(0), ModelConfig(), "cuda")
    codes = torch.randint(65, 91, (1024, 100), generator=torch.Generator(device="cuda").manual_seed(1),
                          device="cuda", dtype=torch.int32)
    return params, codes


def _bf16_flip_excess(params, codes, sheets) -> float:
    """How far the two forwards of ab_fa2 (plain and v2 attention) differ
    beyond what the bf16 projection allows: a flat feature x_k that moves
    in the last f32 bits (the attention's sums in another order) may round
    to its other bf16 neighbour, ulp(x_k) = 2^(e - 8) for |x_k| in [2^(e-1),
    2^e), so a sheet pixel may move by sum_k ulp(x_k) |W_kn|, plus K1_TOL
    for the f32 sums' order. -> the largest |difference| less that bound
    (<= 0 passes)."""
    from ai_font_renderer_tpu_torch.config import ModelConfig
    from ai_font_renderer_tpu_torch.models import font_renderer

    with torch.no_grad():
        flat = font_renderer.frontend(params, codes, ModelConfig())
        e = torch.frexp(flat).exponent
        ulp = torch.where(flat == 0, torch.zeros_like(flat), torch.ldexp(torch.ones_like(flat), e - 8))
        bound = (ulp @ params["out_w"].abs() + K1_TOL).reshape(sheets[0].shape)
        return float(((sheets[0] - sheets[1]).abs() - bound).max())


def _fontgen(out: str, n: int) -> None:
    """``fontgen`` of ``n`` FiraCode samples into ``out`` (the CLI, in this
    process)."""
    rc, _ = _cli(["fontgen", "--num-samples", str(n), "--out", out], "rest fontgen")
    if rc != 0:
        raise AssertionError(f"fontgen exited {rc}")


def phase_rest_tools(workdir: str, card: str) -> dict:
    """Phase 13: the rest of ai_font_renderer_tpu_torch/tools/ in this
    process, at the JAX tools' shapes with only counts cut, each one's JSON
    lines checked -> the phase's launches."""
    from ai_font_renderer_tpu_torch.tools import (
        ab_fa2,
        ab_hard_decode,
        ab_serving_tiers,
        bench_sdf_atlas,
        eval_decode_modes,
        fast60,
        h2h_ours,
        refresh_artifacts,
        render_implicit_demo,
        round4_task5,
        run_extended_configs,
        run_montserrat_conv,
        run_montserrat_converged,
        run_montserrat_hc,
        summarize_run,
    )

    out = os.path.join(workdir, "rest")
    fa2_params, fa2_codes = _fa2_inputs()
    fa2 = {}
    arts = [os.path.dirname(_implicit_paths(font)[0]) for font in IMPLICIT_FONTS]
    fontgen = os.path.join(out, "h2h_data")
    n = REST_SAMPLES
    runs = {
        "ab_fa2": lambda: fa2.update(ab_fa2.main([], iters=10, rounds=2, steps=5, epochs=1, params=fa2_params,
                                                 codes=fa2_codes)),
        "ab_serving_tiers": lambda: ab_serving_tiers.main(["--kernels", "output,attention"], iters=10, rounds=2),
        "ab_hard_decode": lambda: ab_hard_decode.main(arts, per_string=True),
        "eval_decode_modes": lambda: eval_decode_modes.main(arts + ["--samples", "10000", "--val", "1024",
                                                                    "--kernels", "attention"]),
        "bench_sdf_atlas": lambda: bench_sdf_atlas.main(["--steps", "50"], iters=3),
        "render_implicit_demo": lambda: render_implicit_demo.main(["100"], out_root=out, iters=5, rounds=2),
        "run_extended_configs": lambda: run_extended_configs.main(
            ["--kernels", "fused"], out_root=out, siren=dict(steps=100), multifont=dict(steps=100),
            sdf_unicode=dict(steps=50, iters=3), montserrat=dict(epochs=1, samples=n)),
        "run_montserrat_converged": lambda: run_montserrat_converged.main(["--kernels", "fused"], out_root=out,
                                                                          samples=n, epochs=1),
        "run_montserrat_conv": lambda: run_montserrat_conv.main(["1", "1e-3", "conv", "--kernels", "attention"],
                                                                out_root=out, samples=n),
        "run_montserrat_conv_ps": lambda: run_montserrat_conv.main(
            ["1", "1e-3", "conv_ps", "--kernels", "attention_v2"], out_root=out, samples=n),
        "run_montserrat_conv_ps_wide": lambda: run_montserrat_conv.main(["1", "1e-3", "conv_ps", "--wide"],
                                                                        out_root=out, samples=n),
        "run_montserrat_hc": lambda: run_montserrat_hc.main(["1"], out_root=out, samples=n),
        "fast60": lambda: fast60.main(["--epochs", "1", "--samples", str(n), "--kernels", "output"]),
        "h2h_ours": lambda: (_fontgen(fontgen, 512),
                             h2h_ours.main([fontgen, "512", "1", "256", os.path.join(out, "h2h"), "--kernels",
                                            "fused"])),
        "refresh_artifacts": lambda: refresh_artifacts.main(["firacode", arts[0], "--dry-run",
                                                             os.path.join(out, "refresh")]),
        "summarize_run": lambda: summarize_run.main([os.path.join(out, "torch_montserrat_converged")]),
        "round4_task5": lambda: round4_task5.main([], rounds=1, steps=5, long_steps=10, log_root=out),
    }
    counts = {k: 0 for k in _counts()}
    seconds, failed = {}, {}
    for name, run in runs.items():
        try:
            rows, seconds[name], launches = _counted(name, run)
            counts = {k: counts[k] + launches[k] for k in counts}
            held = _rest_checks(name, rows, launches, workdir)
            if name == "ab_fa2":
                excess = _bf16_flip_excess(fa2_params, fa2_codes, fa2["out"])
                held += f"; beyond the bf16 projection's flip bound by {excess:.3g} (tol 0)"
                if excess > 0:
                    raise AssertionError(f"ab_fa2: v2 forward beyond the bf16 flip bound by {excess}")
            if name == "run_montserrat_hc":
                with open(os.path.join(out, "torch_montserrat_hc", "metrics.jsonl")) as f:
                    hc = [json.loads(line) for line in f if line.strip()]
                if not (hc and _finite(hc[0]["train_loss"], hc[0]["val_loss"])) or rows[0]["params"] < 307e6:
                    raise AssertionError(f"run_montserrat_hc: loss not finite or the model is not hc's: {hc} {rows}")
                held += (f"; hc (embed 64, 8 heads, fc1 160, {rows[0]['params']} parameters) first epoch: train loss "
                         f"{hc[0]['train_loss']}, val loss {hc[0]['val_loss']}, {hc[0]['seconds']:.2f} s for "
                         f"{int(n * 0.8) // 1024} steps of 1024")
            print(f"[rest] {name}: {held}; launches {json.dumps({k: v for k, v in launches.items() if v})} "
                  f"({card})", flush=True)
        except Exception as e:  # every tool runs; the phase fails below if any failed
            failed[name] = f"{type(e).__name__}: {str(e)[:600]}"
            print(f"[rest] {name} FAILED: {failed[name]}", flush=True)
            torch.cuda.synchronize()
            gc.collect()
            torch.cuda.empty_cache()
    del fa2
    print(f"[rest] seconds by tool ({card}): {json.dumps({k: round(v, 2) for k, v in seconds.items()})}; "
          f"{sum(seconds.values()):.2f} s in all", flush=True)
    if failed:
        raise AssertionError(f"phase 13: {len(failed)} tools failed: {json.dumps(failed)}")
    return counts


def tools_only() -> int:
    """``--tools-only``: the kernels' build, then phases 12 and 13."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card", file=sys.stderr)
        return 2
    from ai_font_renderer_tpu_torch.device import resolve_device

    resolve_device("cuda")
    card = _nvidia_smi()
    print(card, flush=True)
    phase_build()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        counts = phase_tools(workdir, card)
        print(f"[launches] tools: {json.dumps(counts)}", flush=True)
        print(f"[phase] tools: {time.perf_counter() - t0:.2f} s", flush=True)
        t0 = time.perf_counter()
        counts = phase_rest_tools(workdir, card)
    print(f"[launches] rest of the tools: {json.dumps(counts)}", flush=True)
    print(f"[phase] rest of the tools: {time.perf_counter() - t0:.2f} s", flush=True)
    return 0


def mesh_only() -> int:
    """``--mesh-only``: the kernels' build, then phase 11 alone."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card", file=sys.stderr)
        return 2
    from ai_font_renderer_tpu_torch.device import resolve_device

    resolve_device("cuda")
    card = _nvidia_smi()
    print(card, flush=True)
    phase_build()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        counts = phase_mesh(workdir, card)
    print(f"[launches] mesh: {json.dumps(counts)}", flush=True)
    print(f"[phase] mesh: {time.perf_counter() - t0:.2f} s", flush=True)
    return 0


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
        params, render_counts, atlas_gps = timed("render", phase_render, workdir, card)
        serve_counts, serve_latency = timed("serve", phase_serve, params, workdir)
        del params
        train_counts, rates, ds = timed("train", phase_train, workdir, card)
        data_counts = timed("data and weights", phase_data, workdir, card, rates["fused"])
        decoder_counts, int8_rows = timed("decoders and int8", phase_decoders, workdir, card, ds, rates, atlas_gps)
        del ds
        implicit_counts, implicit_rows = timed("implicit", phase_implicit, workdir, card)
        export_counts = timed("export", phase_export, workdir, card, atlas_gps, serve_latency)
        placement_counts, placement_fwd_rows, placement_bwd_rows, gather_rows = timed(
            "placement", phase_placement, workdir, card)
        gc.collect()
        torch.cuda.empty_cache()
        mesh_counts = timed("mesh", phase_mesh, workdir, card)
        gc.collect()
        torch.cuda.empty_cache()
        tools_counts = timed("tools", phase_tools, workdir, card)
        gc.collect()
        torch.cuda.empty_cache()
        rest_counts = timed("rest of the tools", phase_rest_tools, workdir, card)
    by_phase = {"render": render_counts, "serve": serve_counts, "train": train_counts, "data": data_counts,
                "decoders": decoder_counts, "implicit": implicit_counts, "export": export_counts,
                "placement": placement_counts, "mesh": mesh_counts, "tools": tools_counts,
                "rest_tools": rest_counts}
    print(f"[launches] by phase: {json.dumps(by_phase)}", flush=True)
    launches = {k: sum(c[k] for c in by_phase.values()) for k in render_counts}

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
            "ai_font_renderer_tpu/ops/fused_attention.py:65", wide_fwd_rows + implicit_rows + placement_fwd_rows,
            f"B=1024,S=100,E=64,H=4,float32,dropout={DROPOUT}", launches["attention_wide_fwd"],
        ),
        _kernel_entry(
            "attention_wide_bwd (K6/K8 at other shapes, f32 and bf16)", src + "attention_wide.cu",
            "ai_font_renderer_tpu/ops/fused_attention.py:122", wide_bwd_rows + placement_bwd_rows,
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
        _kernel_entry(
            "gather_rows_bwd (the embedding gathers' backward: f32 two passes, bf16 the index form's order)",
            src + "gather_rows.cu",
            "none: the JAX package's gather VJP is XLA's scatter-add", gather_rows,
            "B=1024,S=100,V=128,E=32,float32", launches["gather_rows_backward"],
        ),
    ]
    # The int8 product is cuBLASLt's (torch._int_mm): a library call, as the
    # JAX package's lax.dot_general is no Pallas kernel, so it is no entry
    # of the kernels line.
    print(f"[int8 product] rows: {json.dumps(int8_rows)}", flush=True)
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
    if sys.argv[1:2] == ["--mesh-rank"] and len(sys.argv) == 3:
        sys.exit(mesh_rank(sys.argv[2]))
    if sys.argv[1:] == ["--mesh-only"]:
        sys.exit(mesh_only())
    if sys.argv[1:] == ["--tools-only"]:
        sys.exit(tools_only())
    if sys.argv[1:] == ["--step-memory"]:
        sys.exit(step_memory())
    if sys.argv[1:2] == ["--serve-repeats"] and len(sys.argv) == 3:
        sys.exit(serve_repeats(int(sys.argv[2])))
    sys.exit(main())
