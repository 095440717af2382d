"""Profiler-trace attribution of a train step: where the device is busy,
where it idles, and what the host was doing across the longest idle gaps.

The port of tools/trace_step.py. It traces ``train_epoch`` (the train-only
loop, no eval pass) over STEPS = 20 chained steps through
``utils.profiling.trace``, then reads the Chrome trace torch wrote: the
device's kernel events (categories ``kernel``, ``gpu_memcpy`` and
``gpu_memset``, every CUDA stream of a device) give the busy time as the
union of their intervals, the idle time as the span less that, both also
per step, the kernels that took the most time, and the longest idle gaps,
each with the innermost host operation or program span (utils/profiling.py
``span``, a ``user_annotation``) open across it; ``phase_device_ms`` gives
the median device time of each span of the traced steps (``train.forward``,
``train.backward``, ...) and ``first_calls`` the host seconds of each span
name's first call in the process (the first ``train.step`` and its phases,
each ``ops.load.<lib>``: where set-up time goes). It then measures
the wall per step again with the trace off, at the microbench length and
at the production epoch length (20 against 117 steps).

    python -m ai_font_renderer_tpu_torch.tools.trace_step [profile ...] [--kernels K] [--device cpu]

Profiles are tools/ab_profiles.py's (default: fast_handrolled); ``--kernels``
sets the kernel flags (tools/_common.py), so the paths PERF.md reports are
``parity --kernels fused``, ``parity --kernels fused,attention`` (attn_v1)
and ``fast_hr_rematdots --kernels attention_v2`` (attn_v2_fast). The trace
lands under extended_runs/torch_trace_<profile>[_<kernels>]/; one JSON
line a profile.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import torch

from ..train.step import train_epoch
from ..utils.profiling import OPENING_NAME, spans, spans_dropped, trace, trace_events
from . import _common
from .ab_profiles import configs, fresh_state, random_corpus

STEPS = 20
LONG_STEPS = 117  # the production epoch length (bench.py's train section)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


def run_profile(name: str, kernels: str = "none", device=None, widths: dict | None = None, batch: int | None = None,
                steps: int = STEPS, long_steps: int = LONG_STEPS, log_root: str = "extended_runs") -> dict:
    mcfg, tcfg = configs(name, kernels, widths, batch)
    dev = torch.device(device or "cuda")
    b = tcfg.batch_size
    n = 4 * b
    ds = random_corpus(mcfg, n, dev)

    def epoch(st, k, i):
        bi = torch.arange(k * b, device=dev).reshape(k, b) % n
        return train_epoch(st, ds, bi, 1e-3, torch.Generator(device=dev).manual_seed(1 + i), mcfg, tcfg)

    st, tl = epoch(fresh_state(mcfg, tcfg, dev), steps, 0)
    float(tl)  # warm

    tag = name + ("" if kernels == "none" else "_" + kernels.replace(",", "+"))
    logdir = os.path.join(log_root, f"torch_trace_{tag}")
    first = len(spans())
    with trace(logdir):
        t0 = time.perf_counter()
        st, tl = epoch(st, steps, 1)
        float(tl)
        wall = time.perf_counter() - t0  # the steps under the profiler, not its writing of the trace
    phases = phase_device_ms(spans()[first:])

    # The wall per step with the trace off, at both epoch lengths: the
    # epoch's fetch of its loss divides by the step count.
    walls = {}
    for k in (steps, long_steps):
        st, tl = epoch(st, k, 2)
        float(tl)
        t0 = time.perf_counter()
        st, tl = epoch(st, k, 3)
        float(tl)
        walls[k] = 1e3 * (time.perf_counter() - t0) / k

    return {
        "profile": name,
        "kernels": kernels,
        "logdir": logdir,
        "wall_ms_per_step_traced": 1e3 * wall / steps,
        "wall_ms_per_step": {f"steps={k}": v for k, v in walls.items()},
        "phase_device_ms": phases,
        "first_calls": first_calls(spans()),
        **summarize_trace(logdir, steps),
    }


def phase_device_ms(records: list[dict]) -> dict | None:
    """{span name: the median of its records' device_ms} over the span
    records (utils/profiling.py ``spans``) that have one: none on the CPU.
    None where spans were dropped at the cap: the medians would miss them."""
    if spans_dropped():
        return None
    by_name: dict = {}
    for r in records:
        if r["device_ms"] is not None:
            by_name.setdefault(r["name"], []).append(r["device_ms"])
    return {name: statistics.median(v) for name, v in sorted(by_name.items())}


def first_calls(records: list[dict]) -> list[dict]:
    """The first record of each span name, oldest first: {"name", "parent"
    (the enclosing span's name, or None), "host_s" (None while open)}. A
    name's first call is recorded with spans off too, so these are the
    process's first steps and library loads, traced or not."""
    seen: set = set()
    out = []
    for r in records:
        if r["name"] in seen:
            continue
        seen.add(r["name"])
        out.append({
            "name": r["name"],
            "parent": None if r["parent"] is None else records[r["parent"]]["name"],
            "host_s": None if r["end_ns"] is None else (r["end_ns"] - r["start_ns"]) / 1e9,
        })
    return out


def _union_ms(intervals: list[tuple[float, float]]) -> tuple[float, float]:
    """(busy, span) in ms from possibly-nested [start_us, end_us) intervals."""
    intervals.sort()
    busy = 0.0
    cur0, cur1 = intervals[0]
    hi = intervals[0][1]
    for a, b in intervals[1:]:
        hi = max(hi, b)
        if a > cur1:
            busy += cur1 - cur0
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    busy += cur1 - cur0
    return busy / 1e3, (hi - intervals[0][0]) / 1e3


def idle_gaps(intervals: list[tuple[float, float]], host: list[tuple[float, float, str]], top: int = 5) -> list:
    """The ``top`` longest gaps between the union of device ``intervals``
    (us), longest first: {"ms", "at_ms" (from the first kernel's start),
    "host_op" (the shortest host operation or span (start, end, name) open across
    the whole gap, or None: the host was between operations),
    "host_op_most_overlap" (the one that overlaps the gap most)}."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1]) for i in range(len(merged) - 1)), reverse=True)
    out = []
    for length, start in gaps[:top]:
        end = start + length
        open_ops = [(h1 - h0, nm) for h0, h1, nm in host if h0 <= start and h1 >= end]
        overlap = [(min(h1, end) - max(h0, start), nm) for h0, h1, nm in host if h0 < end and h1 > start]
        out.append({"ms": length / 1e3, "at_ms": (start - merged[0][0]) / 1e3,
                    "host_op": min(open_ops)[1] if open_ops else None,
                    "host_op_most_overlap": max(overlap)[1] if overlap else None})
    return out


def summarize_trace(log_dir: str, steps: int = STEPS) -> dict:
    """Busy, idle and span (ms) of each device in the newest Chrome trace
    under ``log_dir`` (``trace``'s opening kernels left out), also per step, the 15 kernels with the most time and
    the longest idle gaps (:func:`idle_gaps`), keyed by the device's process
    name; ``processes`` lists the processes that hold events."""
    events = trace_events(log_dir)
    if events is None:
        return {"trace": "NO *.pt.trace.json produced (profiler unsupported here?)"}
    procs: dict = {}
    for e in events:  # torch names every process "python3"; its label tells the device
        if e.get("ph") == "M" and e.get("name") in ("process_name", "process_labels"):
            args = e.get("args", {})
            procs[e["pid"]] = args.get("labels") or procs.get(e["pid"]) or args.get("name", "")
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    host = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in spans if e.get("cat") in HOST_CATS]
    devices: dict = {}
    for e in spans:
        if e.get("cat") in DEVICE_CATS and OPENING_NAME not in e["name"]:
            devices.setdefault(e["pid"], []).append(e)
    out: dict = {"processes": sorted({procs.get(e["pid"], str(e["pid"])) for e in spans})}
    for pid, evs in devices.items():
        intervals = [(e["ts"], e["ts"] + e["dur"]) for e in evs]
        per_op: dict = {}
        for e in evs:
            per_op[e["name"]] = per_op.get(e["name"], 0.0) + e["dur"]
        busy_ms, span_ms = _union_ms(list(intervals))
        top = sorted(per_op.items(), key=lambda kv: -kv[1])[:15]
        out[procs.get(pid) or f"device {pid}"] = {
            "events": len(evs),
            "span_ms": span_ms,
            "busy_ms": busy_ms,
            "idle_ms": span_ms - busy_ms,
            "busy_ms_per_step": busy_ms / steps,
            "idle_ms_per_step": (span_ms - busy_ms) / steps,
            "top_ops_ms_total": {k[:120]: v / 1e3 for k, v in top},
            "longest_idle_gaps": idle_gaps(intervals, host),
        }
    return out


def main(argv: list[str] | None = None, widths: dict | None = None, batch: int | None = None,
         steps: int = STEPS, long_steps: int = LONG_STEPS, log_root: str = "extended_runs") -> list[dict]:
    rest, dev, kernels = _common.start(sys.argv[1:] if argv is None else argv)
    out = []
    for nm in rest or ["fast_handrolled"]:
        row = run_profile(nm, kernels, dev, widths, batch, steps, long_steps, log_root)
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


if __name__ == "__main__":
    main()
