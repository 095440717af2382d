"""A device trace of a short stretch of the run, reduced to busy time, span,
the operations that took the most time and the longest idle gaps.

torch.profiler with CPU and CUDA activity. The stretch opens with 512 spin
kernels of about a microsecond, waited for and left out of every reading:
in a long process the trace loses its first kernel records, and these take
their place. Busy time is the union of the intervals of the device's
kernel, memcpy and memset records; the span runs from the first such
record's start to the last one's end; an idle gap is named by the innermost
host operation open across it. The arithmetic is a copy of the program's
``tools/trace_step.py``. ``busy_s`` traces the device's activity alone,
over a whole window, and reads its busy time from the profiler's records
in memory.
"""

from __future__ import annotations

import json
import os
import tempfile

import torch

OPENING_KERNELS = 512
OPENING_NAME = "spin_kernel"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


def _opening() -> None:
    for _ in range(OPENING_KERNELS):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def traced(fn) -> list | None:
    """Run ``fn()`` under the profiler and return the Chrome trace's events
    (None where no trace came out). The trace is written to a temporary
    directory under TMPDIR and removed."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with profile(activities=activities) as prof:
            if cuda:
                _opening()
            fn()
            if cuda:
                torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f).get("traceEvents", [])


def _merged(intervals: list[tuple[float, float]]) -> list[list[float]]:
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def device_intervals(records) -> list[tuple[int, int]]:
    """(start, end) in ns of the device's kernel, memcpy and memset records
    among the profiler's ``records`` (``kineto_results.events()``), the
    opening kernels left out."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.start_ns(), e.end_ns()) for e in records
            if e.device_type() == cuda and OPENING_NAME not in e.name()
            and (not hasattr(e, "activity_type") or e.activity_type() in DEVICE_CATS)]


def busy_s(fn) -> float | None:
    """Run ``fn()`` with the device's activity alone traced, which costs the
    host little over a long stretch, and return the device's busy seconds
    in it: the union of its kernel, memcpy and memset intervals. None where
    no device record came out. Nothing is written to disk."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _opening()
        fn()
        torch.cuda.synchronize()
    merged = _merged(device_intervals(prof.profiler.kineto_results.events()))
    return sum(b - a for a, b in merged) / 1e9 if merged else None


def summarize(events: list, top: int = 10) -> dict | None:
    """{"busy_s", "span_s", "device_ops": [[name, s]], "idle_gaps": [[host
    op, s]]} of the device records in ``events``, or None where there are
    none. Several devices' records are averaged (busy and span)."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    host = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in spans if e.get("cat") in HOST_CATS]
    devices: dict = {}
    for e in spans:
        if e.get("cat") in DEVICE_CATS and OPENING_NAME not in e["name"]:
            devices.setdefault(e["pid"], []).append(e)
    if not devices:
        return None
    busy = span = 0.0
    per_op: dict = {}
    gaps: list = []
    for evs in devices.values():
        merged = _merged([(e["ts"], e["ts"] + e["dur"]) for e in evs])
        busy += sum(b - a for a, b in merged)
        span += merged[-1][1] - merged[0][0]
        for e in evs:
            per_op[e["name"]] = per_op.get(e["name"], 0.0) + e["dur"]
        gaps += [(merged[i + 1][0] - merged[i][1], merged[i][1]) for i in range(len(merged) - 1)]
    named = []
    for length, start in sorted(gaps, reverse=True)[:top]:
        end = start + length
        open_ops = [(h1 - h0, nm) for h0, h1, nm in host if h0 <= start and h1 >= end]
        named.append([min(open_ops)[1] if open_ops else "(host between operations)", length / 1e6])
    n = len(devices)
    return {
        "busy_s": busy / 1e6 / n,
        "span_s": span / 1e6 / n,
        "device_ops": [[k[:160], v / 1e6] for k, v in sorted(per_op.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": named,
    }
