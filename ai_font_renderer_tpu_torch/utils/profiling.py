"""Profiling helpers: torch.profiler traces, program spans, timers that wait
for the device, per-device memory statistics, and the check that a trace
holds every launch of the port's kernels.

The port of ai_font_renderer_tpu/utils/profiling.py. ``trace`` writes a
Chrome trace (``*.pt.trace.json``) that chrome://tracing, Perfetto and
tools/trace_step.py read. ``timed`` waits for the device with
``torch.cuda.synchronize()`` (CUDA calls return before the device is done,
so a clock that stops without it measures the enqueue). ``span`` marks a
phase of the program: in a trace it is a ``user_annotation`` on the device
records' clock, and ``spans`` gives its host and device times.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import re
import threading
import time

import torch

# The device kernel each counting wrapper of ops/ launches, as the profiler
# names it (a pattern searched in the kernel's demangled name). The f32
# attention kernels have no wrapper of their own: the entry points count
# them, together with the launches they hand to the tensor-core and general
# kernels (``launch_counts``). ``ops.gather_rows_backward`` counts the
# gathers' backward on f32 tables (``gather_rows_bwd``) and on bf16 tables
# (``gather_rows_bwd_ordered``) on counters of their own.
KERNEL_NAMES = {
    "round_bf16": r"round_bf16_kernel",
    "gemm_bf16_tn": r"gemm_bf16_tn_kernel",
    "gemm_bf16_mn": r"gemm_bf16_bmn_kernel<false, [^<>]*EpiStore",
    "gemm_bf16_bias_clamp": r"gemm_bf16_bmn_kernel<true, [^<>]*EpiBiasClamp",
    "fused_dw_adamw": r"gemm_bf16_bmn_kernel<false, [^<>]*EpiAdamW",
    "fused_dw_adamw_xt": r"gemm_bf16_bmn_kernel<true, [^<>]*EpiAdamW",
    "attention_mma_fwd": r"attention_fwd_mma",
    "attention_mma_bwd": r"attention_bwd_mma",
    "attention_wide_fwd": r"\bwide_fwd\b",
    "attention_wide_bwd": r"\bwide_bwd\b",
    "attention_f32_fwd": r"attention_f32_fwd",
    "attention_f32_bwd": r"attention_f32_bwd",
    "gather_rows_bwd": r"gather_rows_bwd_(partial|sum)\b",
    "gather_rows_bwd_ordered": r"gather_rows_bwd_ordered\b",
}
# Kernels one counted call launches, where that is more than one: the
# gathers' backward on an f32 table is two passes (ops/gather_rows.py).
KERNELS_PER_CALL = {"gather_rows_bwd": 2}


# Spin kernels a trace launches and waits for as it opens. In a long
# process the traces lost the first kernel records after their start, more
# as the process went on (chip_smoke.py on the H100: 0 in its first trace,
# 2 to 9 in later ones, 32 in its tenth: a step's whole forward), with or
# without idle time or a warm-up step before; these kernels take that
# place (``opening_kernels`` counts what is left of them).
OPENING_KERNELS = 512
OPENING_NAME = "spin_kernel"


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Capture a device trace: ``with trace('/tmp/trace') as prof: run()``.

    torch.profiler with CPU activity, and CUDA activity where there is a
    card. On a card the window opens with OPENING_KERNELS spin kernels of
    about a microsecond, waited for; on exit it waits for the device, then writes a
    Chrome trace under ``log_dir`` (nothing when it is None).
    ``prof.events()`` and ``prof.key_averages()`` stay readable, but hold
    only the kernels the profiler links to a host operation it recorded:
    count launches from the trace (``device_kernels``).
    """
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir) if log_dir else None)
    prof.start()
    if cuda:
        for _ in range(OPENING_KERNELS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    try:
        yield prof
    finally:
        _sync()
        prof.stop()


# The program's spans (``span``). At most MAX_SPANS records are kept; the
# rest are counted (``spans_dropped``).
MAX_SPANS = 65_536
_profiler_enabled = torch.autograd._profiler_enabled


class _Spans:
    """The process's span records, each [name, parent, start_ns, end_ns,
    start event, end event, device_ms]; ``parent`` indexes the record of
    the span that was open around it on the same thread."""

    def __init__(self, cap: int = MAX_SPANS):
        self.cap = cap
        self.records: list = []
        self.seen: set = set()  # names that have had their first call
        self.dropped = 0
        self.lock = threading.Lock()
        self.local = threading.local()  # .stack: open records' indices (None: dropped)


_SPANS = _Spans()


class _Off:
    """What ``span`` returns when it records nothing: one shared object."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("spans", "name", "fn", "rec")

    def __init__(self, spans: _Spans, name: str):
        self.spans, self.name, self.fn, self.rec = spans, name, None, None

    def __enter__(self):
        s = self.spans
        on = _profiler_enabled()
        if on:
            self.fn = torch.profiler.record_function(self.name)
            self.fn.__enter__()
        stack = s.local.__dict__.setdefault("stack", [])
        with s.lock:
            s.seen.add(self.name)
            index = None
            if len(s.records) < s.cap:
                index = len(s.records)
                self.rec = [self.name, stack[-1] if stack else None, 0, None, None, None, None]
                s.records.append(self.rec)
            else:
                s.dropped += 1
        stack.append(index)
        if self.rec is not None:
            if on and torch.cuda.is_initialized():
                self.rec[4] = torch.cuda.Event(enable_timing=True)
                self.rec[4].record()
            self.rec[2] = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        rec = self.rec
        if rec is not None:
            rec[3] = time.perf_counter_ns()
            if rec[4] is not None:
                rec[5] = torch.cuda.Event(enable_timing=True)
                rec[5].record()
        self.spans.local.stack.pop()
        if self.fn is not None:
            self.fn.__exit__(*exc)
        return False


def span(name: str):
    """A span around a phase of the program: ``with span("train.forward"):``.

    Off (no torch profiler window open: ``trace``, or any other), it costs
    a set lookup and a flag test, and records nothing, but for the first
    call of each name in the process, which is recorded with host times
    only: that is where set-up time goes. On, it opens
    ``torch.profiler.record_function(name)`` (a ``user_annotation`` in the
    Chrome trace, on the device records' clock) and keeps a record: the
    enclosing span, host ``perf_counter_ns`` at both edges and, once CUDA
    is initialized, a timing event on the current stream at each edge.
    Autograd's backward runs on a thread of its own but on the caller's
    stream, so a span around ``autograd.grad`` covers its kernels in stream
    order. A span never changes what the code inside it computes.
    """
    s = _SPANS
    if name in s.seen and not _profiler_enabled():
        return _OFF
    return _Span(s, name)


def spans() -> list[dict]:
    """The span records, oldest first, each {"name", "parent" (the index
    of the enclosing span's record, or None), "start_ns", "end_ns" (host
    ``perf_counter_ns``; None while open), "device_ms" (the device's time
    between the span's edges, idle time inside included; None without
    events)}. Waits for each span's end event; the records stay, for the
    next reader."""
    s = _SPANS
    with s.lock:
        records = list(s.records)
    out = []
    for r in records:
        if r[5] is not None:
            r[5].synchronize()
            r[6] = r[4].elapsed_time(r[5])
            r[4] = r[5] = None
        out.append({"name": r[0], "parent": r[1], "start_ns": r[2], "end_ns": r[3], "device_ms": r[6]})
    return out


def spans_dropped() -> int:
    """Spans that were on but did not fit in the MAX_SPANS records: while
    it is above 0, ``spans`` is not the whole of them."""
    return _SPANS.dropped


def timed(fn, *args, iters: int = 10, warmup: int = 2) -> float:
    """Seconds per call of ``fn(*args)``: ``warmup`` calls, then ``iters``
    timed ones between two device synchronizations."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync()
    return (time.perf_counter() - t0) / iters


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def device_memory_stats() -> dict:
    """{device name: torch.cuda.memory_stats} for each card; on a machine
    without one, the CPU device -> None (the JAX package's CPU devices give
    None too)."""
    if not torch.cuda.is_available():
        return {"cpu": None}
    return {str(torch.device("cuda", i)): torch.cuda.memory_stats(i) for i in range(torch.cuda.device_count())}


def launch_counts() -> dict:
    """The launch counters of the port's kernels, by :data:`KERNEL_NAMES`
    key (the f32 attention's: what the entry points counted less what they
    handed to the tensor-core and general kernels)."""
    from .. import ops

    counts = {name: getattr(ops, name).launches for name in KERNEL_NAMES if hasattr(ops, name)}
    for side, entries in (("fwd", ("fused_attention", "fused_attention2")),
                          ("bwd", ("fused_attention_backward", "fused_attention2_backward"))):
        counts[f"attention_f32_{side}"] = (sum(getattr(ops, e).launches for e in entries)
                                           - counts[f"attention_mma_{side}"] - counts[f"attention_wide_{side}"])
    counts["gather_rows_bwd"] = ops.gather_rows_backward.launches
    counts["gather_rows_bwd_ordered"] = ops.gather_rows_backward.ordered_launches
    return counts


def trace_events(log_dir: str) -> list | None:
    """The events of the newest Chrome trace under ``log_dir`` (what
    ``trace`` wrote), or None when there is none."""
    paths = glob.glob(os.path.join(log_dir, "**", "*.pt.trace.json*"), recursive=True)
    if not paths:
        return None
    path = max(paths, key=os.path.getmtime)
    with gzip.open(path) if path.endswith(".gz") else open(path) as f:
        return json.load(f)["traceEvents"]


def device_kernels(events: list) -> list:
    """The kernel events of a Chrome trace, one a launch, but ``trace``'s
    opening kernels: the device's own activity records, each launch whether
    or not a host operation that the profiler records holds it (the
    profiler's table, ``prof.events()``, keeps only kernels it can link to
    one)."""
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == "kernel" and OPENING_NAME not in e["name"]]


def opening_kernels(events: list) -> int:
    """How many of ``trace``'s opening kernels a Chrome trace holds."""
    return sum(1 for e in events if e.get("ph") == "X" and e.get("cat") == "kernel" and OPENING_NAME in e["name"])


def profiled_launches(names: list[str]) -> dict:
    """{KERNEL_NAMES key: number of kernels among ``names`` that are its}."""
    return {key: sum(bool(re.search(pat, n)) for n in names) for key, pat in KERNEL_NAMES.items()}


def check_launches(names: list[str], before: dict, after: dict) -> dict:
    """Raise unless the kernels ``names`` of a trace hold each port kernel
    as many times as its counter rose from ``before`` to ``after``
    (``launch_counts``), times its :data:`KERNELS_PER_CALL`; returns
    {kernel: calls counted} of the kernels that ran."""
    seen = profiled_launches(names)
    rose = {k: after[k] - before[k] for k in after}
    wrong = {k: (rose[k], seen[k]) for k in rose if rose[k] * KERNELS_PER_CALL.get(k, 1) != seen[k]}
    if wrong:
        raise AssertionError(f"the trace lost or added launches, {{kernel: (counted, traced)}}: {wrong}")
    return {k: v for k, v in rose.items() if v}
