"""The port's program spans (utils/profiling.py ``span``) and the spans of
the training step, on the CPU: what is recorded off and on, the parents,
the cap, the Chrome trace's annotations, each step's span tree, that spans
change nothing a step computes, and how tools/trace_step.py reads them."""

import dataclasses
import json
import types

import pytest
import torch

from ai_font_renderer_tpu_torch.config import ModelConfig, TrainConfig
from ai_font_renderer_tpu_torch.ops import _build
from ai_font_renderer_tpu_torch.tools import trace_step
from ai_font_renderer_tpu_torch.tools.ab_profiles import fresh_state, random_corpus
from ai_font_renderer_tpu_torch.train.step import train_epoch
from ai_font_renderer_tpu_torch.utils import profiling

WIDTHS = dict(max_length=16, hidden_dim=16, sheet_height=16, sheet_width=24)
STEPS = {
    "standard": ({}, {}),
    "handrolled": ({}, dict(handrolled_bwd=True)),
    "fused": (dict(use_pallas_output=True), dict(fused_dw_adamw=True)),
}
PHASES = ["train.gather", "train.forward", "train.backward", "train.update"]


@pytest.fixture
def fresh(monkeypatch):
    """A process's span state of its own: no name has had its first call."""
    spans = profiling._Spans()
    monkeypatch.setattr(profiling, "_SPANS", spans)
    return spans


@pytest.fixture
def rf_calls(monkeypatch):
    """The names ``torch.profiler.record_function`` was opened with."""
    calls = []
    real = torch.profiler.record_function

    def counting(name, *args):
        calls.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    return calls


def _tree(records):
    return [(r["name"], r["parent"]) for r in records]


def test_off_records_only_each_names_first_call(fresh, rf_calls):
    for _ in range(3):
        with profiling.span("a"):
            with profiling.span("b"):
                pass
    with profiling.span("a"):
        with profiling.span("c"):
            pass
    records = profiling.spans()
    # The first call of each name, host times only; c's enclosing a was off.
    assert _tree(records) == [("a", None), ("b", 0), ("c", None)]
    assert all(r["device_ms"] is None and r["end_ns"] >= r["start_ns"] > 0 for r in records)
    assert rf_calls == [] and profiling.spans_dropped() == 0
    assert profiling.span("a") is profiling.span("b")  # off: one shared object, nothing allocated


def _two_steps():
    with profiling.span("epoch"):
        for _ in range(2):
            with profiling.span("step"):
                with profiling.span("gather"):
                    pass
                with profiling.span("forward"):
                    pass


def _window(kind, tmp_path):
    """``profiling.trace``, or a bare torch profiler window (as perfbench's
    traced stretch opens): spans are on in either."""
    if kind == "trace":
        return profiling.trace(str(tmp_path))
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.mark.parametrize("window", ["trace", "torch.profiler"])
def test_on_records_parents(fresh, rf_calls, window, tmp_path):
    _two_steps()  # the first calls
    first = len(profiling.spans())
    with _window(window, tmp_path):
        _two_steps()
    _two_steps()  # off again
    assert _tree(profiling.spans()[first:]) == [
        ("epoch", None),
        ("step", first), ("gather", first + 1), ("forward", first + 1),
        ("step", first), ("gather", first + 4), ("forward", first + 4),
    ]
    # The first calls were off: only the window's spans opened record_function.
    assert rf_calls == ["epoch", "step", "gather", "forward", "step", "gather", "forward"]


def test_the_cap_counts_what_it_drops(monkeypatch, tmp_path):
    monkeypatch.setattr(profiling, "_SPANS", profiling._Spans(cap=3))
    with profiling.trace(str(tmp_path)):
        with profiling.span("outer"):
            for _ in range(2):
                with profiling.span("inner"):
                    pass
            with profiling.span("over"):
                with profiling.span("under"):
                    pass
    assert _tree(profiling.spans()) == [("outer", None), ("inner", 0), ("inner", 0)]
    assert profiling.spans_dropped() == 2
    assert profiling._SPANS.local.stack == []  # dropped spans close as they opened
    # trace_step's medians would miss the dropped spans: it gives none.
    assert trace_step.phase_device_ms(profiling.spans()) is None


def test_a_trace_window_writes_each_span_as_a_user_annotation(fresh, tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.span("phase.outer"):
            with profiling.span("phase.inner"):
                (torch.ones(8, 8) @ torch.ones(8, 8)).sum()
    events = profiling.trace_events(str(tmp_path))
    marks = {e["name"]: e for e in events if e.get("cat") == "user_annotation" and e["name"].startswith("phase.")}
    assert set(marks) == {"phase.outer", "phase.inner"}
    outer, inner = marks["phase.outer"], marks["phase.inner"]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    mm = [e for e in events if e.get("cat") == "cpu_op" and e["name"] == "aten::mm"]
    assert mm and inner["ts"] <= mm[0]["ts"] <= inner["ts"] + inner["dur"]


def test_a_library_load_is_a_span(fresh, monkeypatch):
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "build", lambda names: {})
    monkeypatch.setattr(_build, "_lib_path", lambda name: f"lib{name}.so")
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: types.SimpleNamespace())
    lib = _build.load("dummy_lib", {})
    assert _build.load("dummy_lib", {}) is lib  # the cached lookup: no span
    assert _tree(profiling.spans()) == [("ops.load.dummy_lib", None)]


def _configs(kind):
    mkw, tkw = STEPS[kind]
    return ModelConfig(**WIDTHS, **mkw), TrainConfig(batch_size=8, **tkw)


def _epoch(kind, seed=0):
    """Two steps of ``kind`` from the same weights, corpus and dropout
    generator -> (state, loss)."""
    mcfg, tcfg = _configs(kind)
    ds = random_corpus(mcfg, 32, "cpu")
    idx = torch.arange(16).reshape(2, 8)
    return train_epoch(fresh_state(mcfg, tcfg, "cpu"), ds, idx, 1e-3, torch.Generator().manual_seed(seed),
                       mcfg, tcfg)


@pytest.mark.parametrize("kind", sorted(STEPS))
def test_each_step_has_the_same_span_tree(fresh, kind, tmp_path):
    with profiling.trace(str(tmp_path)):
        _epoch(kind)
    records = profiling.spans()
    assert [r["name"] for r in records].count("train.epoch") == 1
    epoch = next(i for i, r in enumerate(records) if r["name"] == "train.epoch")
    steps = [i for i, r in enumerate(records) if r["name"] == "train.step"]
    assert [records[i]["parent"] for i in steps] == [epoch, epoch]
    for i in steps:
        children = [r for r in records if r["parent"] == i]
        assert [r["name"] for r in children] == PHASES
        assert all(r["start_ns"] >= records[i]["start_ns"] and r["end_ns"] <= records[i]["end_ns"]
                   for r in children)
        assert all(a["end_ns"] <= b["start_ns"] for a, b in zip(children, children[1:]))


@pytest.mark.parametrize("kind", sorted(STEPS))
def test_spans_change_nothing_a_step_computes(kind, tmp_path):
    off_state, off_loss = _epoch(kind)
    with profiling.trace(str(tmp_path)):
        on_state, on_loss = _epoch(kind)
    assert torch.equal(off_loss, on_loss)
    fields = [f.name for f in dataclasses.fields(off_state)]
    for name in fields:
        a, b = getattr(off_state, name), getattr(on_state, name)
        if isinstance(a, dict):
            assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a), name
        elif isinstance(a, torch.Tensor):
            assert torch.equal(a, b), name
        else:
            assert a == b, name


@pytest.mark.cuda
def test_spans_time_the_device_on_a_card(fresh, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: device times come from CUDA events")
    x = torch.ones(2048, 2048, device="cuda")
    torch.cuda.synchronize()
    with profiling.trace(str(tmp_path)):
        with profiling.span("card.product"):
            for _ in range(8):
                x = x @ x / 2048
    (rec,) = profiling.spans()
    assert rec["name"] == "card.product" and rec["device_ms"] > 0
    assert profiling.spans()[0]["device_ms"] == rec["device_ms"]  # resolved once, kept


# --- tools/trace_step.py: idle gaps named by spans; per-phase medians --------


def test_port_names_a_gap_by_the_program_span_open_across_it(tmp_path):
    """A gap inside ``train.backward`` (a user annotation) and no op is named
    by the span; the innermost span wins over its enclosing ``train.step``;
    a gap outside every span and op stays unnamed."""
    def x(cat, name, pid, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": pid, "ts": ts, "dur": dur}

    events = [
        {"name": "process_labels", "ph": "M", "pid": 1, "tid": 0, "args": {"labels": "CPU"}},
        {"name": "process_labels", "ph": "M", "pid": 0, "tid": 0, "args": {"labels": "GPU 0"}},
        x("kernel", "k", 0, 0.0, 100.0),
        x("kernel", "k", 0, 400.0, 100.0),  # gap [100, 400): inside train.backward
        x("kernel", "k", 0, 700.0, 100.0),  # gap [500, 700): outside every span
        x("user_annotation", "train.step", 1, 0.0, 480.0),
        x("user_annotation", "train.backward", 1, 50.0, 400.0),
        x("cpu_op", "aten::brief", 1, 550.0, 20.0),
    ]
    (tmp_path / "w.pt.trace.json").write_text(json.dumps({"traceEvents": events}))
    gaps = trace_step.summarize_trace(str(tmp_path), steps=1)["GPU 0"]["longest_idle_gaps"]
    assert [(round(g["ms"], 9), g["host_op"]) for g in gaps] == [(0.3, "train.backward"), (0.2, None)]
    assert gaps[1]["host_op_most_overlap"] == "aten::brief"


def test_port_phase_device_ms_is_the_median_of_each_span(fresh):
    records = [{"name": "train.forward", "device_ms": v} for v in (1.0, 3.0, 2.0)]
    records += [{"name": "train.update", "device_ms": 5.0}, {"name": "train.step", "device_ms": None}]
    assert trace_step.phase_device_ms(records) == {"train.forward": 2.0, "train.update": 5.0}


def test_first_calls_are_each_names_first_record(fresh):
    """The process's first step and its library load, then a traced step:
    each name once, its first record's host seconds and parent's name."""
    def rec(name, parent, start_ns, end_ns):
        return {"name": name, "parent": parent, "start_ns": start_ns, "end_ns": end_ns, "device_ms": None}

    records = [
        rec("train.step", None, 0, 9_000_000_000),
        rec("train.forward", 0, 1_000_000_000, 8_000_000_000),
        rec("ops.load.fused_output", 1, 2_000_000_000, 2_500_000_000),
        rec("train.step", None, 10_000_000_000, 10_020_000_000),
        rec("train.update", 3, 10_010_000_000, None),
    ]
    assert trace_step.first_calls(records) == [
        {"name": "train.step", "parent": None, "host_s": 9.0},
        {"name": "train.forward", "parent": "train.step", "host_s": 7.0},
        {"name": "ops.load.fused_output", "parent": "train.forward", "host_s": 0.5},
        {"name": "train.update", "parent": "train.step", "host_s": None},
    ]


def test_trace_step_reports_phases_and_first_calls_on_the_cpu(fresh, tmp_path):
    """The whole tool on the CPU at a tiny width: its line carries the
    per-phase medians (none: no device events) and each span's first call."""
    (row,) = trace_step.main(["parity", "--kernels", "fused", "--device", "cpu"], widths=WIDTHS, batch=8,
                             steps=2, long_steps=2, log_root=str(tmp_path))
    assert row["phase_device_ms"] == {}
    names = [c["name"] for c in row["first_calls"]]
    assert names[:3] == ["train.epoch", "train.step", "train.gather"]
    assert set(PHASES) <= set(names)
    assert all(c["host_s"] > 0 for c in row["first_calls"])
