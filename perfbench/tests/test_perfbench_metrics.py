"""The trace reduction and the per-layer readers on a small canned Chrome
trace, with known values."""

import pytest

from perfbench import devtrace, harness

# Device records (us): spin kernels (left out), a 0-100 kernel, a 50-150
# memcpy overlapping it, a 300-400 kernel; a host op open across the gap.
EVENTS = [
    {"ph": "X", "cat": "kernel", "name": "spin_kernel", "pid": 1, "ts": -50, "dur": 10},
    {"ph": "X", "cat": "kernel", "name": "gemm", "pid": 1, "ts": 0, "dur": 100},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "pid": 1, "ts": 50, "dur": 100},
    {"ph": "X", "cat": "kernel", "name": "gemm", "pid": 1, "ts": 300, "dur": 100},
    {"ph": "X", "cat": "cpu_op", "name": "aten::index", "pid": 9, "ts": 140, "dur": 200},
    {"ph": "X", "cat": "cpu_op", "name": "outer", "pid": 9, "ts": 100, "dur": 400},
    {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "GPU 0"}},
]


def test_summarize_canned_trace():
    s = devtrace.summarize(EVENTS)
    assert s["busy_s"] == pytest.approx(250e-6)
    assert s["span_s"] == pytest.approx(400e-6)
    assert s["device_ops"][0] == ["gemm", pytest.approx(200e-6)]
    assert s["idle_gaps"] == [["aten::index", pytest.approx(150e-6)]]


class _Record:
    """A record of the profiler's ``kineto_results.events()``."""

    def __init__(self, name, device, kind, start, end):
        self._v = name, device, kind, start, end

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def activity_type(self):
        return self._v[2]

    def start_ns(self):
        return self._v[3]

    def end_ns(self):
        return self._v[4]


def test_device_intervals_keep_the_device_records():
    """The same records as the canned trace's, read from the profiler's
    memory: the device's kernels and copies, not the opening kernels nor a
    host record."""
    import torch

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    records = [_Record(e["name"], cuda if e["pid"] == 1 else cpu, e["cat"], e["ts"] * 1000,
                       (e["ts"] + e["dur"]) * 1000) for e in EVENTS if e["ph"] == "X"]
    records.append(_Record("gpu annotation", cuda, "gpu_user_annotation", 0, 10**6))
    got = devtrace.device_intervals(records)
    assert got == [(0, 100_000), (50_000, 150_000), (300_000, 400_000)]
    assert sum(b - a for a, b in devtrace._merged(got)) / 1e9 == pytest.approx(devtrace.summarize(EVENTS)["busy_s"])


def test_no_device_records_read_nothing():
    assert devtrace.summarize([e for e in EVENTS if e.get("cat") == "cpu_op"]) is None


def _layer(kind, **kw):
    trace = devtrace.summarize(EVENTS)
    base = {"kind": kind, "model": {"vocab_size": 128, "embedding_dim": 32, "num_heads": 4, "max_length": 100,
                                    "hidden_dim": 64, "sheet_height": 80, "sheet_width": 240},
            "train": {"batch_size": 1024, "adam_mu_bf16": True}, "trace": trace, "host_s": 0.5,
            "sheets_per_s": 70_000.0}
    return {**base, **kw}


def test_readers_give_known_values():
    names = [p.name[: -len(".py")] for p in (harness.HERE / "metrics").glob("*.py")]
    read = {name: harness._reader(name, harness.ROOT) for name in names}
    train = _layer("train", steps=50, traced_steps=2)
    other = _layer("other", steps=50, traced_steps=2)
    assert read["host_ms_per_step.train"](train) == pytest.approx(10.0)
    assert read["mfu.train"](train) == pytest.approx(100 * 3 * 248_268_800 * 70_000 / 989e12)
    assert read["device_idle_share.train"](train) == pytest.approx(37.5)
    from perfbench.counts import linear as model
    least = model.least_seconds(model.train_functions(train["model"], train["train"]))
    assert read["kernel_roofline.train"](train) == pytest.approx(100 * least / 125e-6)
    assert read["kernel_roofline.train_device"](train) == read["kernel_roofline.train"](train)
    assert read["mfu.train_device"](train) == pytest.approx(100 * 3 * 248_268_800 * 1024 / 125e-6 / 989e12)
    assert read["train_sheets_per_s.host_paced"](train) == 70_000.0
    # Each reader reads nothing in another kind of cell, or without a trace.
    for name, fn in read.items():
        assert fn(other) is None
        if "roofline" in name or "idle" in name or name == "mfu.train_device":
            assert fn({**train, "trace": None}) is None
