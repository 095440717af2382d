"""The readers of the program's spans (``program_span`` metrics) on a canned
list of span records, with known values; None on an empty list, outside a
training cell, where the program has no spans, and where it dropped some."""

import pytest

from perfbench import harness

PHASES = ["forward_ms", "backward_ms", "update_ms"]
READERS = [f"{p}.{suffix}" for suffix in ("train", "train_device") for p in PHASES] + ["first_step_s.train"]
TRAIN = {"kind": "train"}


def _rec(name, device_ms=None, start_ns=0, end_ns=1):
    return {"name": name, "parent": None, "start_ns": start_ns, "end_ns": end_ns, "device_ms": device_ms}


# The first step's spans (host times only, spans off), then three traced
# steps' (device times) and a first call of a library load.
RECORDS = [
    _rec("train.epoch", None, 0, 9_000_000_000),
    _rec("train.step", None, 1_000_000_000, 8_500_000_000),
    _rec("train.forward", None, 1_100_000_000, 2_000_000_000),
    _rec("ops.load.fused_output", None, 1_200_000_000, 1_900_000_000),
    _rec("train.epoch", 30.0),
    *[r for k in range(3) for r in (_rec("train.step", 10.0 + k), _rec("train.forward", [1.0, 1.5, 1.2][k]),
                                     _rec("train.backward", [9.0, 11.0, 10.0][k]),
                                     _rec("train.update", [2.0, 2.2, 2.1][k]))],
]
EXPECTED = {f"{p}.{suffix}": v for suffix in ("train", "train_device")
            for p, v in zip(PHASES, (1.2, 10.0, 2.1))} | {"first_step_s.train": 7.5}


@pytest.fixture
def profiling():
    return pytest.importorskip("ai_font_renderer_tpu_torch.utils.profiling")


def _read(name, run):
    return harness._reader(name, harness.ROOT)(run)


@pytest.mark.parametrize("name", READERS)
def test_a_reader_gives_its_value_on_canned_spans(name, profiling, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: [dict(r) for r in RECORDS])
    assert _read(name, TRAIN) == pytest.approx(EXPECTED[name])
    assert _read(name, {"kind": "other"}) is None


@pytest.mark.parametrize("name", READERS)
def test_a_reader_reads_nothing_without_spans(name, profiling, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert _read(name, TRAIN) is None
    # Host-only records (spans off) give no device phase.
    monkeypatch.setattr(profiling, "spans", lambda: [dict(r) for r in RECORDS[:4]])
    assert (_read(name, TRAIN) is None) == (name != "first_step_s.train")
    # A program with no spans at all, as before they were added.
    monkeypatch.delattr(profiling, "spans")
    assert _read(name, TRAIN) is None


@pytest.mark.parametrize("name", READERS)
def test_a_reader_reads_nothing_where_spans_were_dropped(name, profiling, monkeypatch):
    """Past the program's cap the records are not the whole: no reading."""
    monkeypatch.setattr(profiling, "spans", lambda: [dict(r) for r in RECORDS])
    monkeypatch.setattr(profiling, "spans_dropped", lambda: 1)
    assert _read(name, TRAIN) is None


def test_the_readers_are_declared():
    """Each phase is read in every training cell, under the name whose
    end-to-end metric the cell reports; the first step in all of them."""
    spec = harness.load_spec()
    declared = {m["name"]: m for m in spec["per_layer"]}
    cells = [w["name"] for w in spec["workloads"]]
    for name in READERS:
        assert declared[name]["source"] == "program_span"
        for w in declared[name]["workloads"]:
            assert harness._applies(next(m for m in spec["end_to_end"] if m["name"] == declared[name]["moves"]),
                                    w, spec)
    for p in PHASES:
        assert sorted(declared[f"{p}.train"]["workloads"] + declared[f"{p}.train_device"]["workloads"]) == cells
    assert declared["first_step_s.train"]["moves"] == "setup_s"
    assert declared["first_step_s.train"]["workloads"] == cells
