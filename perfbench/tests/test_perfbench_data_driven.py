"""A new configuration, traffic mix, driver, decoder, per-layer metric and
cell need only new files under perfbench/ and new entries in
BENCHMARK.json: the harness finds each by its name."""

import json
import shutil
import sys
import time
import types

import torch

from perfbench import counts, harness, reference, weights


def test_dummy_entries_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = harness.load_spec()
    cfg = json.loads((root / "perfbench/configs/flagship.json").read_text())
    cfg["model"]["hidden_dim"] = 8
    (root / "perfbench/configs/dummy.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "perfbench/traffic/train_corpus.json").read_text())
    (root / "perfbench/traffic/dummy_mix.json").write_text(json.dumps({**mix, "steps_per_call": 3}))
    (root / "perfbench/limits/dummy.cell.json").write_text(json.dumps({"limits": {"loss_gap": 0.5}}))
    (root / "perfbench/metrics/dummy_metric.train.py").write_text(
        "def read(run):\n    return None if run['kind'] != 'train' else 2.0 * run['steps']\n")
    spec["configs"].append({"name": "dummy", "source": "https://example.org/dummy",
                            "file": "perfbench/configs/dummy.json", "reduced": []})
    spec["workloads"].append({"name": "dummy.cell", "config": "dummy", "traffic": "dummy_mix", "chips": 1,
                              "why": "a test"})
    spec["end_to_end"][0]["workloads"].append("dummy.cell")
    spec["per_layer"].append({"name": "dummy_metric.train", "unit": "1", "better": "higher",
                              "source": "host_clock", "layer": "training step", "moves": "train_sheets_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = harness.load_cell("dummy.cell", 5, 1.0, True, torch.device("cpu"), time.perf_counter(), root=root)
    assert cell.cfg["model"]["hidden_dim"] == 8 and cell.mix["steps_per_call"] == 3
    assert cell.limits == {"loss_gap": 0.5}
    layer = {"kind": "train", "steps": 7, "host_s": 0.07, "sheets_per_s": 1.0, "trace": None,
             "model": cell.cfg["model"], "train": cell.cfg["train"], "traced_steps": 1}
    got = harness.metrics({"layer": layer}, "dummy.cell", True, spec, root)
    assert got["dummy_metric.train"] == {"value": 14.0, "unit": "1"}
    assert "host_ms_per_step.train" not in got  # listed for its own cells only
    e2e = harness.metrics({"e2e": {"train_sheets_per_s": 3.0, "setup_s": 1.0, "other_per_s": 9.0}},
                          "dummy.cell", False, spec, root)
    assert set(e2e) == {"train_sheets_per_s", "setup_s"}


def test_a_new_kind_of_mix_runs_its_own_driver(tmp_path):
    """A mix of a new ``kind`` runs ``perfbench/<kind>_cell.py``, a new file
    that may use the package's modules."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = harness.load_spec()
    (root / "perfbench/traffic/dummy_kind.json").write_text(json.dumps({"kind": "dummy", "size": 3}))
    (root / "perfbench/limits/flagship.dummy_kind.json").write_text(json.dumps({"limits": {"x": 1.0}}))
    (root / "perfbench/dummy_cell.py").write_text(
        "from . import traffic\n\n\ndef run(cell):\n"
        "    return {'kind': 'dummy', 'size': cell.mix['size'], 'seed': traffic.torch_seed(cell.seed, 0)}\n")
    spec["workloads"].append({"name": "flagship.dummy_kind", "config": "flagship", "traffic": "dummy_kind",
                              "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.load_cell("flagship.dummy_kind", 5, 1.0, False, torch.device("cpu"), time.perf_counter(),
                             root=root)
    got = harness.run_cell(cell)
    assert got["kind"] == "dummy" and got["size"] == 3 and got["seed"] == harness.traffic.torch_seed(5, 0)


def test_a_new_decoder_brings_its_own_reference_and_counts(monkeypatch):
    """A configuration's ``decoder`` names ``reference/<decoder>.py`` (its
    leaves and training forward) and ``counts/<decoder>.py``: new files."""
    ref = types.ModuleType("perfbench.reference.dummy")
    ref.leaves = lambda m: ({"w": ((2, 3), 0.5)}, {"e": ((4,), 1.0)}, {"b": ((3,), 0.0)})
    cnt = types.ModuleType("perfbench.counts.dummy")
    monkeypatch.setitem(sys.modules, "perfbench.reference.dummy", ref)
    monkeypatch.setitem(sys.modules, "perfbench.counts.dummy", cnt)
    m = {"decoder": "dummy"}
    assert reference.arch(m) is ref and counts.of(m) is cnt
    p = weights.init(m, 7, "cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == {"w": (2, 3), "e": (4,), "b": (3,)}
    assert float(p["w"].abs().max()) <= 0.5 and float(p["b"].abs().max()) == 0.0


def test_every_cell_has_its_files():
    spec = harness.load_spec()
    names = {m["name"] for m in spec["per_layer"]}
    for m in names:
        assert (harness.HERE / "metrics" / f"{m}.py").exists()
    for w in spec["workloads"]:
        assert (harness.HERE / "limits" / f"{w['name']}.json").exists()
        assert (harness.HERE / "traffic" / f"{w['traffic']}.json").exists()
        # Every cell reports setup_s, another end-to-end metric and a per-layer metric.
        e2e = [m for m in spec["end_to_end"] if harness._applies(m, w["name"], spec)]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert any(harness._applies(m, w["name"], spec) for m in spec["per_layer"])
