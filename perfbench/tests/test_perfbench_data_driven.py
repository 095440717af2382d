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
from perfbench.reference import check


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


def test_a_cell_knows_the_end_to_end_metrics_it_reports():
    """The driver takes the device's time a step only where the cell reports
    it: the flagship, whose host paces its rate; the rate where it is
    steady."""
    from .tiny import cell

    assert cell("flagship.train_corpus").e2e == ("train_device_ms_per_step", "setup_s")
    assert cell("hc307m.train_corpus").e2e == ("train_sheets_per_s", "setup_s")


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


def _program_as_reference(kernels: str) -> types.ModuleType:
    """A ``perfbench.reference.conv_ps`` that checks the plumbing only: its
    training forward is the program's own (``font_renderer.apply`` under
    the cell's kernels) and its leaves follow ``font_renderer.init``. The
    benchmark's reference of a conv decoder is plain PyTorch that imports
    nothing of the program; it comes with the configuration that runs it."""
    from ai_font_renderer_tpu_torch.models import font_renderer

    from perfbench import program
    from perfbench.reference import linear

    def mcfg(m):
        return program.configs({"model": m, "train": {}, "kernels": kernels})[0]

    def train_output(p, codes, m, num, gen, fused):
        return font_renderer.apply(p, codes, mcfg(m), train=True, generator=gen).reshape(codes.shape[0], -1)

    def leaves(m):
        uniform, normal, const = linear.leaves(m)
        del uniform["out_w"], uniform["out_b"]
        h, chans = m["hidden_dim"], m["decoder_channels"]
        uniform["dec_in_w"], uniform["dec_in_b"] = ((h, chans[0]), h**-0.5), ((chans[0],), h**-0.5)
        for i, (fy, fx, cin, cout) in enumerate(font_renderer._decoder_plan_ps(mcfg(m))):
            k, bound = cout * fy * fx, (9 * cin) ** -0.5
            uniform[f"dec_w{i}"], uniform[f"dec_b{i}"] = ((3, 3, cin, k), bound), ((k,), bound)
        uniform["dec_out_w"] = ((3, 3, chans[-1], 1), (9 * chans[-1]) ** -0.5)
        const["dec_out_b"] = ((1,), 1.0)
        return uniform, normal, const

    ref = types.ModuleType("perfbench.reference.conv_ps")
    ref.train_output, ref.leaves = train_output, leaves
    return ref


def test_a_conv_ps_cell_runs_from_new_files(tmp_path, monkeypatch):
    """A cell of a decoder that has no out_w (the pixel-shuffle conv decoder)
    runs set-up, the checked steps and calls, the window and the check from
    a configuration, a limits file, a reference module and new entries
    alone; against the program's own forward every number reads rounding,
    and half a batch left out fails the check."""
    from perfbench import faults

    from .tiny import TINY

    root = tmp_path / "checkout"
    shutil.copytree(harness.ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = harness.load_spec()
    cfg = json.loads((root / "perfbench/configs/hc307m.json").read_text())
    cfg["model"].update(embedding_dim=32, num_heads=4, hidden_dim=64, decoder="conv_ps", decoder_grid=[5, 20],
                        decoder_channels=[256, 256, 128, 64, 32])
    cfg["train"]["learning_rate"] = 1e-3
    (root / "perfbench/configs/conv_ps.json").write_text(json.dumps(cfg))
    numbers = ("loss_gap", "grad_gap", "change_gap", "call_loss_gap", "call_grad_gap", "call_change_gap")
    (root / "perfbench/limits/conv_ps.train_corpus.json").write_text(
        json.dumps({"limits": dict.fromkeys(numbers, 1e-6)}))
    spec["configs"].append({"name": "conv_ps", "source": "https://arxiv.org/abs/1609.05158",
                            "file": "perfbench/configs/conv_ps.json", "reduced": []})
    spec["workloads"].append({"name": "conv_ps.train_corpus", "config": "conv_ps", "traffic": "train_corpus",
                              "chips": 1, "why": "a test"})
    spec["end_to_end"][0]["workloads"].append("conv_ps.train_corpus")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.setitem(sys.modules, "perfbench.reference.conv_ps", _program_as_reference(cfg["kernels"]))

    def run():
        c = harness.load_cell("conv_ps.train_corpus", 2**31 + 23, 0.5, False, torch.device("cpu"),
                              time.perf_counter(), root=root, overrides=TINY)
        assert c.cfg["model"]["decoder_channels"] == TINY["model"]["decoder_channels"]
        result = harness.run_cell(c)
        assert "out_w" not in result["readings"]["reference"]["change_norms"]
        return result, check.passes(result["numbers"], c.limits) and result["failed"] == 0

    result, correct = run()
    assert result["attempted"] > 0 and set(result["numbers"]) == set(numbers)
    assert all(v <= 1e-6 for v in result["numbers"].values()), result["numbers"]
    assert correct
    e2e = harness.metrics(result, "conv_ps.train_corpus", False, spec, root)
    assert set(e2e) == {"train_sheets_per_s", "setup_s"}
    with faults.planted("half_batch"):
        assert not run()[1]
