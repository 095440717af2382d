"""No module the harness loads is JAX, jaxlib, flax or the JAX package,
compared by whole top-level names, in a process that runs a whole cell."""

import subprocess
import sys

from perfbench import harness

SCRIPT = """
import sys
sys.path.insert(0, {root!r})
from perfbench.tests.tiny import cell
from perfbench import harness
harness.run_cell(cell("flagship.train_corpus", trace=True))
harness.run_cell(cell("hc307m.train_corpus"))
top = sorted({{m.split(".")[0] for m in sys.modules}})
print(",".join(top))
"""


def test_a_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(root=str(harness.ROOT))], capture_output=True,
                         text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(out.stdout.strip().splitlines()[-1].split(","))
    assert "ai_font_renderer_tpu_torch" in top and "perfbench" in top
    assert not top & {"jax", "jaxlib", "flax", "ai_font_renderer_tpu"}


def test_forbidden_names_are_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ai_font_renderer_tpu_torch_extra", sys)
    assert "ai_font_renderer_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert harness.forbidden_modules() == ["jaxlib"]


def test_no_result_without_a_card_or_without_the_program(tmp_path):
    run = [sys.executable, "perfbench/run.py", "--workload", "flagship.train_corpus", "--seed", "3",
           "--seconds", "1", "--trace", "0"]
    out = subprocess.run(run, capture_output=True, text=True, timeout=300, cwd=harness.ROOT)
    if out.returncode == 0:  # a card: the result line is the last line
        assert out.stdout.strip().splitlines()[-1].startswith("{")
    else:
        assert not out.stdout.strip()
    import shutil

    shutil.copytree(harness.ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    alone = subprocess.run(run, capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert alone.returncode != 0 and not alone.stdout.strip()


RUN_TINY = """
import sys, time
sys.path.insert(0, {stub!r})
sys.path.insert(0, {repo!r})
import torch
from perfbench import harness
from perfbench.tests.tiny import TINY
sys.exit(harness.main(["--workload", "flagship.train_corpus", "--seed", "11", "--seconds", "0.3", "--trace", "1"],
                      time.perf_counter(), root=__import__("pathlib").Path({root!r}), device=torch.device("cpu"),
                      overrides=TINY))
"""


def test_no_result_where_a_reader_loads_jax(tmp_path):
    """The look for JAX comes after the readers have loaded: a per-layer
    metric whose reader imports a module named ``jax`` leaves no result."""
    import json
    import shutil

    stub = tmp_path / "stub"
    stub.mkdir()
    (stub / "jax.py").write_text("")
    root = tmp_path / "checkout"
    shutil.copytree(harness.ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = harness.load_spec()

    def run():
        (root / "BENCHMARK.json").write_text(json.dumps(spec))
        script = RUN_TINY.format(stub=str(stub), repo=str(harness.ROOT), root=str(root))
        return subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=600,
                              cwd=root)

    sound = run()
    assert sound.returncode == 0, sound.stderr[-3000:]
    assert json.loads(sound.stdout.strip().splitlines()[-1])["correct"] is True
    (root / "perfbench/metrics/loads_jax.train.py").write_text("import jax  # noqa: F401\n\n\n"
                                                               "def read(run):\n    return 1.0\n")
    spec["per_layer"].append({"name": "loads_jax.train", "unit": "1", "better": "higher", "source": "host_clock",
                              "layer": "training step", "moves": "setup_s"})
    loaded = run()
    assert loaded.returncode != 0 and not loaded.stdout.strip()
    assert "jax" in loaded.stderr
