"""F4: the port's hang deadlines. ``AFR_DUMP_AFTER`` (the CLI) and
``AFR_BENCH_DUMP_AFTER`` (tools/bench_serve.py) arm a deadline that dumps
every thread's stack to stderr and exits, as the JAX CLI
(ai_font_renderer_tpu/cli.py) and the JAX tools/bench_serve.py do. Each
command here runs a few seconds: with the variable at 0.5 s it is cut, with
its stacks on stderr and a non-zero exit; without it, it runs to its end."""

import os
import subprocess
import sys

import torch

from ai_font_renderer_tpu_torch.config import ModelConfig
from ai_font_renderer_tpu_torch.models import font_renderer
from ai_font_renderer_tpu_torch.utils.checkpoint import save_params

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SAMPLES = 1500  # fontgen's BMPs: about 2.5 s of work after the CLI starts


def _run(args, cwd, **env):
    full = {**os.environ, "PYTHONPATH": ROOT, **env}
    for var in ("AFR_DUMP_AFTER", "AFR_BENCH_DUMP_AFTER"):
        if var not in env:
            full.pop(var, None)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=full, capture_output=True, text=True, timeout=120)


def _dumped(proc) -> bool:
    return proc.returncode != 0 and "Timeout (0:00:00.500000)!" in proc.stderr and "most recent call first" in \
        proc.stderr


def test_cli_dumps_its_stacks_at_the_deadline(tmp_path):
    args = ["-m", "ai_font_renderer_tpu_torch", "fontgen", "--num-samples", str(SAMPLES), "--out", "d",
            "--device", "cpu"]
    cut = _run(args, tmp_path, AFR_DUMP_AFTER="0.5")
    assert _dumped(cut), (cut.returncode, cut.stderr[-2000:])
    assert "ai_font_renderer_tpu_torch" in cut.stderr  # the main thread's frames
    written = len(os.listdir(tmp_path / "d")) if (tmp_path / "d").exists() else 0
    assert written < SAMPLES
    full = _run(args, tmp_path)
    assert full.returncode == 0, full.stderr[-2000:]
    assert "Timeout" not in full.stderr
    assert sum(name.endswith(".bmp") for name in os.listdir(tmp_path / "d")) == SAMPLES


def test_bench_serve_dumps_its_stacks_at_the_deadline(tmp_path):
    mcfg = ModelConfig(max_length=16, hidden_dim=16, sheet_height=16, sheet_width=24)
    save_params(font_renderer.init(torch.Generator().manual_seed(0), mcfg, "cpu"),
                str(tmp_path / "font_renderer.npz"), mcfg)
    args = ["-m", "ai_font_renderer_tpu_torch.tools.bench_serve", "2", "300", "5", "--device", "cpu"]
    cut = _run(args, tmp_path, AFR_BENCH_DUMP_AFTER="0.5")
    assert _dumped(cut), (cut.returncode, cut.stderr[-2000:])
    assert '"metric": "serve_strings_per_sec"' not in cut.stdout
    full = _run(args, tmp_path)
    assert full.returncode == 0, full.stderr[-2000:]
    assert '"metric": "serve_strings_per_sec"' in full.stdout


def test_the_cli_deadline_is_the_jax_clis_variable():
    """The JAX CLI reads AFR_DUMP_AFTER and the JAX bench_serve
    AFR_BENCH_DUMP_AFTER; the port reads the same names."""
    jax_cli = open(os.path.join(ROOT, "ai_font_renderer_tpu", "cli.py")).read()
    jax_bench = open(os.path.join(ROOT, "tools", "bench_serve.py")).read()
    port_cli = open(os.path.join(ROOT, "ai_font_renderer_tpu_torch", "cli.py")).read()
    port_bench = open(os.path.join(ROOT, "ai_font_renderer_tpu_torch", "tools", "bench_serve.py")).read()
    assert '"AFR_DUMP_AFTER"' in jax_cli and '"AFR_DUMP_AFTER"' in port_cli
    assert '"AFR_BENCH_DUMP_AFTER"' in jax_bench and '"AFR_BENCH_DUMP_AFTER"' in port_bench
