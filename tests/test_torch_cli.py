"""The port's command line, its import rule and its device rule, on the CPU."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from ai_font_renderer_tpu import cli as jax_cli
from ai_font_renderer_tpu_torch import cli
from ai_font_renderer_tpu_torch.config import ModelConfig
from ai_font_renderer_tpu_torch.fontgen.bmp import read_bmp
from ai_font_renderer_tpu_torch.models import font_renderer as tfr
from ai_font_renderer_tpu_torch.utils.checkpoint import save_params

ROOT = pathlib.Path(__file__).resolve().parent.parent
SMALL = ModelConfig(max_length=16, hidden_dim=16, sheet_height=16, sheet_width=24)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("w") / "font_renderer.npz")
    save_params(tfr.init(torch.Generator().manual_seed(0), SMALL, "cpu"), path, SMALL)
    return path


def test_unknown_option_exits_1(capsys):
    assert cli.main(["--frobnicate"]) == 1
    assert "Available options: --train" in capsys.readouterr().out
    assert cli.main(["--help"]) == 0


@pytest.mark.parametrize(
    "argv",
    [["--train"], ["--weights", "/nonexistent.npz"], ["render", "HI", "--weights", "/nonexistent.npz"]],
    ids=["train", "bare_no_weights", "render_no_weights"],
)
def test_training_and_missing_weights_exit_1(argv, capsys):
    assert cli.main(argv) == 1
    out = capsys.readouterr().out
    assert "not ported" in out or "not found" in out


@pytest.mark.parametrize(
    "extra",
    [["--int8"], ["--truth"], ["--implicit", "b.npz"], ["--placement", "p.npz"], ["--exported", "a.hlo"]],
)
def test_later_slice_flags_exit_1(weights, extra, tmp_path, capsys):
    rc = cli.main(["render", "HI", "--weights", weights, "--out", str(tmp_path), "--device", "cpu", *extra])
    assert rc == 1
    assert "not ported" in capsys.readouterr().out
    assert not os.path.exists(tmp_path / "string_0.bmp")


def test_other_subcommands_and_serve_flags_exit_1(weights, capsys):
    assert cli.main(["fontgen"]) == 1
    assert cli.main(["serve", "--weights", weights, "--int8", "--device", "cpu"]) == 1
    assert cli.main(["serve", "--weights", weights, "--tcp", "nope", "--device", "cpu"]) == 1
    assert "HOST:PORT" in capsys.readouterr().out


def test_render_subcommand_on_cpu(weights, tmp_path):
    out = str(tmp_path / "r")
    rc = cli.main(["render", "HELLO", "WORLD", "--weights", weights, "--out", out, "--device", "cpu", "--fast"])
    assert rc == 0
    for i in range(2):
        assert read_bmp(os.path.join(out, f"string_{i}.bmp")).shape == (16, 24)


def test_bare_run_renders_test_strings(weights, tmp_path):
    out = str(tmp_path / "bare")
    assert cli.main(["--weights", weights, "--output", out, "--device", "cpu"]) == 0
    assert sorted(os.listdir(out)) == sorted(f"string_{i}.bmp" for i in range(15))


def test_cli_refuses_missing_cuda(weights, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the rule is about its absence")
    rc = cli.main(["render", "HI", "--weights", weights, "--out", str(tmp_path)])
    assert rc == 1
    assert "device='cpu'" in capsys.readouterr().out
    assert not os.path.exists(tmp_path / "string_0.bmp")


def test_copies_of_host_constants_match_jax():
    assert cli.TEST_STRINGS == jax_cli.TEST_STRINGS
    for value in ["localhost:8080", "[::1]:8080", "::1:8080", "nope", ":8080", "h:65536", "::1", ":::8080"]:
        assert cli.parse_tcp(value) == jax_cli.parse_tcp(value), value


def _port_sources():
    files = sorted((ROOT / "ai_font_renderer_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    banned = ("jax", "jaxlib", "ai_font_renderer_tpu")
    found = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in banned:
                    found.append(f"{path.relative_to(ROOT)}:{node.lineno} imports {name}")
    assert len(_port_sources()) > 10
    assert not found, found


def test_port_modules_load_without_jax():
    """A fresh interpreter imports every module of the port and chip_smoke
    without JAX ever entering sys.modules."""
    mods = [
        "ai_font_renderer_tpu_torch." + ".".join(p.relative_to(ROOT / "ai_font_renderer_tpu_torch").with_suffix("").parts)
        for p in (ROOT / "ai_font_renderer_tpu_torch").rglob("*.py")
        if p.name != "__init__.py"
    ]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r} + ['chip_smoke']: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ai_font_renderer_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the rule is about its absence")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout

