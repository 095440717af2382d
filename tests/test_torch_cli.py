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
    """Training (``--train``, or a bare run without weights) runs on the card
    by default: without one it exits 1 and names --device cpu. A render
    without weights exits 1 and says they were not found."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the rule is about its absence")
    assert cli.main(argv) == 1
    out = capsys.readouterr().out
    assert "device='cpu'" in out or "not found" in out


@pytest.mark.parametrize(
    "extra",
    [["--int8"], ["--implicit", "b.npz"], ["--placement", "p.npz"], ["--exported", "a.hlo"]],
)
def test_later_slice_flags_exit_1(weights, extra, tmp_path, capsys):
    rc = cli.main(["render", "HI", "--weights", weights, "--out", str(tmp_path), "--device", "cpu", *extra])
    assert rc == 1
    out = capsys.readouterr().out
    assert "not ported" in out and "item " in out
    assert not os.path.exists(tmp_path / "string_0.bmp")


@pytest.mark.parametrize("hinted", [False, True], ids=["unhinted", "hinted"])
def test_render_truth_writes_the_shaped_ground_truth(hinted, tmp_path, capsys):
    """render --truth: the 15 test strings' shaped ground truth as BMPs,
    byte-equal to the JAX package's ShapedRenderer sheets through its BMP
    encoder; no weights are read and no card is needed."""
    from ai_font_renderer_tpu.fontgen.bmp import encode_bmp
    from ai_font_renderer_tpu.fontgen.shaped import ShapedRenderer

    from ai_font_renderer_tpu_torch.config import MONTSERRAT_PATH

    argv = ["render", "--truth", "--font", MONTSERRAT_PATH, "--out", str(tmp_path), "--weights", "/none.npz"]
    assert cli.main(argv + (["--hinted"] if hinted else [])) == 0
    assert f"Saved 15 shaped ground-truth strings to {tmp_path}/" in capsys.readouterr().out
    want = ShapedRenderer(MONTSERRAT_PATH, hinted=hinted).render_batch(cli.TEST_STRINGS)
    assert sorted(os.listdir(tmp_path)) == sorted(f"string_{i}.bmp" for i in range(15))
    for i, sheet in enumerate(want):
        assert (tmp_path / f"string_{i}.bmp").read_bytes() == encode_bmp(sheet), i


def test_other_subcommands_and_serve_flags_exit_1(weights, capsys):
    assert cli.main(["export"]) == 1
    assert cli.main(["train-placement"]) == 1
    assert "item 14" in capsys.readouterr().out
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



def _fake_training(monkeypatch):
    seen = {}

    def fake_run_training(mcfg, tcfg, output_dir, font=None, checkpoint_dir=None, resume=False, device=None):
        seen.update(mcfg=mcfg, tcfg=tcfg, font=font, checkpoint_dir=checkpoint_dir, resume=resume, device=device)
        raise SystemExit(0)  # skip save/render

    monkeypatch.setattr(cli, "run_training", fake_run_training)
    return seen


def test_train_flags_reach_configs(monkeypatch, tmp_path):
    """The probes of tests/test_cli.py:130-159 on the port's flags."""
    seen = _fake_training(monkeypatch)
    with pytest.raises(SystemExit):
        cli.main([
            "--train", "--lr", "0.0005", "--leaky-clamp", "0.02", "--max-seconds", "90",
            "--samples", "1200", "--epochs", "7", "--batch-size", "64", "--schedule", "cosine",
            "--peak-lr", "0.003", "--checkpoint-dir", str(tmp_path / "ck"), "--resume",
            "--output", str(tmp_path / "o"), "--device", "cpu",
        ])
    m, t = seen["mcfg"], seen["tcfg"]
    assert m.leaky_clamp == 0.02 and not m.use_pallas_output
    assert (t.learning_rate, t.max_train_seconds, t.num_samples, t.num_epochs) == (0.0005, 90, 1200, 7)
    assert (t.batch_size, t.schedule, t.peak_learning_rate) == (64, "cosine", 0.003)
    assert seen["checkpoint_dir"] == str(tmp_path / "ck") and seen["resume"]
    assert seen["device"] == torch.device("cpu")


def test_profile_fast_flag(monkeypatch, tmp_path):
    """As tests/test_cli.py:230-254: --profile fast turns on the bf16
    frontend, uint8 dropout masks and the hand-rolled backward (not with a
    leaky clamp, which the hand-rolled step cannot take)."""
    seen = _fake_training(monkeypatch)
    out = ["--output", str(tmp_path / "o"), "--device", "cpu"]
    with pytest.raises(SystemExit):
        cli.main(["--train", "--profile", "fast", *out])
    assert seen["mcfg"].bf16_frontend and seen["mcfg"].bits_dropout
    assert seen["tcfg"].handrolled_bwd
    with pytest.raises(SystemExit):
        cli.main(["--train", "--profile", "fast", "--leaky-clamp", "0.1", *out])
    assert seen["mcfg"].bf16_frontend and not seen["tcfg"].handrolled_bwd


@pytest.mark.parametrize(
    "kernels,pallas,fused",
    [("none", False, False), ("output", True, False), ("fused", True, True)],
)
def test_kernels_flag_selects_the_projection_kernels(monkeypatch, tmp_path, kernels, pallas, fused):
    seen = _fake_training(monkeypatch)
    with pytest.raises(SystemExit):
        cli.main(["--train", "--kernels", kernels, "--output", str(tmp_path / "o"), "--device", "cpu"])
    assert seen["mcfg"].use_pallas_output == pallas and seen["tcfg"].fused_dw_adamw == fused
    assert not seen["tcfg"].handrolled_bwd


@pytest.mark.parametrize(
    "argv,words",
    [
        (["--mesh", "3"], "item 15"),
        (["--mesh", "2,1"], "item 15"),
        (["--decoder", "conv"], "item 8"),
        (["--decoder", "conv_ps"], "item 8"),
        (["--decoder-channels", "8,8"], "item 8"),
    ],
)
def test_later_slice_training_flags_exit_1(monkeypatch, tmp_path, capsys, argv, words):
    _fake_training(monkeypatch)
    assert cli.main(["--train", *argv, "--output", str(tmp_path / "o"), "--device", "cpu"]) == 1
    assert words in capsys.readouterr().out
    assert not os.path.exists(tmp_path / "o")


@pytest.fixture
def tiny_model(monkeypatch):
    """The CLI's configs with the model narrowed to a CPU test size."""
    from ai_font_renderer_tpu_torch.config import replace

    configs = cli._configs

    def small(args):
        mcfg, tcfg = configs(args)
        return replace(mcfg, max_length=16, hidden_dim=16, sheet_height=16, sheet_width=24), tcfg

    monkeypatch.setattr(cli, "_configs", small)


@pytest.mark.parametrize("kernels", ["none", "fused"])
def test_tiny_train_on_cpu_writes_weights_and_bmps(tiny_model, tmp_path, monkeypatch, kernels):
    """--train on the CPU: font_renderer.npz in the working directory, the
    manifests and 15 BMPs in the output directory, and weights that load
    back with their config."""
    from ai_font_renderer_tpu_torch.utils.checkpoint import load_params_with_config

    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "run")
    rc = cli.main(["--train", "--device", "cpu", "--samples", "80", "--epochs", "2", "--batch-size", "16",
                   "--output", out, "--kernels", kernels])
    assert rc == 0
    assert os.path.exists(tmp_path / "font_renderer.npz")
    names = set(os.listdir(out))
    assert {f"string_{i}.bmp" for i in range(15)} <= names
    assert {"config.txt", "training_results.txt", "metrics.jsonl", "epoch_0"} <= names
    assert read_bmp(os.path.join(out, "string_0.bmp")).shape == (16, 24)
    params, mcfg = load_params_with_config(str(tmp_path / "font_renderer.npz"), device="cpu")
    assert (mcfg.max_length, mcfg.hidden_dim, mcfg.sheet_width) == (16, 16, 24)
    assert params["out_w"].shape == (256, 384)


def test_proportional_font_trains_on_cpu(tiny_model, tmp_path, monkeypatch):
    """A proportional font (Montserrat) used to be refused with exit 1;
    --train --font Montserrat now trains on the CPU
    (narrowed model) on the proportional corpus, and writes the weights and
    15 BMPs."""
    from ai_font_renderer_tpu_torch.config import MONTSERRAT_PATH

    seen = {}
    build = cli._build_dataset

    def spy(*args, **kw):
        seen["atlas"], seen["ds"] = build(*args, **kw)
        return seen["atlas"], seen["ds"]

    monkeypatch.setattr(cli, "_build_dataset", spy)
    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "run")
    rc = cli.main(["--train", "--font", MONTSERRAT_PATH, "--device", "cpu", "--samples", "48", "--epochs", "1",
                   "--batch-size", "16", "--output", out])
    assert rc == 0
    assert type(seen["atlas"]).__name__ == "PropAtlas" and seen["ds"].targets_u8.shape == (48, 16, 24)
    assert os.path.exists(tmp_path / "font_renderer.npz")
    assert {f"string_{i}.bmp" for i in range(15)} <= set(os.listdir(out))


def test_bare_run_without_weights_trains(tiny_model, tmp_path, capsys):
    weights = str(tmp_path / "w.npz")
    out = str(tmp_path / "bare")
    rc = cli.main(["--weights", weights, "--output", out, "--device", "cpu", "--samples", "48",
                   "--epochs", "1", "--batch-size", "16"])
    assert rc == 0
    assert "No saved model found. Training a new model..." in capsys.readouterr().out
    assert os.path.exists(weights)
    assert {f"string_{i}.bmp" for i in range(15)} <= set(os.listdir(out))
