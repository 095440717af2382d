"""The port's placement decode evals and artifact tools
(ai_font_renderer_tpu_torch/tools/: ab_hard_decode, eval_decode_modes,
gen_artifact_golden, refresh_artifacts) and its fidelity study, on the CPU
on the committed artifacts (artifacts/*/), against the JAX tools of the
root tools/ and the committed golden tables."""

import functools
import json
import os
import sys
import types

import numpy as np
import pytest

from ai_font_renderer_tpu.fontgen import atlas as jatlas
from ai_font_renderer_tpu.train import placement_cli as jplacement_cli
from ai_font_renderer_tpu_torch.fontgen.bmp import read_bmp
from ai_font_renderer_tpu_torch.tools import (
    ab_hard_decode,
    eval_decode_modes,
    fidelity_study,
    gen_artifact_golden,
    refresh_artifacts,
)
from test_torch_native_build import install_reference_native
from test_torch_tools_rest import CPU, ROOT, _jax_tool, _json_lines

install_reference_native()

ART = os.path.join(ROOT, "artifacts")
GOLDEN_TOL = 1e-4  # per-string MSE against golden_mse.json (tests/test_artifacts.py)
RECORD_RTOL = 1e-5  # the decode evals' records against the JAX tools'


# --- the placement decode evals against the JAX tools -------------------------

@pytest.fixture
def jax_atlas_cache(tmp_path):
    """The JAX tools' bake_atlas with a cache of this test's own."""
    return functools.partial(jatlas.bake_atlas, cache_dir=str(tmp_path / "jax_atlas"))


def _assert_records(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k, v in w.items():
            if isinstance(v, float):
                assert g[k] == pytest.approx(v, rel=RECORD_RTOL, abs=1e-9), k
            else:
                assert g[k] == v, k


def test_ab_hard_decode_matches_jax(monkeypatch, capsys, jax_atlas_cache):
    """The records equal the JAX tool's; with ``per_string``, the soft
    decode's per-string MSE equals golden_mse.json within 1e-4."""
    run_dir = os.path.join(ART, "firacode")
    jtool = _jax_tool("ab_hard_decode")
    monkeypatch.setattr(jtool, "bake_atlas", jax_atlas_cache)
    monkeypatch.setattr(sys, "argv", ["ab_hard_decode.py", run_dir])
    jtool.main()
    want = _json_lines(capsys.readouterr().out)
    got = ab_hard_decode.main(CPU + [run_dir], per_string=True)
    assert _json_lines(capsys.readouterr().out) == got
    assert [r["checkpoint"] for r in got] == ["placement_finetuned.npz"]
    per_string = {k: got[0].pop(k) for k in list(got[0]) if k.endswith("_per_string")}
    assert sorted(per_string) == [f"e2e_render_mse_{m}_per_string" for m in ("hard", "mono", "soft")]
    _assert_records(got, want)
    with open(os.path.join(run_dir, "golden_mse.json")) as f:
        golden = json.load(f)
    np.testing.assert_allclose(per_string["e2e_render_mse_soft_per_string"], golden["per_string_mse"],
                               atol=GOLDEN_TOL, rtol=0)
    assert abs(got[0]["e2e_render_mse_soft"] - golden["mean_mse"]) < GOLDEN_TOL


def test_eval_decode_modes_matches_jax(monkeypatch, capsys):
    """At a cut protocol (2000 strings, 256 val). The JAX tool imports
    build_table from tools/train_placement.py, which now lives in the JAX
    package's train/placement_cli.py: the test hands it that function."""
    run_dir = os.path.join(ART, "firacode")
    monkeypatch.setitem(sys.modules, "train_placement", types.SimpleNamespace(build_table=jplacement_cli.build_table))
    jtool = _jax_tool("eval_decode_modes")
    monkeypatch.setattr(sys, "argv", ["eval_decode_modes.py", run_dir, "--samples", "2000", "--val", "256"])
    jtool.main()
    want = _json_lines(capsys.readouterr().out)
    got = eval_decode_modes.main(CPU + [run_dir, "--samples", "2000", "--val", "256"])
    assert [r["mode"] for r in got] == ["soft", "hard", "mono"]
    assert all("val_line_acc" in r for r in got)
    _assert_records(got, want)


# --- the artifact tools --------------------------------------------------------

def test_gen_artifact_golden_equals_the_committed_tables(tmp_path, capsys):
    out = gen_artifact_golden.main(CPU, out_root=str(tmp_path))
    for font in ("firacode", "montserrat"):
        with open(os.path.join(ART, font, "golden_mse.json")) as f:
            committed = json.load(f)
        with open(tmp_path / font / "golden_mse.json") as f:
            written = json.load(f)
        assert written == out[font] and set(written) == set(committed)
        assert written["n_strings"] == committed["n_strings"] and written["backend"] == "cpu"
        np.testing.assert_allclose(written["per_string_mse"], committed["per_string_mse"], atol=GOLDEN_TOL, rtol=0)
        assert abs(written["mean_mse"] - committed["mean_mse"]) < GOLDEN_TOL
    assert "golden_mse.json: mean" in capsys.readouterr().out


def test_refresh_artifacts_dry_run(tmp_path, capsys):
    dry = tmp_path / "dry"
    assert refresh_artifacts.main(CPU + ["firacode", os.path.join(ART, "firacode"), "--dry-run", str(dry)]) == 0
    (rec,) = _json_lines(capsys.readouterr().out)
    with open(os.path.join(ART, "firacode", "golden_mse.json")) as f:
        assert abs(rec["e2e_mse"] - json.load(f)["mean_mse"]) < GOLDEN_TOL
    assert rec["exported_u8_equal"] is True and rec["dst"] == str(dry)
    assert {"placement_finetuned.npz", "siren_finetuned.npz", "neural_render.pt2", "renders"} <= set(os.listdir(dry))
    renders = sorted(os.listdir(dry / "renders"))
    assert renders == sorted(f"{k}_{t}.bmp" for k in ("neural", "truth") for t in ("pangram", "string0"))
    assert read_bmp(str(dry / "renders" / "truth_pangram.bmp")).shape == (80, 240)


def test_fidelity_study_matches_jax(monkeypatch, capsys, jax_atlas_cache):
    """The printed studies equal the JAX tool's, on a 5-sample corpus."""
    jtool = _jax_tool("fidelity_study")
    monkeypatch.setattr(jtool, "bake_atlas", jax_atlas_cache)
    corpus = jtool.generate_corpus
    monkeypatch.setattr(jtool, "generate_corpus", lambda n: corpus(5))
    jtool.main()
    want = [" ".join(line.split()) for line in capsys.readouterr().out.splitlines()]
    out = fidelity_study.main(CPU, corpus_size=5)
    text = capsys.readouterr().out
    got = [" ".join(line.split()) for line in text.splitlines()[1:] if not line.startswith("{")]
    assert got == [line.replace("FiraCode 100 corpus", "FiraCode 5 corpus") for line in want]
    assert _json_lines(text) == [out] and len(out) == 10
