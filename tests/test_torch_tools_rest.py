"""The rest of the port's tools (ai_font_renderer_tpu_torch/tools/): the
device rule of every tool this file and tests/test_torch_tools_artifacts.py
cover, the A/B and serving tools, the SIREN/SDF tools, the training runners
and the run readers, on the CPU at narrow widths (tests/test_torch_cli.py's
tiny_model sizes), against the JAX tools of the root tools/ and the JAX
package."""

import functools
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_font_renderer_tpu import config as jcfg
from ai_font_renderer_tpu.models import font_renderer as jfr
from ai_font_renderer_tpu.ops import quantized as jq
from ai_font_renderer_tpu_torch.config import ModelConfig
from ai_font_renderer_tpu_torch.fontgen.bmp import read_bmp, write_bmp
from ai_font_renderer_tpu_torch.fontgen.textgen import generate_corpus
from ai_font_renderer_tpu_torch.models import font_renderer as tfr
from ai_font_renderer_tpu_torch.models import siren
from ai_font_renderer_tpu_torch.tools import (
    _common,
    ab_fa2,
    ab_hard_decode,
    ab_serving_tiers,
    bench_sdf_atlas,
    eval_decode_modes,
    fast60,
    fidelity_study,
    gen_artifact_golden,
    h2h_ours,
    metrics_to_tensorboard,
    refresh_artifacts,
    render_implicit_demo,
    round4_task5,
    run_extended_configs,
    run_montserrat_conv,
    run_montserrat_converged,
    run_montserrat_hc,
    summarize_run,
    train_placement,
)
from test_torch_native_build import install_reference_native

install_reference_native()

ROOT = os.path.join(os.path.dirname(__file__), "..")
WIDTHS = dict(max_length=16, hidden_dim=16, sheet_height=16, sheet_width=24, decoder_grid=(4, 4))
TINY = ModelConfig(**WIDTHS)
SIREN_WIDTHS = dict(embed_dim=8, hidden_dim=16, n_layers=2, cell=8)
CPU = ["--device", "cpu"]
F32_TOL = 1e-5  # tests/test_torch_parity.py's forward bound
INT8_SHEET_TOL = 1e-6  # tests/test_torch_quantized.py's int8 sheets against JAX
# The bf16 frontend: the two frameworks round its bf16 products and sums at
# other places (tests/test_torch_model.py's bf16_frontend bound).
BF16_FRONTEND_TOL = 1e-2


def _jax_tool(name: str):
    """A root tools/ script of the JAX package, loaded as
    tests/test_torch_tools.py loads them."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _json_lines(text: str) -> list[dict]:
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


# --- the tools' device rule ---------------------------------------------------

TOOLS = {
    "train_placement": train_placement, "ab_fa2": ab_fa2, "ab_serving_tiers": ab_serving_tiers,
    "ab_hard_decode": ab_hard_decode, "eval_decode_modes": eval_decode_modes, "bench_sdf_atlas": bench_sdf_atlas,
    "render_implicit_demo": render_implicit_demo, "run_extended_configs": run_extended_configs,
    "run_montserrat_converged": run_montserrat_converged, "run_montserrat_conv": run_montserrat_conv,
    "run_montserrat_hc": run_montserrat_hc, "fast60": fast60, "h2h_ours": h2h_ours,
    "gen_artifact_golden": gen_artifact_golden, "refresh_artifacts": refresh_artifacts,
    "fidelity_study": fidelity_study, "summarize_run": summarize_run,
    "metrics_to_tensorboard": metrics_to_tensorboard, "round4_task5": round4_task5,
}


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_each_tool_raises_without_a_card_unless_told_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        TOOLS[name].main([])


def test_every_root_tool_has_its_port():
    """Every Python tool of the root tools/ has a module of the same name in
    the port, but h2h_reference.py, which runs the upstream PyTorch
    reference from its own checkout."""
    root = {n[:-3] for n in os.listdir(os.path.join(ROOT, "tools")) if n.endswith(".py")}
    port = {n[:-3] for n in os.listdir(os.path.join(ROOT, "ai_font_renderer_tpu_torch", "tools"))
            if n.endswith(".py")}
    assert root - port == {"h2h_reference"}


def test_golden_refuses_the_card(monkeypatch):
    """The golden tables are CPU numerics: on a card the tool raises with
    the JAX tool's reason."""
    monkeypatch.setattr(_common, "resolve_device", lambda device: torch.device("cuda"))
    monkeypatch.setattr(_common, "card_line", lambda device: "a card")
    with pytest.raises(RuntimeError, match="golden tables are defined on CPU numerics"):
        gen_artifact_golden.main([])


@pytest.mark.parametrize("module,tool", [("PIL", fidelity_study), ("torch.utils.tensorboard", metrics_to_tensorboard)],
                         ids=["pillow", "tensorboard"])
def test_host_tools_name_the_package_they_miss(module, tool, monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, module, None)
    (tmp_path / "metrics.jsonl").write_text('{"epoch": 0, "val_loss": 1.0}\n')
    with pytest.raises(ImportError, match="Pillow" if module == "PIL" else "'tensorboard' package"):
        tool.main(CPU + [str(tmp_path)])


# --- ab_fa2 and ab_serving_tiers against the JAX model ------------------------

@pytest.fixture(scope="module")
def jax_pair():
    """Tiny JAX weights (and their port copy) and codes, from seeds."""
    jparams = jfr.init(jax.random.PRNGKey(3), jcfg.ModelConfig(**WIDTHS))
    params = tfr.params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, "cpu")
    codes = np.random.default_rng(4).integers(65, 91, (8, WIDTHS["max_length"])).astype(np.int32)
    return jparams, params, codes


def test_ab_fa2_forward_and_gradients_match_jax(jax_pair, capsys):
    """The plain and the v2 forward (eval mode) and the gradients of
    mean(out^2) equal the JAX model's: the forward within 1e-5, each
    gradient within 1e-5 of its largest value."""
    jparams, params, codes = jax_pair
    jm = jcfg.ModelConfig(**WIDTHS)
    out = ab_fa2.main(CPU, mcfg=TINY, params=params, codes=torch.from_numpy(codes), iters=1, rounds=1, steps=2,
                      epochs=1)
    text = capsys.readouterr().out
    assert text.splitlines()[0].startswith("cpu")
    want = np.asarray(jfr.apply(jparams, jnp.asarray(codes), jm, train=False))
    jgrads = jax.grad(lambda p: jnp.mean(jfr.apply(p, jnp.asarray(codes), jm, train=False) ** 2))(jparams)
    for sheets, grads in zip(out["out"], out["grads"]):
        np.testing.assert_allclose(sheets.numpy(), want, atol=F32_TOL, rtol=0)
        assert set(grads) == {"wq", "wk", "wv", "wo", "out_w", "embedding"}
        for key, g in grads.items():
            jg = np.asarray(jgrads[key])
            np.testing.assert_allclose(g.numpy(), jg, atol=F32_TOL * np.abs(jg).max(), rtol=0, err_msg=key)
    (line,) = _json_lines(text)
    assert set(line["train_step_ms"]) == {f"{t} fast={f}" for t in ("plain", "v1", "v2") for f in (False, True)}
    assert set(line["eval_glyphs_per_sec"]) == {"plain", "v1"}
    assert "train step [v2 (v2 f16/b8, v2 f32/b16, v2 f64/b32) fast=True]" in text


def _jax_tier(tier, jparams, codes):
    jm = jcfg.ModelConfig(**WIDTHS, bf16_frontend=tier.endswith("bf16"))
    if tier.startswith("int8"):
        return jq.apply_quantized_int8(jq.quantize_params(jparams), jnp.asarray(codes), jm)
    return jfr.apply(jparams, jnp.asarray(codes), jm, train=False)


@pytest.mark.parametrize("tier", ["fp32", "fp+bf16", "int8", "int8+bf16"])
def test_ab_serving_tiers_sheets_match_jax(tier, jax_pair, capsys):
    """Each tier's sheets equal the JAX tool's tier on the same weights:
    fp32 within 1e-5, int8 within 1e-6 (tests/test_torch_quantized.py's
    bound), the bf16-frontend tiers within tests/test_torch_model.py's
    bf16_frontend bound."""
    jparams, params, codes = jax_pair
    out = ab_serving_tiers.main(CPU, mcfg=TINY, params=params, codes=torch.from_numpy(codes), iters=1, rounds=1)
    want = np.asarray(_jax_tier(tier, jparams, codes))
    tol = {"fp32": F32_TOL, "fp+bf16": BF16_FRONTEND_TOL, "int8": INT8_SHEET_TOL, "int8+bf16": BF16_FRONTEND_TOL}[tier]
    np.testing.assert_allclose(out["sheets"][tier].numpy(), want, atol=tol, rtol=0)
    (line,) = _json_lines(capsys.readouterr().out)
    assert list(line["tiers"]) == ["fp32", "fp+bf16", "int8", "int8+bf16"]
    assert set(line["tiers"][tier]) == {"ms_per_batch", "glyphs_per_sec", "max_abs_diff_vs_fp32",
                                        "mean_abs_diff_vs_fp32"}


# --- the run readers -----------------------------------------------------------

def _metrics(tmp_path) -> str:
    rows = [{"epoch": e, "train_loss": 0.1 / (e + 1), "val_loss": 0.05 + 0.01 * (e - 2) ** 2, "lr": 1e-3 * 0.7 ** e,
             "seconds": 1.5 + 0.1 * e, "early_stopped": False} for e in range(6)]
    run = tmp_path / "run"
    run.mkdir()
    (run / "metrics.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows))
    return str(run)


def test_summarize_run_matches_jax(tmp_path, capsys):
    run = _metrics(tmp_path)
    assert summarize_run.main(CPU + [run]) == [_jax_tool("summarize_run").summarize(run)]
    assert _json_lines(capsys.readouterr().out)[0]["best_epoch"] == 2


def test_metrics_to_tensorboard_scalars_read_back(tmp_path):
    pytest.importorskip("tensorboard")
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    run = _metrics(tmp_path)
    (out,) = metrics_to_tensorboard.main(CPU + [run])
    acc = EventAccumulator(out)
    acc.Reload()
    assert set(acc.Tags()["scalars"]) == {f"train/{k}" for k in ("train_loss", "val_loss", "lr", "seconds")}
    vals = acc.Scalars("train/val_loss")
    assert [v.step for v in vals] == list(range(6))
    np.testing.assert_allclose([v.value for v in vals], [0.05 + 0.01 * (e - 2) ** 2 for e in range(6)], rtol=1e-6)


# --- the runners: each one's JSON line and keys at tiny widths, 1 epoch ------

RUNNER_KEYS = {"config", "final_epoch", "best_val_loss", "early_stopped", "wall_s"}


def _h2h(tmp_path):
    """A disk dataset of 24 sheets at the tiny geometry, then h2h_ours."""
    data = tmp_path / "data"
    data.mkdir()
    strings = generate_corpus(24)
    (data / "data.txt").write_text("\n".join(strings) + "\n")
    rng = np.random.default_rng(0)
    for i in range(len(strings)):
        write_bmp(str(data / f"{i + 1}.bmp"), rng.uniform(0, 1, (16, 24)).astype(np.float32))
    return h2h_ours.main(CPU + [str(data), "24", "1", "8", str(tmp_path / "h2h")], widths=WIDTHS)


RUNNERS = {
    "converged": (lambda tmp: run_montserrat_converged.main(CPU + ["--kernels", "fused"], out_root=str(tmp),
                                                            samples=40, epochs=1, widths=WIDTHS),
                  RUNNER_KEYS, "torch_montserrat_converged"),
    "conv": (lambda tmp: run_montserrat_conv.main(CPU + ["1"], out_root=str(tmp), samples=40,
                                                  widths=dict(WIDTHS, decoder_channels=(8, 8, 8, 8, 8))),
             RUNNER_KEYS | {"params"}, "torch_montserrat_conv"),
    "conv_ps": (lambda tmp: run_montserrat_conv.main(CPU + ["1", "1e-3", "conv_ps"], out_root=str(tmp), samples=40,
                                                     widths=dict(WIDTHS, decoder_channels=(8, 8, 8, 8, 8))),
                RUNNER_KEYS | {"params"}, "torch_montserrat_conv_ps"),
    "conv_ps_wide": (lambda tmp: run_montserrat_conv.main(CPU + ["1", "1e-3", "conv_ps", "--wide"], out_root=str(tmp),
                                                          samples=40, widths=WIDTHS),
                     RUNNER_KEYS | {"params"}, "torch_montserrat_conv_ps_wide"),
    "hc": (lambda tmp: run_montserrat_hc.main(CPU + ["1"], out_root=str(tmp), samples=40, widths=WIDTHS),
           RUNNER_KEYS | {"params"}, "torch_montserrat_hc"),
    "h2h_ours": (_h2h, {"config", "num_samples", "batch", "best_val_loss", "final_epoch", "early_stopped", "wall_s"},
                 "h2h"),
}


@pytest.mark.parametrize("name", list(RUNNERS))
def test_runner_lines(name, tmp_path, capsys):
    run, keys, out_dir = RUNNERS[name]
    out = run(tmp_path)
    (line,) = _json_lines(capsys.readouterr().out)
    assert set(line) == keys and all(line[k] == out[k] for k in line)
    assert line["final_epoch"] == 1 and np.isfinite(line["best_val_loss"])
    assert all(np.isfinite(h["train_loss"]) for h in out["history"])
    names = set(os.listdir(tmp_path / out_dir))
    assert {"metrics.jsonl", "config.txt", "training_results.txt"} <= names
    if name != "h2h_ours":
        assert {f"string_{i}.bmp" for i in range(15)} <= names and any(n.endswith(".npz") for n in names)


def test_hc_is_the_widest_frontend():
    """The hc recipe's frontend: embed 64, 8 heads, fc1 160 -> a 16000-wide
    flat feature and a 16000 x 19200 projection (307M parameters), the
    leaky clamp on."""
    mcfg = ModelConfig(**run_montserrat_hc.HC)
    assert mcfg.max_length * mcfg.hidden_dim == 16000 and mcfg.leaky_clamp == 0.01
    shapes = jax.eval_shape(functools.partial(jfr.init, cfg=jcfg.ModelConfig(**run_montserrat_hc.HC)),
                            jax.random.PRNGKey(0))
    assert sum(int(np.prod(p.shape)) for p in jax.tree.leaves(shapes)) > 307e6


def test_fast60_lines(capsys):
    rows = fast60.main(CPU + ["--epochs", "1", "--samples", "40", "--kernels", "output"], widths=WIDTHS, batch=8)
    text = capsys.readouterr().out
    assert _json_lines(text) == rows
    assert [r["config"] for r in rows] == ["plateau-flat", "cosine-1e3", "cosine-2e3", "cosine-3e3"]
    assert all(set(r) == {"config", "epochs", "best_val_loss", "train_wall_s", "total_wall_s"} for r in rows)
    assert all(np.isfinite(r["best_val_loss"]) for r in rows) and "# best: " in text


def test_run_extended_configs_lines(tmp_path, capsys):
    rows = run_extended_configs.main(
        CPU, out_root=str(tmp_path), siren=dict(steps=2, siren_widths=SIREN_WIDTHS),
        multifont=dict(steps=2, siren_widths=SIREN_WIDTHS),
        sdf_unicode=dict(steps=2, siren_widths=SIREN_WIDTHS, limit=64, iters=1),
        montserrat=dict(epochs=1, samples=40, widths=WIDTHS))
    assert _json_lines(capsys.readouterr().out) == rows
    assert [r["config"] for r in rows] == ["siren-implicit-64", "multifont-2ttf", "sdf-unicode-atlas",
                                           "montserrat-flagship"]
    assert set(rows[2]) == {"config", "charset_size", "steps", "final_sdf_mse", "atlas_glyphs_per_sec",
                            "train_wall_s"} and rows[2]["charset_size"] == 64
    for d, f in (("torch_siren", "atlas_sample.bmp"), ("torch_multifont", "two_fonts_sample.bmp"),
                 ("torch_sdf_unicode", "sdf_levelset_sample.bmp"), ("torch_montserrat", "string_0.bmp")):
        assert (tmp_path / d / f).exists(), d
    assert read_bmp(str(tmp_path / "torch_siren" / "atlas_sample.bmp")).shape == (32, 64)


def test_bench_sdf_atlas_line(capsys):
    rec = bench_sdf_atlas.main(CPU + ["--steps", "2", "--cell", "8", "--limit", "40"], iters=2)
    assert _json_lines(capsys.readouterr().out) == [rec]
    assert rec["metric"] == "sdf_unicode_atlas_glyphs_per_sec" and rec["charset_size"] == 40 and rec["value"] > 0
    assert set(rec) == {"metric", "value", "unit", "charset_size", "cell", "train_seconds", "final_sdf_mse"}


def test_render_implicit_demo_line(tmp_path, capsys):
    out = render_implicit_demo.main(CPU + ["2"], out_root=str(tmp_path), cfg=siren.SirenConfig(**SIREN_WIDTHS),
                                    batch=8, iters=2, rounds=1)
    (line,) = _json_lines(capsys.readouterr().out)
    assert set(line) == {"config", "glyph_mse", "train_s", "test_strings_mse_vs_truth", "test_strings_psnr_db",
                         "compose_glyphs_per_sec", "scales_rendered", "wall_s"}
    assert out["sheets_4x_shape"] == [15, 320, 960] and line["compose_glyphs_per_sec"] > 0
    names = set(os.listdir(tmp_path / "torch_implicit_sheets"))
    assert names == {f"string_{i}{s}.bmp" for i in range(15) for s in ("", "_4x")}


def test_round4_task5_lines(tmp_path, capsys):
    out = round4_task5.main(CPU, widths=WIDTHS, batch=8, rounds=1, steps=2, long_steps=3, log_root=str(tmp_path))
    text = capsys.readouterr().out
    assert list(out["ab_profiles_ms_per_step"]) == list(round4_task5.AB)
    assert _json_lines(text) == out["traces"] and [t["profile"] for t in out["traces"]] == list(round4_task5.TRACED)
    assert sorted(os.listdir(tmp_path)) == ["torch_trace_fast_handrolled", "torch_trace_fast_hr_rematdots"]


def test_train_placement_shim_runs_the_subcommand(tmp_path, capsys):
    out = tmp_path / "tp"
    rc = train_placement.main(CPU + ["--samples", "240", "--batch", "64", "--epochs", "1", "--line-head", "3",
                                     "--no-e2e", "--out", str(out)])
    text = capsys.readouterr().out
    assert rc == 0 and text.splitlines()[0].startswith("cpu")
    assert {"placement.npz", "metrics.jsonl"} <= set(os.listdir(out))
