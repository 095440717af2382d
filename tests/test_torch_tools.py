"""The port's measurement tools (ai_font_renderer_tpu_torch/tools/), on the
CPU at narrow widths (tests/test_torch_cli.py's tiny_model sizes), against
the JAX tools of the root tools/ and the JAX package."""

import dataclasses
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
from ai_font_renderer_tpu.ops.fused_dw_adamw import fused_dw_adamw as jax_fused_dw_adamw
from ai_font_renderer_tpu_torch import cli
from ai_font_renderer_tpu_torch.config import ModelConfig, TrainConfig
from ai_font_renderer_tpu_torch.models import font_renderer as tfr
from ai_font_renderer_tpu_torch.ops import fused_dw_adamw, fused_dw_adamw_xt
from ai_font_renderer_tpu_torch.tools import (
    _common,
    ab_fused,
    ab_fused_attention,
    ab_kernel_micro,
    ab_profiles,
    bench_batch_sweep,
    bench_inference,
    bench_neural_render,
    bench_serve,
    profile_train,
    roofline_bwd,
    trace_step,
)

ROOT = os.path.join(os.path.dirname(__file__), "..")
WIDTHS = dict(max_length=16, hidden_dim=16, sheet_height=16, sheet_width=24, decoder_grid=(4, 4))
TINY = ModelConfig(**WIDTHS)
CPU = ["--device", "cpu"]


def _jax_tool(name: str):
    """A root tools/ script of the JAX package, loaded as
    tests/test_trace_tools.py loads tools/trace_step.py."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _json_lines(text: str) -> list[dict]:
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


# --- the tools' device rule ---------------------------------------------------

TOOLS = {
    "ab_kernel_micro": ab_kernel_micro, "profile_train": profile_train, "ab_profiles": ab_profiles,
    "trace_step": trace_step, "roofline_bwd": roofline_bwd, "ab_fused": ab_fused,
    "ab_fused_attention": ab_fused_attention, "bench_inference": bench_inference,
    "bench_batch_sweep": bench_batch_sweep, "bench_serve": bench_serve, "bench_neural_render": bench_neural_render,
}


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_each_tool_raises_without_a_card_unless_told_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        TOOLS[name].main([])


def test_port_flags_parse_both_forms():
    assert _common.split_flags(["a", "--device", "cpu", "--kernels=fused", "b"]) == (["a", "b"], "cpu", "fused")
    assert _common.split_flags(["x"]) == (["x"], None, "none")
    with pytest.raises(SystemExit):
        _common.split_flags(["--device"])


@pytest.mark.parametrize("kernels", ["none", "output", "fused"])
def test_kernels_keep_the_cli_meaning(kernels):
    mcfg, tcfg = _common.with_kernels(kernels, ModelConfig(), TrainConfig())
    mkw, tkw = cli._KERNELS[kernels]
    assert mcfg == dataclasses.replace(ModelConfig(), **mkw) and tcfg == dataclasses.replace(TrainConfig(), **tkw)


@pytest.mark.parametrize("kernels", ["output,attention", "attention_v2", "attention"])
def test_kernels_keep_the_export_meaning(kernels):
    mcfg, _ = _common.with_kernels(kernels, ModelConfig(), None)
    assert mcfg == dataclasses.replace(ModelConfig(), **cli._export_kernels(kernels))


def test_unknown_kernels_are_refused():
    with pytest.raises(ValueError, match="unknown"):
        _common.with_kernels("fused,warp", ModelConfig(), TrainConfig())


# --- PROFILES and the roofline counts against the JAX tools -------------------

def test_profiles_equal_the_jax_tools():
    jax_profiles = _jax_tool("ab_profiles").PROFILES
    assert list(ab_profiles.PROFILES) == list(jax_profiles)
    for name, (mcfg, tcfg) in ab_profiles.PROFILES.items():
        jm, jt = jax_profiles[name]
        assert dataclasses.asdict(mcfg) == dataclasses.asdict(jm), name
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jt), name


@pytest.mark.parametrize("mu_bf16", [True, False], ids=["mu_bf16", "mu_f32"])
def test_roofline_counts_equal_the_jax_expressions(mu_bf16):
    """tools/roofline_bwd.py:253-261 at the default configs (batch 1024),
    the JAX parameter count from shapes alone (jax.eval_shape)."""
    mcfg, tcfg = jcfg.ModelConfig(), jcfg.TrainConfig(adam_mu_bf16=mu_bf16)
    B = 1024
    P = mcfg.sheet_height * mcfg.sheet_width
    K_, N_ = mcfg.max_length * mcfg.hidden_dim, P
    shapes = jax.eval_shape(functools.partial(jfr.init, cfg=mcfg), jax.random.PRNGKey(0))
    n_par = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(shapes))
    mu_b = 2 if tcfg.adam_mu_bf16 else 4
    want = {"flop_gemm": 2.0 * B * K_ * N_, "chain_bytes": B * P * (4 + 1 + 4), "n_par": n_par,
            "adamw_bytes": n_par * (4 * 2 + 4 * 2 + mu_b * 2 + 4)}
    got = roofline_bwd.roofline_counts(ModelConfig(), TrainConfig(adam_mu_bf16=mu_bf16), B)
    assert got == want
    assert got["n_par"] == 122_912_896


# --- ab_kernel_micro: K9's home, against the JAX package's fused_dw_adamw -----

def _micro_inputs(m=256, k=640, n=384, seed=5):
    """x and gm rounded to bf16 (as the tool draws them), w, from numpy."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(torch.bfloat16)
    gm = torch.from_numpy((rng.standard_normal((m, n)) * 1e-4).astype(np.float32)).to(torch.bfloat16)
    w = (rng.standard_normal((k, n)) * 0.01).astype(np.float32)
    return x, gm, w


def _jax_update(x, gm, w, mu_dtype):
    k, n = w.shape
    out = jax_fused_dw_adamw(
        jnp.asarray(x.float().numpy()), jnp.asarray(gm.float().numpy()), jnp.asarray(w),
        jnp.zeros((k, n), mu_dtype), jnp.zeros((k, n), jnp.float32), jnp.float32(ab_kernel_micro.LR),
        5e-4, 0.9, 0.99, jnp.int32(ab_kernel_micro.COUNT),
    )
    return [np.asarray(a).astype(np.float32) for a in out]


def _assert_update(got, want, mu_bf16):
    """tests/test_torch_attention_train.py's K9 tolerances: w to 1e-7, nu and
    an f32 mu to 1e-5 of their largest value, a bf16 mu to one bf16 step."""
    w, mu, nu = (t.float().numpy() for t in got)
    jw, jmu, jnu = want
    np.testing.assert_allclose(w, jw, atol=1e-7, rtol=0)
    np.testing.assert_allclose(nu, jnu, atol=1e-5 * np.abs(jnu).max(), rtol=0)
    np.testing.assert_allclose(mu, jmu, atol=1e-5 * np.abs(jmu).max(), rtol=2.0**-7 if mu_bf16 else 0.0)


def test_micro_library_update_matches_jax():
    x, gm, w = _micro_inputs()
    k, n = w.shape
    got = ab_kernel_micro.library_update(x, gm, torch.from_numpy(w.copy()), torch.zeros(k, n), torch.zeros(k, n))
    _assert_update(got, _jax_update(x, gm, w, jnp.float32), mu_bf16=False)


@pytest.mark.parametrize("entry", ["k4", "k9"])
def test_micro_kernel_calls_match_jax(entry):
    x, gm, w = _micro_inputs(seed=6)
    k, n = w.shape
    state = (torch.from_numpy(w.copy()), torch.zeros(k, n, dtype=torch.bfloat16), torch.zeros(k, n))
    counter = fused_dw_adamw if entry == "k4" else fused_dw_adamw_xt
    before = counter.launches
    if entry == "k4":
        got = ab_kernel_micro.k4_update(x, gm, *state)
    else:
        got = ab_kernel_micro.k9_update(x.t().contiguous(), gm, *state)
    assert counter.launches == before  # CPU tensors: the plain version, no launch
    _assert_update(got, _jax_update(x, gm, w, jnp.bfloat16), mu_bf16=True)


def test_micro_main_takes_the_tile_arguments(capsys):
    out = ab_kernel_micro.main(CPU + ["256", "640", "384", "xt"], m=32, k=64, n=48, iters=2)
    text = capsys.readouterr().out
    assert text.splitlines()[0].startswith("cpu")
    assert "fixed by the build" in text and "fused XT K9" in text
    assert set(out) == {"library", "fused", "fused_xt"}
    assert _json_lines(text)[0]["ms_per_update"] == out


# --- ab_fused_attention's correctness outputs against the JAX attention -------

def test_fused_attention_correctness_outputs_match_jax():
    """At rate 0 (eval mode) the fused flag's forward (the kernel's plain
    version on the CPU) and its gradients equal the JAX model's: the
    forward within 2e-5, each gradient within 1e-4 of its largest value."""
    jm = jcfg.ModelConfig(**WIDTHS)
    jparams = jfr.init(jax.random.PRNGKey(3), jm)
    params = tfr.params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, "cpu")
    codes = np.random.default_rng(4).integers(65, 91, (8, WIDTHS["max_length"])).astype(np.int32)
    got = ab_fused_attention.correctness(params, torch.from_numpy(codes), TINY,
                                         dataclasses.replace(TINY, fused_attention=True))
    want = np.asarray(jfr.apply(jparams, jnp.asarray(codes), jm, train=False))
    for out in got["out"]:
        np.testing.assert_allclose(out.numpy(), want, atol=2e-5, rtol=0)
    jgrads = jax.grad(lambda p: jnp.mean(jfr.apply(p, jnp.asarray(codes), jm, train=False) ** 2))(jparams)
    for grads in got["grads"]:
        for key, g in grads.items():
            jg = np.asarray(jgrads[key])
            np.testing.assert_allclose(g.numpy(), jg, atol=1e-4 * np.abs(jg).max(), rtol=0, err_msg=key)
    assert got["fwd_diff"] <= 2e-5 and max(got["grad_rel"].values()) <= 1e-4


# --- bench_serve ---------------------------------------------------------------

SERVE_KEYS = {"metric", "value", "unit", "glyphs_per_sec", "clients", "batch_size", "int8", "format", "wall_s"}


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_bench_serve_replies_equal_a_direct_render(tmp_path, monkeypatch, capsys, int8):
    monkeypatch.chdir(tmp_path)
    rows = bench_serve.main(CPU + ["2", "2", "5", "--format", "raw,rle"] + (["--int8"] if int8 else []), mcfg=TINY)
    assert [r["format"] for r in rows] == ["raw", "rle"]
    lines = _json_lines(capsys.readouterr().out)
    assert lines == rows and all(set(r) == SERVE_KEYS for r in rows)
    assert all(r["int8"] is int8 and r["clients"] == 2 and r["batch_size"] == 256 for r in rows)


def test_bench_serve_refuses_a_reply_that_differs(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    real = bench_serve.render_batch_u8_async
    monkeypatch.setattr(bench_serve, "render_batch_u8_async", lambda *a: real(*a) ^ 1)
    with pytest.raises(AssertionError, match="differs from a direct render"):
        bench_serve.main(CPU + ["1", "1", "4"], mcfg=TINY)


# --- each tool at narrow widths, its output as the JAX tool's -----------------

def test_bench_inference_lines(capsys):
    rows = bench_inference.main(CPU, mcfg=TINY, batch=8, iters=2, rounds=1)
    assert _json_lines(capsys.readouterr().out) == rows
    assert [r["metric"] for r in rows] == [f"inference_{t}_glyphs_per_sec" for t in ("bf16", "int8w", "int8x8")]
    # The JAX tool's keys, its batch 1024 in the last one's name.
    assert all(set(r) == {"metric", "value", "unit", "ms_per_batch_8"} and r["unit"] == "glyphs/sec" for r in rows)


def test_bench_batch_sweep_lines(capsys):
    rows = bench_batch_sweep.main(CPU, mcfg=TINY, batches=(4, 8), iters=2, rounds=1)
    assert _json_lines(capsys.readouterr().out) == rows
    assert [(r["mode"], r["batch"]) for r in rows] == [("full", 4), ("int8", 4), ("full", 8), ("int8", 8)]
    assert all(set(r) == {"mode", "batch", "ms_per_batch", "glyphs_per_sec"} for r in rows)


def test_trace_step_on_the_cpu(tmp_path, capsys):
    rows = trace_step.main(CPU + ["parity", "--kernels", "fused,attention"], widths=WIDTHS, batch=8, steps=2,
                           long_steps=3, log_root=str(tmp_path))
    assert _json_lines(capsys.readouterr().out) == rows
    row = rows[0]
    assert {"profile", "logdir", "wall_ms_per_step_traced", "wall_ms_per_step", "processes"} <= set(row)
    assert row["kernels"] == "fused,attention" and set(row["wall_ms_per_step"]) == {"steps=2", "steps=3"}
    assert "CPU" in row["processes"] and list((tmp_path / "torch_trace_parity_fused+attention").glob("*.json"))


def test_roofline_bwd_on_the_cpu(capsys):
    out = roofline_bwd.main(CPU, mcfg=TINY, batch=4, iters=2, windows=1)
    assert _json_lines(capsys.readouterr().out) == [json.loads(json.dumps(out))]
    assert list(out["segments_ms"]) == ["full_step", "fwd", "fwd_bwd", "fwd_bwd_dw_side", "fwd_bwd_dx_side",
                                        "chain_only", "raw_dx_gemm", "raw_dw_gemm", "frontend_fwd",
                                        "frontend_fwd_bwd", "adamw_only"]
    assert out["counts"] == roofline_bwd.roofline_counts(TINY, TrainConfig(), 4)


@pytest.mark.parametrize("name", ["profile_train", "ab_profiles", "ab_fused", "ab_fused_attention"])
def test_the_timing_tools_run_on_the_cpu(name, capsys):
    runs = {
        "profile_train": lambda: profile_train.main(CPU + ["--kernels", "output"], mcfg=TINY, batch=4, iters=1,
                                                    steps=1),
        "ab_profiles": lambda: ab_profiles.main(CPU + ["parity", "fast_hr_rematdots"], widths=WIDTHS, batch=4,
                                                steps=2, rounds=1),
        "ab_fused": lambda: ab_fused.main(CPU, mcfg=TINY, batch=4, steps=2, rounds=1),
        "ab_fused_attention": lambda: ab_fused_attention.main(CPU, mcfg=TINY, batch=4, iters=1, rounds=1, steps=2,
                                                              epochs=1),
    }
    out = runs[name]()
    text = capsys.readouterr().out
    assert text.splitlines()[0].startswith("cpu")
    labels = {
        "profile_train": ["fwd eval", "K1-vs-plain fwd max abs err", "train step plain", "AdamW update alone"],
        "ab_profiles": ["parity: ", "fast_hr_rematdots: "],
        "ab_fused": ["standard (warm): ", "fused    (warm): ", "standard: ", "fused   : "],
        "ab_fused_attention": ["no effect in the port", "fwd max|diff|", "train step [fused fast=True]"],
    }[name]
    assert all(label in text for label in labels)
    assert all(np.isfinite(v) for v in out.values() if isinstance(v, float))


def test_bench_neural_render_lines(capsys):
    summary = bench_neural_render.main(CPU + ["--batch", "2", "--iters", "1"], supersamples=(2,), phases=(8,))
    lines = _json_lines(capsys.readouterr().out)
    variants = [r for r in lines if "variant" in r]
    assert [r["variant"] for r in variants] == ["exact_f32", "exact_bf16", "baked_ss2", "phased_p8",
                                                "phased_p8_onehot", "phased_p8_matmul", "learned_pipeline_exact"]
    keys = {"variant", "glyphs_per_sec", "ms_per_batch", "test_strings_mse", "font"}
    assert all(set(r) == keys for r in variants[:-1]) and set(variants[-1]) == keys - {"test_strings_mse"}
    assert [set(r) for r in lines if "bake" in r] == [{"bake", "bake_seconds", "baked_mb"}] * 2
    assert lines[-1] == summary and summary["summary"] == "neural_render"
    # The committed pair renders the test strings near the artifact lock.
    assert 0 < summary["exact_mse"] < 0.01 and abs(summary["phased_p8_matmul_mse_delta"]) < 1e-3
