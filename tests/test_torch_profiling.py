"""The port's profiling module (utils/profiling.py) and the trace reader of
its trace_step tool, on the CPU, against the JAX package's profiling module
and the JAX tools/trace_step.py."""

import gzip
import importlib.util
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_font_renderer_tpu.utils import profiling as jax_profiling
from ai_font_renderer_tpu_torch import ops
from ai_font_renderer_tpu_torch.tools import trace_step
from ai_font_renderer_tpu_torch.utils import profiling

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _jax_trace_step():
    """tools/trace_step.py of the JAX package, loaded as
    tests/test_trace_tools.py loads it."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    spec = importlib.util.spec_from_file_location("jax_trace_step", os.path.join(ROOT, "tools", "trace_step.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX_UNION = _jax_trace_step()._union_ms


@pytest.mark.parametrize("iters, warmup", [(10, 2), (3, 1), (1, 5)])
def test_timed_calls_as_often_as_jax(iters, warmup):
    calls = {"jax": 0, "torch": 0}

    def counter(side, make):
        def fn():
            calls[side] += 1
            return make()

        return fn

    jax_s = jax_profiling.timed(counter("jax", lambda: jnp.zeros(2)), iters=iters, warmup=warmup)
    torch_s = profiling.timed(counter("torch", lambda: torch.zeros(2)), iters=iters, warmup=warmup)
    assert calls["torch"] == calls["jax"] == iters + warmup
    assert torch_s >= 0 and jax_s >= 0


def test_timed_passes_its_arguments():
    seen = []
    profiling.timed(lambda a, b: seen.append((a, b)), 1, 2, iters=2, warmup=1)
    assert seen == [(1, 2)] * 3


def test_device_memory_stats_has_the_jax_shape_on_the_cpu():
    ours = profiling.device_memory_stats()
    theirs = jax_profiling.device_memory_stats()
    assert ours and all(isinstance(k, str) for k in ours)
    assert all(v is None for v in ours.values())
    assert all(v is None for v in theirs.values())


def test_trace_writes_a_chrome_trace_that_summarize_reads(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    assert any(e.key == "aten::mm" for e in prof.key_averages())
    assert list(tmp_path.rglob("*.pt.trace.json*"))
    out = trace_step.summarize_trace(str(tmp_path), steps=1)
    assert "CPU" in out["processes"]
    # The CPU holds no device events: no device entry, as JAX's summary on
    # a host without a device plane.
    assert not [k for k in out if k.startswith("GPU")]


def test_trace_without_a_directory_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with profiling.trace() as prof:
        torch.ones(3).sum()
    assert prof.key_averages()
    assert not list(tmp_path.rglob("*.json*"))


# --- _union_ms against the JAX tool's, bit for bit ---------------------------

@pytest.mark.parametrize("intervals", [
    [(0.0, 1000.0), (2000.0, 3000.0)],
    [(0.0, 10_000.0), (1000.0, 2000.0), (9000.0, 12_000.0)],
    [(5000.0, 6000.0), (0.0, 1000.0), (500.0, 1500.0)],
], ids=["disjoint", "nested", "unsorted"])
def test_union_ms_equals_the_jax_tool(intervals):
    assert trace_step._union_ms(list(intervals)) == JAX_UNION(list(intervals))


def test_union_ms_equals_the_jax_tool_on_random_intervals():
    rng = np.random.default_rng(0)
    starts = rng.uniform(0, 10_000, size=200)
    durs = rng.uniform(1, 500, size=200)
    intervals = [(float(s), float(s + d)) for s, d in zip(starts, durs)]
    assert trace_step._union_ms(list(intervals)) == JAX_UNION(list(intervals))


# --- summarize_trace on a hand-built Chrome trace -----------------------------

def _synthetic_trace() -> dict:
    """Device 0: two of ``trace``'s opening spin kernels long before, which
    must not count, then kernels at [0, 100), [50, 150) (overlapping), [400,
    500) on stream 7, a memset at [600, 610) on stream 8 and a memcpy at
    [700, 750); a user annotation spanning all that must not count either. Host: an op
    open across the gap [150, 400), another inside the gap [500, 600), and
    the user annotation, a span open across every gap."""
    meta = [
        {"name": "process_name", "ph": "M", "pid": 118, "tid": 0, "args": {"name": "python3"}},
        {"name": "process_labels", "ph": "M", "pid": 118, "tid": 0, "args": {"labels": "CPU"}},
        {"name": "process_name", "ph": "M", "pid": 0, "tid": 0, "args": {"name": "python3"}},
        {"name": "process_labels", "ph": "M", "pid": 0, "tid": 0, "args": {"labels": "GPU 0"}},
        {"name": "process_name", "ph": "M", "pid": 1, "tid": 0, "args": {"name": "python3"}},
        {"name": "process_labels", "ph": "M", "pid": 1, "tid": 0, "args": {"labels": "GPU 1"}},
    ]

    def x(cat, name, pid, tid, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts, "dur": dur}

    events = meta + [
        x("kernel", "void at::cuda::(anonymous namespace)::spin_kernel(long)", 0, 7, 10.0, 1.0),
        x("kernel", "void at::cuda::(anonymous namespace)::spin_kernel(long)", 0, 7, 20.0, 1.0),
        x("kernel", "k_a", 0, 7, 1000.0, 100.0),
        x("kernel", "k_b", 0, 7, 1050.0, 100.0),
        x("kernel", "k_a", 0, 7, 1400.0, 100.0),
        x("gpu_memset", "Memset (Device)", 0, 8, 1600.0, 10.0),
        x("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 0, 7, 1700.0, 50.0),
        x("gpu_user_annotation", "ProfilerStep#1", 0, 7, 900.0, 2000.0),
        x("cpu_op", "aten::long_host_op", 118, 118, 1100.0, 400.0),
        x("cpu_op", "aten::inner", 118, 118, 1140.0, 300.0),
        x("cpu_op", "aten::brief", 118, 118, 1520.0, 30.0),
        x("user_annotation", "ProfilerStep#1", 118, 118, 800.0, 3000.0),
        x("cuda_runtime", "cudaLaunchKernel", 118, 118, 990.0, 5.0),
    ]
    return {"traceEvents": events}


@pytest.mark.parametrize("suffix", [".pt.trace.json", ".pt.trace.json.gz"])
def test_summarize_trace_on_a_synthetic_trace(tmp_path, suffix):
    data = json.dumps(_synthetic_trace()).encode()
    path = tmp_path / ("worker" + suffix)
    path.write_bytes(gzip.compress(data) if suffix.endswith(".gz") else data)
    out = trace_step.summarize_trace(str(tmp_path), steps=2)
    assert out["processes"] == ["CPU", "GPU 0"]
    gpu = out["GPU 0"]
    # Busy: [1000, 1150) + [1400, 1500) + [1600, 1610) + [1700, 1750) = 310 us.
    assert gpu["events"] == 5
    assert gpu["busy_ms"] == pytest.approx(0.310, abs=1e-12)
    assert gpu["span_ms"] == pytest.approx(0.750, abs=1e-12)
    assert gpu["idle_ms"] == pytest.approx(0.440, abs=1e-12)
    assert gpu["busy_ms"] + gpu["idle_ms"] == pytest.approx(gpu["span_ms"], abs=1e-12)
    assert gpu["busy_ms_per_step"] == pytest.approx(0.155, abs=1e-12)
    assert gpu["idle_ms_per_step"] == pytest.approx(0.220, abs=1e-12)
    assert list(gpu["top_ops_ms_total"]) == ["k_a", "k_b", "Memcpy DtoD (Device -> Device)", "Memset (Device)"]
    assert gpu["top_ops_ms_total"]["k_a"] == pytest.approx(0.2, abs=1e-12)
    gaps = gpu["longest_idle_gaps"]
    assert [round(g["ms"], 9) for g in gaps] == [0.25, 0.1, 0.09]
    assert [round(g["at_ms"], 9) for g in gaps] == [0.15, 0.5, 0.61]
    assert gaps[0]["host_op"] == "aten::inner"  # the shortest op open across [1150, 1400)
    # No op spans [1500, 1600) or [1610, 1700): the annotation names them.
    assert gaps[1]["host_op"] == "ProfilerStep#1"
    assert gaps[1]["host_op_most_overlap"] == "ProfilerStep#1"  # 100 us against aten::brief's 30
    assert gaps[2]["host_op"] == "ProfilerStep#1" and gaps[2]["host_op_most_overlap"] == "ProfilerStep#1"


def test_summarize_trace_without_a_trace(tmp_path):
    assert "NO" in trace_step.summarize_trace(str(tmp_path))["trace"]


# --- the launch check ---------------------------------------------------------

# Device kernels' names as torch.profiler gave them on the H100.
H100_NAMES = {
    "round_bf16": "(anonymous namespace)::round_bf16_kernel(float const*, float const*, __nv_bfloat16*, long long, "
                  "int, int, int)",
    "gemm_bf16_tn": "sm90::gemm_bf16_tn_kernel(CUtensorMap_st, CUtensorMap_st, float*, int, int, int, int)",
    "gemm_bf16_bias_clamp": "void sm90::gemm_bf16_bmn_kernel<true, sm90::EpiBiasClamp>(CUtensorMap_st, "
                            "CUtensorMap_st, sm90::EpiBiasClamp::Params, int, int, int)",
    "gemm_bf16_mn": "void sm90::gemm_bf16_bmn_kernel<false, sm90::EpiStore>(CUtensorMap_st, CUtensorMap_st, "
                    "sm90::EpiStore::Params, int, int, int)",
    "fused_dw_adamw": "void sm90::gemm_bf16_bmn_kernel<false, (anonymous namespace)::EpiAdamW<__nv_bfloat16, true> >"
                      "(CUtensorMap_st, CUtensorMap_st, (anonymous namespace)::EpiAdamW<__nv_bfloat16, true>::Params)",
    "fused_dw_adamw_xt": "void sm90::gemm_bf16_bmn_kernel<true, (anonymous namespace)::EpiAdamW<__nv_bfloat16, "
                         "false> >(CUtensorMap_st, CUtensorMap_st, (anonymous namespace)::EpiAdamW<__nv_bfloat16, "
                         "false>::Params)",
    "attention_mma_fwd": "void (anonymous namespace)::attention_fwd_mma<8, 2>(__nv_bfloat16 const*, (anonymous "
                         "namespace)::Weights, __nv_bfloat16*, unsigned char*, int const*, int, int)",
    "attention_mma_bwd": "void (anonymous namespace)::attention_bwd_mma<8>(__nv_bfloat16 const*, __nv_bfloat16 "
                         "const*, (anonymous namespace)::Weights, unsigned char const*)",
    "attention_wide_fwd": "void (anonymous namespace)::wide_fwd<float, 1>((anonymous namespace)::OnChipArgs)",
    "attention_wide_bwd": "void (anonymous namespace)::wide_bwd<float, 1>((anonymous namespace)::OnChipArgs)",
    "attention_f32_fwd": "void (anonymous namespace)::attention_f32_fwd<8, 0>((anonymous namespace)::FwdArgs)",
    "attention_f32_bwd": "void (anonymous namespace)::attention_f32_bwd<8, 1>((anonymous namespace)::BwdArgs)",
}
LIBRARY_NAMES = [
    "void (anonymous namespace)::indexing_backward_kernel_small_stride<float>(long const*, long const*)",
    "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float> >(int)",
    "void (anonymous namespace)::rows_fwd((anonymous namespace)::RowArgs)",
    "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize64x64x8_stage3_warpsize1x4x1_ffma_aligna4_alignc4_execute_kernel",
    "Memcpy DtoD (Device -> Device)",
    "ProfilerStep*",
]


def test_each_kernel_name_matches_its_counter_alone():
    assert set(H100_NAMES) == set(profiling.KERNEL_NAMES)
    seen = profiling.profiled_launches(list(H100_NAMES.values()) * 2 + LIBRARY_NAMES)
    assert seen == {k: 2 for k in H100_NAMES}


def test_check_launches_passes_a_whole_trace_and_fails_a_lost_launch():
    zero = {k: 0 for k in H100_NAMES}
    after = dict(zero, round_bf16=2, fused_dw_adamw=1)
    names = [H100_NAMES["round_bf16"]] * 2 + [H100_NAMES["fused_dw_adamw"]] + LIBRARY_NAMES
    assert profiling.check_launches(names, zero, after) == {"round_bf16": 2, "fused_dw_adamw": 1}
    with pytest.raises(AssertionError, match="round_bf16"):
        profiling.check_launches(names[1:], zero, after)
    with pytest.raises(AssertionError, match="fused_dw_adamw_xt"):
        profiling.check_launches(names + [H100_NAMES["fused_dw_adamw_xt"]], zero, after)


def test_device_kernels_are_the_kernel_records_of_the_newest_trace(tmp_path):
    old = tmp_path / "a" / "old.pt.trace.json"
    old.parent.mkdir()
    old.write_text(json.dumps({"traceEvents": []}))
    os.utime(old, (1, 1))
    (tmp_path / "new.pt.trace.json").write_text(json.dumps(_synthetic_trace()))
    events = profiling.trace_events(str(tmp_path))
    assert [k["name"] for k in profiling.device_kernels(events)] == ["k_a", "k_b", "k_a"]
    assert profiling.opening_kernels(events) == 2
    assert profiling.trace_events(str(tmp_path / "a" / "none")) is None


def test_launch_counts_splits_the_attention_entries(monkeypatch):
    for name, value in (("fused_attention", 5), ("fused_attention2", 2), ("attention_mma_fwd", 2),
                        ("attention_wide_fwd", 1), ("fused_attention_backward", 4),
                        ("fused_attention2_backward", 0), ("attention_mma_bwd", 1), ("attention_wide_bwd", 1)):
        monkeypatch.setattr(getattr(ops, name), "launches", value)
    counts = profiling.launch_counts()
    assert set(counts) == set(profiling.KERNEL_NAMES)
    assert counts["attention_f32_fwd"] == 4 and counts["attention_f32_bwd"] == 2
