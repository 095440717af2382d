"""The counts of perfbench/counts against hand arithmetic."""

import json
from pathlib import Path

import pytest

from perfbench import counts
from perfbench.counts import linear as model, peaks

ROOT = Path(__file__).resolve().parents[2]


def _m(name):
    return json.loads((ROOT / "perfbench" / "configs" / f"{name}.json").read_text())


def test_flagship_forward_is_248_3_mflop_a_sheet():
    m = _m("flagship")["model"]
    f = model.forward_flops(m)
    assert f["projection"] == 2 * 6400 * 19200
    assert f["attention"] == 4 * 2 * 100 * 32 * 32 + 2 * 2 * 100 * 100 * 32
    assert f["fc1"] == 2 * 100 * 32 * 64
    assert model.model_flops_per_sheet(m) == 248_268_800


def test_hc307m_projection_is_16000_by_19200():
    m = _m("hc307m")["model"]
    assert model.forward_flops(m)["projection"] == 2 * 16000 * 19200


def test_train_least_time_flagship():
    cfg = _m("flagship")
    fns = {f["name"]: f for f in model.train_functions(cfg["model"], cfg["train"])}
    gemm = 2 * 1024 * 6400 * 19200 / 989e12
    assert fns["projection dX"]["flops"] / peaks.FLOPS["bf16"] == pytest.approx(gemm)
    # dW + AdamW: w, bf16 mu and nu read and written once, 20 bytes a parameter.
    state = 20 * (6400 * 19200 + 19200) / 3.35e12
    assert fns["out_w dW + AdamW"]["bytes"] / peaks.HBM_BYTES_PER_S == pytest.approx(state)
    front = 3 * 1024 * (model.forward_flops(cfg["model"])["attention"] + 2 * 100 * 32 * 64) / 67e12
    least = model.least_seconds(list(fns.values()))
    assert least > 2 * gemm + state + front * 0.999
    assert least == pytest.approx(2 * gemm + state + front, rel=0.01)


def test_counts_are_found_by_the_decoder():
    assert counts.of(_m("flagship")["model"]) is model
    assert counts.of({}) is model  # the linear decoder by default
