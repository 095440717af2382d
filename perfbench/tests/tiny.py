"""A cell cut to a size the CPU runs in seconds: narrow widths (a conv
decoder's channels too; the linear decoder has none), a batch of 16, a
corpus of 96 strings. For the CPU tests only; the benchmark's cells
run at their configurations' sizes."""

from __future__ import annotations

import time

import torch

from perfbench import harness

TINY = {
    "model": {"embedding_dim": 8, "num_heads": 2, "hidden_dim": 4, "decoder_channels": (8, 8, 4, 4, 2)},
    "train": {"batch_size": 16},
    "top": {"num_samples": 96},
    "mix": {"num_samples": 96, "steps_per_call": 2, "trace_steps": 2},
}
ALL = [w["name"] for w in harness.load_spec()["workloads"]]


def cell(name: str, seed: int = 2**31 + 17, trace: bool = False, seconds: float = 0.5, **fields):
    c = harness.load_cell(name, seed, seconds, trace, torch.device("cpu"), time.perf_counter(), overrides=TINY)
    for k, v in fields.items():
        setattr(c, k, v)
    return c
