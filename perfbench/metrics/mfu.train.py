"""The training step's share of the H100's bf16 peak: the model's operations
a sheet (forward, and twice that for the backward; perfbench/counts) times
the untraced window's sheets a second, over 989 TFLOP/s, in %."""

from perfbench import counts
from perfbench.counts import peaks


def read(run: dict):
    if run["kind"] != "train":
        return None
    flops = counts.of(run["model"]).model_flops_per_sheet(run["model"])
    return 100.0 * 3 * flops * run["sheets_per_s"] / peaks.FLOPS["bf16"]
