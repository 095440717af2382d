"""The training step's share of the H100's bf16 peak over the device's busy
time: the model's operations a step (forward, and twice that for the
backward; perfbench/counts) over the busy time a step of the traced
stretch, over 989 TFLOP/s, in %. It leaves out the time the device idles
waiting for the host."""

from perfbench import counts
from perfbench.counts import peaks


def read(run: dict):
    trace = run.get("trace")
    if run["kind"] != "train" or not trace or trace["busy_s"] <= 0:
        return None
    flops = counts.of(run["model"]).model_flops_per_sheet(run["model"]) * run["train"]["batch_size"]
    return 100.0 * 3 * flops / (trace["busy_s"] / run["traced_steps"]) / peaks.FLOPS["bf16"]
