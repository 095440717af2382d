"""The step's kernels against their roofline: the least time of the step's
functions on one H100 (perfbench/counts: operations and bytes from shapes)
over the device's busy time a step in the traced stretch, in %."""

from perfbench import counts


def read(run: dict):
    trace = run.get("trace")
    if run["kind"] != "train" or not trace or trace["busy_s"] <= 0:
        return None
    model = counts.of(run["model"])
    least = model.least_seconds(model.train_functions(run["model"], run["train"]))
    return 100.0 * least / (trace["busy_s"] / run["traced_steps"])
