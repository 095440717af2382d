"""The device's idle share in the traced stretch of training: 1 - the union
of its kernel, memcpy and memset intervals over their span, in %. Traced,
the profiler's own host work adds idle time that the untraced window has
not."""


def read(run: dict):
    trace = run.get("trace")
    if run["kind"] != "train" or not trace or trace["span_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["span_s"])
