"""Host seconds of the process's first training step: the program's first
``train.step`` span record (the first call of a span name is recorded,
host times only, with spans off). It holds the program's first calls:
library loads, CUDA's lazy module loading, library handles; nothing in a
step waits for the device, so it is the host's time to enqueue it."""

from perfbench import program_spans


def read(run: dict):
    if run["kind"] != "train":
        return None
    for r in program_spans.records() or ():
        if r["name"] == "train.step" and r["end_ns"] is not None:
            return (r["end_ns"] - r["start_ns"]) / 1e9
    return None
