"""Milliseconds of the program's span ``train.forward``, on the device: the
median over the traced steps of the time between its edges on the current
stream (CUDA events), which includes any device idle time inside the span.
The span holds the step's forward: the frontend, then the projection with
its clamp and loss (K1 under the fused kernels)."""

from perfbench import program_spans


def read(run: dict):
    return program_spans.median_device_ms(run, "train.forward")
