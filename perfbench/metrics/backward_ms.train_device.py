"""Milliseconds of the program's span ``train.backward``, on the device: the
median over the traced steps of the time between its edges on the current
stream (CUDA events), which includes any device idle time inside the span.
The span holds the step's backward through the projection and the frontend:
K2, out_b's sum, the embedding backward and, in the standard step, the dW
product."""

from perfbench import program_spans


def read(run: dict):
    return program_spans.median_device_ms(run, "train.backward")
