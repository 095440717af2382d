"""Milliseconds of the program's span ``train.update``, on the device: the
median over the traced steps of the time between its edges on the current
stream (CUDA events), which includes any device idle time inside the span.
The span holds AdamW over the parameters; in the fused step it also holds
K4, which forms out_w's gradient (the dW product) and applies its update in
one pass."""

from perfbench import program_spans


def read(run: dict):
    return program_spans.median_device_ms(run, "train.update")
