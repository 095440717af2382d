"""The plain reference the benchmark holds the program to: plain PyTorch in
f32 (TF32 off), written from the model's equations and importing nothing of
the program. ``<decoder>.py`` (``linear``): one architecture's training
forward and its leaves, found by the configuration's ``decoder``;
``common``: plain numerics, the control's lower precision and optax's
AdamW; ``philox``: a frozen copy of the attention's dropout bits;
``check``: the numbers that decide ``correct``."""

import importlib


def arch(m: dict):
    """The reference module of model ``m``'s decoder:
    ``perfbench/reference/<decoder>.py``."""
    return importlib.import_module(f"{__name__}.{m.get('decoder', 'linear')}")
