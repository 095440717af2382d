"""Work counted from shapes alone: the operations and bytes each function of
a step needs (``<decoder>.py``, found by the configuration's ``decoder``:
``linear``), and the H100's published peaks they are held to (``peaks``).
No time of any kernel enters here, so a kernel that a later change renames
or replaces is read against the same bound."""

import importlib


def of(m: dict):
    """The counts module of model ``m``'s decoder:
    ``perfbench/counts/<decoder>.py``."""
    return importlib.import_module(f"{__name__}.{m.get('decoder', 'linear')}")
