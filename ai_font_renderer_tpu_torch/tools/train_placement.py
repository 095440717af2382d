"""A shim over the port's ``train-placement`` (train/placement_cli.py).

The port of tools/train_placement.py, which the campaign scripts
(tools/round*_queue*.sh) call with ``train-placement``'s flags; they are
the same here, ``--device`` and ``--kernels none|attention|attention_v2``
included. It prints the card's line first.

    python -m ai_font_renderer_tpu_torch.tools.train_placement [train-placement flags] [--device cpu]
"""

from __future__ import annotations

import sys

from ..device import resolve_device
from ..train import placement_cli
from . import _common


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    _, device, _ = _common.split_flags(argv)
    print(_common.card_line(resolve_device(device)), flush=True)
    return placement_cli.main(argv)


if __name__ == "__main__":
    sys.exit(main())
