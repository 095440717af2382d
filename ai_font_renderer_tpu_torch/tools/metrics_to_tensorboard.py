"""Export a run's metrics.jsonl to TensorBoard event files.

The port of tools/metrics_to_tensorboard.py: every numeric field of each
record becomes a scalar tagged ``train/<field>``, stepped by the record's
epoch (else its line number), written by ``torch.utils.tensorboard``'s
SummaryWriter under ``RUN_DIR/tb``. That writer needs the ``tensorboard``
package; without it the tool raises an ImportError naming it.

    python -m ai_font_renderer_tpu_torch.tools.metrics_to_tensorboard RUN_DIR [RUN_DIR ...] [--device cpu]
    tensorboard --logdir RUN_DIR/tb
"""

from __future__ import annotations

import json
import os
import sys

from . import _common


def _summary_writer():
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        raise ImportError(
            "metrics_to_tensorboard writes through torch.utils.tensorboard, which needs the "
            f"'tensorboard' package; it is not installed here ({e})"
        ) from e
    return SummaryWriter


def export(run_dir: str) -> str:
    path = os.path.join(run_dir, "metrics.jsonl")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    out = os.path.join(run_dir, "tb")
    writer = _summary_writer()(log_dir=out)
    n = 0
    with open(path) as f:
        for lineno, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            step = int(rec.get("epoch", lineno))
            for key, val in rec.items():
                if key == "epoch" or isinstance(val, bool):
                    continue
                if isinstance(val, (int, float)):
                    writer.add_scalar(f"train/{key}", val, step)
            n += 1
    writer.close()
    print(f"{run_dir}: {n} epochs -> {out}")
    return out


def main(argv: list[str] | None = None) -> list[str]:
    run_dirs, _, _ = _common.start(sys.argv[1:] if argv is None else argv)
    if not run_dirs:
        print(__doc__)
        raise SystemExit(1)
    return [export(d) for d in run_dirs]


if __name__ == "__main__":
    main()
