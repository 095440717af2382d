"""Summarize a training run's metrics.jsonl: best val, timings, LR path.

The port of tools/summarize_run.py (host only: it reads the file the
port's training loop writes, utils/metrics.py, with the JAX package's
keys).

    python -m ai_font_renderer_tpu_torch.tools.summarize_run RUN_DIR [RUN_DIR ...] [--device cpu]

One JSON line a run.
"""

from __future__ import annotations

import json
import os
import sys

from . import _common


def summarize(run_dir: str) -> dict:
    path = os.path.join(run_dir, "metrics.jsonl")
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    best = min(rows, key=lambda r: r["val_loss"])
    steady = [r["seconds"] for r in rows[1:]] or [rows[0]["seconds"]]
    return {
        "run": run_dir,
        "epochs": len(rows),
        "best_val_loss": round(best["val_loss"], 8),
        "best_epoch": best["epoch"],
        "final_val_loss": round(rows[-1]["val_loss"], 8),
        "final_lr": rows[-1]["lr"],
        "epoch_seconds_median": round(sorted(steady)[len(steady) // 2], 3),
        "total_train_s": round(sum(r["seconds"] for r in rows), 1),
    }


def main(argv: list[str] | None = None) -> list[dict]:
    run_dirs, _, _ = _common.start(sys.argv[1:] if argv is None else argv)
    out = [summarize(d) for d in run_dirs]
    for rec in out:
        print(json.dumps(rec), flush=True)
    return out


if __name__ == "__main__":
    main()
