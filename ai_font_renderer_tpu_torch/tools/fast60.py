"""Fast-profile experiments: best val loss within a fixed epoch budget.

The port of tools/fast60.py: the FiraCode corpus (150k samples) built once
on the device, then the flagship model trained under four schedules (the
plateau schedule at its flat LR, cosine with peaks 1e-3, 2e-3 and 3e-3)
for ``--epochs`` epochs each, with no mid-run renders or checkpoints; for
each, the best val loss and the pure train wall time (the epochs' own
seconds).

    python -m ai_font_renderer_tpu_torch.tools.fast60 [--epochs 25] [--samples 150000] [--kernels K] [--device cpu]

One JSON line a schedule, with the JAX tool's keys.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from ..config import FIRACODE_PATH, ModelConfig, TrainConfig, replace
from ..train import train
from . import _common

SCHEDULES = (
    ("plateau-flat", dict(schedule="plateau")),
    ("cosine-1e3", dict(schedule="cosine", peak_learning_rate=1e-3)),
    ("cosine-2e3", dict(schedule="cosine", peak_learning_rate=2e-3)),
    ("cosine-3e3", dict(schedule="cosine", peak_learning_rate=3e-3)),
)


def main(argv: list[str] | None = None, widths: dict | None = None, batch: int | None = None) -> list[dict]:
    """Cuts: ``widths`` (ModelConfig fields) and ``batch``, for CPU tests."""
    rest, dev, kernels = _common.start(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(prog="python -m ai_font_renderer_tpu_torch.tools.fast60")
    ap.add_argument("--epochs", type=int, default=25)
    ap.add_argument("--samples", type=int, default=150000)
    args = ap.parse_args(rest)

    mcfg = replace(ModelConfig(), **(widths or {}))
    print("building dataset...", flush=True)
    ds = _common.sheet_dataset(FIRACODE_PATH, mcfg, args.samples, dev)
    out = []
    for name, kw in SCHEDULES:
        tcfg = TrainConfig(num_epochs=args.epochs, num_samples=args.samples, eval_every=10**9, checkpoint_every=0,
                           **kw)
        if batch is not None:
            tcfg = replace(tcfg, batch_size=batch)
        m, tcfg = _common.with_kernels(kernels, mcfg, tcfg)
        t0 = time.time()
        r = train(ds, m, tcfg, log=lambda *_: None)
        wall = time.time() - t0
        rec = {
            "config": name,
            "epochs": args.epochs,
            "best_val_loss": round(r.best_val_loss, 6),
            "train_wall_s": round(sum(h["seconds"] for h in r.history), 1),
            "total_wall_s": round(wall, 1),
        }
        print(json.dumps(rec), flush=True)
        out.append(rec)
    best = min(out, key=lambda rec: rec["best_val_loss"])
    print(f"# best: {best['config']} val={best['best_val_loss']:.6f}", flush=True)
    return out


if __name__ == "__main__":
    main()
