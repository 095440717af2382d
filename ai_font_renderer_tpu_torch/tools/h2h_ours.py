"""The head-to-head harness, this side: train on a disk dataset.

The port of tools/h2h_ours.py: loads a dataset in the reference's file
format (``afr fontgen``'s ``data.txt`` + ``1.bmp``..``N.bmp``, read by
``fontgen/dataset.py:device_dataset_from_disk``) and trains the flagship
with the reference's hyper-parameters: the given batch, AdamW (1e-3, wd
5e-4, betas 0.9/0.99), ReduceLROnPlateau (0.7 / 20), early stop 70, an
80/20 split, eval renders every 5 epochs. The run's files go to OUT_DIR.

    python -m ai_font_renderer_tpu_torch.tools.h2h_ours DATA_DIR NUM_SAMPLES EPOCHS BATCH OUT_DIR [--kernels K] [--device cpu]

The JAX tool's summary line, then one JSON line of the same numbers.
"""

from __future__ import annotations

import json
import os
import sys
import time

from ..config import ModelConfig, TrainConfig, replace
from ..fontgen.dataset import device_dataset_from_disk
from ..train import train
from . import _common


def main(argv: list[str] | None = None, widths: dict | None = None) -> dict:
    """``widths``: ModelConfig fields (CPU tests: the disk sheets must
    then have the narrowed geometry)."""
    rest, dev, kernels = _common.start(sys.argv[1:] if argv is None else argv)
    if len(rest) != 5:
        print(__doc__)
        raise SystemExit(1)
    data_dir, num_samples, epochs, batch, out_dir = rest[0], int(rest[1]), int(rest[2]), int(rest[3]), rest[4]
    mcfg = replace(ModelConfig(), **(widths or {}))
    t0 = time.time()
    ds = device_dataset_from_disk(data_dir, num_samples, mcfg.sheet_height, mcfg.sheet_width, mcfg.max_length,
                                  device=dev)
    print(f"[h2h] dataset loaded+resident in {time.time() - t0:.1f}s", flush=True)
    tcfg = TrainConfig(num_epochs=epochs, batch_size=batch, num_samples=num_samples, eval_every=5)
    mcfg, tcfg = _common.with_kernels(kernels, mcfg, tcfg)
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.time()
    result = train(ds, mcfg, tcfg, output_dir=out_dir)
    wall = time.time() - t0
    print(f"[h2h] ours: best val {result.best_val_loss:.6f} after {result.final_epoch} epochs in {wall:.1f}s "
          f"(early_stopped={result.early_stopped})", flush=True)
    rec = {"config": "h2h-ours", "num_samples": num_samples, "batch": batch,
           "best_val_loss": round(result.best_val_loss, 6), "final_epoch": result.final_epoch,
           "early_stopped": result.early_stopped, "wall_s": round(wall, 1)}
    print(json.dumps(rec), flush=True)
    return {**rec, "history": result.history}


if __name__ == "__main__":
    main()
