"""Converge the Montserrat flagship config.

The port of tools/run_montserrat_converged.py: the proportional-layout
Montserrat corpus (150k sheets, GPOS kerning, GSUB ligatures) through the
flagship recipe (plateau LR schedule, early stop; eval renders every 50
epochs, a checkpoint every 100). The run's files (metrics.jsonl, the
manifests, the renders, font_renderer_montserrat.npz) go to
``<out_root>/torch_montserrat_converged/``.

    python -m ai_font_renderer_tpu_torch.tools.run_montserrat_converged [--kernels K] [--device cpu]

One JSON summary line at the end, with the JAX tool's keys.
"""

from __future__ import annotations

import json
import os
import sys
import time

from ..config import MONTSERRAT_PATH, ModelConfig, TrainConfig, replace
from . import _common


def main(argv: list[str] | None = None, out_root: str = "extended_runs", samples: int = 150000,
         epochs: int | None = None, widths: dict | None = None) -> dict:
    """Cuts: ``samples`` (the corpus), ``epochs`` (default: the recipe's
    TrainConfig, early stopping ends it), ``widths`` (ModelConfig fields,
    for CPU tests)."""
    _, dev, kernels = _common.start(sys.argv[1:] if argv is None else argv)
    t0 = time.time()
    out = os.path.join(out_root, "torch_montserrat_converged")
    mcfg = replace(ModelConfig(), **(widths or {}))
    tcfg = TrainConfig(eval_every=50, checkpoint_every=100)
    if epochs is not None:
        tcfg = replace(tcfg, num_epochs=epochs)
    mcfg, tcfg = _common.with_kernels(kernels, mcfg, tcfg)
    r, _ = _common.train_recipe("montserrat", MONTSERRAT_PATH, mcfg, tcfg, samples, dev, out,
                                "font_renderer_montserrat.npz")
    rec = {
        "config": "montserrat-flagship-converged",
        "final_epoch": r.final_epoch,
        "best_val_loss": round(r.best_val_loss, 6),
        "early_stopped": r.early_stopped,
        "wall_s": round(time.time() - t0, 1),
    }
    print(json.dumps(rec), flush=True)
    return {**rec, "out": out, "history": r.history}


if __name__ == "__main__":
    main()
