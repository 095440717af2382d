"""The high-capacity Montserrat variant.

The port of tools/run_montserrat_hc.py: the frontend widened to embed 64, 8
heads and fc1 160 (flat 16000, an out projection of 16000 x 19200: 307M
parameters), the bf16 frontend, bits dropout and the training-only leaky
clamp (0.01: the 16000-wide head saturates the (0, 1) clamp and freezes
without it), trained on the Montserrat corpus with the flagship recipe
(default 400 epochs at lr 5e-4; eval renders every 50 epochs, a checkpoint
every 200). The run's files go to ``<out_root>/torch_montserrat_hc/``.

    python -m ai_font_renderer_tpu_torch.tools.run_montserrat_hc [epochs] [lr] [--kernels K] [--device cpu]

One JSON summary line at the end, with the JAX tool's keys.
"""

from __future__ import annotations

import json
import os
import sys
import time

from ..config import MONTSERRAT_PATH, ModelConfig, TrainConfig, replace
from ..models.font_renderer import param_count
from . import _common

HC = dict(embedding_dim=64, num_heads=8, hidden_dim=160, bf16_frontend=True, bits_dropout=True, leaky_clamp=0.01)


def main(argv: list[str] | None = None, out_root: str = "extended_runs", samples: int = 150000,
         widths: dict | None = None) -> dict:
    """Cuts: ``samples`` (the corpus), ``widths`` (ModelConfig fields, for
    CPU tests)."""
    rest, dev, kernels = _common.start(sys.argv[1:] if argv is None else argv)
    epochs = int(rest[0]) if len(rest) > 0 else 400
    lr = float(rest[1]) if len(rest) > 1 else 5e-4
    out = os.path.join(out_root, "torch_montserrat_hc")
    t0 = time.time()
    mcfg = replace(ModelConfig(**HC), **(widths or {}))
    tcfg = TrainConfig(num_epochs=epochs, learning_rate=lr, eval_every=50, checkpoint_every=200)
    mcfg, tcfg = _common.with_kernels(kernels, mcfg, tcfg)
    r, _ = _common.train_recipe("montserrat-hc", MONTSERRAT_PATH, mcfg, tcfg, samples, dev, out,
                                "font_renderer_montserrat_hc.npz")
    rec = {
        "config": "montserrat-hc (embed 64, heads 8, fc1 160, 307M)",
        "params": param_count(r.params),
        "final_epoch": r.final_epoch,
        "best_val_loss": round(r.best_val_loss, 6),
        "early_stopped": r.early_stopped,
        "wall_s": round(time.time() - t0, 1),
    }
    print(json.dumps(rec), flush=True)
    return {**rec, "out": out, "history": r.history}


if __name__ == "__main__":
    main()
