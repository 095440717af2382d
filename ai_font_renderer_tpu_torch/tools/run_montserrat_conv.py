"""Montserrat with a conv decoder.

The port of tools/run_montserrat_conv.py: the flagship's frontend (embed
32, 4 heads, fc1 64) with the bf16 frontend, bits dropout and the leaky
clamp (0.01), and the position-equivariant conv decoder in place of the
6400 x 19200 head: ``conv`` (resize + conv) or ``conv_ps`` (pixel
shuffle); ``--wide`` doubles the channel plan (256, 256, 128, 64, 32).
Eval renders every 25 epochs, a checkpoint every 100; ``--resume``
continues from the run's latest checkpoint. The run's files go to
``<out_root>/torch_montserrat_<decoder>[_wide]/``.

    python -m ai_font_renderer_tpu_torch.tools.run_montserrat_conv [epochs] [lr] [decoder] [--resume] [--wide] [--kernels K] [--device cpu]

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

WIDE_CHANNELS = (256, 256, 128, 64, 32)


def main(argv: list[str] | None = None, out_root: str = "extended_runs", samples: int = 150000,
         widths: dict | None = None) -> dict:
    """Cuts: ``samples`` (the corpus), ``widths`` (ModelConfig fields, for
    CPU tests)."""
    rest, dev, kernels = _common.start(sys.argv[1:] if argv is None else argv)
    flags = {a for a in rest if a.startswith("--")}
    args = [a for a in rest if not a.startswith("--")]
    resume = "--resume" in flags
    wide = "--wide" in flags
    epochs = int(args[0]) if len(args) > 0 else 1000
    lr = float(args[1]) if len(args) > 1 else 1e-3
    decoder = args[2] if len(args) > 2 else "conv"
    out = os.path.join(out_root, f"torch_montserrat_{decoder}" + ("_wide" if wide else ""))
    t0 = time.time()
    mcfg = ModelConfig(decoder=decoder, bf16_frontend=True, bits_dropout=True, leaky_clamp=0.01,
                       decoder_channels=WIDE_CHANNELS if wide else ModelConfig.decoder_channels)
    mcfg = replace(mcfg, **(widths or {}))
    tcfg = TrainConfig(num_epochs=epochs, learning_rate=lr, eval_every=25, checkpoint_every=100)
    mcfg, tcfg = _common.with_kernels(kernels, mcfg, tcfg)
    r, _ = _common.train_recipe(f"montserrat-{decoder}", MONTSERRAT_PATH, mcfg, tcfg, samples, dev, out,
                                f"font_renderer_montserrat_{decoder}.npz", resume=resume)
    rec = {
        "config": f"montserrat-{decoder} (parity frontend + {decoder} decoder)",
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
