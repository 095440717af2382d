"""The implicit hybrid demo: train the SIREN bank, compose sheets.

The port of tools/render_implicit_demo.py: trains the implicit glyph bank
(cell 64, printable ASCII), renders the 15 test strings as composed sheets
at 1x (80 x 240, beside the bitmap pipeline) and at 4x (320 x 960), the MSE
of the 1x sheets against the bitmap pipeline's ground truth, and the
composition's glyphs/s at 1x on 256 strings (each call's first pixel
perturbs the next call's origins; 20 calls a window, best of 3). The BMPs
go to ``<out_root>/torch_implicit_sheets/``.

    python -m ai_font_renderer_tpu_torch.tools.render_implicit_demo [steps] [--device cpu]

One JSON line with the JAX tool's keys.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from ..cli import TEST_STRINGS
from ..config import FIRACODE_PATH, PRINTABLE_ASCII
from ..fontgen import bake_atlas
from ..fontgen.bmp import write_bmp
from ..fontgen.dataset import unit_ground_truth
from ..fontgen.ttf import TrueTypeFont
from ..models import siren
from ..render.implicit_sheet import build_layout, compose, place_glyphs, render_implicit_sheets
from ..train.implicit import train_siren
from . import _common


def compose_glyphs_per_sec(params, cfg: siren.SirenConfig, device, batch: int = 256, iters: int = 20,
                           rounds: int = 3) -> float:
    """Glyphs/s of ``compose`` at 1x on ``batch`` strings, chained."""
    font = TrueTypeFont.load(FIRACODE_PATH)
    lay = build_layout(font, cell=cfg.cell)
    strings = [("HELLO WORLD " * 9)[: 10 + (i * 7) % 90] for i in range(batch)]
    ids, origins, valid = (torch.from_numpy(a).to(device) for a in place_glyphs(strings, font, lay))
    n_glyphs = int(valid.sum())
    carry = [torch.zeros((), device=device)]

    @torch.inference_mode()
    def chain():
        out = compose(params, ids, origins + carry[0] * 1e-6, valid, cfg, lay)
        carry[0] = out[:, 0, 0].mean()

    return n_glyphs * iters / _common.best_s(chain, iters, rounds, device)


def main(argv: list[str] | None = None, out_root: str = "extended_runs", cfg: siren.SirenConfig | None = None,
         batch: int = 256, iters: int = 20, rounds: int = 3) -> dict:
    """``cfg``: the bank's SirenConfig (default: the flagship bank over
    printable ASCII)."""
    rest, dev, _ = _common.start(sys.argv[1:] if argv is None else argv)
    steps = int(rest[0]) if rest else 2000
    out = os.path.join(out_root, "torch_implicit_sheets")
    t0 = time.time()
    cfg = cfg or siren.SirenConfig(n_chars=len(PRINTABLE_ASCII))
    params, losses, _ = train_siren(FIRACODE_PATH, cfg, steps=steps, device=dev)
    glyph_mse = float(losses[-1])
    train_s = time.time() - t0

    os.makedirs(out, exist_ok=True)
    sheets1 = render_implicit_sheets(params, TEST_STRINGS, FIRACODE_PATH, cfg).cpu().numpy()
    gt = unit_ground_truth(bake_atlas(FIRACODE_PATH), TEST_STRINGS)
    fid_mse = float(np.mean((sheets1 - gt) ** 2))
    sheets4 = render_implicit_sheets(params, TEST_STRINGS, FIRACODE_PATH, cfg, scale=4.0).cpu().numpy()
    for i, (s1, s4) in enumerate(zip(sheets1, sheets4)):
        write_bmp(os.path.join(out, f"string_{i}.bmp"), s1)
        write_bmp(os.path.join(out, f"string_{i}_4x.bmp"), s4)
    gps = compose_glyphs_per_sec(params, cfg, dev, batch, iters, rounds)
    rec = {
        "config": "implicit-hybrid (SIREN bank + composed sheets)",
        "glyph_mse": round(glyph_mse, 8),
        "train_s": round(train_s, 1),
        "test_strings_mse_vs_truth": round(fid_mse, 8),
        "test_strings_psnr_db": round(10.0 * np.log10(1.0 / max(fid_mse, 1e-12)), 2),
        "compose_glyphs_per_sec": round(gps, 1),
        "scales_rendered": [1.0, 4.0],
        "wall_s": round(time.time() - t0, 1),
    }
    print(json.dumps(rec), flush=True)
    return {**rec, "out": out, "sheets_4x_shape": list(sheets4.shape)}


if __name__ == "__main__":
    main()
