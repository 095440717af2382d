"""Config 5: the SDF implicit model over FiraCode's printable Unicode,
rendered as one batched atlas.

The port of tools/bench_sdf_atlas.py: trains the SDF-head SIREN (hidden
128, 4 layers; 256 glyphs a step, lr 5e-4) on every printable codepoint the
font maps (``--limit`` caps the charset), then times the chunked atlas
render (``models/siren.py:render_atlas_chunked``), 10 chained renders a
window ending in a device sync, in glyphs/s. One JSON line with the JAX
tool's keys.

    python -m ai_font_renderer_tpu_torch.tools.bench_sdf_atlas [--steps 1500] [--cell 64] [--limit N] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from ..config import FIRACODE_PATH
from ..fontgen.glyphs import unicode_charset
from ..models import siren
from ..train.implicit import train_siren
from . import _common


def atlas_glyphs_per_sec(params, cfg: siren.SirenConfig, device, iters: int = 10, rounds: int = 1) -> float:
    """Glyphs/s of the chunked atlas render, ``iters`` renders a window."""
    return cfg.n_chars * iters / _common.best_s(lambda: siren.render_atlas_chunked(params, cfg), iters, rounds,
                                                device)


def main(argv: list[str] | None = None, iters: int = 10) -> dict:
    rest, dev, _ = _common.start(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(prog="python -m ai_font_renderer_tpu_torch.tools.bench_sdf_atlas")
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--cell", type=int, default=64)
    ap.add_argument("--limit", type=int, default=None, help="cap charset size")
    args = ap.parse_args(rest)

    charset = unicode_charset(FIRACODE_PATH, limit=args.limit)
    n = len(charset)
    print(f"# printable-unicode charset: {n} glyphs", flush=True)
    cfg = siren.SirenConfig(n_chars=n, cell=args.cell, hidden_dim=128, n_layers=4, mode="sdf")
    t0 = time.time()
    params, losses, _ = train_siren(FIRACODE_PATH, cfg, charset, steps=args.steps, lr=5e-4, glyph_batch=256,
                                    device=dev)
    train_s = time.time() - t0
    rec = {
        "metric": "sdf_unicode_atlas_glyphs_per_sec",
        "value": round(atlas_glyphs_per_sec(params, cfg, dev, iters), 1),
        "unit": "glyphs/sec",
        "charset_size": n,
        "cell": args.cell,
        "train_seconds": round(train_s, 1),
        "final_sdf_mse": round(float(losses[-1]), 6),
    }
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
