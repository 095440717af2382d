"""Val-position metrics of each placement decode mode.

The port of tools/eval_decode_modes.py. It replays a placement run's own
val protocol (the LCG corpus of ``--samples`` strings, numpy's seed-42
permutation, the first ``--val`` of its 20% val split, the layout engine's
targets from ``models/placement.py:placement_targets``) and reports, for
the soft, hard and monotone decodes of each checkpoint: the position RMSE,
worst and 99th-percentile error (px) over the visible slots, the share of
errors above half a line, and with a line head the decoded line's accuracy.
The font is inferred from the directory's name (montserrat, else
firacode). ``--kernels attention`` or ``attention_v2`` runs the net's
attention through the attention kernels.

    python -m ai_font_renderer_tpu_torch.tools.eval_decode_modes RUN_DIR [RUN_DIR ...] [--samples 100000] [--val 4096] [--kernels K] [--device cpu]

One JSON line a checkpoint and mode.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ..config import PRINTABLE_ASCII, SheetSpec
from ..fontgen.layout import encode_codes
from ..fontgen.textgen import generate_corpus
from ..models import placement
from ..train.placement_cli import build_table
from ..utils.checkpoint import load_params_with_config
from . import _common
from .ab_hard_decode import CHECKPOINTS, MODES, font_of


def val_split(font_path: str, kerned: bool, samples: int, val: int, spec: SheetSpec):
    """(codes [V, S] int32, midpoints [V, S, 2], visible [V, S], line
    indices [V, S]) of the run's val protocol, on the host."""
    table = build_table(font_path, spec, PRINTABLE_ASCII, kerned=kerned)
    strings = generate_corpus(samples)
    mids, vis, line_t, _ = placement.placement_targets(strings, table, spec, full=True)
    vi = np.random.default_rng(42).permutation(samples)[: samples // 5][:val]
    return encode_codes(strings, spec.max_chars)[vi], mids[vi], vis[vi], line_t[vi]


def records(pp, pcfg, codes: torch.Tensor, mids, vis, line_t, lh: float) -> list[dict]:
    """The metrics of each decode mode of one net."""
    L = placement.head_lines(pp)
    tgt = np.clip(line_t, 0, max(L - 1, 0))
    out = []
    for mode, kw in MODES:
        with torch.inference_mode():
            xy, _ = placement.apply(pp, codes, pcfg, **kw)
        xy = xy.cpu().numpy()
        err = np.sqrt(np.sum((xy - mids) ** 2, -1))[vis]
        rec = {
            "mode": mode,
            "val_rmse_px": float(np.sqrt(np.mean(err**2))),
            "val_worst_px": float(err.max()),
            "val_p99_px": float(np.percentile(err, 99)),
            "frac_err_gt_half_line": float(np.mean(err > 0.5 * lh)),
        }
        if L:
            # The DECODED line (y / line_height - 1) on visible slots: for
            # mono this scores the monotone path, not the raw argmax.
            dec = np.clip(np.round(xy[..., 1] / lh).astype(np.int32) - 1, 0, L - 1)
            rec["val_line_acc"] = float(np.mean((dec == tgt)[vis]))
        out.append(rec)
    return out


def main(argv: list[str] | None = None) -> list[dict]:
    rest, dev, kernels = _common.start(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(prog="python -m ai_font_renderer_tpu_torch.tools.eval_decode_modes")
    ap.add_argument("run_dirs", nargs="+")
    ap.add_argument("--samples", type=int, default=100000)
    ap.add_argument("--val", type=int, default=4096)
    args = ap.parse_args(rest)
    spec = SheetSpec()
    cache: dict[str, tuple] = {}
    out = []
    for run_dir in args.run_dirs:
        font, font_path = font_of(run_dir)
        if font not in cache:
            codes, mids, vis, line_t = val_split(font_path, font == "montserrat", args.samples, args.val, spec)
            cache[font] = (torch.from_numpy(codes).to(dev), mids, vis, line_t)
        codes, mids, vis, line_t = cache[font]
        for name in CHECKPOINTS:
            path = os.path.join(run_dir, name)
            if not os.path.exists(path):
                continue
            pp, pcfg = load_params_with_config(path, device=dev)
            pcfg, _ = _common.with_kernels(kernels, pcfg, None)
            for rec in records(pp, pcfg, codes, mids, vis, line_t, spec.line_height):
                rec = {"run": run_dir, "checkpoint": name, **rec}
                print(json.dumps(rec), flush=True)
                out.append(rec)
    return out


if __name__ == "__main__":
    main()
