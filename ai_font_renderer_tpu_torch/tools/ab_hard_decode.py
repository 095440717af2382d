"""A/B the hard (discrete) placement decodes against the soft one.

The port of tools/ab_hard_decode.py. For each placement run directory
(train-placement's layout: siren.npz or siren_finetuned.npz, placement.npz
and/or placement_finetuned.npz), renders the 15 test strings fully
neurally (render/implicit_sheet.py: ``render_learned_sheets``) with the
soft, the hard (``hard``: argmax structure) and the monotone decode
(``monotone``: the lines decoded jointly), and reports each one's
end-to-end render MSE against the bitmap pipeline's ground truth: "soft"
reproduces the run's ``end_to_end_neural_render_mse``. A joint fine-tune's
tuned bank is preferred where the run has one. The font is inferred from
the directory's name (montserrat, else firacode). ``--kernels attention``
or ``attention_v2`` runs the net's attention through the attention
kernels.

    python -m ai_font_renderer_tpu_torch.tools.ab_hard_decode RUN_DIR [RUN_DIR ...] [--kernels K] [--device cpu]

One JSON line a checkpoint.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from ..cli import TEST_STRINGS
from ..config import FIRACODE_PATH, MONTSERRAT_PATH, SheetSpec
from ..fontgen.dataset import bake_font_atlas, unit_ground_truth
from ..render.implicit_sheet import render_learned_sheets
from ..utils.checkpoint import load_params_with_config, load_siren
from . import _common

MODES = (("soft", {}), ("hard", {"hard": True}), ("mono", {"monotone": True}))
CHECKPOINTS = ("placement.npz", "placement_finetuned.npz")


def font_of(run_dir: str) -> tuple[str, str]:
    """(font key, TTF path) of a run directory, by its name."""
    return ("montserrat", MONTSERRAT_PATH) if "montserrat" in run_dir else ("firacode", FIRACODE_PATH)


def main(argv: list[str] | None = None, per_string: bool = False) -> list[dict]:
    """``per_string``: each record also holds every test string's MSE of
    each mode (``e2e_render_mse_<mode>_per_string``)."""
    run_dirs, dev, kernels = _common.start(sys.argv[1:] if argv is None else argv)
    if not run_dirs:
        print(__doc__)
        raise SystemExit(1)
    spec = SheetSpec()
    gt_cache: dict[str, np.ndarray] = {}
    out = []
    for run_dir in run_dirs:
        font, font_path = font_of(run_dir)
        if font not in gt_cache:
            gt_cache[font] = unit_ground_truth(bake_font_atlas(font_path, proportional=font == "montserrat"),
                                               TEST_STRINGS)
        gt = gt_cache[font]
        bank = os.path.join(run_dir, "siren_finetuned.npz")
        if not os.path.exists(bank):
            bank = os.path.join(run_dir, "siren.npz")
        sp, scfg, charset = load_siren(bank, device=dev)
        for name in CHECKPOINTS:
            path = os.path.join(run_dir, name)
            if not os.path.exists(path):
                continue
            pp, pcfg = load_params_with_config(path, device=dev)
            pcfg, _ = _common.with_kernels(kernels, pcfg, None)
            rec = {"run": run_dir, "checkpoint": name, "font": font}
            for mode, kw in MODES:
                sheets = render_learned_sheets(sp, pp, TEST_STRINGS, font_path, scfg, pcfg, spec, charset=charset,
                                               **kw).cpu().numpy()
                rec[f"e2e_render_mse_{mode}"] = float(np.mean((sheets - gt) ** 2))
                if per_string:
                    rec[f"e2e_render_mse_{mode}_per_string"] = np.mean((sheets - gt) ** 2, axis=(1, 2)).tolist()
            rec["hard_vs_soft_pct"] = 100.0 * (rec["e2e_render_mse_hard"] / rec["e2e_render_mse_soft"] - 1.0)
            print(json.dumps(rec), flush=True)
            out.append(rec)
    return out


if __name__ == "__main__":
    main()
