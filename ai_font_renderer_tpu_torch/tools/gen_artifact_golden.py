"""The golden per-string MSE tables of the committed artifacts.

The port of tools/gen_artifact_golden.py: for each committed pair
(``artifacts/<font>/placement_finetuned.npz`` + ``siren_finetuned.npz``)
the per-string end-to-end MSE of the 15 test strings (soft decode, against
the bitmap ground truth), their mean, and ``backend: cpu``, written as
``<out_root>/<font>/golden_mse.json`` (default: beside the pair). The
tables are defined on CPU numerics, so the tool runs on the CPU only and
refuses the card, as the JAX tool refuses any backend but the CPU. Rerun it
only when the artifacts themselves are re-promoted.

    python -m ai_font_renderer_tpu_torch.tools.gen_artifact_golden --device cpu
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from ..cli import TEST_STRINGS
from ..config import FIRACODE_PATH, MONTSERRAT_PATH
from ..fontgen.dataset import bake_font_atlas, unit_ground_truth
from ..render.implicit_sheet import render_learned_sheets
from ..utils.checkpoint import load_params_with_config, load_siren
from . import _common

ARTIFACTS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "artifacts")
FONTS = (("firacode", FIRACODE_PATH), ("montserrat", MONTSERRAT_PATH))


def golden(pdir: str, font_key: str, font_path: str, device="cpu") -> dict:
    """The golden record of the pair in ``pdir``."""
    pp, pcfg = load_params_with_config(os.path.join(pdir, "placement_finetuned.npz"), device=device)
    sp, scfg, charset = load_siren(os.path.join(pdir, "siren_finetuned.npz"), device=device)
    sheets = render_learned_sheets(sp, pp, TEST_STRINGS, font_path, scfg, pcfg, charset=charset).cpu().numpy()
    gt = unit_ground_truth(bake_font_atlas(font_path, proportional=font_key == "montserrat"), TEST_STRINGS)
    return {
        "per_string_mse": [round(float(np.mean((sheets[i] - gt[i]) ** 2)), 8) for i in range(len(TEST_STRINGS))],
        "mean_mse": round(float(np.mean((sheets - gt) ** 2)), 8),
        "n_strings": len(TEST_STRINGS),
        "backend": "cpu",
    }


def main(argv: list[str] | None = None, art_root: str = ARTIFACTS, out_root: str | None = None) -> dict:
    """``art_root``: where the pairs are read; ``out_root``: where the
    tables are written (default ``art_root``)."""
    _, dev, _ = _common.start(sys.argv[1:] if argv is None else argv)
    if dev.type != "cpu":
        raise RuntimeError("golden tables are defined on CPU numerics; run with --device cpu")
    out = {}
    for font_key, font_path in FONTS:
        rec = golden(os.path.join(art_root, font_key), font_key, font_path)
        d = os.path.join(out_root or art_root, font_key)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, "golden_mse.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"{path}: mean {rec['mean_mse']}", flush=True)
        out[font_key] = rec
    return out


if __name__ == "__main__":
    main()
