"""Promote a measured-best placement run to the committed artifacts.

The port of tools/refresh_artifacts.py: copies the run's
``placement_finetuned.npz`` + ``siren_finetuned.npz`` into
``artifacts/<font>/`` (or ``--dry-run DIR``), exports the fully neural
pipeline from the new pair (the CLI's ``export --placement --implicit``: a
``torch.export`` artifact, ``neural_render.pt2``, where the JAX tool writes
the StableHLO ``neural_render.hlo``), writes the paired truth/neural
evidence renders (the pangram and the first test string) under
``renders/``, and prints the promoted pair's end-to-end MSE over the 15
test strings, to check against the run's logged
``end_to_end_neural_render_mse`` before committing. It also loads the
artifact and renders the test strings through it: ``exported_u8_equal``
says whether they equal the direct render's uint8 sheets.

    python -m ai_font_renderer_tpu_torch.tools.refresh_artifacts FONT RUN_DIR [--dry-run DIR] [--device cpu]

FONT is firacode or montserrat. One JSON line. Update artifacts/MANIFEST.md
and the bounds of tests/test_artifacts.py when the measured best improves.
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import numpy as np
import torch

from . import _common

PANGRAM = "THE QUICK BROWN FOX JUMPS OVER THE LAZY DOG"


def main(argv: list[str] | None = None) -> int:
    rest, dev, _ = _common.start(sys.argv[1:] if argv is None else argv)
    dry = None
    if "--dry-run" in rest:
        i = rest.index("--dry-run")
        dry = rest[i + 1]
        del rest[i : i + 2]
    if len(rest) != 2:
        print(__doc__)
        return 1
    font_key, run_dir = rest

    from ..cli import TEST_STRINGS
    from ..cli import main as cli_main
    from ..config import FIRACODE_PATH, MONTSERRAT_PATH
    from ..fontgen.bmp import write_bmp
    from ..fontgen.dataset import bake_font_atlas, unit_ground_truth
    from ..render.implicit_sheet import render_learned_sheets
    from ..utils.checkpoint import load_params_with_config, load_siren
    from ..utils.export import load_exported, render_exported_u8
    from .gen_artifact_golden import ARTIFACTS

    font_path = {"firacode": FIRACODE_PATH, "montserrat": MONTSERRAT_PATH}[font_key]
    dst = dry or os.path.join(ARTIFACTS, font_key)
    os.makedirs(os.path.join(dst, "renders"), exist_ok=True)
    for name in ("placement_finetuned.npz", "siren_finetuned.npz"):
        src = os.path.join(run_dir, name)
        if os.path.abspath(src) != os.path.abspath(os.path.join(dst, name)):
            shutil.copyfile(src, os.path.join(dst, name))
        print(f"promoted {src} -> {dst}/{name}")
    pnpz = os.path.join(dst, "placement_finetuned.npz")
    snpz = os.path.join(dst, "siren_finetuned.npz")

    # The fully neural artifact from the promoted pair.
    artifact = os.path.join(dst, "neural_render.pt2")
    rc = cli_main(["export", "--placement", pnpz, "--implicit", snpz, "--font", font_path, "--out", artifact,
                   "--device", dev.type])
    if rc:
        print("export failed", file=sys.stderr)
        return rc

    # Evidence renders and the measured number.
    pp, pcfg = load_params_with_config(pnpz, device=dev)
    sp, scfg, charset = load_siren(snpz, device=dev)
    direct = render_learned_sheets(sp, pp, TEST_STRINGS, font_path, scfg, pcfg, charset=charset)
    sheets = direct.cpu().numpy()
    gt = unit_ground_truth(bake_font_atlas(font_path, proportional=font_key == "montserrat"), TEST_STRINGS)
    mse = float(np.mean((sheets - gt) ** 2))
    for tag, i in {"pangram": TEST_STRINGS.index(PANGRAM), "string0": 0}.items():
        write_bmp(os.path.join(dst, "renders", f"neural_{tag}.bmp"),
                  np.clip(sheets[i] * 255.0, 0, 255).astype(np.uint8))
        write_bmp(os.path.join(dst, "renders", f"truth_{tag}.bmp"), np.clip(gt[i] * 255.0, 0, 255).astype(np.uint8))

    got = render_exported_u8(load_exported(artifact, dev), TEST_STRINGS)
    want = torch.round(direct * 255.0).to(torch.uint8)
    print(json.dumps({"font": font_key, "e2e_mse_test_strings": round(mse, 6), "e2e_mse": mse, "dst": dst,
                      "artifact": artifact, "exported_u8_equal": bool(torch.equal(got, want))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
