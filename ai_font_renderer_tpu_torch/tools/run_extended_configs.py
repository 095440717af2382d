"""Train and evaluate the extended configs (BASELINE.json 2-5).

The port of tools/run_extended_configs.py. Each section prints one JSON
line with the JAX tool's keys and writes its files under ``<out_root>/``:

  * ``torch_montserrat/``  the flagship model trained on the Montserrat
                           corpus (150k samples, 25 epochs), the test
                           strings' renders (config 2);
  * ``torch_siren/``       the implicit coverage MLP at 64 x 64 over
                           printable ASCII (3000 steps), an atlas sample
                           (config 3);
  * ``torch_multifont/``   the font-conditioned model on both TTFs (4000
                           steps), a side-by-side sample (config 4);
  * ``torch_sdf_unicode/`` the SDF head over FiraCode's printable Unicode
                           (2000 steps), the atlas render's glyphs/s, a
                           zero-level-set preview (config 5).

    python -m ai_font_renderer_tpu_torch.tools.run_extended_configs [--sections siren,multifont,sdf_unicode,montserrat] [--kernels K] [--device cpu]

``--kernels`` applies to the Montserrat section (the implicit models have
no kernel).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from ..config import FIRACODE_PATH, MONTSERRAT_PATH, PRINTABLE_ASCII, ModelConfig, TrainConfig, replace
from ..fontgen.bmp import write_bmp
from . import _common


def section_montserrat(dev, out_root, kernels="none", epochs=25, samples=150000, widths=None) -> dict:
    from ..cli import TEST_STRINGS
    from ..render import render_strings
    from ..train import train
    from ..utils.checkpoint import save_params

    t0 = time.time()
    mcfg = replace(ModelConfig(), **(widths or {}))
    ds = _common.sheet_dataset(MONTSERRAT_PATH, mcfg, samples, dev)
    tcfg = TrainConfig(num_epochs=epochs, eval_every=10**9, checkpoint_every=0)
    mcfg, tcfg = _common.with_kernels(kernels, mcfg, tcfg)
    r = train(ds, mcfg, tcfg, log=lambda *_: None)
    d = os.path.join(out_root, "torch_montserrat")
    render_strings(r.params, TEST_STRINGS, d, mcfg)
    save_params(r.params, f"{d}/font_renderer_montserrat.npz", mcfg)
    return {"config": "montserrat-flagship", "epochs": epochs, "best_val_loss": round(r.best_val_loss, 6),
            "wall_s": round(time.time() - t0, 1)}


def section_siren(dev, out_root, steps=3000, siren_widths=None) -> dict:
    from ..models import siren
    from ..train.implicit import train_siren

    t0 = time.time()
    cfg = siren.SirenConfig(**{**dict(n_chars=95, cell=64, hidden_dim=128, n_layers=4), **(siren_widths or {})})
    params, losses, targets = train_siren(FIRACODE_PATH, cfg, PRINTABLE_ASCII, steps=steps, lr=5e-4, device=dev)
    atlas = siren.render_atlas(params, cfg).cpu().numpy()
    mse = float(np.mean((atlas - targets) ** 2))
    d = os.path.join(out_root, "torch_siren")
    os.makedirs(d, exist_ok=True)
    # A-Z tiled 4 rows x 8 columns.
    c = cfg.cell
    tile = np.ones((4 * c, 8 * c), np.float32)
    for k, i in enumerate(ord(ch) - 32 for ch in "ABCDEFGHIJKLMNOPQRSTUVWXYZ"):
        r, col = divmod(k, 8)
        tile[r * c : (r + 1) * c, col * c : (col + 1) * c] = 1.0 - atlas[i]
    write_bmp(f"{d}/atlas_sample.bmp", tile)
    return {"config": "siren-implicit-64", "steps": steps, "final_train_mse": round(float(losses[-1]), 6),
            "atlas_mse": round(mse, 6), "wall_s": round(time.time() - t0, 1)}


def section_multifont(dev, out_root, steps=4000, siren_widths=None) -> dict:
    from ..models import multifont as mf
    from ..train.implicit import train_multifont

    t0 = time.time()
    cfg = mf.MultiFontConfig(**{**dict(n_fonts=2, n_chars=95, cell=64, hidden_dim=128, n_layers=4),
                                **(siren_widths or {})})
    params, losses, targets = train_multifont([FIRACODE_PATH, MONTSERRAT_PATH], cfg, PRINTABLE_ASCII, steps=steps,
                                              lr=5e-4, device=dev)
    atlas = mf.render_atlas(params, cfg).cpu().numpy()
    mse = float(np.mean((atlas.reshape(targets.shape) - targets) ** 2))
    d = os.path.join(out_root, "torch_multifont")
    os.makedirs(d, exist_ok=True)
    # 'ABCDEF' in both fonts, side by side.
    c = cfg.cell
    tile = np.ones((2 * c, 6 * c), np.float32)
    for f in range(2):
        for k, i in enumerate(ord(ch) - 32 for ch in "ABCDEF"):
            tile[f * c : (f + 1) * c, k * c : (k + 1) * c] = 1.0 - atlas[f, i]
    write_bmp(f"{d}/two_fonts_sample.bmp", tile)
    return {"config": "multifont-2ttf", "steps": steps, "atlas_mse": round(mse, 6),
            "wall_s": round(time.time() - t0, 1)}


def section_sdf_unicode(dev, out_root, steps=2000, siren_widths=None, limit=None, iters=10) -> dict:
    from ..fontgen.glyphs import unicode_charset
    from ..models import siren
    from ..train.implicit import train_siren

    t0 = time.time()
    charset = unicode_charset(FIRACODE_PATH, limit=limit)
    n = len(charset)
    cfg = siren.SirenConfig(**{**dict(n_chars=n, cell=64, hidden_dim=128, n_layers=4, mode="sdf"),
                               **(siren_widths or {})})
    params, losses, _ = train_siren(FIRACODE_PATH, cfg, charset, steps=steps, lr=5e-4, glyph_batch=256, device=dev)
    train_s = time.time() - t0
    dt = _common.best_s(lambda: siren.render_atlas_chunked(params, cfg), iters, 1, dev) / iters
    atlas = siren.render_atlas_chunked(params, cfg).cpu().numpy()
    d = os.path.join(out_root, "torch_sdf_unicode")
    os.makedirs(d, exist_ok=True)
    # The zero level set of a few glyphs (coverage ~ sdf < 0).
    tile = np.concatenate([(atlas[ord(ch) - 32] < 0).astype(np.float32) for ch in "AQ@"], axis=1)
    write_bmp(f"{d}/sdf_levelset_sample.bmp", 1.0 - tile)
    return {"config": "sdf-unicode-atlas", "charset_size": n, "steps": steps,
            "final_sdf_mse": round(float(losses[-1]), 6), "atlas_glyphs_per_sec": round(n / dt, 1),
            "train_wall_s": round(train_s, 1)}


SECTIONS = {
    "siren": section_siren,
    "multifont": section_multifont,
    "sdf_unicode": section_sdf_unicode,
    "montserrat": section_montserrat,
}


def main(argv: list[str] | None = None, out_root: str = "extended_runs", **cuts) -> list[dict]:
    """``cuts``: ``<section>=dict(...)`` keyword arguments of a section
    (steps, epochs, samples; widths for CPU tests)."""
    rest, dev, kernels = _common.start(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(prog="python -m ai_font_renderer_tpu_torch.tools.run_extended_configs")
    ap.add_argument("--sections", default="siren,multifont,sdf_unicode,montserrat",
                    help="comma-separated subset to run")
    args = ap.parse_args(rest)
    os.makedirs(out_root, exist_ok=True)
    out = []
    for name in (n.strip() for n in args.sections.split(",")):
        kw = dict(cuts.get(name, {}))
        if name == "montserrat":
            kw["kernels"] = kernels
        rec = SECTIONS[name](dev, out_root, **kw)
        print(json.dumps(rec), flush=True)
        out.append(rec)
    print("# extended configs complete", flush=True)
    return out


if __name__ == "__main__":
    main()
