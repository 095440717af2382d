"""Cross-rasterizer fidelity study: our analytic AA against FreeType +
HarfBuzz.

The port of tools/fidelity_study.py (host only: no device work). The
reference's ground truth is Cairo behind node-canvas; this study compares
the port's rasterizer and shaper with an independent renderer, Pillow's
FreeType with the Raqm layout engine (HarfBuzz shaping and kerning,
FreeType hinting), at the dataset's geometry (240 x 80 sheet, 12 px font,
baseline at (line + 1) * 14.4, pen from x = 0, our word wrap). For each
string set: the per-pixel MSE / PSNR, and the MSE / PSNR after a 3 x 3 box
blur of both sides (hinting moves stems by up to a pixel; the blur measures
the structure beneath that). It needs Pillow; without it it raises an
ImportError naming it.

    python -m ai_font_renderer_tpu_torch.tools.fidelity_study [--device cpu]

The JAX tool's lines, then one JSON line of every study's numbers.
"""

from __future__ import annotations

import json
import sys

import numpy as np

from ..config import FIRACODE_PATH, MONTSERRAT_PATH, SheetSpec
from ..fontgen import bake_atlas
from ..fontgen.dataset import synthesize_ground_truth
from ..fontgen.layout import wrap_text
from ..fontgen.shaped import ShapedRenderer
from ..fontgen.textgen import generate_corpus
from . import _common


def _pillow():
    try:
        from PIL import Image, ImageDraw, ImageFont
    except ImportError as e:
        raise ImportError(f"fidelity_study renders its reference with Pillow (PIL), which is not installed ({e})") from e
    return Image, ImageDraw, ImageFont


def pil_render(font_path, text, spec):
    """FreeType + Raqm render with the dataset geometry and our wrap."""
    Image, ImageDraw, ImageFont = _pillow()
    ft = ImageFont.truetype(font_path, int(spec.font_size), layout_engine=ImageFont.Layout.RAQM)
    r = ShapedRenderer(font_path, spec)  # for the advance table / wrap only
    text = text[: spec.max_chars]
    lines = wrap_text(text, r._advances_for(text), spec.width - 2 * spec.padding)
    im = Image.new("L", (spec.width, spec.height), 255)
    d = ImageDraw.Draw(im)
    for i, line in enumerate(lines):
        d.text((spec.padding, (i + 1) * spec.line_height), line, font=ft, fill=0, anchor="ls")
    return np.asarray(im, np.float32) / 255.0


def blur3(x):
    k = np.ones(3) / 3.0
    x = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, x)
    return np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, x)


def metrics(a, b):
    mse = float(np.mean((a - b) ** 2))
    bm = float(np.mean((blur3(a) - blur3(b)) ** 2))
    return mse, -10 * np.log10(max(mse, 1e-12)), bm, -10 * np.log10(max(bm, 1e-12))


def study(results: dict, name, ours_list, pil_list):
    """Print one study's line, as the JAX tool does, and keep its numbers
    in ``results`` -> its mean MSE."""
    per = [metrics(o, p) for o, p in zip(ours_list, pil_list)]
    mse = np.array([m[0] for m in per])
    bmse = np.array([m[2] for m in per])
    print(
        f"{name:44s} n={len(per):3d}  MSE {mse.mean():.5f} "
        f"(max {mse.max():.5f}, PSNR {-10*np.log10(mse.mean()):.1f} dB)  "
        f"blur3 MSE {bmse.mean():.5f} (PSNR {-10*np.log10(bmse.mean()):.1f} dB)"
    )
    results[name] = {"n": len(per), "mse": float(mse.mean()), "mse_max": float(mse.max()),
                     "psnr_db": float(-10 * np.log10(mse.mean())), "blur3_mse": float(bmse.mean()),
                     "blur3_psnr_db": float(-10 * np.log10(bmse.mean()))}
    return mse.mean()


def main(argv: list[str] | None = None, corpus_size: int = 100) -> dict:
    """``corpus_size``: the corpus samples of the second FiraCode set."""
    from ..cli import TEST_STRINGS

    _common.start(sys.argv[1:] if argv is None else argv)
    _pillow()
    spec = SheetSpec()
    corpus = generate_corpus(corpus_size)
    results: dict = {}

    # FiraCode: the flagship training ground truth.
    atlas = bake_atlas(FIRACODE_PATH, spec)
    shaped = ShapedRenderer(FIRACODE_PATH, spec)
    hinted = ShapedRenderer(FIRACODE_PATH, spec, hinted=True)
    for label, strings in [
        ("FiraCode 15 adversarial test strings", list(TEST_STRINGS)),
        (f"FiraCode {corpus_size} corpus samples", corpus),
    ]:
        ours_atlas = np.asarray(synthesize_ground_truth(atlas, strings))
        pil = [pil_render(FIRACODE_PATH, s, spec) for s in strings]
        study(results, f"{label} [atlas truth vs FT+HB]", list(ours_atlas), pil)
        m_u = study(results, f"{label} [shaped vs FT+HB]", list(shaped.render_batch(strings)), pil)
        m_h = study(results, f"{label} [shaped+HINTED vs FT+HB]", list(hinted.render_batch(strings)), pil)
        print(f"  -> hinting emulation reduces the FreeType delta by {100*(1-m_h/m_u):.0f}%")

    # FiraCode ligatures: shaping must move us toward HarfBuzz.
    liga_strings = ["a->b != c", "x => y === z", "www <=> :: !="]
    pil = [pil_render(FIRACODE_PATH, s, spec) for s in liga_strings]
    sh_on = ShapedRenderer(FIRACODE_PATH, spec).render_batch(liga_strings)
    sh_off = ShapedRenderer(FIRACODE_PATH, spec, shape=False).render_batch(liga_strings)
    m_on = study(results, "FiraCode ligature strings [shaped]", list(sh_on), pil)
    m_off = study(results, "FiraCode ligature strings [shaping OFF]", list(sh_off), pil)
    print(f"  -> shaping reduces HarfBuzz delta by {100*(1-m_on/m_off):.0f}%")

    # Montserrat: kerning must move us toward HarfBuzz.
    kern_strings = ["AVATAR WAY TO VALUE", "Yo Two Ave LTA", "office fly fin"]
    pil = [pil_render(MONTSERRAT_PATH, s, spec) for s in kern_strings]
    k_on = ShapedRenderer(MONTSERRAT_PATH, spec).render_batch(kern_strings)
    k_off = ShapedRenderer(MONTSERRAT_PATH, spec, kern=False, shape=False).render_batch(kern_strings)
    m_on = study(results, "Montserrat kerned strings [shape+kern]", list(k_on), pil)
    m_off = study(results, "Montserrat kerned strings [both OFF]", list(k_off), pil)
    print(f"  -> shaping+kerning reduces HarfBuzz delta by {100*(1-m_on/m_off):.0f}%")
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
