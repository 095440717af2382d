"""The fully neural render path's throughput and quality: exact against
baked and phased compose, on the committed artifacts.

The port of tools/bench_neural_render.py, on artifacts/<font>/ (the SIREN
bank and the placement net the JAX package trained):

  * exact compose (per-window SIREN evaluation), in f32 and with the bf16
    trunk (SirenConfig.compute);
  * compose_baked at supersample 2, 4 and 8 (the bank baked once, a
    bilinear 4-tap gather per window pixel), each bake's seconds and MB;
  * the phase-binned bake at 8 and 16 phases, its block fetch by index,
    by a one-hot product and with the matmul composite;
  * the whole learned pipeline (placement net + exact compose).

Each variant's throughput comes from chained calls (the origins perturbed by
the previous output; the window ends in a device sync), best of 3 windows,
on a batch of strings placed by the layout engine; its quality is the MSE
of the 15 test strings against the bitmap ground truth, the artifact lock's
metric, so a fast variant that is wrong shows.

    python -m ai_font_renderer_tpu_torch.tools.bench_neural_render [--font firacode|montserrat] [--iters 20] [--batch 256] [--device cpu]

One JSON line a variant and a bake, then a summary line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from ..cli import TEST_STRINGS
from ..config import FIRACODE_PATH, MONTSERRAT_PATH
from ..fontgen.dataset import bake_font_atlas, unit_ground_truth
from ..fontgen.layout import encode_codes
from ..fontgen.ttf import TrueTypeFont
from ..models import placement
from ..render.implicit_sheet import (
    bake_bank,
    bake_bank_phased,
    build_layout,
    compose,
    compose_baked,
    compose_phased,
    font_kerning,
    known_slots,
    origins_from_midpoints,
    place_glyphs,
)
from ..utils.checkpoint import load_params_with_config, load_siren
from . import _common


def emit(rec):
    print(json.dumps(rec), flush=True)


def main(argv: list[str] | None = None, artifacts: str = "artifacts", phases=(8, 16), supersamples=(2, 4, 8)) -> dict:
    rest, dev, _ = _common.start(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser()
    ap.add_argument("--font", default="firacode", choices=["firacode", "montserrat"])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--batch", type=int, default=256)
    args = ap.parse_args(rest)

    font_path = FIRACODE_PATH if args.font == "firacode" else MONTSERRAT_PATH
    art = os.path.join(artifacts, args.font)
    sp, scfg, charset = load_siren(os.path.join(art, "siren_finetuned.npz"), device=dev)
    pparams, pcfg = load_params_with_config(os.path.join(art, "placement_finetuned.npz"), device=dev)

    font = TrueTypeFont.load(font_path)
    lay = build_layout(font, cell=scfg.cell, max_glyphs=pcfg.max_length)
    kern = font_kerning(font_path, charset) if args.font == "montserrat" else None

    # Throughput: a batch of strings of realistic lengths at the engine's
    # placements (throughput does not depend on where the glyphs sit).
    batch = [("HELLO WORLD " * 9)[: 10 + (i * 7) % 90] for i in range(args.batch)]
    to_dev = lambda *a: [torch.from_numpy(x).to(dev) for x in a]  # noqa: E731
    ids, origins, valid = to_dev(*place_glyphs(batch, font, lay, charset=charset, kerning=kern))
    n_glyphs = int(valid.sum())

    # Quality: the 15 test strings against the bitmap ground truth.
    gt = unit_ground_truth(bake_font_atlas(font_path, proportional=args.font == "montserrat"), TEST_STRINGS)
    t_ids, t_org, t_val = to_dev(*place_glyphs(TEST_STRINGS, font, lay, charset=charset, kerning=kern))

    results = {}

    def timed_chain(step) -> float:
        """Best seconds of ``iters`` chained calls of ``step(carry) -> carry``."""
        box = [torch.zeros((), device=dev)]

        def run():
            box[0] = step(box[0])

        return _common.best_s(run, args.iters, 3, dev)

    @torch.no_grad()
    def run_variant(name, compose_fn, quality_fn):
        best = timed_chain(lambda c: compose_fn(origins + c * 1e-6)[:, 0, 0].mean())
        gps = n_glyphs * args.iters / best
        mse = float(np.mean((quality_fn().cpu().numpy() - gt) ** 2))
        results[name] = (gps, mse)
        emit({"variant": name, "glyphs_per_sec": gps, "ms_per_batch": best / args.iters * 1e3,
              "test_strings_mse": mse, "font": args.font})

    # 1. Exact per-window SIREN evaluation (the committed artifacts' path).
    run_variant("exact_f32", lambda o: compose(sp, ids, o, valid, scfg, lay),
                lambda: compose(sp, t_ids, t_org, t_val, scfg, lay))

    # 2. The bf16 trunk.
    scfg_bf16 = dataclasses.replace(scfg, compute="bfloat16")
    run_variant("exact_bf16", lambda o: compose(sp, ids, o, valid, scfg_bf16, lay),
                lambda: compose(sp, t_ids, t_org, t_val, scfg_bf16, lay))

    # 3. The bank baked once, bilinear sampling.
    for ss in supersamples:
        t0 = time.perf_counter()
        with torch.no_grad():
            baked = bake_bank(sp, scfg, supersample=ss)
        _common.sync(dev)
        emit({"bake": f"ss{ss}", "bake_seconds": time.perf_counter() - t0, "baked_mb": baked.numel() * 4 / 1e6})
        run_variant(f"baked_ss{ss}", lambda o, b=baked, s=ss: compose_baked(b, ids, o, valid, scfg, lay, s),
                    lambda b=baked, s=ss: compose_baked(b, t_ids, t_org, t_val, scfg, lay, s))
        del baked

    # 3b. The phase-binned bake: a whole block a glyph by index, by a
    # one-hot product, or placed by the matmul composite.
    for P in phases:
        t0 = time.perf_counter()
        with torch.no_grad():
            pbaked = bake_bank_phased(sp, scfg, lay, phases=P)
        _common.sync(dev)
        emit({"bake": f"phased_p{P}", "bake_seconds": time.perf_counter() - t0, "baked_mb": pbaked.numel() * 4 / 1e6})
        for suffix, kw in (("", {}), ("_onehot", {"onehot": True}), ("_matmul", {"composite": "matmul"})):
            run_variant(f"phased_p{P}{suffix}",
                        lambda o, b=pbaked, p=P, kw=kw: compose_phased(b, ids, o, valid, scfg, lay, p, **kw),
                        lambda b=pbaked, p=P, kw=kw: compose_phased(b, t_ids, t_org, t_val, scfg, lay, p, **kw))
        del pbaked

    # 4. The whole learned pipeline: placement net + exact compose.
    codes = torch.from_numpy(encode_codes(batch, pcfg.max_length)).to(dev)
    k_ids, known = to_dev(*known_slots(batch, charset, pcfg.max_length))

    @torch.no_grad()
    def learned(c):
        mids, logits = placement.apply(pparams, codes, pcfg)
        org = origins_from_midpoints(mids, lay)
        val = known & (torch.sigmoid(logits) > 0.5)
        return compose(sp, k_ids, org + c * 1e-6, val, scfg, lay)[:, 0, 0].mean()

    best = timed_chain(learned)
    emit({"variant": "learned_pipeline_exact", "glyphs_per_sec": n_glyphs * args.iters / best,
          "ms_per_batch": best / args.iters * 1e3, "font": args.font})

    ex_gps, ex_mse = results["exact_f32"]
    summary = {"summary": "neural_render", "exact_glyphs_per_sec": ex_gps, "exact_mse": ex_mse,
               "best_variant": max(results, key=lambda k: results[k][0]), "font": args.font}
    for name, (gps, mse) in results.items():
        summary[f"{name}_speedup"] = gps / ex_gps
        summary[f"{name}_mse_delta"] = mse - ex_mse
    emit(summary)
    return summary


if __name__ == "__main__":
    main()
