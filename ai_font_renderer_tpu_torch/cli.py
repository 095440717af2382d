"""Command line of the port: train, render, serve, export the dataset and
evaluate weights.

  * ``--train``      train a new model, save ``font_renderer.npz`` in the
                     working directory, render the test strings to BMPs
                     under ``train_output_<timestamp>/`` (``--output``);
                     ``--font`` picks the corpus' font, monospace
                     (FiraCode) or proportional (Montserrat);
                     ``--decoder`` the sheet decoder, linear (default),
                     conv or conv_ps (``--decoder-channels``);
  * no arguments     load saved weights if present, else train and save;
                     then render the test strings;
  * ``render``       render given strings (or the test strings) to BMPs,
                     from ``.npz`` or ``.pth`` weights (``--int8``: the
                     projection in int8); ``--truth`` draws the shaped
                     ground truth (GSUB + GPOS, ``--hinted`` grid-fitted)
                     with no model; ``--implicit BANK`` composes a SIREN
                     glyph bank at the layout engine's positions, or with
                     ``--placement NET`` at the learned placement net's
                     (the fully neural path), at any ``--scale``;
  * ``serve``        run the batched render server (``--int8`` as render);
  * ``export``       write the render function with its weights as one
                     ``torch.export`` artifact (``.pt2``): the flagship
                     (``--weights``, ``--int8``, ``--fast``) or the fully
                     neural pipeline (``--placement NET --implicit BANK``),
                     its kernels (``--kernels``) as operators in the graph;
                     ``render --exported`` and ``serve --exported`` run one
                     with no weights file;
  * ``fontgen``      write the dataset in the reference's file format:
                     ``data.txt``, ``1.bmp``..``N.bmp`` and
                     ``dataset_metadata.txt``;
  * ``eval``         val-split MSE/PSNR and the test strings' MSE of
                     saved weights, as one JSON line;
  * ``train-placement`` train the learned-placement pipeline: supervised
                     placement, the SIREN bank, the pixel or joint
                     fine-tune (train/placement_cli.py; ``--kernels
                     attention|attention_v2`` trains the net's attention
                     through the attention kernels);
  * unknown option   usage plus ``Available options: --train``, exit 1.

Everything runs on the card unless ``--device cpu`` is given. ``--kernels``
picks the training configuration: ``none`` (the JAX package's defaults, no
kernel), ``output`` (``use_pallas_output``: K1 forward, K2/K3 backward) or
``fused`` (``use_pallas_output`` + ``fused_dw_adamw``: K1, K2 and K4); the
last two are kernels of the linear decoder's projection and exit 1 with a
conv decoder. ``--mesh DATA,MODEL`` trains on a device mesh (parallel/):
the batch splits DATA ways, the output projection's columns MODEL ways;
with DATA x MODEL above 1 the CLI starts that many ranks of itself, one a
visible card (NCCL), or with ``--device cpu`` CPU ranks (gloo), and rank 0
writes what the one-device run writes. ``--mesh 1,1`` is the one-device run.
``AFR_DUMP_AFTER=<seconds>`` in the environment dumps every thread's stack
to stderr after that long and exits, as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys

from .config import FIRACODE_PATH, ModelConfig, SheetSpec, replace

# Curated eval strings: repeated wide/narrow chars, multi-space runs, the
# exact-length boundary, the alphabet both ways, all spaces.
TEST_STRINGS = [
    "HELLO LEANN I LOVE YOU SO MUCH I HOPE YOU HAVE A GREAT DAY",
    "TWO WORLDS ONE FAMILY TRUST YOUR HEART LET FATE DECIDE TO GUIDE THESE LIVES WE SEE",
    "A PARADISE UNTOUCHED BY MAN WITHIN THIS WORLD BLESSED WITH LOVE A SIMPLE LIFE THEY LIVE IN PEACE",
    "SOFTLY TREAD THE SAND BELOW YOUR FEET NOW TWO WORLDS ONE FAMILY TRUST YOUR HEART LET FATE",
    "BENEATH THE SHELTER OF THE TREES ONLY LOVE CAN ENTER HERE A SIMPLE LIFE THEY LIVE IN PEACE",
    "THE QUICK BROWN FOX JUMPS OVER THE LAZY DOG",
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ",
    "WWWWWWWWWWWWWWWWWWWW",  # width test (repeating wide character)
    "IIIIIIIIIIIIIIIIIIII",  # width test (repeating narrow character)
    "ALTERNATING CASE TEST   SPACES",  # spacing test
    "CLAUDE IS RENDERING FONTS",
    "ZYXWVUTSRQPONMLKJIHGFEDCBA",  # reverse alphabet
    "AEIOU BCDFGHJKLMNPQRSTVWXYZ",  # vowels and consonants grouped
    "EXACTLY TWENTY CHARS",  # boundary test
    "                    ",
]

_KERNELS = {
    "none": ({}, {}),
    "output": ({"use_pallas_output": True}, {}),
    "fused": ({"use_pallas_output": True}, {"fused_dw_adamw": True}),
}


def default_output_dir() -> str:
    return "train_output_" + datetime.datetime.now().strftime("%m_%d_%H_%M_%S")


def parse_tcp(value: str) -> tuple[str, int] | None:
    """'HOST:PORT' -> (host, port), or None if malformed. Accepts
    hostnames, IPv4, bracketed '[::1]:8080' and bare '::1:8080' IPv6."""
    host, _, port = value.rpartition(":")
    if not host or not port.isascii() or not port.isdigit():
        return None
    if not 0 <= int(port) <= 65535:
        return None
    if host.endswith(":") and host != "::":
        return None  # a bare IPv6 address with no port
    if host.startswith("[") and host.endswith("]"):
        host = host[1:-1]
    return host, int(port)


def _load(args):
    """(params, mcfg) from ``args.weights`` on ``args.device``, or None
    after printing why not."""
    from .device import resolve_device
    from .utils.checkpoint import load_params_with_config

    if not os.path.exists(args.weights):
        print(f"Error: weights file not found: {args.weights}")
        return None
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"Error: {e}")
        return None
    params, mcfg = load_params_with_config(args.weights, device=device)
    if getattr(args, "fast", False):
        mcfg = replace(mcfg, bf16_frontend=True)
    return params, mcfg


def _build_dataset(mcfg, tcfg, font, device, subset=None):
    """(atlas, device dataset) for ``font``: the monospace grid or the
    proportional pen walk, at ``mcfg``'s sheet geometry. ``subset`` keeps
    only those corpus indices (the proportional path synthesizes the whole
    corpus and slices it, as the JAX package does)."""
    import torch

    from .fontgen import DeviceDataset, bake_atlas, bake_prop_atlas, build_device_dataset, build_device_dataset_prop
    from .fontgen.dataset import font_is_monospace

    print("Creating sheet dataset...")
    spec = replace(SheetSpec(), width=mcfg.sheet_width, height=mcfg.sheet_height, max_chars=mcfg.max_length)
    if font_is_monospace(font):
        atlas = bake_atlas(font, spec)
        return atlas, build_device_dataset(atlas, tcfg.num_samples, device=device, subset=subset)
    atlas = bake_prop_atlas(font, spec)
    ds = build_device_dataset_prop(atlas, tcfg.num_samples, device=device)
    if subset is not None:
        sub = torch.from_numpy(subset).to(ds.codes.device, torch.long)
        ds = DeviceDataset(codes=ds.codes[sub], targets_u8=ds.targets_u8[sub])
    return atlas, ds


def _warn_bank_font_mismatch(bank_path: str, font_path: str) -> None:
    """Warn when a SIREN bank tagged with its font is composed with another
    font's metrics (``--font`` defaults to FiraCode; a Montserrat bank laid
    out with FiraCode's advances renders a near-blank sheet). Untagged
    banks, the committed artifacts among them, skip the check."""
    from .utils.checkpoint import siren_font

    tag = siren_font(bank_path)
    if tag is not None and tag != os.path.basename(font_path):
        print(
            f"WARNING: SIREN bank {bank_path} was trained against {tag} "
            f"but --font is {os.path.basename(font_path)}; the composed "
            "layout uses the wrong font's metrics and will render "
            "garbage. Pass the matching --font."
        )


def _render_implicit(args) -> int:
    """``render --implicit BANK [--placement NET]``: the bank composed at the
    layout engine's positions, or at the placement net's."""
    from .device import resolve_device
    from .fontgen.bmp import write_bmp
    from .render.implicit_sheet import render_implicit_sheets, render_learned_sheets
    from .utils.checkpoint import load_params_with_config, load_siren

    for path, what in ((args.implicit, "SIREN bank"), (args.placement, "placement weights")):
        if path and not os.path.exists(path):
            print(f"Error: {what} not found: {path}")
            return 1
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"Error: {e}")
        return 1
    _warn_bank_font_mismatch(args.implicit, args.font)
    sp, scfg, charset = load_siren(args.implicit, device=device)
    strings = args.strings or TEST_STRINGS
    if args.placement:
        pp, pcfg = load_params_with_config(args.placement, device=device)
        sheets = render_learned_sheets(
            sp, pp, strings, args.font, scfg, pcfg, scale=args.scale, charset=charset,
            hard=args.hard_placement, monotone=args.monotone_placement,
            baked=args.baked, phased=args.phased,
        )
    else:
        sheets = render_implicit_sheets(
            sp, strings, args.font, scfg, scale=args.scale, charset=charset,
            baked=args.baked, phased=args.phased,
        )
    os.makedirs(args.out, exist_ok=True)
    for i, sheet in enumerate(sheets.cpu().numpy()):
        write_bmp(os.path.join(args.out, f"string_{i}.bmp"), sheet)
    print(f"Saved {len(sheets)} implicit renders to {args.out}/")
    return 0


def cmd_render(args) -> int:
    from .render import render_strings

    if args.truth:
        # The rasterizer's ground truth with full shaping (GSUB ligatures,
        # GPOS kerning), independent of any model; --hinted grid-fits it.
        from .fontgen.bmp import write_bmp
        from .fontgen.shaped import ShapedRenderer

        sheets = ShapedRenderer(args.font, hinted=args.hinted).render_batch(args.strings or TEST_STRINGS)
        os.makedirs(args.out, exist_ok=True)
        for i, sheet in enumerate(sheets):
            write_bmp(os.path.join(args.out, f"string_{i}.bmp"), sheet)
        print(f"Saved {len(sheets)} shaped ground-truth strings to {args.out}/")
        return 0
    if args.implicit:
        return _render_implicit(args)
    if args.exported:
        return _render_exported(args)
    loaded = _load(args)
    if loaded is None:
        return 1
    params, mcfg = loaded
    if args.int8:
        from .ops.quantized import quantize_params

        try:
            params = quantize_params(params)
        except ValueError as e:
            print(f"Error: {e}")
            return 1
    render_strings(params, args.strings or TEST_STRINGS, args.out, mcfg)
    return 0


def _load_artifact(args):
    """The artifact ``args.exported`` on ``args.device``, or None after
    printing why not."""
    from .device import resolve_device
    from .utils.export import load_exported

    if not os.path.exists(args.exported):
        print(f"Error: exported artifact not found: {args.exported}")
        return None
    try:
        return load_exported(args.exported, resolve_device(args.device))
    except (RuntimeError, ValueError) as e:
        print(f"Error: {e}")
        return None


def _render_exported(args) -> int:
    """``render --exported A``: the strings through the artifact alone, no
    weights file."""
    from .fontgen.bmp import write_bmp
    from .utils.export import render_exported

    artifact = _load_artifact(args)
    if artifact is None:
        return 1
    sheets = render_exported(artifact, args.strings or TEST_STRINGS)
    os.makedirs(args.out, exist_ok=True)
    for i, sheet in enumerate(sheets):
        write_bmp(os.path.join(args.out, f"string_{i}.bmp"), sheet)
    print(f"Saved {len(sheets)} exported-artifact renders to {args.out}/")
    return 0


def _export_kernels(value: str) -> dict:
    """``--kernels`` of ``export``: "none", or a comma-separated subset of
    output (K1), attention (K5) and attention_v2 (K7) -> ModelConfig flags."""
    flags = {"output": "use_pallas_output", "attention": "fused_attention",
             "attention_v2": "fused_attention_v2"}
    names = [n.strip() for n in value.split(",") if n.strip() and n.strip() != "none"]
    unknown = [n for n in names if n not in flags]
    if unknown:
        raise ValueError(f"--kernels {value}: unknown {unknown}; take none or a comma-separated "
                         f"subset of {', '.join(flags)}")
    return {flags[n]: True for n in names}


def cmd_export(args) -> int:
    """Write a self-contained torch.export render artifact (utils/export.py)."""
    from .device import resolve_device
    from .utils.checkpoint import load_params_with_config, load_siren
    from .utils.export import check_platforms, export_neural_render, export_render

    try:
        kernels = _export_kernels(args.kernels)
        platforms = check_platforms(p.strip() for p in args.platforms.split(",") if p.strip())
    except ValueError as e:
        print(f"Error: {e}")
        return 1
    if args.placement:
        # The fully neural pipeline: placement net + SIREN bank +
        # composition, one artifact, the flagship's contract.
        if args.int8 or args.fast:
            print(
                "Warning: --int8/--fast apply only to the flagship export; "
                "ignored for --placement artifacts"
            )
        if not args.implicit:
            print("Error: --placement export requires --implicit SIREN_NPZ")
            return 1
        if "use_pallas_output" in kernels:
            print("Error: --kernels output: the placement net has no output projection")
            return 1
        for path in (args.placement, args.implicit):
            if not os.path.exists(path):
                print(f"Error: weights file not found: {path}")
                return 1
        try:
            device = resolve_device(args.device)
        except (RuntimeError, ValueError) as e:
            print(f"Error: {e}")
            return 1
        _warn_bank_font_mismatch(args.implicit, args.font)
        pp, pcfg = load_params_with_config(args.placement, device=device)
        sp, scfg, charset = load_siren(args.implicit, device=device)
        n = export_neural_render(
            pp, replace(pcfg, **kernels), sp, scfg, charset, args.font, args.out,
            platforms=platforms, scale=args.scale, hard=args.hard_placement,
            monotone=args.monotone_placement,
        )
        print(
            f"Exported neural render fn to {args.out} ({n / 1e6:.1f} MB, "
            f"platforms {','.join(platforms)}, batch dim symbolic)"
        )
        return 0

    loaded = _load(args)
    if loaded is None:
        return 1
    params, mcfg = loaded
    if args.int8:
        from .ops.quantized import quantize_params

        try:
            params = quantize_params(params)
        except ValueError as e:
            print(f"Error: {e}")
            return 1
    n = export_render(params, replace(mcfg, **kernels), args.out, platforms=platforms)
    print(
        f"Exported render fn to {args.out} ({n / 1e6:.1f} MB, "
        f"platforms {','.join(platforms)}, batch dim symbolic)"
    )
    return 0


def cmd_serve(args) -> int:
    """Run the batched render server until interrupted."""
    import time

    from .render.server import RenderServer
    from .utils.export import render_exported_u8

    tcp = None
    if args.tcp:
        tcp = parse_tcp(args.tcp)
        if tcp is None:
            print(f"Error: --tcp expects HOST:PORT, got {args.tcp!r}")
            return 1
    render_fn = None
    if args.exported:
        # The artifact is the whole deployment: no weights file; the wire
        # format's sheet size comes from its contract.
        if args.int8 or args.fast:
            print(
                "Warning: --int8/--fast have no effect with --exported — "
                "the artifact serves whatever precision was baked in "
                "(use `export --int8/--fast` instead)"
            )
        artifact = _load_artifact(args)
        if artifact is None:
            return 1
        params = None
        mcfg = replace(
            ModelConfig(), max_length=artifact.max_length, sheet_height=artifact.height,
            sheet_width=artifact.width,
        )

        def render_fn(strings):
            return render_exported_u8(artifact, strings)

    else:
        loaded = _load(args)
        if loaded is None:
            return 1
        params, mcfg = loaded
    try:
        server = RenderServer(
            params,
            mcfg,
            socket_path=args.socket,
            batch_size=args.batch_size,
            int8=args.int8,
            render_fn=render_fn,
            auth_token=args.auth_token or os.environ.get("AFR_AUTH_TOKEN"),
            tcp=tcp,
            tls_cert=args.tls_cert,
            tls_key=args.tls_key,
        )
    except ValueError as e:
        print(f"Error: {e}")
        return 1
    server.start()
    where = (
        f"{server.address[0]}:{server.address[1]}" + (" (TLS)" if args.tls_cert else "")
        if tcp
        else args.socket
    )
    print(f"Render server listening on {where} (batch {args.batch_size})")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


def cmd_fontgen(args) -> int:
    """Write the dataset in the reference's file format, synthesized on
    ``--device`` in chunks of 2048 sheets; the same files as the JAX
    package's ``fontgen``."""
    import shutil
    from functools import partial

    import numpy as np
    import torch

    from .device import resolve_device
    from .fontgen.bmp import write_bmp
    from .fontgen.dataset import font_is_monospace
    from .fontgen.textgen import generate_corpus

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"Error: {e}")
        return 1
    spec = SheetSpec()
    out = args.out
    if os.path.exists(out):
        print(f"Removing existing directory {out}...")
        shutil.rmtree(out)
    os.makedirs(out, exist_ok=True)
    print(f"Generating text samples in {out}/...")
    texts = generate_corpus(args.num_samples)
    with open(os.path.join(out, "data.txt"), "w") as f:
        f.write("\n".join(texts))
    print(f"Saved all text data to {out}/data.txt")

    if font_is_monospace(args.font):
        from .fontgen import bake_atlas, build_layouts, make_synth_ops, synthesize_sheets

        atlas = bake_atlas(args.font, spec)
        _, grids = build_layouts(atlas, args.num_samples)
        synth = partial(synthesize_sheets, make_synth_ops(atlas, device))
    else:
        from .fontgen.proportional import _synth, bake_prop_atlas, encode_prop_grids, prop_synth_operands

        atlas = bake_prop_atlas(args.font, spec)
        grids = encode_prop_grids(texts, atlas)
        synth = partial(_synth, *prop_synth_operands(atlas, device))
    print("Rendering bitmaps...")
    chunk = 2048
    for start in range(0, args.num_samples, chunk):
        sheets = synth(torch.from_numpy(grids[start : start + chunk].astype(np.int32))).cpu().numpy()
        for i, sheet in enumerate(sheets):
            write_bmp(os.path.join(out, f"{start + i + 1}.bmp"), sheet)
    metadata = (
        "AI Font Renderer Dataset - Fira Code\n"
        "==============================\n\n"
        f"Font: {os.path.basename(args.font)}\n"
        f"Font size: {int(spec.font_size)}\n"
        f"Sheet dimensions: {spec.width}x{spec.height}\n"
        f"Padding: {int(spec.padding)}px\n\n"
        "Format: Images are numbered sequentially (1.bmp, 2.bmp, etc.)\n"
        "Text labels are stored line by line in data.txt "
        "(line 1 corresponds to 1.bmp)\n"
    )
    with open(os.path.join(out, "dataset_metadata.txt"), "w") as f:
        f.write(metadata)
    print(f"Dataset generation complete. Check the {out}/ directory.")
    return 0


def cmd_eval(args) -> int:
    """Evaluate saved weights: the val split's MSE and PSNR on the corpus,
    and the test strings' MSE against their ground truth, as one JSON line
    with the JAX package's keys. ``--kernels`` sets only
    ``use_pallas_output``, as in the bare run."""
    import json

    import numpy as np
    import torch

    from .config import TrainConfig
    from .fontgen.dataset import split_permutation, split_sizes, synthesize_ground_truth
    from .render import render_batch
    from .train.step import eval_epoch

    loaded = _load(args)
    if loaded is None:
        return 1
    params, mcfg = loaded
    mcfg = replace(mcfg, use_pallas_output=_KERNELS[args.kernels][0].get("use_pallas_output", False))
    device = params["embedding"].device
    tcfg = TrainConfig(num_samples=args.num_samples)
    # Only the val split (the 20% the training split permutation holds out)
    # is synthesized.
    n = tcfg.num_samples
    train_size, _ = split_sizes(n, tcfg.validation_split)
    val_idx = split_permutation(n, tcfg.seed)[train_size:].astype(np.int64)
    atlas, ds = _build_dataset(mcfg, tcfg, args.font, device, subset=val_idx)
    b = min(1024, ds.num_samples)
    steps = ds.num_samples // b
    idx = torch.arange(steps * b, device=device).reshape(steps, b)
    w = torch.ones((steps, b), device=device)
    mse = float(eval_epoch(params, ds, idx, w, mcfg))
    psnr = 10.0 * np.log10(1.0 / max(mse, 1e-12))

    gt = synthesize_ground_truth(atlas, TEST_STRINGS)
    pred = render_batch(params, TEST_STRINGS, mcfg)
    t_mse = float(np.mean((pred - gt) ** 2))
    print(
        json.dumps(
            {
                "val_mse": round(mse, 8),
                "val_psnr_db": round(psnr, 2),
                "val_samples": steps * b,
                "test_strings_mse": round(t_mse, 8),
                "test_strings_psnr_db": round(10.0 * np.log10(1.0 / max(t_mse, 1e-12)), 2),
                "weights": args.weights,
            }
        )
    )
    return 0


def _subcommands(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(prog="python -m ai_font_renderer_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_ren = sub.add_parser("render", help="render strings with saved weights")
    p_ren.add_argument("strings", nargs="*")
    p_ren.add_argument("--weights", default="font_renderer.npz")
    p_ren.add_argument("--out", default=default_output_dir())
    p_ren.add_argument("--fast", action="store_true", help="bf16 frontend")
    p_ren.add_argument("--truth", action="store_true",
                       help="rasterize shaped ground truth (GSUB+GPOS) instead of model inference")
    p_ren.add_argument("--hinted", action="store_true",
                       help="with --truth: FreeType-style vertical grid fit")
    p_ren.add_argument("--font", default=FIRACODE_PATH)
    p_srv = sub.add_parser("serve", help="batched render server on a unix socket")
    p_srv.add_argument("--weights", default="font_renderer.npz")
    p_srv.add_argument("--socket", default="/tmp/afr.sock")
    p_srv.add_argument("--batch-size", type=int, default=64)
    p_srv.add_argument("--fast", action="store_true", help="bf16 frontend")
    p_srv.add_argument(
        "--auth-token", default=None,
        help="require this shared token on every request ($AFR_AUTH_TOKEN also works)",
    )
    p_srv.add_argument("--tcp", default=None, metavar="HOST:PORT")
    p_srv.add_argument("--tls-cert", default=None)
    p_srv.add_argument("--tls-key", default=None)
    p_gen = sub.add_parser("fontgen", help="export dataset BMPs + data.txt")
    p_gen.add_argument("--num-samples", type=int, default=150000)
    p_gen.add_argument("--out", default="train_input")
    p_gen.add_argument("--font", default=FIRACODE_PATH)
    p_ev = sub.add_parser("eval", help="val MSE/PSNR of saved weights")
    p_ev.add_argument("--weights", default="font_renderer.npz")
    p_ev.add_argument("--num-samples", type=int, default=150000)
    p_ev.add_argument("--font", default=FIRACODE_PATH)
    p_ev.add_argument("--kernels", choices=sorted(_KERNELS), default="none",
                      help="output or fused: the projection kernel K1 (only use_pallas_output is taken)")
    p_ren.add_argument("--implicit", metavar="SIREN_NPZ", default=None,
                       help="compose a SIREN glyph bank (utils/checkpoint.save_siren) at the layout "
                       "engine's positions; any --scale")
    p_ren.add_argument("--placement", metavar="PLACEMENT_NPZ", default=None,
                       help="with --implicit: positions from the learned placement net instead of "
                       "the layout engine (the fully neural path)")
    p_ren.add_argument("--hard-placement", action="store_true",
                       help="with --placement: discrete decode (argmax line, thresholded contribution)")
    p_ren.add_argument("--monotone-placement", action="store_true",
                       help="with --placement: the line indices decoded jointly under the engine's "
                       "monotone-break rule (implies --hard-placement)")
    p_ren.add_argument("--scale", type=float, default=1.0,
                       help="output resolution multiplier for --implicit renders")
    p_ren.add_argument("--baked", type=int, default=0, metavar="SS",
                       help="with --implicit: bake the bank once at SSx the cell resolution and "
                       "sample it bilinearly (0: evaluate the bank at every window pixel)")
    p_ren.add_argument("--phased", type=int, default=0, metavar="P",
                       help="with --implicit: bake the bank at PxP subpixel phases and place whole "
                       "blocks by one-hot products; positions quantize to 1/P px (0: exact)")
    p_exp = sub.add_parser("export", help="serialize the render function to a torch.export artifact "
                           "(weights baked in, symbolic batch dim)")
    p_exp.add_argument("--weights", default="font_renderer.npz")
    p_exp.add_argument("--out", default="font_renderer.pt2")
    p_exp.add_argument("--platforms", default="cpu,cuda",
                       help="comma-separated platforms the artifact may be loaded onto (default cpu,cuda)")
    p_exp.add_argument("--fast", action="store_true", help="bake the bf16-frontend fast profile")
    p_exp.add_argument("--kernels", default="none",
                       help="none (default), or a comma-separated subset of output (K1), attention (K5) "
                       "and attention_v2 (K7): the kernels the artifact's graph calls as operators")
    p_exp.add_argument("--implicit", metavar="SIREN_NPZ", default=None,
                       help="with --placement: the SIREN glyph bank to bake into a fully neural artifact")
    p_exp.add_argument("--placement", metavar="PLACEMENT_NPZ", default=None,
                       help="export the fully neural pipeline instead of the flagship: placement net + "
                       "--implicit SIREN bank + composition, the same codes->uint8 contract")
    p_exp.add_argument("--font", default=FIRACODE_PATH,
                       help="font consulted at export time for the static cell geometry of --placement "
                       "artifacts (never shipped inside)")
    p_exp.add_argument("--scale", type=float, default=1.0,
                       help="output resolution multiplier baked into a --placement artifact")
    p_exp.add_argument("--hard-placement", action="store_true",
                       help="bake the discrete placement decode (argmax line)")
    p_exp.add_argument("--monotone-placement", action="store_true",
                       help="bake the Viterbi monotone-break placement decode")
    for p in (p_ren, p_srv, p_exp):
        p.add_argument("--int8", action="store_true",
                       help="the linear head as an int8 x int8 product (per-channel weight scales, "
                       "dynamic per-row activation scales)")
    for p in (p_ren, p_srv):
        p.add_argument("--exported", default=None, metavar="ARTIFACT",
                       help="render from a self-contained torch.export artifact (export) instead of "
                       "weights: no weights file or model config needed")
    for p in (p_ren, p_srv, p_gen, p_ev, p_exp):
        p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    commands = {"render": cmd_render, "serve": cmd_serve, "fontgen": cmd_fontgen, "eval": cmd_eval,
                "export": cmd_export}
    return commands[args.cmd](args)


def run_training(mcfg, tcfg, output_dir, font=None, checkpoint_dir=None, resume=False, device=None, mesh=None):
    """Build the device dataset from ``font`` (monospace or proportional)
    and train, on ``mesh`` (a rank's parallel.Mesh) if given; ->
    TrainResult."""
    from .device import resolve_device
    from .train import train

    _, ds = _build_dataset(mcfg, tcfg, font or FIRACODE_PATH, resolve_device(device))
    print(
        "Training attention-based sheet renderer with reduced embedding "
        f"dimensions ({mcfg.embedding_dim}) and learned positional encoding..."
    )
    print(f"Using batch size {tcfg.batch_size}")
    return train(
        ds, mcfg, tcfg, output_dir=output_dir, eval_strings=TEST_STRINGS,
        checkpoint_dir=checkpoint_dir, resume=resume, mesh=mesh,
    )


def _train_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m ai_font_renderer_tpu_torch")
    parser.add_argument("--train", action="store_true")
    parser.add_argument("--samples", type=int, default=None)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--output", default=None)
    parser.add_argument("--font", default=FIRACODE_PATH)
    parser.add_argument("--weights", default="font_renderer.npz")
    parser.add_argument("--checkpoint-dir", default=None)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--schedule", choices=["plateau", "cosine"], default=None,
                        help="plateau = reference parity; cosine = fast time-budget profile")
    parser.add_argument("--peak-lr", type=float, default=None)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--leaky-clamp", type=float, default=None,
                        help="training-only leaky output clamp slope (0 = reference-exact)")
    parser.add_argument("--max-seconds", type=float, default=None,
                        help="wall-clock training budget; clean stop + best-weights restore")
    parser.add_argument("--profile", choices=["parity", "fast"], default="parity",
                        help="parity = reference-exact math (default); fast = bf16 frontend, "
                        "uint8 dropout masks, hand-rolled projection backward")
    parser.add_argument("--kernels", choices=sorted(_KERNELS), default="none",
                        help="none = plain PyTorch (default); output = K1/K2/K3 for the output "
                        "projection; fused = K1/K2 plus the fused dW+AdamW kernel K4")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--decoder", choices=["linear", "conv", "conv_ps"], default=None,
                        help="sheet decoder: linear (the reference's 6400x19200 head), conv "
                        "(resize + conv pyramid) or conv_ps (pixel-shuffle conv pyramid)")
    parser.add_argument("--decoder-channels", default=None,
                        help="comma-separated conv decoder channels, e.g. 128,128,64,32,16")
    parser.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                        help="device mesh layout: DATA-way batch sharding x MODEL-way output-projection "
                        "sharding, one rank a card (with --device cpu, CPU ranks); e.g. 2,1 or 1,2")
    return parser


def _configs(args):
    """(mcfg, tcfg) from the training flags, as the JAX package's CLI
    builds them."""
    from .config import TrainConfig

    mcfg, tcfg = ModelConfig(), TrainConfig()
    decoder = args.decoder or mcfg.decoder
    if decoder != "linear" and args.kernels != "none":
        raise ValueError(
            f"--kernels {args.kernels}: the output-projection kernels need the linear "
            f"decoder; --decoder {decoder} has no output projection (use --kernels none)"
        )
    if args.profile == "fast":
        mcfg = replace(mcfg, bf16_frontend=True, bits_dropout=True)
        # The hand-rolled backward exists only for the linear decoder; the
        # conv decoders keep the other fast flags.
        if decoder == "linear" and not (args.leaky_clamp or 0.0) and args.kernels == "none":
            tcfg = replace(tcfg, handrolled_bwd=True)
    mkw, tkw = _KERNELS[args.kernels]
    mcfg, tcfg = replace(mcfg, **mkw), replace(tcfg, **tkw)
    if args.samples:
        tcfg = replace(tcfg, num_samples=args.samples)
    if args.epochs:
        tcfg = replace(tcfg, num_epochs=args.epochs)
    if args.batch_size:
        tcfg = replace(tcfg, batch_size=args.batch_size)
    if args.schedule:
        tcfg = replace(tcfg, schedule=args.schedule)
    if args.peak_lr:
        tcfg = replace(tcfg, peak_learning_rate=args.peak_lr)
    if args.lr:
        tcfg = replace(tcfg, learning_rate=args.lr)
    if args.decoder:
        mcfg = replace(mcfg, decoder=args.decoder)
    if args.leaky_clamp is not None:
        mcfg = replace(mcfg, leaky_clamp=args.leaky_clamp)
    if args.max_seconds is not None:
        tcfg = replace(tcfg, max_train_seconds=args.max_seconds)
    if args.decoder_channels:
        chans = tuple(int(c) for c in args.decoder_channels.split(","))
        mcfg = replace(mcfg, decoder_channels=chans)
    return mcfg, tcfg


def _mesh_shape(value: str | None) -> tuple[int, int] | None:
    """``--mesh DATA,MODEL`` -> (DATA, MODEL); ValueError as the JAX CLI."""
    if not value:
        return None
    parts = value.split(",")
    if len(parts) != 2:
        raise ValueError(f"--mesh expects DATA,MODEL (got {value!r})")
    return int(parts[0]), int(parts[1])


def _launch_mesh(argv: list[str], args, shape: tuple[int, int], output_dir: str) -> int:
    """Start the DATA x MODEL ranks of this command line's training, one a
    visible card or with ``--device cpu`` CPU ranks, and wait for them.
    With fewer cards than ranks: exit 1 with make_mesh's message."""
    from .parallel import mesh as pmesh

    device = "cpu" if args.device == "cpu" else "cuda"
    data, model = shape
    try:
        # On the CPU the ranks are the devices; on the card, the cards.
        pmesh.mesh_shape(data, model, range(data * model) if device == "cpu" else pmesh.available_devices())
    except ValueError as e:
        print(f"Error: {e}")
        return 1
    # Every rank trains (the weights appear only when rank 0 is done) into
    # the output directory the parent chose.
    rank_argv = [*argv, "--train"] + ([] if args.output else ["--output", output_dir])
    return pmesh.launch(["-m", "ai_font_renderer_tpu_torch", *rank_argv], data * model, device)


def arm_dump_after(var: str) -> None:
    """Opt-in hang diagnostics, the JAX CLI's contract: ``var`` set to a
    number of seconds arms a wall-clock deadline that dumps every thread's
    stack to stderr and exits. It is a deadline, not an idle watchdog: set
    it above the run's expected wall time."""
    dump_after = os.environ.get(var)
    if dump_after:
        import faulthandler

        faulthandler.dump_traceback_later(float(dump_after), exit=True)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    arm_dump_after("AFR_DUMP_AFTER")
    if argv and argv[0] in ("render", "serve", "fontgen", "eval", "export"):
        return _subcommands(argv)
    if argv and argv[0] == "train-placement":
        from .train import placement_cli

        return placement_cli.main(argv[1:])

    parser = _train_parser()
    try:
        args = parser.parse_args(argv)
    except SystemExit as e:
        if not e.code:
            return 0  # --help: argparse printed it
        print("Available options: --train")
        return 1
    from .device import resolve_device
    from .parallel import mesh as pmesh
    from .render import render_strings
    from .utils.checkpoint import save_params

    try:
        shape = _mesh_shape(args.mesh)
        device = resolve_device(args.device)
        mcfg, tcfg = _configs(args)
    except (RuntimeError, ValueError) as e:
        print(f"Error: {e}")
        return 1
    output_dir = args.output or default_output_dir()
    training = args.train or not os.path.exists(args.weights)
    mesh = None
    if training and shape is not None and shape != (1, 1):
        if not pmesh.is_rank():
            return _launch_mesh(argv, args, shape, output_dir)
        pmesh.init_rank()
        mesh = pmesh.make_mesh(*shape)
    writes = mesh is None or mesh.is_main
    if writes:
        os.makedirs(output_dir, exist_ok=True)

    if training:
        if not args.train:
            print("No saved model found. Training a new model...")
        try:
            result = run_training(
                mcfg, tcfg, output_dir, args.font, args.checkpoint_dir, args.resume, device=device, mesh=mesh
            )
        finally:
            if mesh is not None:
                pmesh.finish_rank()
        if not writes:
            return 0
        params = result.params
        save_params(params, args.weights, mcfg)
    else:
        loaded = _load(args)
        if loaded is None:
            return 1
        params, loaded_cfg = loaded
        mcfg = replace(loaded_cfg, use_pallas_output=mcfg.use_pallas_output)
    render_strings(params, TEST_STRINGS, output_dir, mcfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
