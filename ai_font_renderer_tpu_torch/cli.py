"""Command line of the port: train, render and serve.

  * ``--train``      train a new model, save ``font_renderer.npz`` in the
                     working directory, render the test strings to BMPs
                     under ``train_output_<timestamp>/`` (``--output``);
  * no arguments     load saved weights if present, else train and save;
                     then render the test strings;
  * ``render``       render given strings (or the test strings) to BMPs;
  * ``serve``        run the batched render server;
  * unknown option   usage plus ``Available options: --train``, exit 1.

Everything runs on the card unless ``--device cpu`` is given. ``--kernels``
picks the training configuration: ``none`` (the JAX package's defaults, no
kernel), ``output`` (``use_pallas_output``: K1 forward, K2/K3 backward) or
``fused`` (``use_pallas_output`` + ``fused_dw_adamw``: K1, K2 and K4).
Options that need other slices of the port exit 1 with a message that says
so.
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys

from .config import SheetSpec, replace

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

_LATER = "{flag} is not ported to the PyTorch/CUDA package yet; it comes with a later slice."
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


def _refuse_later(args, flags) -> bool:
    for flag in flags:
        if getattr(args, flag.lstrip("-").replace("-", "_"), None):
            print(_LATER.format(flag=flag))
            return True
    return False


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


def cmd_render(args) -> int:
    from .render import render_strings

    if _refuse_later(args, ("--int8", "--implicit", "--placement", "--exported", "--truth")):
        return 1
    loaded = _load(args)
    if loaded is None:
        return 1
    params, mcfg = loaded
    render_strings(params, args.strings or TEST_STRINGS, args.out, mcfg)
    return 0


def cmd_serve(args) -> int:
    """Run the batched render server until interrupted."""
    import time

    from .render.server import RenderServer

    if _refuse_later(args, ("--int8", "--exported")):
        return 1
    tcp = None
    if args.tcp:
        tcp = parse_tcp(args.tcp)
        if tcp is None:
            print(f"Error: --tcp expects HOST:PORT, got {args.tcp!r}")
            return 1
    loaded = _load(args)
    if loaded is None:
        return 1
    params, mcfg = loaded
    server = RenderServer(
        params,
        mcfg,
        socket_path=args.socket,
        batch_size=args.batch_size,
        auth_token=args.auth_token or os.environ.get("AFR_AUTH_TOKEN"),
        tcp=tcp,
        tls_cert=args.tls_cert,
        tls_key=args.tls_key,
    )
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


def _subcommands(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(prog="python -m ai_font_renderer_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_ren = sub.add_parser("render", help="render strings with saved weights")
    p_ren.add_argument("strings", nargs="*")
    p_ren.add_argument("--weights", default="font_renderer.npz")
    p_ren.add_argument("--out", default=default_output_dir())
    p_ren.add_argument("--fast", action="store_true", help="bf16 frontend")
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
    # Options of later slices are accepted so that they fail with a clear
    # message rather than a usage error.
    p_ren.add_argument("--truth", action="store_true", help="not ported yet")
    p_ren.add_argument("--implicit", default=None, help="not ported yet")
    p_ren.add_argument("--placement", default=None, help="not ported yet")
    for p in (p_ren, p_srv):
        p.add_argument("--int8", action="store_true", help="not ported yet")
        p.add_argument("--exported", default=None, help="not ported yet")
        p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    return {"render": cmd_render, "serve": cmd_serve}[args.cmd](args)


def run_training(mcfg, tcfg, output_dir, font=None, checkpoint_dir=None, resume=False, device=None):
    """Build the device dataset from ``font`` and train; -> TrainResult."""
    from .config import FIRACODE_PATH
    from .device import resolve_device
    from .fontgen import bake_atlas, build_device_dataset
    from .fontgen.dataset import require_monospace
    from .train import train

    font = font or FIRACODE_PATH
    dev = resolve_device(device)
    require_monospace(font)
    print("Creating sheet dataset...")
    spec = replace(SheetSpec(), width=mcfg.sheet_width, height=mcfg.sheet_height, max_chars=mcfg.max_length)
    ds = build_device_dataset(bake_atlas(font, spec), tcfg.num_samples, device=dev)
    print(
        "Training attention-based sheet renderer with reduced embedding "
        f"dimensions ({mcfg.embedding_dim}) and learned positional encoding..."
    )
    print(f"Using batch size {tcfg.batch_size}")
    return train(
        ds, mcfg, tcfg, output_dir=output_dir, eval_strings=TEST_STRINGS,
        checkpoint_dir=checkpoint_dir, resume=resume,
    )


def _train_parser() -> argparse.ArgumentParser:
    from .config import FIRACODE_PATH

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
    # Options of later slices: accepted so that they fail with a clear message.
    parser.add_argument("--decoder", choices=["linear", "conv", "conv_ps"], default=None,
                        help="only linear is ported")
    parser.add_argument("--decoder-channels", default=None, help="not ported yet")
    parser.add_argument("--mesh", default=None, metavar="DATA,MODEL", help="only 1,1 is ported")
    return parser


def _configs(args):
    """(mcfg, tcfg) from the training flags, as the JAX package's CLI
    builds them."""
    from .config import ModelConfig, TrainConfig

    mcfg, tcfg = ModelConfig(), TrainConfig()
    if args.profile == "fast":
        mcfg = replace(mcfg, bf16_frontend=True, bits_dropout=True)
        if not (args.leaky_clamp or 0.0) and args.kernels == "none":
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
    if args.leaky_clamp is not None:
        mcfg = replace(mcfg, leaky_clamp=args.leaky_clamp)
    if args.max_seconds is not None:
        tcfg = replace(tcfg, max_train_seconds=args.max_seconds)
    return mcfg, tcfg


def _refuse_later_training(args) -> bool:
    if args.decoder not in (None, "linear") or args.decoder_channels:
        print(
            "--decoder conv/conv_ps: the conv decoders are not ported to the "
            "PyTorch/CUDA package yet; they come with a later slice (ROADMAP "
            "queue 1, item 8)."
        )
        return True
    if args.mesh is not None and args.mesh.replace(" ", "") != "1,1":
        print(
            f"--mesh {args.mesh}: training on a device mesh is not ported to the "
            "PyTorch/CUDA package yet; it comes with a later slice (ROADMAP queue "
            "1, item 15). Only --mesh 1,1 (one card) runs."
        )
        return True
    return False


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] in ("render", "serve"):
        return _subcommands(argv)
    if argv and argv[0] in ("fontgen", "eval", "export", "train-placement"):
        print(_LATER.format(flag=argv[0]))
        return 1

    parser = _train_parser()
    try:
        args = parser.parse_args(argv)
    except SystemExit as e:
        if not e.code:
            return 0  # --help: argparse printed it
        print("Available options: --train")
        return 1
    if _refuse_later_training(args):
        return 1
    from .device import resolve_device
    from .fontgen.dataset import require_monospace
    from .render import render_strings
    from .utils.checkpoint import save_params

    try:
        device = resolve_device(args.device)
        mcfg, tcfg = _configs(args)
        if args.train or not os.path.exists(args.weights):
            require_monospace(args.font)
    except (RuntimeError, ValueError, NotImplementedError) as e:
        print(f"Error: {e}")
        return 1
    output_dir = args.output or default_output_dir()
    os.makedirs(output_dir, exist_ok=True)

    if args.train or not os.path.exists(args.weights):
        if not args.train:
            print("No saved model found. Training a new model...")
        result = run_training(
            mcfg, tcfg, output_dir, args.font, args.checkpoint_dir, args.resume, device=device
        )
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
