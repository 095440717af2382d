"""Command line of the port: render and serve with saved weights.

  * no arguments     load ``font_renderer.npz`` and render the test strings
                     to BMPs under ``train_output_<timestamp>/``;
  * ``render``       render given strings (or the test strings) to BMPs;
  * ``serve``        run the batched render server;
  * unknown option   usage plus ``Available options: --train``, exit 1.

Everything runs on the card unless ``--device cpu`` is given. Training
(``--train``, or a bare run without weights) and the options that need other
slices of the port exit 1 with a message that says so.
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys

from .config import replace

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

_NOT_TRAINING = (
    "Training is not ported to the PyTorch/CUDA package yet (it is the next "
    "slice); train with `python -m ai_font_renderer_tpu --train`, then render "
    "or serve its font_renderer.npz here."
)
_LATER = "{flag} is not ported to the PyTorch/CUDA package yet; it comes with a later slice."


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


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] in ("render", "serve"):
        return _subcommands(argv)
    if argv and argv[0] in ("fontgen", "eval", "export", "train-placement"):
        print(_LATER.format(flag=argv[0]))
        return 1

    parser = argparse.ArgumentParser(prog="python -m ai_font_renderer_tpu_torch")
    parser.add_argument("--train", action="store_true")
    parser.add_argument("--weights", default="font_renderer.npz")
    parser.add_argument("--output", default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    try:
        args = parser.parse_args(argv)
    except SystemExit as e:
        if not e.code:
            return 0  # --help: argparse printed it
        print("Available options: --train")
        return 1
    if args.train:
        print(_NOT_TRAINING)
        return 1
    if not os.path.exists(args.weights):
        print(f"No saved model found at {args.weights}. {_NOT_TRAINING}")
        return 1
    from .render import render_strings

    loaded = _load(args)
    if loaded is None:
        return 1
    params, mcfg = loaded
    output_dir = args.output or default_output_dir()
    os.makedirs(output_dir, exist_ok=True)
    render_strings(params, TEST_STRINGS, output_dir, mcfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
