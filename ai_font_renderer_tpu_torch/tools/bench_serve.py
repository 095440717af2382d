"""End-to-end render-server throughput.

The port of tools/bench_serve.py: a RenderServer in this process (the
weights of ./font_renderer.npz when there is one, else random weights from
a seed), driven over its unix socket by concurrent clients, the whole
serving path: socket framing, dynamic batching (batch 256), the render on
the device and the reply's encoding. Before the timed window one request
of 4 strings must come back byte-equal to a direct render of them.

    python -m ai_font_renderer_tpu_torch.tools.bench_serve [n_clients] [reqs_per_client] [strings_per_req] [--int8] [--format raw|rle|zlib|bmp] [--kernels K] [--device cpu]

``--int8`` serves the int8 x int8 projection (``serve --int8``);
``--format`` takes a comma-separated list, each format timed on the one
server. One JSON line a format, with the JAX tool's keys.
``AFR_BENCH_DUMP_AFTER=<seconds>`` dumps every thread's stack to stderr
after that long and exits, as in the JAX tool.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from ..cli import arm_dump_after
from ..config import ModelConfig
from ..models import font_renderer
from ..ops.quantized import quantize_params
from ..render.render import render_batch_u8_async
from ..render.server import RenderServer, request_render
from . import _common

BATCH = 256


def _formats(argv: list[str]) -> tuple[list[str], list[str]]:
    """(formats, argv without --format and its value)."""
    fmt, rest = "raw", []
    it = iter(argv)
    for a in it:
        if a == "--format":
            fmt = next(it, None)
            if fmt is None:
                raise SystemExit("--format needs a value (raw|rle|zlib|bmp, comma-separated)")
        elif a.startswith("--format="):
            fmt = a.split("=", 1)[1]
        else:
            rest.append(a)
    return [f.strip() for f in fmt.split(",") if f.strip()], rest


def _weights(mcfg: ModelConfig, device):
    if os.path.exists("font_renderer.npz"):
        from ..utils.checkpoint import load_params_with_config

        return load_params_with_config("font_renderer.npz", base=mcfg, device=device)
    return font_renderer.init(torch.Generator(device=device).manual_seed(0), mcfg, device), mcfg


def main(argv: list[str] | None = None, mcfg: ModelConfig = ModelConfig()) -> list[dict]:
    arm_dump_after("AFR_BENCH_DUMP_AFTER")  # a watchdog for deadlocks of the serve path under load
    rest, dev, kernels = _common.start(sys.argv[1:] if argv is None else argv)
    fmts, rest = _formats(rest)
    int8 = "--int8" in rest
    args = [a for a in rest if not a.startswith("--")]
    n_clients = int(args[0]) if len(args) > 0 else 8
    reqs = int(args[1]) if len(args) > 1 else 20
    per_req = int(args[2]) if len(args) > 2 else 64

    params, mcfg = _weights(mcfg, dev)
    mcfg, _ = _common.with_kernels(kernels, mcfg, None)
    sock_dir = tempfile.mkdtemp(prefix="afr_bench")
    sock = os.path.join(sock_dir, "afr_bench.sock")
    server = RenderServer(params, mcfg, socket_path=sock, batch_size=BATCH, int8=int8)
    server.start()
    strings = [("HELLO WORLD " * 9)[: 10 + (i * 7) % 90] for i in range(per_req)]
    glyphs_per_req = sum(len(s) for s in strings)
    rows = []
    try:
        header, warm = request_render(sock, strings[:4], fmt="raw")
        got = np.stack([np.frombuffer(p, np.uint8) for p in warm]).reshape(4, header["height"], header["width"])
        want = render_batch_u8_async(quantize_params(params) if int8 else params, strings[:4], mcfg).cpu().numpy()
        if not np.array_equal(got, want):
            raise AssertionError("the server's reply differs from a direct render of the same strings")
        for fmt in fmts:
            request_render(sock, strings[:4], fmt=fmt)  # warm this format's encoder
            done = [0] * n_clients
            errors = []

            def client(ci: int) -> None:
                try:
                    for _ in range(reqs):
                        _, sheets = request_render(sock, strings, fmt=fmt)
                        if len(sheets) != per_req:
                            raise AssertionError(f"{len(sheets)} sheets for {per_req} strings")
                        done[ci] += 1
                except Exception as e:  # reported after the join
                    errors.append(repr(e))

            threads = [threading.Thread(target=client, args=(i,)) for i in range(n_clients)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            dt = time.perf_counter() - t0
            if errors or any(t.is_alive() for t in threads) or sum(done) != n_clients * reqs:
                raise AssertionError(f"serve clients failed: {errors}")
            rows.append({
                "metric": "serve_strings_per_sec",
                "value": n_clients * reqs * per_req / dt,
                "unit": "strings/sec",
                "glyphs_per_sec": n_clients * reqs * glyphs_per_req / dt,
                "clients": n_clients,
                "batch_size": BATCH,
                "int8": int8,
                "format": fmt,
                "wall_s": dt,
            })
            print(json.dumps(rows[-1]), flush=True)
    finally:
        server.stop()
        shutil.rmtree(sock_dir, ignore_errors=True)
    return rows


if __name__ == "__main__":
    main()
