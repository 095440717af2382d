"""Batched render server: many clients, fixed-shape device batches.

The port's own copy of ai_font_renderer_tpu/render/server.py, with the
port's ``render_batch_u8_async`` as its backend. Clients connect over a
Unix socket (or TCP/TLS), requests accumulate in a queue while the card is
busy, and a single dispatcher thread drains them into FIXED-SIZE padded
batches — classic dynamic batching. Double buffering falls out of the
architecture: kernel launches are asynchronous, so the dispatcher encodes
and launches batch N+1 while batch N runs on the card; only the fetch of a
batch to the host (``.cpu()``) waits for it.

Protocol (length-prefixed, stdlib-only):
  request : uint32 BE length + UTF-8 JSON {"strings": [...], "format":
            "raw"|"bmp"|"rle"|"zlib", "auth": TOKEN (required iff the
            server has one)}
  response: uint32 BE length + JSON header {"count", "height", "width",
            "format"} then, per string: raw uint8 H*W bytes (format=raw) or
            uint32 BE length + BMP file bytes (format=bmp); for the
            compressed formats, ONE uint32 BE length-prefixed blob holding
            all count*H*W pixels: byte-level run-length pairs
            (value u8, runlen u16 BE — format=rle) or a zlib stream of the
            raw bytes (format=zlib). Text sheets are ~97% white, so both
            cut reply bytes many times over. An unauthorized request gets
            {"error": "unauthorized"} and the connection closes.

Auth: a unix socket is already gated by filesystem permissions; the
optional shared token (``serve --auth-token`` / ``$AFR_AUTH_TOKEN``)
adds an application-level check (constant-time compare) for sockets
shared across trust domains.

Transports: unix socket (default) or TCP (``serve --tcp HOST:PORT``),
optionally under TLS (``--tls-cert/--tls-key``; stdlib ``ssl``, TLS 1.2+).
The framing protocol is transport-agnostic — the same length-prefixed
messages flow over all three. Plaintext TCP is intended for loopback/
trusted networks; anything routable should use TLS + the auth token.

Run: `python -m ai_font_renderer_tpu_torch serve --weights font_renderer.npz --socket /tmp/afr.sock`
"""

from __future__ import annotations

import hmac
import json
import os
import queue
import socket
import socketserver
import struct
import threading

import numpy as np

from ..config import ModelConfig


class _Request:
    """One client request moving through the batching pipeline."""

    __slots__ = ("strings", "reply", "sheets", "cursor", "remaining")

    def __init__(self, strings: list[str], reply, height: int, width: int):
        self.strings = strings
        self.reply = reply
        self.sheets = np.empty((len(strings), height, width), np.uint8)
        self.cursor = 0  # next string index to dispatch
        self.remaining = len(strings)  # strings not yet fetched


def _to_host(sheets) -> np.ndarray:
    """Fetch a rendered uint8 batch (a device tensor) to the host. This
    copy is the one place the serving loop waits for the card; ``np.asarray``
    cannot read a CUDA tensor."""
    return sheets.cpu().numpy()


class _Batcher:
    """Queue of (strings, reply_fn); drains into fixed-size device batches.

    A continuous pipeline, not drain-at-a-time: chunks are packed across
    requests (one fixed batch shape), up to ``_WINDOW`` chunks stay
    launched ahead of the oldest un-fetched one (CUDA launches are
    asynchronous, so the card works ahead while the host encodes the next
    chunk's codes), newly arrived requests join the dispatch queue between
    fetches — so a long backlog never stalls admission — and each
    request's reply streams out the moment its own rows are fetched
    instead of waiting for the whole drain. Quantization to uint8 happens
    on the device (4x smaller fetches), and replies are written by a
    separate thread so socket IO never blocks the render loop.
    """

    _WINDOW = 2  # fetch once more than this many chunks are in flight

    def __init__(
        self,
        params,
        mcfg: ModelConfig,
        batch_size: int = 64,
        int8: bool = False,
        render_fn=None,
    ):
        if render_fn is not None:
            # Pluggable backend: strings -> uint8 device tensor [n, H, W].
            self._render = render_fn
        else:
            from .render import render_batch_u8_async

            if int8 and "out_w_q" not in params:
                from ..ops.quantized import quantize_params

                params = quantize_params(params)
            self._render = lambda strings: render_batch_u8_async(
                params, strings, mcfg
            )
        self.mcfg = mcfg
        self.batch_size = batch_size
        self.q: queue.Queue = queue.Queue()
        self._replies: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self._reply_thread = threading.Thread(target=self._reply_loop, daemon=True)

    def start(self):
        # One render at the batch shape before the first client: builds the
        # kernels and warms the allocator.
        _to_host(self._render([""] * self.batch_size))
        self.thread.start()
        self._reply_thread.start()

    def stop(self):
        self._stop.set()
        self.q.put(None)
        # Join the render loop BEFORE the reply sentinel: an in-flight
        # drain may still be enqueueing replies, which must precede None.
        self.thread.join(timeout=5)
        self._replies.put(None)
        self._reply_thread.join(timeout=5)

    def submit(self, strings: list[str], reply):
        self.q.put((strings, reply))

    def _reply_loop(self):
        while True:
            item = self._replies.get()
            if item is None:
                return
            reply, sheets = item
            try:
                reply(sheets)
            except (BrokenPipeError, ConnectionError, OSError, socket.timeout):
                pass  # client went away or stalled; keep serving others

    def _admit(self, reqs: list, block: bool) -> bool:
        """Move queued submissions into the dispatch list. Returns False
        once the shutdown sentinel has been consumed."""
        h, w = self.mcfg.sheet_height, self.mcfg.sheet_width
        first = block
        while True:
            try:
                item = self.q.get(block=first)
            except queue.Empty:
                return True
            first = False
            if item is None:
                return False
            strings, reply = item
            if not strings:  # nothing to render; reply immediately
                self._replies.put((reply, np.empty((0, h, w), np.uint8)))
                continue
            reqs.append(_Request(strings, reply, h, w))

    def _dispatch_chunk(self, reqs: list):
        """Pack the next batch_size strings across requests, dispatch one
        device call; returns (segments, device_array)."""
        chunk: list[str] = []
        segs = []  # (request, start_row_in_request, start_in_chunk, count)
        while reqs and len(chunk) < self.batch_size:
            req = reqs[0]
            take = min(self.batch_size - len(chunk), len(req.strings) - req.cursor)
            segs.append((req, req.cursor, len(chunk), take))
            chunk.extend(req.strings[req.cursor : req.cursor + take])
            req.cursor += take
            if req.cursor == len(req.strings):
                reqs.pop(0)
        padded = chunk + [""] * (self.batch_size - len(chunk))
        return segs, self._render(padded)

    def _fetch_chunk(self, inflight: list):
        """Fetch the oldest in-flight chunk; stream any completed replies."""
        segs, dev = inflight.pop(0)
        arr = _to_host(dev)
        for req, row0, c0, count in segs:
            req.sheets[row0 : row0 + count] = arr[c0 : c0 + count]
            req.remaining -= count
            if req.remaining == 0:
                self._replies.put((req.reply, req.sheets))

    def _loop(self):
        reqs: list[_Request] = []  # admitted, not fully dispatched
        inflight: list = []  # dispatched, not fetched
        alive = True
        while alive or reqs or inflight:
            if alive:
                # Block for work only when the pipeline is empty.
                alive = self._admit(reqs, block=not (reqs or inflight))
            while reqs and len(inflight) <= self._WINDOW:
                inflight.append(self._dispatch_chunk(reqs))
            if inflight:
                self._fetch_chunk(inflight)


def rle_encode(arr: np.ndarray) -> bytes:
    """uint8 array -> byte-level run-length pairs (value u8, len u16 BE).

    Vectorized: run boundaries via diff, runs longer than 65535 split
    into ceil(len/65535) pairs. A mostly-white text sheet encodes to a
    few hundred bytes instead of 19200."""
    flat = np.ascontiguousarray(arr, np.uint8).reshape(-1)
    if flat.size == 0:
        return b""
    starts = np.concatenate([[0], np.flatnonzero(np.diff(flat)) + 1])
    lens = np.diff(np.concatenate([starts, [flat.size]]))
    vals = flat[starts]
    reps = (lens + 65534) // 65535  # pairs per run
    total = int(reps.sum())
    lens2 = np.full(total, 65535, np.int64)
    lens2[np.cumsum(reps) - 1] = lens - (reps - 1) * 65535
    vals2 = np.repeat(vals, reps)
    out = np.empty((total, 3), np.uint8)
    out[:, 0] = vals2
    out[:, 1] = lens2 >> 8
    out[:, 2] = lens2 & 0xFF
    return out.tobytes()


def rle_decode(blob: bytes) -> np.ndarray:
    """Inverse of :func:`rle_encode` -> flat uint8 array."""
    a = np.frombuffer(blob, np.uint8).reshape(-1, 3)
    lens = (a[:, 1].astype(np.int64) << 8) | a[:, 2]
    return np.repeat(a[:, 0], lens)


def _send_msg(sock, payload: bytes):
    sock.sendall(struct.pack(">I", len(payload)) + payload)


def _recv_exact(sock, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        part = sock.recv(n - len(buf))
        if not part:
            return None
        buf += part
    return buf


def _recv_msg(sock, cap: int = 16 << 20) -> bytes | None:
    head = _recv_exact(sock, 4)
    if head is None:
        return None
    (length,) = struct.unpack(">I", head)
    # Asymmetric caps: the server reads REQUESTS under the default 16 MB
    # (this runs before the auth check, so the pre-auth buffering exposure
    # stays bounded); only the CLIENT raises the cap, for compressed reply
    # blobs (a 2048-string reply RLE-encodes to ~10 MB worst case on real
    # text sheets).
    if length > cap:
        raise ValueError(f"oversized message: {length} bytes")
    return _recv_exact(sock, length)


class RenderServer:
    """``tcp=(host, port)`` switches the listener from the unix socket to
    TCP; ``tls_cert``/``tls_key`` (PEM paths) wrap accepted TCP
    connections in server-side TLS. After ``start()``, ``address`` holds
    the bound ``(host, port)`` — useful with port 0 (ephemeral).

    ``render_fn`` (strings -> uint8 device tensor [n, H, W]) replaces the
    weights-based backend entirely: ``params`` may be None and ``mcfg``
    only supplies the wire-format sheet dims. ``int8`` serves the linear
    decoder's projection in int8 (``ops.quantized``): a dict without
    ``out_w_q`` is quantized once, here."""

    def __init__(
        self,
        params: dict | None,
        mcfg: ModelConfig = ModelConfig(),
        socket_path: str = "/tmp/afr.sock",
        batch_size: int = 64,
        int8: bool = False,
        auth_token: str | None = None,
        tcp: tuple[str, int] | None = None,
        tls_cert: str | None = None,
        tls_key: str | None = None,
        render_fn=None,
    ):
        if (tls_cert is None) != (tls_key is None):
            raise ValueError("tls_cert and tls_key must be given together")
        if tls_cert is not None and tcp is None:
            raise ValueError("TLS requires the TCP transport (tcp=...)")
        self.socket_path = socket_path
        self.tcp = tcp
        self.tls_cert, self.tls_key = tls_cert, tls_key
        self.address: tuple[str, int] | None = None
        self.batcher = _Batcher(params, mcfg, batch_size, int8=int8, render_fn=render_fn)
        self.mcfg = mcfg
        self.auth_token = auth_token
        self._server: socketserver.BaseServer | None = None

    def start(self):
        if self.tcp is None and os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        self.batcher.start()
        batcher, mcfg = self.batcher, self.mcfg
        token = self.auth_token

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                # All replies funnel through one reply thread; a stalled
                # (connected but unread) client must raise out of sendall
                # instead of head-of-line-blocking every other reply.
                self.request.settimeout(30)
                if hasattr(self.request, "do_handshake"):
                    try:
                        self.request.do_handshake()
                    except OSError:  # includes ssl.SSLError + timeouts
                        return  # non-TLS/garbage client; drop quietly
                while True:
                    try:
                        raw = _recv_msg(self.request)
                    except (OSError, ValueError):
                        # Idle >30s, oversized frame, or reset mid-read:
                        # drop the connection quietly — any unauthenticated
                        # peer can trigger these, so no traceback spam.
                        return
                    if raw is None:
                        return
                    try:
                        req = json.loads(raw)
                        if not isinstance(req, dict):
                            raise ValueError("request must be a JSON object")
                    except (ValueError, UnicodeDecodeError):
                        try:
                            _send_msg(
                                self.request,
                                json.dumps({"error": "malformed request"}).encode(),
                            )
                        except OSError:
                            pass
                        return
                    if token is not None and not hmac.compare_digest(
                        str(req.get("auth", "")), token
                    ):
                        _send_msg(
                            self.request,
                            json.dumps({"error": "unauthorized"}).encode(),
                        )
                        return
                    strings = [str(s) for s in req.get("strings", [])]
                    fmt = req.get("format", "raw")
                    done = threading.Event()

                    def reply(sheets, sock=self.request, fmt=fmt, done=done):
                        # done.set() in finally: if the send raises, the
                        # handler must not sit out the full 60 s wait on a
                        # connection that is already dead.
                        try:
                            header = json.dumps(
                                {
                                    "count": len(sheets),
                                    "height": mcfg.sheet_height,
                                    "width": mcfg.sheet_width,
                                    "format": fmt,
                                }
                            ).encode()
                            _send_msg(sock, header)
                            if fmt == "bmp":
                                from ..fontgen.bmp import encode_bmp

                                for sheet in sheets:
                                    _send_msg(sock, encode_bmp(sheet))
                            else:
                                if sheets.dtype != np.uint8:
                                    sheets = np.round(
                                        np.clip(sheets, 0, 1) * 255
                                    ).astype(np.uint8)
                                if fmt == "rle":
                                    _send_msg(sock, rle_encode(sheets))
                                elif fmt == "zlib":
                                    import zlib

                                    # Level 1: the host core is the
                                    # bottleneck, not the wire.
                                    _send_msg(
                                        sock,
                                        zlib.compress(sheets.tobytes(), 1),
                                    )
                                else:
                                    sock.sendall(sheets.tobytes())
                        finally:
                            done.set()

                    batcher.submit(strings, reply)
                    done.wait(timeout=60)

        if self.tcp is not None:
            ctx = None
            if self.tls_cert is not None:
                import ssl

                ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
                ctx.minimum_version = ssl.TLSVersion.TLSv1_2
                ctx.load_cert_chain(self.tls_cert, self.tls_key)

            class TCPServer(socketserver.ThreadingTCPServer):
                allow_reuse_address = True
                daemon_threads = True
                # IPv6 literal hosts ('::1') need AF_INET6; ThreadingTCPServer
                # defaults to AF_INET and would fail the bind.
                if ":" in self.tcp[0]:
                    address_family = socket.AF_INET6

                def get_request(inner):
                    # do_handshake_on_connect=False: the handshake runs on
                    # the handler thread's first read (under its 30 s
                    # timeout), so a stalled or non-TLS client can never
                    # block the accept loop.
                    sock, addr = inner.socket.accept()
                    if ctx is not None:
                        sock = ctx.wrap_socket(
                            sock, server_side=True, do_handshake_on_connect=False
                        )
                    return sock, addr

            self._server = TCPServer(self.tcp, Handler)
            self.address = self._server.server_address[:2]
        else:
            self._server = socketserver.ThreadingUnixStreamServer(
                self.socket_path, Handler
            )
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()

    def stop(self):
        if self._server:
            self._server.shutdown()
            self._server.server_close()
        self.batcher.stop()
        if self.tcp is None and os.path.exists(self.socket_path):
            os.unlink(self.socket_path)


def _connect(
    socket_path: str,
    tcp: tuple[str, int] | None,
    tls_ca: str | None,
) -> socket.socket:
    if tcp is None:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.connect(socket_path)
        return s
    s = socket.create_connection(tcp)
    if tls_ca is not None:
        import ssl

        ctx = ssl.create_default_context(cafile=tls_ca)
        s = ctx.wrap_socket(s, server_hostname=tcp[0])
    return s


def request_render(
    socket_path: str,
    strings: list[str],
    fmt: str = "raw",
    auth_token: str | None = None,
    tcp: tuple[str, int] | None = None,
    tls_ca: str | None = None,
):
    """Client helper: returns (header dict, [payload bytes per string]).

    ``tcp=(host, port)`` targets a TCP server instead of the unix socket;
    ``tls_ca`` (PEM path) turns on TLS with certificate verification
    against that CA (hostname checked). Raises PermissionError if the
    server requires a token and ``auth_token`` is missing or wrong."""
    with _connect(socket_path, tcp, tls_ca) as s:
        req = {"strings": strings, "format": fmt}
        if auth_token is not None:
            req["auth"] = auth_token
        _send_msg(s, json.dumps(req).encode())

        def _or_raise(data):
            if data is None:
                raise ConnectionError(
                    "server closed the connection mid-reply (restart, or "
                    "its 60s reply window elapsed)"
                )
            return data

        def recv_or_raise(**kw):
            return _or_raise(_recv_msg(s, **kw))

        header = json.loads(recv_or_raise())
        if "error" in header:
            if header["error"] == "unauthorized":
                raise PermissionError(header["error"])
            raise ValueError(f"server rejected the request: {header['error']}")
        hw = header["height"] * header["width"]
        if fmt == "bmp":
            payloads = [recv_or_raise() for _ in range(header["count"])]
        elif fmt in ("rle", "zlib"):
            comp = recv_or_raise(cap=64 << 20)
            if fmt == "rle":
                flat = rle_decode(comp)
            else:
                import zlib

                flat = np.frombuffer(zlib.decompress(comp), np.uint8)
            if flat.size != header["count"] * hw:
                raise ValueError(
                    f"reply decodes to {flat.size} bytes, expected "
                    f"{header['count']}x{hw}"
                )
            blob = flat.tobytes()
            payloads = [
                blob[i * hw : (i + 1) * hw] for i in range(header["count"])
            ]
        else:
            blob = _or_raise(_recv_exact(s, header["count"] * hw))
            payloads = [
                blob[i * hw : (i + 1) * hw] for i in range(header["count"])
            ]
        return header, payloads
