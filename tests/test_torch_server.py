"""The port's batched render server over a unix socket, on the CPU: the
scenarios of tests/test_server.py with the port's backend, held against the
port's direct render and the JAX package's render_batch."""

import threading

import jax
import numpy as np
import pytest

from ai_font_renderer_tpu.config import ModelConfig as JaxModelConfig
from ai_font_renderer_tpu.models import font_renderer as jfr
from ai_font_renderer_tpu.render.render import render_batch as jax_render_batch
from ai_font_renderer_tpu_torch.config import ModelConfig
from ai_font_renderer_tpu_torch.fontgen.bmp import read_bmp
from ai_font_renderer_tpu_torch.models.font_renderer import params_from_jax
from ai_font_renderer_tpu_torch.render.render import render_batch
from ai_font_renderer_tpu_torch.render.server import RenderServer, request_render
from test_torch_native_build import install_reference_native

install_reference_native()

SMALL = dict(max_length=16, sheet_height=16, sheet_width=48)
MCFG = ModelConfig(**SMALL)
H, W = 16, 48


@pytest.fixture(scope="module")
def jax_params():
    return jfr.init(jax.random.PRNGKey(0), JaxModelConfig(**SMALL))


@pytest.fixture(scope="module")
def server(jax_params, tmp_path_factory):
    params = params_from_jax({k: np.asarray(v) for k, v in jax_params.items()}, "cpu")
    sock = str(tmp_path_factory.mktemp("srv") / "afr.sock")
    srv = RenderServer(params, MCFG, socket_path=sock, batch_size=8)
    srv.start()
    yield srv, sock, params
    srv.stop()


def _sheets(payloads):
    return np.stack([np.frombuffer(p, np.uint8).reshape(H, W) for p in payloads])


def _u8(sheets):
    return np.round(np.clip(sheets, 0, 1) * 255).astype(np.int32)


def test_raw_roundtrip_matches_direct_and_jax_render(server, jax_params):
    _, sock, params = server
    strings = ["HELLO", "WORLD", ""]
    header, payloads = request_render(sock, strings)
    assert header["count"] == 3 and (header["height"], header["width"]) == (H, W)
    got = _sheets(payloads).astype(np.int32)
    assert np.abs(got - _u8(render_batch(params, strings, MCFG))).max() <= 1
    want = jax_render_batch(jax_params, strings, JaxModelConfig(**SMALL))
    assert np.abs(got - _u8(want)).max() <= 1


def test_bmp_format(server):
    _, sock, _ = server
    header, payloads = request_render(sock, ["ABC"], fmt="bmp")
    assert header["format"] == "bmp"
    assert read_bmp(payloads[0]).shape == (H, W)


def test_empty_request_replies_immediately(server):
    _, sock, _ = server
    header, payloads = request_render(sock, [])
    assert header["count"] == 0 and payloads == []


def test_cross_request_packing_and_oversized_requests(server):
    """Concurrent requests whose sizes straddle the 8-string batch (5, 6,
    3, 20, 1) are packed into shared batches; each client still gets its
    own sheets in its own order."""
    _, sock, params = server
    sizes = [5, 6, 3, 20, 1]
    reqs = {i: [f"REQ{i} S{j}" for j in range(n)] for i, n in enumerate(sizes)}
    results, errors = {}, []

    def client(i):
        try:
            results[i] = request_render(sock, reqs[i])
        except Exception as e:  # reported by the assert below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in reqs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and not any(t.is_alive() for t in threads)
    for i, strings in reqs.items():
        header, payloads = results[i]
        assert header["count"] == len(strings)
        got = _sheets(payloads).astype(np.int32)
        assert np.abs(got - _u8(render_batch(params, strings, MCFG))).max() <= 1


@pytest.mark.parametrize("fmt", ["rle", "zlib"])
def test_compressed_reply_matches_raw(server, fmt):
    _, sock, _ = server
    strings = ["HELLO", "WORLD WIDE WEB", ""]
    _, raw = request_render(sock, strings, fmt="raw")
    header, comp = request_render(sock, strings, fmt=fmt)
    assert header["format"] == fmt and header["count"] == 3
    assert [bytes(c) for c in comp] == [bytes(r) for r in raw]


def test_auth_token_gates_requests(server, tmp_path):
    _, _, params = server
    sock = str(tmp_path / "auth.sock")
    srv = RenderServer(params, MCFG, socket_path=sock, batch_size=8, auth_token="s3cret")
    srv.start()
    try:
        with pytest.raises(PermissionError):
            request_render(sock, ["HI"])
        with pytest.raises(PermissionError):
            request_render(sock, ["HI"], auth_token="wrong")
        header, payloads = request_render(sock, ["HI"], auth_token="s3cret")
        assert header["count"] == 1 and len(payloads[0]) == H * W
    finally:
        srv.stop()


def test_tls_requires_tcp_and_pairing(server):
    _, _, params = server
    with pytest.raises(ValueError, match="together"):
        RenderServer(params, MCFG, tcp=("127.0.0.1", 0), tls_cert="c.pem")
    with pytest.raises(ValueError, match="TCP"):
        RenderServer(params, MCFG, tls_cert="c.pem", tls_key="k.pem")


def test_rle_codec_matches_jax():
    from ai_font_renderer_tpu.render import server as jserver
    from ai_font_renderer_tpu_torch.render.server import rle_decode, rle_encode

    rng = np.random.default_rng(0)
    for arr in (np.full((4, 80, 240), 255, np.uint8), rng.integers(0, 256, (2, 8, 8)).astype(np.uint8)):
        blob = rle_encode(arr)
        assert blob == jserver.rle_encode(arr)
        np.testing.assert_array_equal(rle_decode(blob), arr.reshape(-1))
