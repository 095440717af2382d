"""The port's int8 serving (ai_font_renderer_tpu_torch/ops/quantized.py)
against the JAX package's ops/quantized.py on the CPU: the int8 weights and
activations byte for byte, the int32 accumulators exactly, the sheets to
1e-6; the render dispatch, the server and the CLI's --int8. Inputs come
from numpy seeds; parameters are JAX-initialised."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_font_renderer_tpu import config as jcfg
from ai_font_renderer_tpu.models import font_renderer as jfr
from ai_font_renderer_tpu.ops import quantized as jq
from ai_font_renderer_tpu_torch import cli
from ai_font_renderer_tpu_torch import config as tcfg
from ai_font_renderer_tpu_torch.fontgen.bmp import read_bmp
from ai_font_renderer_tpu_torch.models import font_renderer as tfr
from ai_font_renderer_tpu_torch.ops import quantized as tq
from ai_font_renderer_tpu_torch.render import render_atlas, render_batch, render_batch_u8_async
from ai_font_renderer_tpu_torch.render.server import RenderServer, request_render
from ai_font_renderer_tpu_torch.utils.checkpoint import save_params
from test_torch_native_build import install_reference_native

install_reference_native()

SMALL = dict(max_length=16, hidden_dim=16, sheet_height=16, sheet_width=24)
SHEET_ATOL = 1e-6


def _rng(seed):
    return np.random.default_rng(seed)


def _codes(bsz, length=16, seed=0):
    return _rng(seed).integers(32, 127, (bsz, length)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_params():
    return {k: np.asarray(v) for k, v in jfr.init(jax.random.PRNGKey(1), jcfg.ModelConfig(**SMALL)).items()}


@pytest.fixture(scope="module")
def port_params(jax_params):
    return tfr.params_from_jax(jax_params, "cpu")


def _i8(x):
    return np.asarray(x).view(np.int8)


# --- the quantizers ---------------------------------------------------------


WEIGHT_CASES = {
    "normal": lambda: _rng(0).standard_normal((128, 64)).astype(np.float32) * 0.01,
    "wide_range": lambda: (_rng(1).standard_normal((256, 40)) * np.logspace(-6, 2, 40)).astype(np.float32),
    # A zero column: its scale is the 1e-12 floor and its weights stay 0.
    "zero_column": lambda: np.concatenate([_rng(2).uniform(-1, 1, (64, 7)), np.zeros((64, 1))], 1).astype(
        np.float32),
    # Exact ties: max 127 gives s = 1, so w / s lands on .5 and rounds to even.
    "ties": lambda: np.array([[127.0, 0.5, -2.5], [1.5, -127.0, 3.5], [-0.5, 2.5, 127.0]], np.float32),
}


@pytest.mark.parametrize("case", list(WEIGHT_CASES))
def test_quantize_weights_is_byte_equal_to_jax(case):
    w = WEIGHT_CASES[case]()
    jw, js = jq.quantize_weights(jnp.asarray(w))
    tw, ts = tq.quantize_weights(torch.from_numpy(w))
    assert tw.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tw.numpy(), _i8(jw))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


ACT_CASES = {
    "relu_features": lambda: np.maximum(_rng(3).standard_normal((8, 640)), 0).astype(np.float32),
    "signed": lambda: (_rng(4).standard_normal((5, 96)) * 3).astype(np.float32),
    "zero_row": lambda: np.concatenate([_rng(5).uniform(0, 2, (3, 64)), np.zeros((1, 64))]).astype(np.float32),
    "ties": lambda: np.array([[127.0, 0.5, 1.5, 2.5, -3.5], [-127.0, 4.5, -5.5, 6.5, 0.0]], np.float32),
}


@pytest.mark.parametrize("case", list(ACT_CASES))
def test_quantize_activations_is_byte_equal_to_jax(case):
    x = ACT_CASES[case]()
    ja, js = jq.quantize_activations(jnp.asarray(x))
    ta, ts = tq.quantize_activations(torch.from_numpy(x))
    np.testing.assert_array_equal(ta.numpy(), _i8(ja))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_rounding_is_half_to_even():
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5]])
    a_q, s = tq.quantize_activations(x)
    assert float(s) == 1.0 and a_q.tolist() == [[127, 0, 2, 2, 0, -2]]


# --- the product ------------------------------------------------------------


@pytest.mark.parametrize("m", [3, 15, 17, 64])
def test_int32_accumulators_equal_jax(m):
    """The plain product (f64 sums cast to int32) against JAX's
    lax.dot_general with int32 accumulation, on the same int8 operands."""
    a = _rng(10 + m).integers(-127, 128, (m, 640)).astype(np.int8)
    w = _rng(20 + m).integers(-127, 128, (640, 96)).astype(np.int8)
    want = np.asarray(jax.lax.dot_general(jnp.asarray(a), jnp.asarray(w), (((1,), (0,)), ((), ())),
                                          preferred_element_type=jnp.int32))
    got = tq.int8_product(torch.from_numpy(a), torch.from_numpy(w))
    assert got.dtype == torch.int32 and got.shape == (m, 96)
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_product_is_exact_at_the_largest_accumulator():
    """127 * 127 * 6400 = 103,225,600 needs 27 bits, more than f32's 24:
    the f64 sums keep every unit, one term's sign or size changed too."""
    k = 6400
    a = torch.full((2, k), 127, dtype=torch.int8)
    a[1, 0] = -127
    w = torch.full((k, 8), 127, dtype=torch.int8)
    w[1, 3] = 126
    acc = tq.int8_product_reference(a, w)
    want = np.full((2, 8), 127 * 127 * k, np.int64)
    want[1] -= 2 * 127 * 127
    want[:, 3] -= 127
    np.testing.assert_array_equal(acc.numpy().astype(np.int64), want)


def test_cpu_product_counts_no_launch():
    before = tq.int8_product.launches
    tq.int8_product(torch.ones((3, 8), dtype=torch.int8), torch.ones((8, 8), dtype=torch.int8))
    assert tq.int8_product.launches == before


def test_column_major_copy_is_made_once_per_version():
    w = torch.arange(48, dtype=torch.int8).reshape(8, 6)
    c1 = tq._col_major(w)
    assert c1.stride() == (1, 8) and torch.equal(c1, w)
    assert tq._col_major(w) is c1
    assert tq._col_major(c1) is c1  # already column-major: no copy
    w.add_(1)
    c2 = tq._col_major(w)
    assert c2 is not c1 and torch.equal(c2, w)


# --- outputs and the forward ------------------------------------------------


@pytest.mark.parametrize("int8_acts", [True, False], ids=["int8_x_int8", "bf16_x_int8"])
def test_quantized_output_matches_jax(int8_acts):
    flat = np.maximum(_rng(30).standard_normal((7, 256)), 0).astype(np.float32)
    w = (_rng(31).standard_normal((256, 120)) * 0.05).astype(np.float32)
    b = (_rng(32).standard_normal(120) * 0.1 + 0.5).astype(np.float32)
    jw, js = jq.quantize_weights(jnp.asarray(w))
    tw, ts = tq.quantize_weights(torch.from_numpy(w))
    jfn, tfn = (jq.quantized_output_int8, tq.quantized_output_int8) if int8_acts else (
        jq.quantized_output, tq.quantized_output)
    want = np.asarray(jfn(jnp.asarray(flat), jw, js, jnp.asarray(b)))
    got = tfn(torch.from_numpy(flat), tw, ts, torch.from_numpy(b)).numpy()
    assert 0 < (want > 0).mean() < 1
    assert float(np.abs(got - want).max()) <= SHEET_ATOL


def test_quantize_params_keys_match_jax(jax_params, port_params):
    want = jq.quantize_params({k: jnp.asarray(v) for k, v in jax_params.items()})
    got = tq.quantize_params(port_params)
    assert list(got) == list(want)
    assert "out_w" not in got and got["out_w_q"].dtype == torch.int8
    np.testing.assert_array_equal(got["out_w_q"].numpy(), _i8(want["out_w_q"]))
    np.testing.assert_array_equal(got["out_w_scale"].numpy(), np.asarray(want["out_w_scale"]))
    assert got["out_w_q"].numel() == port_params["out_w"].numel()


def test_quantize_params_refuses_a_conv_dict_as_jax():
    jm = jcfg.ModelConfig(decoder="conv_ps", max_length=16, hidden_dim=16, sheet_height=16, sheet_width=24,
                          decoder_grid=(4, 4))
    params = {k: np.asarray(v) for k, v in jfr.init(jax.random.PRNGKey(0), jm).items()}
    with pytest.raises(ValueError, match="quantizes the linear decoder's out_w") as jerr:
        jq.quantize_params(params)
    with pytest.raises(ValueError, match="quantizes the linear decoder's out_w") as terr:
        tq.quantize_params(tfr.params_from_jax(params, "cpu"))
    assert str(terr.value) == str(jerr.value)


FORWARD_FLAGS = {"plain": {}, "fused_attention": dict(fused_attention=True), "f32": dict(bf16_matmul=False)}


@pytest.mark.parametrize("flags", list(FORWARD_FLAGS))
def test_apply_quantized_int8_matches_jax(flags, jax_params, port_params):
    """The int8 forward from codes to sheets: the frontend (with the f32
    attention, K5's plain version here, JAX's Pallas kernel in interpret
    mode), then the int8 x int8 projection. Batch 8, a multiple of the JAX
    kernel's tile."""
    kw = {**SMALL, **FORWARD_FLAGS[flags]}
    codes = _codes(8)
    jserved = jq.quantize_params({k: jnp.asarray(v) for k, v in jax_params.items()})
    want = np.asarray(jq.apply_quantized_int8(jserved, jnp.asarray(codes), jcfg.ModelConfig(**kw)))
    got = tq.apply_quantized_int8(tq.quantize_params(port_params), torch.from_numpy(codes), tcfg.ModelConfig(**kw))
    assert got.shape == (8, 16, 24)
    assert float(np.abs(got.numpy() - want).max()) <= SHEET_ATOL


def test_apply_quantized_bf16_activations_matches_jax(jax_params, port_params):
    codes = _codes(6, seed=1)
    jserved = jq.quantize_params({k: jnp.asarray(v) for k, v in jax_params.items()})
    want = np.asarray(jq.apply_quantized(jserved, jnp.asarray(codes), jcfg.ModelConfig(**SMALL)))
    got = tq.apply_quantized(tq.quantize_params(port_params), torch.from_numpy(codes), tcfg.ModelConfig(**SMALL))
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5


def test_int8_sheets_stay_within_the_jax_packages_bounds_of_f32(port_params):
    """tests/test_quantized.py:56-57's bounds on the port: 4/255 max and
    0.5/255 mean from the full-precision render."""
    mcfg = tcfg.ModelConfig(**SMALL)
    codes = torch.from_numpy(_rng(2).integers(65, 91, (8, 16)).astype(np.int32))
    full = tfr.apply(port_params, codes, mcfg)
    q = tq.apply_quantized_int8(tq.quantize_params(port_params), codes, mcfg)
    assert float((q - full).abs().max()) < 4 / 255 and float((q - full).abs().mean()) < 0.5 / 255


@pytest.mark.parametrize("seed", [0, 1])
def test_int8_sheets_stay_within_the_quantization_bound(seed, port_params):
    """Each pixel of the int8 forward lies within int8_error_bound of the
    forward with exact f32 products (plus 1e-5 for f32 sums), and the
    bound is no vacuous one: its largest value stays below 0.5."""
    mcfg = tcfg.ModelConfig(bf16_matmul=False, **SMALL)
    codes = torch.from_numpy(_codes(8, seed=seed))
    served = tq.quantize_params(port_params)
    flat = tfr.frontend(port_params, codes, mcfg)
    bound = tq.int8_error_bound(flat, port_params["out_w"], served["out_w_scale"]).reshape(8, 16, 24)
    diff = (tq.apply_quantized_int8(served, codes, mcfg) - tfr.apply(port_params, codes, mcfg)).abs()
    assert float((diff - bound).max()) <= 1e-5 and float(bound.max()) < 0.5
    assert float(diff.max()) > 0


# --- render, serve, CLI -----------------------------------------------------


def test_render_dispatches_on_out_w_q(jax_params, port_params):
    """render_batch, render_batch_u8_async and render_atlas take an int8
    dict to the int8 forward, equal to the JAX package's render_batch."""
    from ai_font_renderer_tpu.render.render import render_batch as jax_render_batch

    mcfg = tcfg.ModelConfig(**SMALL)
    served = tq.quantize_params(port_params)
    strings = ["HELLO", "INT8 SERVING", "", "WWWWWWWWWWWWWWWWWWWW"]
    sheets = render_batch(served, strings, mcfg)
    jserved = jq.quantize_params({k: jnp.asarray(v) for k, v in jax_params.items()})
    want = jax_render_batch(jserved, strings, jcfg.ModelConfig(**SMALL))
    assert float(np.abs(sheets - want).max()) <= SHEET_ATOL
    u8 = render_batch_u8_async(served, strings, mcfg).numpy()
    np.testing.assert_array_equal(u8, np.round(sheets * 255).astype(np.uint8))
    atlas = render_atlas(served, strings * 3, mcfg, chunk=5).numpy()
    assert atlas.shape == (12, 16, 24)
    np.testing.assert_allclose(atlas[:4], sheets, rtol=0, atol=SHEET_ATOL)


def test_int8_server_replies_equal_a_direct_int8_render(port_params, tmp_path):
    """RenderServer(int8=True) quantizes the f32 dict once; its replies
    equal the direct int8 render byte for byte."""
    mcfg = tcfg.ModelConfig(**SMALL)
    sock = str(tmp_path / "afr.sock")
    srv = RenderServer(port_params, mcfg, socket_path=sock, batch_size=4, int8=True)
    srv.start()
    try:
        strings = ["HELLO", "SERVE ME", "", "INT8", "A LONGER STRING"]
        header, payloads = request_render(sock, strings)
    finally:
        srv.stop()
    got = np.stack([np.frombuffer(p, np.uint8).reshape(16, 24) for p in payloads])
    want = render_batch_u8_async(tq.quantize_params(port_params), strings, mcfg).numpy()
    assert header["count"] == 5
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def weights(jax_params, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("w") / "font_renderer.npz")
    save_params(tfr.params_from_jax(jax_params, "cpu"), path, tcfg.ModelConfig(**SMALL))
    return path


def test_render_int8_cli_writes_the_int8_sheets(weights, jax_params, tmp_path):
    """render --int8: the BMPs of the int8 render, within one gray level of
    the JAX package's render --int8 sheets."""
    from ai_font_renderer_tpu.render.render import render_batch as jax_render_batch

    out = str(tmp_path / "r")
    assert cli.main(["render", "HELLO", "INT8", "--weights", weights, "--out", out, "--int8", "--device", "cpu"]) == 0
    jserved = jq.quantize_params({k: jnp.asarray(v) for k, v in jax_params.items()})
    want = np.round(np.clip(jax_render_batch(jserved, ["HELLO", "INT8"], jcfg.ModelConfig(**SMALL)), 0, 1) * 255)
    for i in range(2):
        got = np.round(read_bmp(os.path.join(out, f"string_{i}.bmp")) * 255)
        assert np.abs(got - want[i]).max() <= 1


def test_serve_int8_cli_builds_an_int8_server(weights, tmp_path, monkeypatch, capsys):
    """serve --int8 hands int8=True to the server, which serves the int8
    render; the command returns 0 once interrupted."""
    import time

    import ai_font_renderer_tpu_torch.render.server as server_mod

    seen = {}
    cls = server_mod.RenderServer

    class Spy(cls):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            seen["int8"] = kw["int8"]
            seen["server"] = self

        def start(self):
            super().start()
            seen["reply"] = request_render(self.socket_path, ["HELLO"])

    def interrupt(_):
        raise KeyboardInterrupt

    monkeypatch.setattr(server_mod, "RenderServer", Spy)
    monkeypatch.setattr(time, "sleep", interrupt)
    sock = str(tmp_path / "afr.sock")
    assert cli.main(["serve", "--weights", weights, "--int8", "--socket", sock, "--batch-size", "4",
                     "--device", "cpu"]) == 0
    assert seen["int8"] and "Render server listening" in capsys.readouterr().out
    _, payloads = seen["reply"]
    params = tfr.params_from_jax({k: v for k, v in np.load(weights).items() if k != "__config__"}, "cpu")
    want = render_batch_u8_async(tq.quantize_params(params), ["HELLO"], tcfg.ModelConfig(**SMALL)).numpy()
    np.testing.assert_array_equal(np.frombuffer(payloads[0], np.uint8).reshape(16, 24), want[0])


@pytest.mark.parametrize("sub", ["render", "serve"])
def test_int8_of_a_conv_checkpoint_exits_1(sub, tmp_path, capsys):
    mcfg = tcfg.ModelConfig(decoder="conv_ps", decoder_grid=(4, 4), **SMALL)
    path = str(tmp_path / "conv.npz")
    save_params(tfr.init(torch.Generator().manual_seed(0), mcfg, "cpu"), path, mcfg)
    extra = ["--out", str(tmp_path / "r")] if sub == "render" else ["--socket", str(tmp_path / "s.sock")]
    assert cli.main([sub, "--weights", path, "--int8", "--device", "cpu", *extra]) == 1
    assert "quantizes the linear decoder's out_w" in capsys.readouterr().out
