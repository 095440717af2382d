"""The port's weight files and render entry points against the JAX package's,
on the CPU at small widths."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from ai_font_renderer_tpu.config import ModelConfig as JaxModelConfig
from ai_font_renderer_tpu.models import font_renderer as jfr
from ai_font_renderer_tpu.render.render import render_batch as jax_render_batch
from ai_font_renderer_tpu.utils import checkpoint as jckpt
from ai_font_renderer_tpu_torch.config import ModelConfig
from ai_font_renderer_tpu_torch.fontgen.bmp import encode_bmp, read_bmp
from ai_font_renderer_tpu_torch.fontgen.layout import encode_codes
from ai_font_renderer_tpu_torch.models import font_renderer as tfr
from ai_font_renderer_tpu_torch.render import (
    render_atlas,
    render_batch,
    render_batch_u8_async,
    render_strings,
)
from ai_font_renderer_tpu_torch.utils import checkpoint as tckpt

SMALL = dict(max_length=16, hidden_dim=16, sheet_height=16, sheet_width=24)
STRINGS = ["HELLO", "WORLD WIDE", "", "A" * 30]


@pytest.fixture(scope="module")
def jax_pair():
    jc = JaxModelConfig(**SMALL, num_blocks=2, num_heads=2)
    return jfr.init(jax.random.PRNGKey(0), jc), jc


def _asdict(cfg):
    return dataclasses.asdict(cfg)


def test_jax_npz_loads_in_port(jax_pair, tmp_path):
    params, jc = jax_pair
    path = str(tmp_path / "jax.npz")
    jckpt.save_params(params, path, jc)
    got, cfg = tckpt.load_params_with_config(path, device="cpu")
    assert set(got) == set(params)
    for k, v in params.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    _, jcfg_back = jckpt.load_params_with_config(path)
    assert _asdict(cfg) == _asdict(jcfg_back)
    assert cfg.num_heads == 2 and cfg.num_blocks == 2


def test_port_npz_loads_in_jax(jax_pair, tmp_path):
    params, jc = jax_pair
    tc = ModelConfig(**SMALL, num_blocks=2, num_heads=2)
    tparams = tfr.params_from_jax({k: np.asarray(v) for k, v in params.items()}, "cpu")
    path = str(tmp_path / "port.npz")
    tckpt.save_params(tparams, path, tc)
    back, cfg = jckpt.load_params_with_config(path)
    assert set(back) == set(params)
    for k, v in params.items():
        np.testing.assert_array_equal(np.asarray(back[k]), np.asarray(v), err_msg=k)
    assert _asdict(cfg) == _asdict(tckpt.load_params_with_config(path, device="cpu")[1])
    assert _asdict(cfg) == _asdict(jc)


def test_npz_without_config_infers_it(jax_pair, tmp_path):
    params, _ = jax_pair
    path = str(tmp_path / "bare.npz")
    jckpt.save_params(params, path)  # no __config__ entry
    got, cfg = tckpt.load_params_with_config(path, device="cpu")
    _, want = jckpt.load_params_with_config(path)
    assert _asdict(cfg) == _asdict(want)
    params_only, none = tckpt.load_params_with_config(path, base=None, device="cpu")
    assert none is None and params_only.keys() == got.keys()


def test_pth_round_trips_through_save_and_load(tmp_path):
    """A .pth used to be refused. save_params and
    load_params_with_config now dispatch on the name to the reference's
    state_dict (tests/test_torch_data_cli.py holds it against the JAX
    package's): the arrays come back equal and the config from the shapes;
    a dict without the linear decoder has no state_dict."""
    cfg = ModelConfig(max_length=16, hidden_dim=16)
    params = tfr.init(torch.Generator().manual_seed(0), cfg, "cpu")
    path = str(tmp_path / "w.pth")
    tckpt.save_params(params, path, cfg)
    got, mcfg = tckpt.load_params_with_config(path, device="cpu")
    assert sorted(got) == sorted(params) and all(torch.equal(got[k], params[k]) for k in params)
    assert (mcfg.max_length, mcfg.hidden_dim, mcfg.sheet_width) == (16, 16, 240)
    with pytest.raises(ValueError, match="linear-decoder"):
        tckpt.save_params({"a": torch.zeros(1)}, str(tmp_path / "conv.pth"))


@pytest.fixture(scope="module")
def flagship_small():
    jc = JaxModelConfig(**SMALL)
    params = {k: np.asarray(v) for k, v in jfr.init(jax.random.PRNGKey(3), jc).items()}
    return params, jc, ModelConfig(**SMALL)


def test_render_batch_u8_within_one_level_of_jax(flagship_small):
    params, jc, tc = flagship_small
    want = jax_render_batch({k: jax.numpy.asarray(v) for k, v in params.items()}, STRINGS, jc)
    tparams = tfr.params_from_jax(params, "cpu")
    got = render_batch_u8_async(tparams, STRINGS, tc)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (4, 16, 24)
    want_u8 = np.round(np.clip(want, 0, 1) * 255).astype(np.int32)
    assert np.abs(got.numpy().astype(np.int32) - want_u8).max() <= 1
    np.testing.assert_allclose(render_batch(tparams, STRINGS, tc), want, atol=1e-4)


def test_render_strings_writes_bmps_like_jax(flagship_small, tmp_path, capsys):
    params, jc, tc = flagship_small
    tparams = tfr.params_from_jax(params, "cpu")
    paths = render_strings(tparams, STRINGS, str(tmp_path / "out"), tc)
    out = capsys.readouterr().out
    assert "Warning: String truncated to 16 characters: " + "A" * 16 in out
    assert f"Saved 4 rendered strings to {tmp_path / 'out'}/" in out
    assert [os.path.basename(p) for p in paths] == [f"string_{i}.bmp" for i in range(4)]
    want = jax_render_batch({k: jax.numpy.asarray(v) for k, v in params.items()}, STRINGS, jc)
    for i, p in enumerate(paths):
        img = read_bmp(p)
        assert img.shape == (16, 24)
        assert np.abs(img - np.round(np.clip(want[i], 0, 1) * 255) / 255).max() <= 1 / 255 + 1e-6


def test_render_atlas_chunks_match_one_batch(flagship_small):
    params, _, tc = flagship_small
    tparams = tfr.params_from_jax(params, "cpu")
    strings = [f"S{i} ABC" for i in range(11)]
    atlas = render_atlas(tparams, strings, tc, chunk=4)  # 3 chunks, tail padded
    assert tuple(atlas.shape) == (11, 16, 24)
    np.testing.assert_allclose(atlas.numpy(), render_batch(tparams, strings, tc), atol=1e-6)


def test_codec_copies_match_jax():
    """The port's own encode_codes and BMP codec equal the JAX package's."""
    from ai_font_renderer_tpu.fontgen import bmp as jbmp
    from ai_font_renderer_tpu.fontgen.layout import encode_codes as jax_encode

    strings = ["", "HELLO", "é€😀\ud800~", "\x00\x7f\x80 ", "Z" * 40]
    np.testing.assert_array_equal(encode_codes(strings, 16), jax_encode(strings, 16))
    assert encode_codes([], 8).shape == (0, 8)
    sheet = np.random.default_rng(0).random((16, 24)).astype(np.float32)
    blob = encode_bmp(sheet)
    assert blob == jbmp.encode_bmp(sheet)
    np.testing.assert_array_equal(read_bmp(blob), jbmp.read_bmp(blob))


def test_entry_points_refuse_missing_cuda(tmp_path):
    """Without a card, entry points called without device='cpu' raise
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the rule is about its absence")
    tc = ModelConfig(**SMALL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfr.init(torch.Generator(), tc)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfr.params_from_jax({"a": np.zeros(2, np.float32)})
    path = str(tmp_path / "w.npz")
    tckpt.save_params(tfr.init(torch.Generator(), tc, "cpu"), path, tc)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tckpt.load_params_with_config(path)
