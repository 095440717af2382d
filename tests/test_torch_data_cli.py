"""The port's data and weight entry points against the JAX package's, on the
CPU: ``fontgen``, the disk loader, ground-truth synthesis, ``eval``, and
``.pth`` weights.

The JAX side is always run with a cache directory of this module's own
(its default ``.cache`` is shared by every test process and written in
place), so its ``fontgen`` runs with its two cached bakers pointed there.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_font_renderer_tpu import cli as jax_cli
from ai_font_renderer_tpu import config as jcfg
from ai_font_renderer_tpu import fontgen as jfg
from ai_font_renderer_tpu.fontgen import dataset as jds
from ai_font_renderer_tpu.fontgen import proportional as jprop
from ai_font_renderer_tpu.models import font_renderer as jfr
from ai_font_renderer_tpu.render import render_batch as jax_render_batch
from ai_font_renderer_tpu.train.step import eval_epoch as jax_eval_epoch
from ai_font_renderer_tpu.utils import torch_interop as jti
from ai_font_renderer_tpu.utils.checkpoint import load_params_with_config as jax_load
from ai_font_renderer_tpu_torch import cli
from ai_font_renderer_tpu_torch.config import FIRACODE_PATH, MONTSERRAT_PATH, ModelConfig, SheetSpec
from ai_font_renderer_tpu_torch.fontgen import bake_atlas, bake_prop_atlas
from ai_font_renderer_tpu_torch.fontgen import dataset as tds
from ai_font_renderer_tpu_torch.models import font_renderer as tfr
from ai_font_renderer_tpu_torch.utils import torch_interop as tti
from ai_font_renderer_tpu_torch.utils.checkpoint import load_params_with_config, save_params

SMALL_SPEC = dict(width=60, height=20, max_chars=24)
# The narrowed model of tests/test_torch_cli.py.
TINY = ModelConfig(max_length=16, hidden_dim=16, sheet_height=16, sheet_width=24)
# tests/test_torch_model.py's forward bound for the default (bf16 products)
# configuration: sheets within 1e-4 of the JAX package's.
FORWARD_ATOL = 1e-4
FONTS = {"firacode": FIRACODE_PATH, "montserrat": MONTSERRAT_PATH}


@pytest.fixture(scope="module")
def jax_cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("jax_cache"))


def _files(d) -> dict:
    return {name: open(os.path.join(d, name), "rb").read() for name in sorted(os.listdir(d))}


@pytest.mark.parametrize("name,n", [("firacode", 4), ("montserrat", 2)])
def test_fontgen_files_are_byte_equal_to_jax(name, n, tmp_path, jax_cache, monkeypatch):
    """data.txt, every BMP and dataset_metadata.txt, byte for byte."""
    monkeypatch.setattr(jfg, "bake_atlas", functools.partial(jfg.bake_atlas, cache_dir=jax_cache))
    monkeypatch.setattr(jds, "build_layouts", functools.partial(jds.build_layouts, cache_dir=jax_cache))
    font = FONTS[name]
    assert cli.main(["fontgen", "--num-samples", str(n), "--out", str(tmp_path / "t"), "--font", font,
                     "--device", "cpu"]) == 0
    args = type("Args", (), dict(num_samples=n, out=str(tmp_path / "j"), font=font))
    assert jax_cli.cmd_fontgen(args) == 0
    got, want = _files(tmp_path / "t"), _files(tmp_path / "j")
    assert sorted(got) == sorted(want) == sorted(
        [f"{i}.bmp" for i in range(1, n + 1)] + ["data.txt", "dataset_metadata.txt"]
    )
    for k in want:
        assert got[k] == want[k], k
    assert got["data.txt"].decode() == "\n".join(jfg.generate_corpus(n))


def test_fontgen_refuses_without_a_card_before_writing(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the rule is about its absence")
    assert cli.main(["fontgen", "--num-samples", "2", "--out", str(tmp_path / "o")]) == 1
    assert "device='cpu'" in capsys.readouterr().out
    assert not os.path.exists(tmp_path / "o")


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("fontgen") / "train_input")
    assert cli.main(["fontgen", "--num-samples", "5", "--out", out, "--device", "cpu"]) == 0
    return out


def test_disk_loader_equals_jax(exported):
    """load_string_dataset and device_dataset_from_disk read the exported
    directory as the JAX package's do; the u8 targets equal the device
    dataset's (tests/test_dataset.py:test_disk_roundtrip_matches_device)."""
    codes, targets = tds.load_string_dataset(exported, 5)
    jcodes, jtargets = jds.load_string_dataset(exported, 5)
    np.testing.assert_array_equal(codes, jcodes)
    np.testing.assert_array_equal(targets, jtargets)
    ds = tds.device_dataset_from_disk(exported, 5, device="cpu")
    jds_disk = jds.device_dataset_from_disk(exported, 5)
    np.testing.assert_array_equal(ds.codes.numpy(), np.asarray(jds_disk.codes))
    np.testing.assert_array_equal(ds.targets_u8.numpy(), np.asarray(jds_disk.targets_u8))
    built = tds.build_device_dataset(bake_atlas(FIRACODE_PATH), 5, device="cpu")
    np.testing.assert_array_equal(ds.targets_u8.numpy(), built.targets_u8.numpy())
    np.testing.assert_array_equal(ds.codes.numpy(), built.codes.numpy())


def test_disk_loader_error_contracts_equal_jax(tmp_path):
    """tests/test_dataset.py:test_loader_error_contracts on both packages:
    the same exception types and messages."""
    d = tmp_path / "data"
    d.mkdir()
    (d / "data.txt").write_text("ONE\nTWO\n")
    for n, exc in ((5, ValueError), (2, FileNotFoundError)):
        with pytest.raises(exc) as got:
            tds.load_string_dataset(str(d), n)
        with pytest.raises(exc) as want:
            jds.load_string_dataset(str(d), n)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="Not enough strings"):
        tds.device_dataset_from_disk(str(d), 5, device="cpu")


@pytest.fixture(scope="module")
def atlases(jax_cache):
    """Both atlas types at a small sheet, port's and JAX's."""
    return {
        "glyph": (bake_atlas(FIRACODE_PATH, SheetSpec(**SMALL_SPEC)),
                  jfg.bake_atlas(jcfg.FIRACODE_PATH, jcfg.SheetSpec(**SMALL_SPEC), cache_dir=jax_cache)),
        "prop": (bake_prop_atlas(MONTSERRAT_PATH, SheetSpec(**SMALL_SPEC)),
                 jprop.bake_prop_atlas(jcfg.MONTSERRAT_PATH, jcfg.SheetSpec(**SMALL_SPEC))),
    }


@pytest.mark.parametrize("kind", ["glyph", "prop"])
def test_synthesize_ground_truth_equals_jax(kind, atlases):
    """The host oracle bit for bit; on the device (here the CPU, chunks of
    4 so the last is short) on the 8-bit grid: u8 equal."""
    got_atlas, want_atlas = atlases[kind]
    strings = cli.TEST_STRINGS + ["", "AV WA TO"]
    host = tds.synthesize_ground_truth(got_atlas, strings)
    np.testing.assert_array_equal(host, jds.synthesize_ground_truth(want_atlas, strings))
    dev = tds.synthesize_ground_truth(got_atlas, strings, on_device=True, synth_batch=4, device="cpu")
    want_dev = jds.synthesize_ground_truth(want_atlas, strings, on_device=True, synth_batch=4)
    assert dev.shape == host.shape == (len(strings), 20, 60) and dev.dtype == np.float32
    for other in (host, want_dev):
        np.testing.assert_array_equal(np.round(dev * 255), np.round(other * 255))
    np.testing.assert_array_equal(tds.unit_ground_truth(got_atlas, strings), host)


@pytest.fixture(scope="module")
def tiny_weights(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("w") / "font_renderer.npz")
    save_params(tfr.init(torch.Generator().manual_seed(0), TINY, "cpu"), path, TINY)
    return path


def _jax_eval(weights, n, font, jax_cache):
    """eval's quantities by the JAX package's functions: the val split of
    an n-sample corpus at the model's sheet, eval_epoch, the test strings'
    ground truth and render_batch."""
    params, mcfg = jax_load(weights)
    spec = jcfg.SheetSpec(width=mcfg.sheet_width, height=mcfg.sheet_height, max_chars=mcfg.max_length)
    train_size, _ = jds.split_sizes(n, 0.2)
    val_idx = jds.split_permutation(n, 42)[train_size:].astype(np.int32)
    if font == FIRACODE_PATH:
        atlas = jfg.bake_atlas(font, spec, cache_dir=jax_cache)
        ds = jds.build_device_dataset(atlas, n, subset=val_idx, cache_dir=jax_cache)
    else:
        atlas = jprop.bake_prop_atlas(font, spec)
        full = jds.build_device_dataset_prop(atlas, n)
        ds = jds.DeviceDataset(codes=full.codes[val_idx], targets_u8=full.targets_u8[val_idx])
    b = min(1024, ds.num_samples)
    steps = ds.num_samples // b
    idx = jnp.arange(steps * b, dtype=jnp.int32).reshape(steps, b)
    mse = float(jax_eval_epoch(params, ds.codes, ds.targets_u8, idx, jnp.ones((steps, b), jnp.float32), mcfg))
    gt = jds.synthesize_ground_truth(atlas, cli.TEST_STRINGS)
    t_mse = float(np.mean((jax_render_batch(params, cli.TEST_STRINGS, mcfg) - gt) ** 2))
    return mse, t_mse, steps * b


@pytest.mark.parametrize("name", list(FONTS))
def test_eval_json_matches_jax(name, tiny_weights, jax_cache, capsys):
    """eval on the narrowed model: JAX's six keys; val_samples equal; the
    MSEs within what the forward bound allows: |d mse| <= 2 * 1e-4 *
    sqrt(mse) + 1e-4^2 (Cauchy-Schwarz), plus the JSON's rounding to 8
    places; each PSNR is 10 log10(1 / mse) of its own MSE to 0.01."""
    font = FONTS[name]
    capsys.readouterr()
    assert cli.main(["eval", "--weights", tiny_weights, "--num-samples", "40", "--font", font,
                     "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    got = json.loads(line)
    assert list(got) == ["val_mse", "val_psnr_db", "val_samples", "test_strings_mse", "test_strings_psnr_db",
                         "weights"]
    mse, t_mse, n_val = _jax_eval(tiny_weights, 40, font, jax_cache)
    assert got["val_samples"] == n_val == 8 and got["weights"] == tiny_weights
    for key, want in (("val_mse", mse), ("test_strings_mse", t_mse)):
        bound = 2 * FORWARD_ATOL * want**0.5 + FORWARD_ATOL**2 + 1e-8
        assert abs(got[key] - want) <= bound, (key, got[key], want)
        psnr = got[key.replace("mse", "psnr_db")]
        assert abs(psnr - 10 * np.log10(1 / got[key])) <= 0.01
    assert 0 < got["val_mse"] < 1 and 0 < got["test_strings_mse"] < 1


def test_eval_kernels_flag_sets_only_the_projection_kernel(tiny_weights, capsys, monkeypatch):
    """--kernels output: use_pallas_output on, nothing else; on the CPU K1's
    plain version, within the forward bound of the plain path."""
    seen = []
    apply = tfr.apply
    monkeypatch.setattr(tfr, "apply", lambda p, c, m, **kw: seen.append(m) or apply(p, c, m, **kw))
    runs = {}
    for kernels in ("none", "output"):
        capsys.readouterr()
        assert cli.main(["eval", "--weights", tiny_weights, "--num-samples", "40", "--kernels", kernels,
                         "--device", "cpu"]) == 0
        runs[kernels] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {m.use_pallas_output for m in seen} == {False, True}
    assert not any(m.fused_attention or m.fused_attention_v2 for m in seen)
    bound = 2 * FORWARD_ATOL * runs["none"]["val_mse"] ** 0.5 + FORWARD_ATOL**2 + 1e-8
    assert abs(runs["output"]["val_mse"] - runs["none"]["val_mse"]) <= bound


def test_eval_missing_weights_exits_1(tmp_path, capsys):
    assert cli.main(["eval", "--weights", str(tmp_path / "none.npz"), "--device", "cpu"]) == 1
    assert "not found" in capsys.readouterr().out


@pytest.fixture(scope="module")
def jax_params():
    return {k: np.asarray(v) for k, v in jfr.init(jax.random.PRNGKey(0), jcfg.ModelConfig(max_length=16,
                                                                                           hidden_dim=16)).items()}


def test_pth_written_by_the_port_loads_in_jax(jax_params, tmp_path):
    params = tfr.params_from_jax(jax_params, "cpu")
    path = str(tmp_path / "port.pth")
    tti.save_pth(params, path)
    back = jti.load_pth(path)
    assert sorted(back) == sorted(jax_params)
    for k, v in jax_params.items():
        np.testing.assert_array_equal(np.asarray(back[k]), v, err_msg=k)
    sd, jsd = tti.to_state_dict(params), jti.to_state_dict(jax_params)
    assert list(sd) == list(jsd)
    for k in jsd:
        assert sd[k].is_contiguous() and torch.equal(sd[k], jsd[k]), k


def test_pth_written_by_jax_loads_in_the_port(jax_params, tmp_path):
    path = str(tmp_path / "jax.pth")
    jti.save_pth({k: jnp.asarray(v) for k, v in jax_params.items()}, path)
    got = tti.load_pth(path, device="cpu")
    assert sorted(got) == sorted(jax_params)
    for k, v in jax_params.items():
        assert got[k].dtype == torch.float32 and got[k].is_contiguous()
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    params, mcfg = load_params_with_config(path, device="cpu")
    _, jmcfg = jax_load(path)
    assert (mcfg.max_length, mcfg.hidden_dim, mcfg.embedding_dim, mcfg.num_heads) == (
        jmcfg.max_length, jmcfg.hidden_dim, jmcfg.embedding_dim, jmcfg.num_heads) == (16, 16, 32, 4)


def test_pth_refuses_a_dict_without_the_linear_decoder(jax_params):
    with pytest.raises(ValueError, match="linear-decoder"):
        tti.to_state_dict({k: v for k, v in jax_params.items() if k != "out_w"})
    sd = jti.to_state_dict(jax_params)
    sd["attention.in_proj_weight"] = sd["attention.in_proj_weight"][:64]
    with pytest.raises(ValueError, match="3E, E"):
        tti.from_state_dict(sd, device="cpu")


def test_render_from_pth_equals_the_npz_render(jax_params, tmp_path):
    """render --weights x.pth --device cpu writes the same BMPs as from the
    npz of the same weights (the .pth holds no config; the shapes give it)."""
    params = tfr.params_from_jax(jax_params, "cpu")
    save_params(params, str(tmp_path / "w.pth"))
    save_params(params, str(tmp_path / "w.npz"), ModelConfig(max_length=16, hidden_dim=16))
    for ext in ("pth", "npz"):
        assert cli.main(["render", "HELLO", "WORLD WIDE", "--weights", str(tmp_path / f"w.{ext}"),
                         "--out", str(tmp_path / ext), "--device", "cpu"]) == 0
    got, want = _files(tmp_path / "pth"), _files(tmp_path / "npz")
    assert sorted(got) == ["string_0.bmp", "string_1.bmp"] and got == want
