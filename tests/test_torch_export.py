"""The port's deployment artifacts (utils/export.py, ``export``, ``render
--exported``, ``serve --exported`` and the standalone runner) on the CPU,
against the port's own render paths and against the JAX package's
``jax.export`` artifacts on the same JAX-initialised parameters.

Tolerances against the JAX package, on the uint8 grid:

- The flagship: one gray level. Both round the same f32 sheet's value to
  the u8 grid; an f32 sum in another order moves a value that lies near a
  half step onto the other side. Measured (printed by the test): no pixel
  differs with the f32 frontend, plain or through the kernels' operators;
  47 of 640 pixels differ by one level with the bf16 frontend (the plain
  bf16 attention rounds in another order than XLA's).
- The neural pipeline, soft decode: two gray levels, the 5e-3 sheet bound
  of tests/test_torch_implicit.py (the structured head's soft x is
  ill-conditioned) plus one rounding. Hard and monotone decodes: one gray
  level (their positions are discrete). Measured: no pixel differs in any
  of the three.

Against the port's own direct renders the artifacts are u8-equal: the same
operators and ops in the same order.
"""

import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_font_renderer_tpu.config import ModelConfig as JaxConfig
from ai_font_renderer_tpu.models import font_renderer as jfr
from ai_font_renderer_tpu.models import placement as jpl
from ai_font_renderer_tpu.models import siren as jsi
from ai_font_renderer_tpu.utils import export as jex
from ai_font_renderer_tpu_torch import cli
from ai_font_renderer_tpu_torch.config import FIRACODE_PATH, ModelConfig, replace
from ai_font_renderer_tpu_torch.fontgen.bmp import read_bmp
from ai_font_renderer_tpu_torch.fontgen.layout import encode_codes
from ai_font_renderer_tpu_torch.models import font_renderer as tfr
from ai_font_renderer_tpu_torch.models.siren import SirenConfig
from ai_font_renderer_tpu_torch.ops.fused_attention import KEYS
from ai_font_renderer_tpu_torch.ops.fused_output import round_bf16
from ai_font_renderer_tpu_torch.ops.quantized import apply_quantized_int8, quantize_params
from ai_font_renderer_tpu_torch.render.implicit_sheet import render_learned_sheets
from ai_font_renderer_tpu_torch.render.render import render_batch
from ai_font_renderer_tpu_torch.utils.checkpoint import save_params, save_siren
from ai_font_renderer_tpu_torch.utils.export import (
    export_neural_render,
    export_render,
    exported_contract,
    load_exported,
    render_exported,
    render_exported_u8,
)
from test_torch_native_build import install_reference_native

install_reference_native()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_KW = dict(embedding_dim=8, num_heads=2, hidden_dim=8, max_length=12, sheet_height=8, sheet_width=16)
TINY = ModelConfig(**TINY_KW)
CHARSET = " ABCDEFGHIJKLMNOPQRSTUVWXYZ"
STRINGS = ["HELLO", "AB", ""]


def _u8(sheets) -> np.ndarray:
    return np.round(np.clip(np.asarray(sheets), 0, 1) * 255).astype(np.int16)


def _port(jax_params) -> dict:
    return tfr.params_from_jax({k: np.asarray(v) for k, v in jax_params.items()}, "cpu")


@pytest.fixture(scope="module")
def jax_params():
    return jfr.init(jax.random.PRNGKey(0), JaxConfig(**TINY_KW))


@pytest.fixture(scope="module")
def tiny_params(jax_params):
    return _port(jax_params)


def _export(params, mcfg, tmp_path, name="tiny.pt2"):
    path = str(tmp_path / name)
    n = export_render(params, mcfg, path, platforms=("cpu",))
    return path, n


@pytest.fixture(scope="module")
def tiny_artifact(tiny_params, tmp_path_factory):
    """(path, bytes) of TINY's artifact, exported for the CPU alone."""
    return _export(tiny_params, TINY, tmp_path_factory.mktemp("artifact"))


def test_roundtrip_matches_render_path(tiny_params, tiny_artifact):
    path, n = tiny_artifact
    assert n == os.path.getsize(path) and n > 0
    artifact = load_exported(path, "cpu")
    assert exported_contract(artifact) == (12, 8, 16)
    got = render_exported(artifact, STRINGS)
    want = render_batch(tiny_params, STRINGS, TINY)
    np.testing.assert_array_equal(_u8(got), _u8(want))


def test_symbolic_batch_dim(tiny_artifact):
    """One artifact serves any batch size (b is symbolic, not baked)."""
    artifact = load_exported(tiny_artifact[0], "cpu")
    for n in (1, 4, 7):
        assert render_exported(artifact, ["X"] * n).shape == (n, 8, 16)


def test_batch_of_one_alone(tiny_params, tiny_artifact):
    """Batch 1 (which torch.export specialises when it is the example) on
    a freshly loaded artifact, u8-equal to the direct render."""
    artifact = load_exported(tiny_artifact[0], "cpu")
    got = render_exported(artifact, ["ONE"])
    np.testing.assert_array_equal(_u8(got), _u8(render_batch(tiny_params, ["ONE"], TINY)))


def test_int8_params_export(tiny_params, tiny_artifact, tmp_path):
    """The quantized serving bundle exports too, smaller, and renders
    u8-equal to the port's direct int8 forward."""
    n_f32 = tiny_artifact[1]
    served = quantize_params(tiny_params)
    path, n_i8 = _export(served, TINY, tmp_path, "i8.pt2")
    assert n_i8 < n_f32
    artifact = load_exported(path, "cpu")
    assert artifact.operators == ("afr::int8_product",)
    got = render_exported(artifact, ["HELLO"])
    codes = torch.from_numpy(encode_codes(["HELLO"], TINY.max_length))
    want = apply_quantized_int8(served, codes, TINY)
    np.testing.assert_array_equal(_u8(got), _u8(want))


def test_cli_export_then_render(tiny_params, tmp_path):
    """``export`` then ``render --exported``: no weights for the render."""
    weights = str(tmp_path / "w.npz")
    save_params(tiny_params, weights, mcfg=TINY)
    artifact = str(tmp_path / "w.pt2")
    rc = cli.main(["export", "--weights", weights, "--out", artifact, "--platforms", "cpu", "--device", "cpu"])
    assert rc == 0 and os.path.exists(artifact)
    out = str(tmp_path / "renders")
    assert cli.main(["render", "HI", "--exported", artifact, "--out", out, "--device", "cpu"]) == 0
    assert read_bmp(os.path.join(out, "string_0.bmp")).shape == (8, 16)


def test_conv_ps_decoder_exports(tmp_path):
    """A conv_ps decoder at its default width exports and matches its
    render path."""
    cfg = ModelConfig(decoder="conv_ps")
    params = _port(jfr.init(jax.random.PRNGKey(1), JaxConfig(decoder="conv_ps")))
    path, _ = _export(params, cfg, tmp_path, "convps.pt2")
    artifact = load_exported(path, "cpu")
    assert exported_contract(artifact) == (100, 80, 240)
    got = render_exported(artifact, ["CONV PS"])
    np.testing.assert_array_equal(_u8(got), _u8(render_batch(params, ["CONV PS"], cfg)))


def test_standalone_runner_needs_no_framework(tiny_artifact, tmp_path):
    """The standalone runner renders from a no-kernel artifact in a
    subprocess where the port is not importable: the artifact plus torch
    and numpy, nothing else."""
    path = tiny_artifact[0]
    tool = os.path.join(ROOT, "ai_font_renderer_tpu_torch", "tools", "run_exported_standalone.py")
    env = {"PATH": os.environ.get("PATH", ""), "HOME": os.environ.get("HOME", str(tmp_path))}
    probe = subprocess.run([sys.executable, "-c", "import ai_font_renderer_tpu_torch"],
                           env=env, cwd=str(tmp_path), capture_output=True)
    assert probe.returncode != 0, "the package must be masked for this test"
    out_dir = str(tmp_path / "standalone")
    res = subprocess.run([sys.executable, tool, path, out_dir, "HI", "YO", "--device", "cpu"],
                         env=env, cwd=str(tmp_path), capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    want = render_exported(load_exported(path, "cpu"), ["HI", "YO"])
    for i in range(2):
        np.testing.assert_array_equal(read_bmp(os.path.join(out_dir, f"string_{i}.bmp")), want[i])


def _tiny_neural(lines=0):
    jscfg = jsi.SirenConfig(n_chars=len(CHARSET), cell=16, embed_dim=8, hidden_dim=16, n_layers=2)
    jsp = jsi.init(jax.random.PRNGKey(2), jscfg)
    jpp = jpl.init(jax.random.PRNGKey(3), JaxConfig(**TINY_KW), lines=lines)
    scfg = SirenConfig(n_chars=len(CHARSET), cell=16, embed_dim=8, hidden_dim=16, n_layers=2)
    return jpp, jsp, jscfg, _port(jpp), _port(jsp), scfg


@pytest.fixture(scope="module")
def neural_artifact(tmp_path_factory):
    """(path, bytes, (pp, sp, scfg)) of the tiny soft-decode pipeline."""
    *_, pp, sp, scfg = _tiny_neural()
    path = str(tmp_path_factory.mktemp("neural") / "neural.pt2")
    n = export_neural_render(pp, TINY, sp, scfg, CHARSET, FIRACODE_PATH, path, platforms=("cpu",))
    return path, n, (pp, sp, scfg)


def test_neural_export_matches_learned_render(neural_artifact):
    """The fully neural pipeline exports to the same contract and matches
    render_learned_sheets on the u8 grid, at other batch sizes too."""
    path, n, (pp, sp, scfg) = neural_artifact
    assert n == os.path.getsize(path) and n > 0
    artifact = load_exported(path, "cpu")
    assert exported_contract(artifact) == (TINY.max_length, 80, 240)
    strings = ["HELLO", "AB A", ""]
    got = render_exported(artifact, strings)
    want = render_learned_sheets(sp, pp, strings, FIRACODE_PATH, scfg, TINY, charset=CHARSET)
    np.testing.assert_array_equal(_u8(got), _u8(want))
    assert render_exported(artifact, ["X"] * 5).shape == (5, 80, 240)


def test_neural_export_feeds_at_most_one_compose_chunk_a_call(neural_artifact):
    """The artifact composes its whole batch at once, so a call feeds it at
    most its sheets_per_call; a batch of several calls equals their parts."""
    artifact = load_exported(neural_artifact[0], "cpu")
    assert artifact.sheets_per_call >= 1
    strings = ["AB", "CD", "EF", "GH", "IJ"]
    whole = render_exported_u8(artifact, strings)
    artifact.sheets_per_call = 2
    sizes = []
    module = artifact.module
    artifact.module = lambda codes: sizes.append(codes.shape[0]) or module(codes)
    assert torch.equal(render_exported_u8(artifact, strings), whole)
    assert sizes == [2, 2, 1]


def test_neural_export_cli_with_monotone_decode(tmp_path):
    """``export --placement --implicit --monotone-placement`` bakes the
    line head's Viterbi decode; ``render --exported`` runs it."""
    *_, pp, sp, scfg = _tiny_neural(lines=4)
    pnpz, snpz = str(tmp_path / "place.npz"), str(tmp_path / "bank.npz")
    save_params(pp, pnpz, mcfg=TINY)
    save_siren(sp, scfg, CHARSET, snpz)
    artifact = str(tmp_path / "neural.pt2")
    rc = cli.main(["export", "--placement", pnpz, "--implicit", snpz, "--font", FIRACODE_PATH, "--out",
                   artifact, "--platforms", "cpu", "--monotone-placement", "--device", "cpu"])
    assert rc == 0 and os.path.exists(artifact)
    out = str(tmp_path / "renders")
    assert cli.main(["render", "HI WORLD", "--exported", artifact, "--out", out, "--device", "cpu"]) == 0
    got = read_bmp(os.path.join(out, "string_0.bmp")).astype(np.float32)
    want = render_learned_sheets(sp, pp, ["HI WORLD"], FIRACODE_PATH, scfg, TINY, charset=CHARSET,
                                 monotone=True)[0].numpy()
    np.testing.assert_allclose(got, want, atol=1 / 255 + 1e-6)


def test_neural_export_requires_bank(tmp_path, capsys):
    rc = cli.main(["export", "--placement", str(tmp_path / "p.npz"), "--out", str(tmp_path / "x.pt2")])
    assert rc == 1
    assert "requires --implicit" in capsys.readouterr().out


def test_cli_export_missing_weights(tmp_path, capsys):
    rc = cli.main(["export", "--weights", str(tmp_path / "nope.npz"), "--out", str(tmp_path / "x.pt2")])
    assert rc == 1
    assert "not found" in capsys.readouterr().out


def test_cli_render_missing_artifact(tmp_path, capsys):
    rc = cli.main(["render", "HI", "--exported", str(tmp_path / "nope.pt2"), "--out", str(tmp_path / "o"),
                   "--device", "cpu"])
    assert rc == 1
    assert "not found" in capsys.readouterr().out


def test_neural_export_warns_on_ignored_precision_flags(tmp_path, capsys):
    """--int8/--fast exist only for the flagship export; with --placement
    they warn instead of being ignored silently."""
    *_, pp, sp, scfg = _tiny_neural()
    pnpz, snpz = str(tmp_path / "place.npz"), str(tmp_path / "bank.npz")
    save_params(pp, pnpz, mcfg=TINY)
    save_siren(sp, scfg, CHARSET, snpz)
    artifact = str(tmp_path / "neural.pt2")
    rc = cli.main(["export", "--placement", pnpz, "--implicit", snpz, "--font", FIRACODE_PATH, "--out",
                   artifact, "--platforms", "cpu", "--int8", "--device", "cpu"])
    assert rc == 0 and os.path.exists(artifact)
    assert "ignored for --placement" in capsys.readouterr().out


# The port's flags on one side; the JAX config of the other side has the
# same frontend and no kernel (the JAX package's kernels run through
# Pallas, which its CPU export does not take).
JAX_PAIRS = {
    "plain": ({}, {}),
    "k1_k5": ({"use_pallas_output": True, "fused_attention": True}, {}),
    "fast_k1_k7": ({"use_pallas_output": True, "fused_attention_v2": True, "bf16_frontend": True},
                   {"bf16_frontend": True}),
}


@pytest.mark.parametrize("case", sorted(JAX_PAIRS))
def test_flagship_within_one_gray_level_of_the_jax_artifact(case, jax_params, tiny_params, tmp_path):
    port_flags, jax_flags = JAX_PAIRS[case]
    jpath = str(tmp_path / "j.hlo")
    jex.export_render(jax_params, JaxConfig(**TINY_KW, **jax_flags), jpath, platforms=("cpu",))
    strings = ["HELLO", "AB", "", "THE QUICK BROWN FOX", "WWWWW IIIII"]
    want = _u8(jex.render_exported(jex.load_exported(jpath), strings))
    path, _ = _export(tiny_params, replace(TINY, **port_flags), tmp_path)
    got = _u8(render_exported(load_exported(path, "cpu"), strings))
    diff = np.abs(got - want)
    print(f"{case}: {int((diff > 0).sum())} of {diff.size} pixels differ, most {int(diff.max())}")
    assert diff.max() <= 1


NEURAL_CASES = {"soft": (0, {}, 2), "hard": (4, {"hard": True}, 1), "monotone": (4, {"monotone": True}, 1)}


@pytest.mark.parametrize("case", sorted(NEURAL_CASES))
def test_neural_within_the_bound_of_the_jax_artifact(case, tmp_path):
    lines, kw, levels = NEURAL_CASES[case]
    jpp, jsp, jscfg, pp, sp, scfg = _tiny_neural(lines)
    jpath, path = str(tmp_path / "j.hlo"), str(tmp_path / "n.pt2")
    jex.export_neural_render(jpp, JaxConfig(**TINY_KW), jsp, jscfg, CHARSET, FIRACODE_PATH, jpath,
                             platforms=("cpu",), **kw)
    export_neural_render(pp, TINY, sp, scfg, CHARSET, FIRACODE_PATH, path, platforms=("cpu",), **kw)
    strings = ["HELLO", "AB A", "", "HI WORLD"]
    want = _u8(jex.render_exported(jex.load_exported(jpath), strings))
    got = _u8(render_exported(load_exported(path, "cpu"), strings))
    diff = np.abs(got - want)
    print(f"{case}: {int((diff > 0).sum())} of {diff.size} pixels differ, most {int(diff.max())}")
    assert diff.max() <= levels


def _targets(path) -> dict:
    """{operator name: [its calls' non-tensor arguments]} of an artifact's
    graph."""
    program = load_exported(path, "cpu").program
    found = {}
    for n in program.graph.nodes:
        if n.op == "call_function" and isinstance(n.target, torch._ops.OpOverload) and n.target.namespace == "afr":
            found.setdefault(n.target.name(), []).append([a for a in n.args if not isinstance(a, torch.fx.Node)])
    return found


@pytest.mark.parametrize("v2", [False, True], ids=["k5", "k7"])
def test_the_kernels_are_operators_in_the_graph(v2, tiny_params, tmp_path):
    """With the kernel flags the graph calls afr::fused_output_fwd (on W's
    bf16 shadow, held in W's place) and afr::attention_fwd (storing the
    mask with v2); on the CPU the artifact is u8-equal to the direct render."""
    flag = "fused_attention_v2" if v2 else "fused_attention"
    cfg = replace(TINY, use_pallas_output=True, **{flag: True})
    path, _ = _export(tiny_params, cfg, tmp_path)
    targets = _targets(path)
    assert sorted(targets) == ["afr::attention_fwd", "afr::fused_output_fwd"]
    ((heads, rate, seed, store_mask),) = targets["afr::attention_fwd"]
    assert (heads, rate, seed, store_mask) == (TINY.num_heads, 0.0, None, v2)
    artifact = load_exported(path, "cpu")
    state = artifact.program.state_dict
    assert "out_w" not in state and torch.equal(state["out_w16"], round_bf16(tiny_params["out_w"]))
    np.testing.assert_array_equal(_u8(render_exported(artifact, STRINGS)),
                                  _u8(render_batch(tiny_params, STRINGS, cfg)))


def test_the_placement_net_attention_is_an_operator_in_the_graph(tmp_path):
    *_, pp, sp, scfg = _tiny_neural()
    path = str(tmp_path / "neural.pt2")
    pcfg = replace(TINY, fused_attention=True)
    export_neural_render(pp, pcfg, sp, scfg, CHARSET, FIRACODE_PATH, path, platforms=("cpu",))
    assert sorted(_targets(path)) == ["afr::attention_fwd"]
    strings = ["HELLO", "AB A"]
    want = render_learned_sheets(sp, pp, strings, FIRACODE_PATH, scfg, pcfg, charset=CHARSET)
    np.testing.assert_array_equal(_u8(render_exported(load_exported(path, "cpu"), strings)), _u8(want))


def _attention_args(dtype, rate, store_mask):
    g = torch.Generator().manual_seed(7)
    x = torch.randn(3, 7, 16, generator=g).to(dtype)
    w = [torch.randn(16, 16, generator=g) * 0.3 if k.startswith("w") else torch.randn(16, generator=g) * 0.1
         for k in KEYS]
    seed = torch.tensor([5], dtype=torch.int32) if rate else None
    return (x, *w, 2, rate, seed, store_mask)


OPCHECK_CASES = {
    "fused_output_fwd": lambda: (torch.randn(5, 40), round_bf16(torch.randn(40, 20)), torch.randn(20)),
    "attention_fwd_f32": lambda: _attention_args(torch.float32, 0.0, False),
    "attention_fwd_f32_dropout_stored": lambda: _attention_args(torch.float32, 0.2, True),
    "attention_fwd_bf16_dropout": lambda: _attention_args(torch.bfloat16, 0.2, False),
    "int8_product": lambda: (torch.randint(-127, 128, (5, 24), dtype=torch.int8),
                             torch.randint(-127, 128, (24, 16), dtype=torch.int8)),
}


@pytest.mark.parametrize("case", sorted(OPCHECK_CASES))
def test_operators_pass_opcheck(case):
    """torch.library.opcheck on CPU tensors: schema, fake implementation
    and registration agree with the real implementation."""
    op = getattr(torch.ops.afr, case.split("_f32")[0].split("_bf16")[0]).default
    torch.library.opcheck(op, OPCHECK_CASES[case]())


def test_cpu_artifact_refuses_the_card_and_a_jax_artifact_exits_1(jax_params, tiny_artifact, tmp_path, capsys):
    with pytest.raises(ValueError, match="exported for platforms"):
        load_exported(tiny_artifact[0], "cuda")
    jpath = str(tmp_path / "j.hlo")
    jex.export_render(jax_params, JaxConfig(**TINY_KW), jpath, platforms=("cpu",))
    assert cli.main(["render", "HI", "--exported", jpath, "--out", str(tmp_path / "o"), "--device", "cpu"]) == 1
    assert "JAX package" in capsys.readouterr().out


def test_server_on_an_artifact_answers_byte_equal(tiny_artifact, tmp_path):
    """RenderServer(render_fn=...) over an artifact, as ``serve
    --exported`` builds it: each reply byte-equal to render_exported."""
    from ai_font_renderer_tpu_torch.render.server import RenderServer, request_render

    artifact = load_exported(tiny_artifact[0], "cpu")
    mcfg = replace(ModelConfig(), max_length=artifact.max_length, sheet_height=artifact.height,
                   sheet_width=artifact.width)
    sock = str(tmp_path / "afr.sock")
    srv = RenderServer(None, mcfg, socket_path=sock, batch_size=4,
                       render_fn=lambda strings: render_exported_u8(artifact, strings))
    srv.start()
    replies, errors = {}, []
    requests = {"a": ["HELLO", "AB", ""], "b": ["X" * 20] * 9}

    def client(name):
        try:
            replies[name] = request_render(sock, requests[name])
        except Exception as e:  # reported after the join
            errors.append(repr(e))

    try:
        threads = [threading.Thread(target=client, args=(n,)) for n in requests]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        srv.stop()
    assert not errors, errors
    for name, strings in requests.items():
        header, payloads = replies[name]
        want = render_exported_u8(artifact, strings).numpy()
        got = np.stack([np.frombuffer(p, np.uint8).reshape(8, 16) for p in payloads])
        assert header["count"] == len(strings) and np.array_equal(got, want)


def test_cli_serve_exported_starts_and_warns(tiny_artifact, tmp_path, monkeypatch, capsys):
    import time

    def interrupt(_):
        raise KeyboardInterrupt

    path = tiny_artifact[0]
    monkeypatch.setattr(time, "sleep", interrupt)
    sock = str(tmp_path / "afr.sock")
    assert cli.main(["serve", "--exported", path, "--socket", sock, "--fast", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "no effect with --exported" in out and "Render server listening" in out
    assert cli.main(["serve", "--exported", str(tmp_path / "nope.pt2"), "--device", "cpu"]) == 1


def test_jax_and_port_artifacts_take_the_same_codes(jax_params, tiny_artifact, tmp_path):
    """The contract's input is the same int32 codes in both packages."""
    jpath = str(tmp_path / "j.hlo")
    jex.export_render(jax_params, JaxConfig(**TINY_KW), jpath, platforms=("cpu",))
    path = tiny_artifact[0]
    assert exported_contract(load_exported(path, "cpu")) == jex.exported_contract(jex.load_exported(jpath))
    codes = encode_codes(["HI"], TINY.max_length)
    assert np.asarray(jex.load_exported(jpath).call(jnp.asarray(codes))).dtype == np.uint8
    assert load_exported(path, "cpu")(torch.from_numpy(codes)).dtype == torch.uint8
