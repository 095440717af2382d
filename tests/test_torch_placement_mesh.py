"""The data-parallel path of ``train-placement`` on the port: the 4 tests of
tests/test_placement_mesh.py, mirrored, and the CLI run on CPU ranks.

The placement trainer's step builders (train/placement_cli.py:
make_supervised_step / make_finetune_step with ``mesh``) must give the
one-device trajectory on a data-parallel mesh, dropout included: the ranks
draw their rows of the one-device masks and gather the net's features
before the loss (font_renderer.BatchRows). As in tests/test_parallel.py's
port, the ranks (gloo, at most 4) run once for the module through
``tools/dryrun_multichip.py --job`` under their own time limit; the one
device's steps run here. Bounds: JAX's (loss rtol 2e-5, leaves atol
3e-6). Against the JAX package's mesh step (dropout 0): the bounds of
tests/test_torch_placement_train.py (loss 1e-5 relative).
"""

import argparse
import dataclasses
import json
import os
import time

import jax
import numpy as np
import optax
import pytest
import torch

from ai_font_renderer_tpu.config import ModelConfig as JaxModelConfig
from ai_font_renderer_tpu.models import placement as jp
from ai_font_renderer_tpu.models import siren as jsiren
from ai_font_renderer_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ai_font_renderer_tpu.train import placement_cli as jcli
from ai_font_renderer_tpu_torch import cli
from ai_font_renderer_tpu_torch.config import FIRACODE_PATH, ModelConfig, SheetSpec
from ai_font_renderer_tpu_torch.fontgen.ttf import TrueTypeFont
from ai_font_renderer_tpu_torch.models import siren as tsiren
from ai_font_renderer_tpu_torch.parallel import launch, single_device_mesh
from ai_font_renderer_tpu_torch.render.implicit_sheet import build_layout
from ai_font_renderer_tpu_torch.train import optim
from ai_font_renderer_tpu_torch.train import placement_cli
from test_torch_native_build import install_reference_native

install_reference_native()

RANKS = 4
RANKS_LIMIT = 120.0
SCFG = dict(n_chars=95, cell=16, hidden_dim=16, n_layers=1)
NO_DROP = dict(dropout_rate=0.0, fc_dropout_rate=0.0)


def _toy_batch(seed: int, b: int = 16) -> dict:
    rng = np.random.default_rng(seed)
    return {"codes": rng.integers(32, 127, (b, 100)).astype(np.int32),
            "mids": (10.0 * rng.random((b, 100, 2))).astype(np.float32),
            "vis": np.ones((b, 100), bool), "line": np.zeros((b, 100), np.int32),
            "contrib": np.ones((b, 100), bool)}


def _params(jparams) -> dict:
    return {f"p_{k}": np.asarray(v) for k, v in jparams.items()}


def _torch(arrays: dict, prefix: str) -> dict:
    return {k[len(prefix):]: torch.from_numpy(v) for k, v in arrays.items() if k.startswith(prefix)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("placement_mesh")
    batch = _toy_batch(1)
    # Vary the visible slots per row, so the loss's normalisers differ
    # between the ranks' rows and the whole batch.
    batch["vis"][:, 60:] = np.random.default_rng(3).random((16, 40)) < 0.5
    regression = _params(jp.init(jax.random.PRNGKey(0), JaxModelConfig(), lines=5))
    structured = _params(jp.init(jax.random.PRNGKey(0), JaxModelConfig(), lines=5,
                                 advances=np.full(128, 2.0, np.float32)))
    np.savez(d / "in_sup.npz", **batch, **regression)
    np.savez(d / "in_structured.npz", **batch, **structured)
    lay = build_layout(TrueTypeFont.load(FIRACODE_PATH), SheetSpec(), SCFG["cell"], max_glyphs=100)
    rng = np.random.default_rng(4)
    codes = rng.integers(33, 127, (8, 100)).astype(np.int32)
    ft = {"codes": codes, "ids": np.clip(codes - 32, 0, 94).astype(np.int32), "valid": np.ones((8, 100), bool),
          "gt": np.ones((8, lay.height, lay.width), np.float32)}
    bank = {f"s_{k}": np.asarray(v) for k, v in jsiren.init(jax.random.PRNGKey(3), jsiren.SirenConfig(**SCFG)).items()}
    np.savez(d / "in_ft.npz", **ft, **bank, **regression)

    pcfg = {}
    tasks = {
        **{f"sup_{n}": ("placement_supervised", dict(data=n, inputs=str(d / "in_sup.npz"), pcfg=pcfg)) for n in (2, 4)},
        "sup_4_no_dropout": ("placement_supervised", dict(data=4, inputs=str(d / "in_sup.npz"), pcfg=NO_DROP)),
        "structured": ("placement_supervised", dict(data=4, inputs=str(d / "in_structured.npz"), pcfg=pcfg, steps=1,
                                                    detach_structure=True, structured=True)),
        "finetune": ("placement_finetune", dict(data=4, inputs=str(d / "in_ft.npz"), pcfg=pcfg, scfg=SCFG)),
    }
    job = [{"task": t, "args": a, "out": str(d / f"{name}.npz")} for name, (t, a) in tasks.items()]
    with open(d / "job.json", "w") as f:
        json.dump(job, f)
    t0 = time.perf_counter()
    code = launch(["-m", "ai_font_renderer_tpu_torch.tools.dryrun_multichip", "--ranks", str(RANKS), "--device",
                   "cpu", "--job", str(d / "job.json")], RANKS, "cpu", timeout=RANKS_LIMIT, store_dir=str(d),
                  env={"OMP_NUM_THREADS": "2"})
    seconds = time.perf_counter() - t0
    assert code == 0, f"the ranks exited {code} after {seconds:.1f} s (124: killed at the {RANKS_LIMIT} s limit)"
    results = {}
    for name in tasks:
        with np.load(d / f"{name}.npz") as z:
            results[name] = {k: z[k] for k in z.files}
            assert "error" not in results[name], str(results[name]["error"])
    return results, d


def _one_device(path, pcfg=ModelConfig(), steps=3, structured=False, detach=False, mesh=None):
    """The port's supervised steps on one device (or the degenerate mesh),
    as the ranks run them: AdamW 1e-3, decay 1e-4, dropout seeded 2."""
    arrays = dict(np.load(path))
    params = placement_cli.trainable(_torch(arrays, "p_"))
    opt = optim.Adam(1e-3, weight_decay=1e-4)
    state = opt.init(params)
    step = placement_cli.make_supervised_step(pcfg, opt, detach, mesh)
    batch = [torch.from_numpy(arrays[k]) for k in ("codes", "mids", "vis")]
    extra = [torch.from_numpy(arrays[k]) for k in ("line", "contrib")] if structured else [None, None]
    gen = torch.Generator().manual_seed(2)
    losses = []
    for _ in range(steps):
        params, state, loss = step(params, state, *batch, *extra, None, gen)
        losses.append(float(loss))
    return params, losses


@pytest.mark.parametrize("data", [1, 2, 4])
def test_supervised_step_matches_single_device(runs, data):
    """Three steps with dropout on a data-parallel mesh against one device:
    the losses and the leaves JAX's test checks. data=1 is the degenerate
    mesh in this process, which takes the one-device arithmetic."""
    results, d = runs
    p1, l1 = _one_device(d / "in_sup.npz")
    if data == 1:
        pm, lm = _one_device(d / "in_sup.npz", mesh=single_device_mesh())
        assert lm == l1
        for k in p1:
            assert torch.equal(pm[k], p1[k]), k
        return
    out = results[f"sup_{data}"]
    np.testing.assert_allclose(out["loss"], l1, rtol=2e-5)
    for k in ("place_w", "wq", "fc1_w"):
        np.testing.assert_allclose(out[f"p_{k}"], p1[k].detach().numpy(), atol=3e-6, err_msg=k)
    if data == 4:
        # Against the JAX package's mesh step at dropout 0: the first loss.
        jcfg = dataclasses.replace(JaxModelConfig(), **NO_DROP)
        arrays = np.load(d / "in_sup.npz")
        jparams = {k[2:]: jax.numpy.asarray(arrays[k]) for k in arrays.files if k.startswith("p_")}
        opt = optax.adamw(1e-3, weight_decay=1e-4)
        step = jcli.make_supervised_step(jcfg, opt, mesh=jax_make_mesh(data=4, model=1, devices=jax.devices()[:4]))
        _, _, jloss = step(jparams, opt.init(jparams), *(jax.numpy.asarray(arrays[k]) for k in ("codes", "mids", "vis")),
                           None, None, None, jax.random.PRNGKey(2))
        assert abs(results["sup_4_no_dropout"]["loss"][0] - float(jloss)) <= 1e-5 * abs(float(jloss))


def test_supervised_step_structured_head_on_mesh(runs):
    results, d = runs
    _, l1 = _one_device(d / "in_structured.npz", steps=1, structured=True, detach=True)
    np.testing.assert_allclose(results["structured"]["loss"], l1, rtol=2e-5)


def test_finetune_step_matches_single_device(runs):
    """The pixel path (placement.apply -> origins -> SIREN compose) with a
    tiny bank: one Adam step on 4 ranks against one device."""
    results, d = runs
    arrays = dict(np.load(d / "in_ft.npz"))
    pcfg, scfg = ModelConfig(), tsiren.SirenConfig(**SCFG)
    lay = build_layout(TrueTypeFont.load(FIRACODE_PATH), SheetSpec(), scfg.cell, max_glyphs=100)
    params = placement_cli.trainable(_torch(arrays, "p_"))
    opt = optim.Adam(1e-4)
    state = opt.init(params)
    step = placement_cli.make_finetune_step(placement_cli.make_pixel_loss(pcfg, scfg, lay, bank=_torch(arrays, "s_")),
                                            opt)
    params, state, loss = step(params, state, *(torch.from_numpy(arrays[k]) for k in ("codes", "ids", "valid", "gt")))
    out = results["finetune"]
    assert np.isfinite(out["loss"])
    np.testing.assert_allclose(float(out["loss"]), float(loss), rtol=2e-5)
    np.testing.assert_allclose(out["p_place_w"], params["place_w"].detach().numpy(), atol=3e-6)


def test_cli_mesh_flag_registered_and_guarded():
    ap = argparse.ArgumentParser()
    placement_cli.add_args(ap)
    args = ap.parse_args(["--mesh", "4"])
    assert args.mesh == 4
    # The batch guard trips before any data work (run() front matter).
    bad = ap.parse_args(["--mesh", "3", "--batch", "1024", "--samples", "100"])
    with pytest.raises(SystemExit):
        placement_cli.run(bad, ap)


def test_cli_train_placement_on_two_cpu_ranks(tmp_path):
    """``train-placement --mesh 2 --device cpu`` runs its supervised stage
    on two ranks and writes what the one-device run writes; its train
    losses are the one device's (the same masks)."""
    base = ["train-placement", "--device", "cpu", "--font", "firacode", "--samples", "240", "--batch", "64",
            "--epochs", "1", "--no-e2e"]
    assert cli.main(base + ["--mesh", "2", "--out", str(tmp_path / "mesh")]) == 0
    assert cli.main(base + ["--out", str(tmp_path / "one")]) == 0
    assert sorted(os.listdir(tmp_path / "mesh")) == sorted(os.listdir(tmp_path / "one"))
    rows = [[json.loads(line) for line in open(tmp_path / r / "metrics.jsonl")] for r in ("mesh", "one")]
    assert len(rows[0]) == len(rows[1]) == 1
    np.testing.assert_allclose(rows[0][0]["train_loss"], rows[1][0]["train_loss"], rtol=2e-5)
