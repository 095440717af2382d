"""The port's device mesh (ai_font_renderer_tpu_torch/parallel/) against the
JAX package's, on the CPU: the 12 tests of tests/test_parallel.py, mirrored.

The JAX side runs here on the conftest's virtual CPU devices. The port's
side runs on 4 CPU ranks (gloo), started once for the module by
``tools/dryrun_multichip.py --job``: the ranks import only the port, read
the inputs this module writes (JAX-initialised parameters, the batch, the
tiny corpus), run each task and leave the results in ``tmp_path``. They
meet through a FileStore there, never a fixed port, and are killed after
their own time limit (RANKS_LIMIT), which fails the tests.

Bounds: those of tests/test_parallel.py (the sharded step: loss rtol 2e-5,
out_b atol 2e-5; the conv decoder: 1e-4 and 5e-5; the explicit DP step:
loss 1e-6 relative, first moments 1e-7 + 1e-5 of the largest). Dropout is
0 against JAX (threefry's masks cannot be reproduced); with dropout, the
port's mesh step is held to the port's one-device step, whose masks it
draws (font_renderer.BatchRows). Checkpoints move between one device and a
mesh bit for bit.
"""

import dataclasses
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_font_renderer_tpu.config import FIRACODE_PATH
from ai_font_renderer_tpu.config import ModelConfig as JaxModelConfig
from ai_font_renderer_tpu.config import SheetSpec as JaxSheetSpec
from ai_font_renderer_tpu.config import TrainConfig as JaxTrainConfig
from ai_font_renderer_tpu.fontgen import bake_atlas
from ai_font_renderer_tpu.fontgen.dataset import build_device_dataset
from ai_font_renderer_tpu.parallel import make_mesh as jax_make_mesh
from ai_font_renderer_tpu.parallel import make_shard_map_train_step as jax_shard_map_step
from ai_font_renderer_tpu.parallel import shard_batch as jax_shard_batch
from ai_font_renderer_tpu.parallel import shard_state as jax_shard_state
from ai_font_renderer_tpu.train import init_state as jax_init_state
from ai_font_renderer_tpu.train import train_step as jax_train_step
from ai_font_renderer_tpu_torch.config import ModelConfig, TrainConfig
from ai_font_renderer_tpu_torch.parallel import launch, make_mesh, param_spec, single_device_mesh
from ai_font_renderer_tpu_torch.train import step as tstep
from ai_font_renderer_tpu_torch.utils.checkpoint import CheckpointManager
from test_torch_native_build import install_reference_native

install_reference_native()

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 virtual devices")

RANKS = 4
RANKS_LIMIT = 120.0  # seconds for the whole job of the module's ranks
TINY = dict(max_length=24, sheet_height=20, sheet_width=60)
NO_DROP = dict(dropout_rate=0.0, fc_dropout_rate=0.0)
TRAIN = dict(batch_size=16, num_samples=64)
CONV = dict(decoder="conv", decoder_grid=(4, 6), decoder_channels=(32, 32, 16, 8, 8))
SM = dict(max_length=16, hidden_dim=8, sheet_height=16, sheet_width=16, bf16_matmul=False, **NO_DROP)
SM_TRAIN = dict(batch_size=32, adam_mu_bf16=False)
ATTN = dict(max_length=24, sheet_height=16, sheet_width=48, **NO_DROP)
MESHES = [(4, 1), (2, 2), (1, 4)]
# The CLI's fast profile: bf16 frontend, uint8 masks, the hand-rolled
# projection backward with the frontend recomputed ("dots").
FAST = dict(bf16_frontend=True, bits_dropout=True)
FAST_TRAIN = dict(handrolled_bwd=True, remat_frontend="dots")


def _np(tree) -> dict:
    return {k: np.asarray(v) for k, v in tree.items()}


def _job_args(kw: dict) -> dict:
    """Config kwargs as JSON (tuples become lists; the port's configs take
    them back as tuples below)."""
    return {k: list(v) if isinstance(v, tuple) else v for k, v in kw.items()}


def _jax_cfgs(mkw: dict, tkw: dict):
    return dataclasses.replace(JaxModelConfig(), **mkw), dataclasses.replace(JaxTrainConfig(), **tkw)


def _port_cfgs(mkw: dict, tkw: dict):
    return ModelConfig(**mkw), TrainConfig(**tkw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Write the inputs, run every task of the module on RANKS ranks once,
    and return (results by task name, the inputs)."""
    d = tmp_path_factory.mktemp("mesh")
    cache = str(d / "jax_cache")
    atlas = bake_atlas(FIRACODE_PATH, JaxSheetSpec(width=60, height=20, max_chars=24), cache_dir=cache)
    ds = build_device_dataset(atlas, num_samples=64, synth_batch=32, cache_dir=cache)
    codes, targets = ds.gather_batch(jnp.arange(16, dtype=jnp.int32))
    inputs = {"codes": np.asarray(codes), "targets": np.asarray(targets), "targets_u8": np.asarray(ds.targets_u8),
              "all_codes": np.asarray(ds.codes)}
    for name, mkw in (("tiny", TINY), ("conv", {**TINY, **CONV})):
        jm, jt = _jax_cfgs(mkw, TRAIN)
        inputs.update({f"{name}_p_{k}": v for k, v in _np(jax_init_state(jax.random.PRNGKey(0), jm, jt).params).items()})
    jm, jt = _jax_cfgs(SM, SM_TRAIN)
    key = jax.random.PRNGKey(0)
    inputs["sm_codes"] = np.asarray(jax.random.randint(key, (32, 16), 65, 91, jnp.int32))
    inputs["sm_targets"] = np.asarray(jax.random.uniform(key, (32, 16, 16)))
    inputs.update({f"sm_p_{k}": v for k, v in _np(jax_init_state(jax.random.PRNGKey(0), jm, jt).params).items()})
    jm, jt = _jax_cfgs(ATTN, dict(num_samples=64, batch_size=64))
    inputs["attn_codes"] = np.full((64, 24), 65, np.int32)
    inputs["attn_targets"] = np.linspace(0, 1, 64 * 16 * 48, dtype=np.float32).reshape(64, 16, 48)
    inputs.update({f"attn_p_{k}": v for k, v in _np(jax_init_state(jax.random.PRNGKey(0), jm, jt).params).items()})

    def files(prefix, batch):
        """An inputs file for one parameter set and batch."""
        path = str(d / f"in_{prefix}.npz")
        arrays = {k[len(prefix) + 1:]: v for k, v in inputs.items() if k.startswith(prefix + "_p_")}
        np.savez(path, codes=inputs[batch[0]], targets=inputs[batch[1]], **arrays)
        return path

    tiny, conv = files("tiny", ("codes", "targets")), files("conv", ("codes", "targets"))
    sm, attn = files("sm", ("sm_codes", "sm_targets")), files("attn", ("attn_codes", "attn_targets"))
    corpus = str(d / "corpus.npz")
    np.savez(corpus, codes=inputs["all_codes"], targets_u8=inputs["targets_u8"])

    # A one-device checkpoint for the mesh to restore: two port steps from
    # the JAX parameters, so the moments are not zero.
    pm, pt = _port_cfgs(TINY, TRAIN)
    state = tstep.state_from_params({k[2:]: torch.from_numpy(v) for k, v in np.load(tiny).items()
                                     if k.startswith("p_")}, pt)
    for _ in range(2):
        state, _ = tstep.train_step(state, torch.from_numpy(inputs["codes"]), torch.from_numpy(inputs["targets"]),
                                    1e-3, torch.Generator().manual_seed(5), pm, pt)
    CheckpointManager(str(d / "one_device")).save(1, state, state.params, {"epoch": 1})

    tiny_m, tiny_t = _job_args(TINY), _job_args(TRAIN)
    train3 = _job_args({**TRAIN, "num_epochs": 3, "eval_every": 10, "checkpoint_every": 0})
    ck = lambda epochs: _job_args({**TRAIN, "num_epochs": epochs, "eval_every": 10, "checkpoint_every": 1})  # noqa: E731
    tasks = {
        "mesh_shapes": ("mesh_shapes", {}),
        **{f"step_{dd}x{mm}": ("sharded_step", dict(data=dd, model=mm, inputs=tiny, mcfg=_job_args({**TINY, **NO_DROP}),
                                                      tcfg=tiny_t)) for dd, mm in MESHES},
        "step_2x2_dropout": ("sharded_step", dict(data=2, model=2, inputs=tiny, mcfg=tiny_m, tcfg=tiny_t)),
        "step_2x2_fast": ("sharded_step", dict(data=2, model=2, inputs=tiny, mcfg=_job_args({**TINY, **FAST}),
                                               tcfg=_job_args({**TRAIN, **FAST_TRAIN}))),
        "epoch": ("epoch", dict(data=2, model=2, inputs=corpus, mcfg=tiny_m, tcfg=tiny_t)),
        "train": ("train", dict(data=2, model=2, inputs=corpus, mcfg=tiny_m, tcfg=train3,
                                output_dir=str(d / "run"))),
        "resume_full": ("train", dict(data=2, model=2, inputs=corpus, mcfg=tiny_m, tcfg=ck(4),
                                      checkpoint_dir=str(d / "ck_full"))),
        "resume_first": ("train", dict(data=2, model=2, inputs=corpus, mcfg=tiny_m, tcfg=ck(2),
                                       checkpoint_dir=str(d / "ck"))),
        "resume_rest": ("train", dict(data=2, model=2, inputs=corpus, mcfg=tiny_m, tcfg=ck(4),
                                      checkpoint_dir=str(d / "ck"), resume=True)),
        "cross": ("checkpoint_cross", dict(data=1, model=4, inputs=tiny, mcfg=_job_args({**TINY, **NO_DROP}),
                                          tcfg=tiny_t, one_device_dir=str(d / "one_device"),
                                          mesh_dir=str(d / "from_mesh"))),
        "shard_map": ("shard_map_step", dict(data=4, inputs=sm, mcfg=SM, tcfg=SM_TRAIN)),
        "shard_map_dropout": ("shard_map_step", dict(data=4, inputs=sm, mcfg=dict(SM, dropout_rate=0.2,
                                                                                  fc_dropout_rate=0.2,
                                                                                  bf16_matmul=True),
                                                     tcfg=dict(batch_size=32), seed=1)),
        "conv_step": ("sharded_step", dict(data=4, model=1, inputs=conv, mcfg=_job_args({**TINY, **CONV, **NO_DROP}),
                                           tcfg=tiny_t)),
        "refuse_fused": ("train", dict(data=2, model=2, inputs=corpus, mcfg=tiny_m,
                                       tcfg=_job_args({**TRAIN, "num_epochs": 1, "fused_dw_adamw": True}))),
        **{f"refuse_{flag}": ("train", dict(data=2, model=2, inputs=corpus, mcfg=_job_args({**TINY, flag: True}),
                                            tcfg=_job_args({**TRAIN, "num_epochs": 1})))
           for flag in ("fused_attention", "fused_attention_v2")},
        **{f"attn_{name}": ("shard_map_step", dict(data=4, inputs=attn, mcfg={**ATTN, **flags},
                                                   tcfg=dict(num_samples=64, batch_size=64), seed=3))
           for name, flags in (("plain", {}), ("v1", {"fused_attention": True}),
                               ("v2", {"fused_attention_v2": True}))},
    }
    job = [{"task": t, "args": a, "out": str(d / f"{name}.npz")} for name, (t, a) in tasks.items()]
    with open(d / "job.json", "w") as f:
        json.dump(job, f)
    t0 = time.perf_counter()
    code = launch(["-m", "ai_font_renderer_tpu_torch.tools.dryrun_multichip", "--ranks", str(RANKS), "--device",
                   "cpu", "--job", str(d / "job.json")], RANKS, "cpu", timeout=RANKS_LIMIT, store_dir=str(d),
                  env={"OMP_NUM_THREADS": "2"})
    seconds = time.perf_counter() - t0
    print(f"{RANKS} ranks ran {len(job)} tasks in {seconds:.1f} s (exit {code})")
    assert code == 0, f"the ranks exited {code} after {seconds:.1f} s (124: killed at the {RANKS_LIMIT} s limit)"
    results = {}
    for name in tasks:
        with np.load(d / f"{name}.npz") as z:
            results[name] = {k: z[k] for k in z.files}
    return results, inputs, d


def _result(runs, name) -> dict:
    out = runs[0][name]
    assert "error" not in out, str(out["error"])
    return out


def test_mesh_shapes(runs):
    out = _result(runs, "mesh_shapes")
    for dd, mm in MESHES:
        assert out[f"{dd}x{mm}"].tolist() == [dd, mm]
    assert out["default"].tolist() == [RANKS, 1]  # all devices on data
    assert "4 devices not divisible by model=3" in str(out["error_Nonex3"])
    assert "mesh 8x1 needs 8 > 4 devices" in str(out["error_8x1"])
    # Without a process group: the degenerate mesh alone; JAX's message.
    assert single_device_mesh().shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 > 1 devices"):
        make_mesh(2, 1, devices=["cpu"])


def test_out_w_is_sharded(runs):
    assert param_spec("out_w") == (None, "model") and param_spec("out_b") == ("model",)
    assert param_spec("wq") == ()
    out = _result(runs, "step_1x4")
    # Column-parallel: the second dim split 4 ways.
    assert int(out["shard_width"]) == TINY["sheet_height"] * TINY["sheet_width"] // 4


@pytest.mark.parametrize("data,model", MESHES)
def test_sharded_train_step_matches_single_device(runs, data, model):
    """JAX's GSPMD step on a (data, model) mesh and the port's ranks, from
    the same parameters and batch, dropout 0: loss and out_b."""
    results, inputs, _ = runs
    jm, jt = _jax_cfgs({**TINY, **NO_DROP}, TRAIN)
    mesh = jax_make_mesh(data=data, model=model, devices=jax.devices()[:RANKS])
    st = jax_shard_state(mesh, jax_init_state(jax.random.PRNGKey(0), jm, jt))
    sc, stt = jax_shard_batch(mesh, jnp.asarray(inputs["codes"]), jnp.asarray(inputs["targets"]))
    st, loss = jax_train_step(st, sc, stt, jnp.float32(1e-3), jax.random.PRNGKey(7), jm, jt)
    out = _result(runs, f"step_{data}x{model}")
    np.testing.assert_allclose(float(out["loss"][0]), float(loss), rtol=2e-5)
    np.testing.assert_allclose(out["p_out_b"], np.asarray(st.params["out_b"]), atol=2e-5)


def test_sharded_step_draws_the_one_device_dropout(runs):
    """With dropout, a step on a (2, 2) mesh against the port's one-device
    step under the same generator: the ranks' rows of the masks are the one
    device's, so the bounds above hold."""
    results, inputs, d = runs
    pm, pt = _port_cfgs(TINY, TRAIN)
    arrays = np.load(d / "in_tiny.npz")
    state = tstep.state_from_params({k[2:]: torch.from_numpy(arrays[k]) for k in arrays.files
                                     if k.startswith("p_")}, pt)
    gen = torch.Generator().manual_seed(7)
    state, loss = tstep.train_step(state, torch.from_numpy(inputs["codes"]), torch.from_numpy(inputs["targets"]),
                                   1e-3, gen, pm, pt)
    out = _result(runs, "step_2x2_dropout")
    np.testing.assert_allclose(out["loss"], [float(loss)], rtol=2e-5)
    np.testing.assert_allclose(out["p_out_b"], state.params["out_b"].detach().numpy(), atol=2e-5)


def test_fast_profile_step_on_a_mesh(runs):
    """The fast profile's hand-rolled step on a (2, 2) mesh (dflat summed
    over the model axis, the frontend recomputed from the generator the
    rank's BatchRows wraps) against the port's one-device step, dropout on:
    the loss within 1e-3 (the bf16 frontend rounds each rank's rows'
    products on its own), out_b within JAX's 2e-5."""
    results, inputs, d = runs
    pm, pt = _port_cfgs({**TINY, **FAST}, {**TRAIN, **FAST_TRAIN})
    arrays = np.load(d / "in_tiny.npz")
    state = tstep.state_from_params({k[2:]: torch.from_numpy(arrays[k]) for k in arrays.files
                                     if k.startswith("p_")}, pt)
    state, loss = tstep.train_step(state, torch.from_numpy(inputs["codes"]), torch.from_numpy(inputs["targets"]),
                                   1e-3, torch.Generator().manual_seed(7), pm, pt)
    out = _result(runs, "step_2x2_fast")
    np.testing.assert_allclose(out["loss"], [float(loss)], rtol=1e-3)
    np.testing.assert_allclose(out["p_out_b"], state.params["out_b"].detach().numpy(), atol=2e-5)


def test_sharded_epoch_runs(runs):
    out = _result(runs, "epoch")
    assert np.isfinite(out["loss"]) and np.isfinite(out["val"])
    # Parameters remain sharded after the update (no silent gather).
    assert int(out["shard_width"]) == int(out["width"]) // 2


def test_full_train_loop_on_mesh(runs):
    hist = _result(runs, "train")["history"]
    assert len(hist) == 3
    assert np.isfinite(hist[:, 1]).all()
    assert hist[-1, 0] < hist[0, 0]
    # Rank 0 alone wrote the run's files: the manifests, metrics and renders.
    run = runs[2] / "run"
    assert len(open(run / "metrics.jsonl").read().splitlines()) == 3
    assert {"config.txt", "training_results.txt", "epoch_0"} <= set(os.listdir(run))


def test_mesh_checkpoint_resume(runs, tmp_path):
    """Resume on the mesh replays the uninterrupted mesh run exactly; and a
    checkpoint moves from one device to a mesh and back, bit for bit."""
    full, rest = _result(runs, "resume_full")["history"], _result(runs, "resume_rest")["history"]
    assert len(rest) == 2
    np.testing.assert_allclose(rest, full[2:], rtol=0, atol=0)

    out = _result(runs, "cross")
    pm, pt = _port_cfgs(TINY, TRAIN)
    _, one, _, _ = CheckpointManager(str(runs[2] / "one_device")).restore(
        None, tstep.state_from_params({k[len("restored_p_"):]: torch.from_numpy(v) for k, v in out.items()
                                       if k.startswith("restored_p_")}, pt))
    assert int(out["shard_width"]) == TINY["sheet_height"] * TINY["sheet_width"] // 4
    for part in ("p", "mu", "nu"):
        tree = one.params if part == "p" else getattr(one, part)
        for k, v in tree.items():
            np.testing.assert_array_equal(out[f"restored_{part}_{k}"], v.detach().float().numpy(),
                                          err_msg=f"{part} {k}")
    _, back, _, host = CheckpointManager(str(runs[2] / "from_mesh")).restore(None, one)
    assert host["epoch"] == 5 and back.count == int(out["count"]) == one.count + 2
    for part in ("p", "mu", "nu"):
        tree = back.params if part == "p" else getattr(back, part)
        for k, v in tree.items():
            np.testing.assert_array_equal(out[f"after_{part}_{k}"], v.detach().float().numpy(), err_msg=f"{part} {k}")


class TestShardMapStep:
    """The explicit DP step against JAX's shard_map + pmean step."""

    def test_grads_match_single_device(self, runs):
        results, inputs, _ = runs
        jm, jt = _jax_cfgs(SM, SM_TRAIN)
        mesh = jax_make_mesh(data=4, model=1, devices=jax.devices()[:4])
        step = jax_shard_map_step(mesh, jm, jt)
        s2 = jax_init_state(jax.random.PRNGKey(0), jm, jt)
        s2, l2 = step(s2, jnp.asarray(inputs["sm_codes"]), jnp.asarray(inputs["sm_targets"]), jnp.float32(1e-3),
                      jax.random.PRNGKey(0))
        out = _result(runs, "shard_map")
        assert float(out["loss"]) == pytest.approx(float(l2), rel=1e-6)
        mu = s2.opt_state[0].mu
        for n in mu:
            g1, g2 = out[f"mu_{n}"], np.asarray(mu[n])
            scale = max(np.abs(g2).max(), 1e-12)
            np.testing.assert_allclose(g1, g2, atol=1e-7 + 1e-5 * scale, err_msg=n)

    def test_runs_with_dropout(self, runs):
        out = _result(runs, "shard_map_dropout")
        assert np.isfinite(out["loss"])


def test_sharded_conv_decoder_step_matches_single_device(runs):
    """The conv decoder under DP: its kernels replicate (param_spec has no
    entry for dec_*), the batch splits 4 ways; against JAX's (4, 1) step."""
    results, inputs, _ = runs
    jm, jt = _jax_cfgs({**TINY, **CONV, **NO_DROP}, TRAIN)
    mesh = jax_make_mesh(data=4, model=1, devices=jax.devices()[:4])
    st = jax_shard_state(mesh, jax_init_state(jax.random.PRNGKey(0), jm, jt))
    sc, stt = jax_shard_batch(mesh, jnp.asarray(inputs["codes"]), jnp.asarray(inputs["targets"]))
    st, loss = jax_train_step(st, sc, stt, jnp.float32(1e-3), jax.random.PRNGKey(7), jm, jt)
    out = _result(runs, "conv_step")
    np.testing.assert_allclose(float(out["loss"][0]), float(loss), rtol=1e-4)
    np.testing.assert_allclose(out["p_dec_out_b"], np.asarray(st.params["dec_out_b"]), atol=5e-5)


def test_train_refuses_mesh_plus_fused(runs):
    """K4 (fused_dw_adamw) is single-device: a mesh of more than one device
    refuses it, with the JAX package's message."""
    assert "fused_dw_adamw is single-device" in str(_result(runs, "refuse_fused")["refused"])


def test_train_refuses_mesh_plus_fused_attention(runs):
    for flag in ("fused_attention", "fused_attention_v2"):
        assert "shard_map" in str(_result(runs, f"refuse_{flag}")["refused"]), flag


def test_shard_map_step_runs_pallas_attention(runs):
    """The attention kernels compose with the explicit DP step: each rank
    runs them on its rows (their plain versions on CPU tensors). Dropout 0:
    each flag against the plain attention's step on the ranks, and the v2
    flag against JAX's shard_map step with its Pallas attention."""
    results, inputs, _ = runs
    plain = _result(runs, "attn_plain")
    jm = dataclasses.replace(JaxModelConfig(), **ATTN, fused_attention_v2=True, fa2_tile_fwd=8, fa2_tile_bwd=8)
    jt = dataclasses.replace(JaxTrainConfig(), num_samples=64, batch_size=64)
    step = jax_shard_map_step(jax_make_mesh(data=4, model=1, devices=jax.devices()[:4]), jm, jt)
    st = jax_init_state(jax.random.PRNGKey(0), jm, jt)
    st, jloss = step(st, jnp.asarray(inputs["attn_codes"]), jnp.asarray(inputs["attn_targets"]), jnp.float32(1e-3),
                     jax.random.key(3, impl="rbg"))
    for name in ("v1", "v2"):
        out = _result(runs, f"attn_{name}")
        assert np.isfinite(out["loss"])
        np.testing.assert_allclose(float(out["loss"]), float(plain["loss"]), rtol=1e-4)
        np.testing.assert_allclose(out["p_wq"], plain["p_wq"], atol=5e-5)
    np.testing.assert_allclose(float(_result(runs, "attn_v2")["loss"]), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(_result(runs, "attn_v2")["p_wq"], np.asarray(st.params["wq"]), atol=5e-5)


def test_cli_mesh_on_too_few_cards_exits_1_with_make_meshs_message(monkeypatch, tmp_path, capsys):
    """--mesh 2,1 where only one device is visible: exit 1 with make_mesh's
    message, before any rank starts or any file is written."""
    from ai_font_renderer_tpu_torch import cli, device
    from ai_font_renderer_tpu_torch.parallel import mesh as pmesh

    monkeypatch.setattr(device, "resolve_device", lambda d=None: torch.device("cpu"))
    monkeypatch.setattr(pmesh, "available_devices", lambda: [torch.device("cpu")])
    out = tmp_path / "o"
    assert cli.main(["--train", "--mesh", "2,1", "--output", str(out)]) == 1
    assert "mesh 2x1 needs 2 > 1 devices" in capsys.readouterr().out
    assert not out.exists()


# The CLI's configs narrowed to a CPU test size, in a rank's process (the
# ranks are fresh interpreters, so the narrowing rides in their command).
NARROW = dict(max_length=16, hidden_dim=16, sheet_height=16, sheet_width=24)
NARROW_RANK = (
    "import sys; from ai_font_renderer_tpu_torch import cli; from ai_font_renderer_tpu_torch.config import replace; "
    f"configs = cli._configs; cli._configs = lambda a: (replace(configs(a)[0], **{NARROW!r}), configs(a)[1]); "
    "sys.exit(cli.main(sys.argv[1:]))"
)


@pytest.mark.parametrize("shape", ["2,1", "1,2"])
def test_cli_trains_on_a_mesh_and_writes_what_one_device_writes(monkeypatch, tmp_path, shape):
    """``--train --mesh D,M --device cpu`` starts D x M CPU ranks of the CLI;
    rank 0 writes the weights, the manifests, metrics.jsonl and the BMPs, as
    the one-device run does, and its losses are the one device's within
    rounding (the same masks, sums in another order)."""
    from ai_font_renderer_tpu_torch import cli
    from ai_font_renderer_tpu_torch.config import replace
    from ai_font_renderer_tpu_torch.parallel import mesh as pmesh

    configs = cli._configs
    monkeypatch.setattr(cli, "_configs", lambda a: (replace(configs(a)[0], **NARROW), configs(a)[1]))
    started = []

    def narrowed(argv, world, *args, **kw):
        started.append((argv, world))
        assert argv[:2] == ["-m", "ai_font_renderer_tpu_torch"]
        return launch(["-c", NARROW_RANK, *argv[2:]], world, *args, **kw)

    monkeypatch.setattr(pmesh, "launch", narrowed)
    flags = ["--train", "--device", "cpu", "--samples", "80", "--epochs", "2", "--batch-size", "16"]
    runs = {}
    for name, extra in (("mesh", ["--mesh", shape]), ("one", [])):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        assert cli.main([*flags, *extra, "--output", str(tmp_path / name / "run")]) == 0
        runs[name] = tmp_path / name
    assert len(started) == 1 and started[0][1] == 2
    for name in ("mesh", "one"):
        assert sorted(os.listdir(runs[name])) == ["font_renderer.npz", "run"]
    assert sorted(os.listdir(runs["mesh"] / "run")) == sorted(os.listdir(runs["one"] / "run"))
    rows = {n: [json.loads(line) for line in open(runs[n] / "run" / "metrics.jsonl")] for n in runs}
    assert len(rows["mesh"]) == len(rows["one"]) == 2
    for a, b in zip(rows["mesh"], rows["one"]):
        np.testing.assert_allclose([a["train_loss"], a["val_loss"]], [b["train_loss"], b["val_loss"]], rtol=1e-3)
    w = {n: np.load(runs[n] / "font_renderer.npz") for n in runs}
    assert w["mesh"].files == w["one"].files and w["mesh"]["out_w"].shape == (256, 384)
