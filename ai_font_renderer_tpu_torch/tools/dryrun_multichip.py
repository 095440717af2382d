"""The port's multi-device dry run, and the rank functions of its tests.

The counterpart of ``__graft_entry__.py:dryrun_multichip`` (which stays the
JAX package's): the production sharding surface on N ranks at tiny shapes,
four sub-checks, each printing its own ok line:

  1. the DP+TP train step and eval on a (N/2, 2) mesh (N/1 when N is odd):
     the flagship's structure, out_w split by columns over ``model``;
  2. the conv_ps decoder under DP (its kernels replicate, the batch splits);
  3. the explicit DP step (parallel/shard_map_step.py) with the fused
     attention flags, the kernels running on each rank's rows;
  4. the sharded checkpoint round trip: rank 0 writes the one-device file
     with out_w gathered, every rank takes its shard back.

Run it as

    python -m ai_font_renderer_tpu_torch.tools.dryrun_multichip [--ranks 4] [--device cpu]

It starts the ranks itself (parallel.launch: gloo on the CPU, NCCL with a
card a rank, ``--backend gloo`` for ranks sharing cards) and exits with the
first failing rank's code. ``--job FILE`` runs the tasks of a JSON job file
on the ranks instead: ``[{"task": name, "args": {...}, "out": path}]``, each
a function of :data:`TASKS` whose result rank (0, 0) saves to ``out`` (an
npz, with an ``error`` entry when the task raised). The multi-rank tests
(tests/test_torch_parallel.py, tests/test_torch_placement_mesh.py) write
the inputs, run a job and hold the results against the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile
import traceback

import numpy as np
import torch

from ..config import ModelConfig, TrainConfig
from ..fontgen.dataset import DeviceDataset
from ..models import font_renderer
from ..parallel import mesh as pmesh
from ..parallel import (
    gather_params,
    gather_state,
    make_mesh,
    make_shard_map_train_step,
    shard_batch,
    shard_batch_idx,
    shard_state,
)
from ..train import step as tstep


def _device() -> torch.device:
    return torch.device(os.environ.get(pmesh.DEVICE_ENV, "cpu"))


def _cfg(cls, kw: dict):
    """A config from JSON kwargs (lists back to tuples)."""
    return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()})


def _inputs(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _state(arrays: dict, prefix: str, tcfg: TrainConfig, device):
    """A fresh state from the parameters stored under ``prefix``."""
    params = {k[len(prefix):]: torch.from_numpy(v).to(device) for k, v in arrays.items() if k.startswith(prefix)}
    return tstep.state_from_params(params, tcfg)


def _init_state(mcfg: ModelConfig, tcfg: TrainConfig, seed: int, device):
    params = font_renderer.init(torch.Generator().manual_seed(seed), mcfg, "cpu")
    return tstep.state_from_params({k: v.to(device) for k, v in params.items()}, tcfg)


def _numpy(params: dict, prefix: str = "") -> dict:
    """Copies of tensors as numpy arrays (bf16 as its exact f32 values)."""
    return {prefix + k: v.detach().cpu().float().numpy().copy() for k, v in params.items()}


# -- tasks ------------------------------------------------------------------
def task_mesh_shapes() -> dict:
    """make_mesh's shapes and errors on the ranks there are."""
    out = {}
    for d, m in ((4, 1), (2, 2), (1, 4)):
        mesh = make_mesh(d, m)
        out[f"{d}x{m}"] = np.array([mesh.data, mesh.model])
    mesh = make_mesh()
    out["default"] = np.array([mesh.data, mesh.model])
    for d, m in ((None, 3), (8, 1)):
        try:
            make_mesh(d, m)
        except ValueError as e:
            out[f"error_{d}x{m}"] = np.array(str(e))
    return out


def task_sharded_step(data: int, model: int, inputs: str, mcfg: dict, tcfg: dict, lr: float = 1e-3,
                      seed: int = 7, steps: int = 1) -> dict:
    """``steps`` steps of train_step on a (data, model) mesh from the stored
    params and batch, the generator seeded ``seed`` -> the losses and the
    whole parameters and first moments after."""
    mesh = make_mesh(data, model)
    dev = _device()
    arrays = _inputs(inputs)
    mc, tc = _cfg(ModelConfig, mcfg), _cfg(TrainConfig, tcfg)
    state = shard_state(mesh, _state(arrays, "p_", tc, dev))
    codes, targets = shard_batch(mesh, torch.from_numpy(arrays["codes"]).to(dev),
                                 torch.from_numpy(arrays["targets"]).to(dev))
    gen = torch.Generator(device=dev).manual_seed(seed)
    losses = []
    for _ in range(steps):
        state, loss = tstep.train_step(state, codes, targets, lr, gen, mc, tc, mesh)
        losses.append(float(loss))
    shard_width = state.params["out_w"].shape[1] if "out_w" in state.params else 0
    whole = gather_state(mesh, state)
    return {"loss": np.array(losses), "shard_width": np.array(shard_width), **_numpy(whole.params, "p_"),
            **_numpy(whole.mu, "mu_")}


def task_epoch(data: int, model: int, inputs: str, mcfg: dict, tcfg: dict) -> dict:
    """One train_epoch of 4 batches and an eval pass on a (data, model)
    mesh, from parameters drawn from seed 0 -> the losses and shard width."""
    mesh = make_mesh(data, model)
    dev = _device()
    arrays = _inputs(inputs)
    mc, tc = _cfg(ModelConfig, mcfg), _cfg(TrainConfig, tcfg)
    ds = DeviceDataset(torch.from_numpy(arrays["codes"]).to(dev), torch.from_numpy(arrays["targets_u8"]).to(dev))
    state = shard_state(mesh, _init_state(mc, tc, 0, dev))
    n, b = ds.num_samples, tc.batch_size
    batch_idx = shard_batch_idx(mesh, torch.arange(n, device=dev).reshape(n // b, b))
    gen = torch.Generator(device=dev).manual_seed(0)
    state, loss = tstep.train_epoch(state, ds, batch_idx, 1e-3, gen, mc, tc, mesh)
    weights = shard_batch_idx(mesh, torch.ones(n // b, b, device=dev))
    val = tstep.eval_epoch(state.params, ds, batch_idx, weights, mc, mesh)
    return {"loss": np.array(float(loss)), "val": np.array(float(val)),
            "shard_width": np.array(state.params["out_w"].shape[1]), "width": np.array(mc.sheet_height * mc.sheet_width)}


def task_train(data: int, model: int, inputs: str, mcfg: dict, tcfg: dict, checkpoint_dir: str | None = None,
               resume: bool = False, output_dir: str | None = None) -> dict:
    """train() on a (data, model) mesh -> the history and the best params;
    a ValueError's message when train refuses."""
    mesh = make_mesh(data, model)
    dev = _device()
    arrays = _inputs(inputs)
    ds = DeviceDataset(torch.from_numpy(arrays["codes"]).to(dev), torch.from_numpy(arrays["targets_u8"]).to(dev))
    from ..train import train

    try:
        r = train(ds, _cfg(ModelConfig, mcfg), _cfg(TrainConfig, tcfg), output_dir=output_dir,
                  eval_strings=["HI"] if output_dir else None, checkpoint_dir=checkpoint_dir, resume=resume,
                  log=lambda *a, **k: None, mesh=mesh)
    except ValueError as e:
        return {"refused": np.array(str(e))}
    hist = np.array([[h["train_loss"], h["val_loss"]] for h in r.history])
    return {"history": hist, **_numpy(r.params, "p_")}


def task_checkpoint_cross(data: int, model: int, inputs: str, mcfg: dict, tcfg: dict, one_device_dir: str,
                          mesh_dir: str) -> dict:
    """A checkpoint both ways: restore the one-device checkpoint in
    ``one_device_dir`` onto the mesh and return the whole state gathered
    back; take two steps on the mesh and save into ``mesh_dir``, returning
    the state gathered after them."""
    from ..utils.checkpoint import CheckpointManager

    mesh = make_mesh(data, model)
    dev = _device()
    arrays = _inputs(inputs)
    mc, tc = _cfg(ModelConfig, mcfg), _cfg(TrainConfig, tcfg)
    template = shard_state(mesh, _init_state(mc, tc, 1, dev))
    _, state, best, host = CheckpointManager(one_device_dir).restore(None, template, mesh=mesh)
    whole = gather_state(mesh, state)
    restored = {**_numpy(whole.params, "restored_p_"), **_numpy(whole.mu, "restored_mu_"),
                **_numpy(whole.nu, "restored_nu_")}
    codes, targets = shard_batch(mesh, torch.from_numpy(arrays["codes"]).to(dev),
                                 torch.from_numpy(arrays["targets"]).to(dev))
    gen = torch.Generator(device=dev).manual_seed(3)
    for _ in range(2):
        state, _ = tstep.train_step(state, codes, targets, 1e-3, gen, mc, tc, mesh)
    CheckpointManager(mesh_dir).save(5, state, state.params, {"epoch": 5}, mesh=mesh)
    after = gather_state(mesh, state)
    return {"shard_width": np.array(state.params["out_w"].shape[1]), "count": np.array(after.count),
            **restored, **_numpy(after.params, "after_p_"),
            **_numpy(after.mu, "after_mu_"), **_numpy(after.nu, "after_nu_")}


def task_shard_map_step(data: int, inputs: str, mcfg: dict, tcfg: dict, lr: float = 1e-3, seed: int = 0) -> dict:
    """The explicit DP step on a (data, 1) mesh from the stored params and
    whole batch -> the loss and the whole state after."""
    mesh = make_mesh(data, 1)
    dev = _device()
    arrays = _inputs(inputs)
    mc, tc = _cfg(ModelConfig, mcfg), _cfg(TrainConfig, tcfg)
    state = _state(arrays, "p_", tc, dev)
    step = make_shard_map_train_step(mesh, mc, tc)
    state, loss = step(state, torch.from_numpy(arrays["codes"]).to(dev), torch.from_numpy(arrays["targets"]).to(dev),
                       lr, seed)
    return {"loss": np.array(float(loss)), **_numpy(state.params, "p_"), **_numpy(state.mu, "mu_")}


def task_placement_supervised(data: int, inputs: str, pcfg: dict, steps: int = 3, detach_structure: bool = False,
                              structured: bool = False) -> dict:
    """``steps`` supervised placement steps (AdamW 1e-3, decay 1e-4) on a
    data-parallel mesh from the stored params and batch, dropout from a
    generator seeded 2 -> the losses and the params after."""
    from ..train import optim
    from ..train import placement_cli

    mesh = make_mesh(data, 1)
    dev = _device()
    arrays = _inputs(inputs)
    cfg = _cfg(ModelConfig, pcfg)
    params = placement_cli.trainable({k[2:]: torch.from_numpy(v).to(dev) for k, v in arrays.items()
                                      if k.startswith("p_")})
    opt = optim.Adam(1e-3, weight_decay=1e-4)
    state = opt.init(params)
    step = placement_cli.make_supervised_step(cfg, opt, detach_structure, mesh)
    batch = [torch.from_numpy(arrays[k]).to(dev) for k in ("codes", "mids", "vis")]
    extra = [torch.from_numpy(arrays[k]).to(dev) for k in ("line", "contrib")] if structured else [None, None]
    gen = torch.Generator(device=dev).manual_seed(2)
    losses = []
    for _ in range(steps):
        params, state, loss = step(params, state, *batch, *extra, None, gen)
        losses.append(float(loss))
    return {"loss": np.array(losses), **_numpy(params, "p_")}


def task_placement_finetune(data: int, inputs: str, pcfg: dict, scfg: dict, joint: bool = False) -> dict:
    """One pixel fine-tune step (Adam 1e-4) on a data-parallel mesh, the
    tiny bank and the placement params stored -> the loss and the tunable
    params after."""
    from ..config import FIRACODE_PATH, SheetSpec
    from ..fontgen.ttf import TrueTypeFont
    from ..models import siren
    from ..render.implicit_sheet import build_layout
    from ..train import optim
    from ..train import placement_cli

    mesh = make_mesh(data, 1)
    dev = _device()
    arrays = _inputs(inputs)
    cfg, sc = _cfg(ModelConfig, pcfg), _cfg(siren.SirenConfig, scfg)
    params = placement_cli.trainable({k[2:]: torch.from_numpy(v).to(dev) for k, v in arrays.items()
                                      if k.startswith("p_")})
    bank = {k[2:]: torch.from_numpy(v).to(dev) for k, v in arrays.items() if k.startswith("s_")}
    lay = build_layout(TrueTypeFont.load(FIRACODE_PATH), SheetSpec(), sc.cell, max_glyphs=cfg.max_length)
    if joint:
        tunable, loss_fn = (params, placement_cli.trainable(bank)), placement_cli.make_pixel_loss(cfg, sc, lay)
    else:
        tunable, loss_fn = params, placement_cli.make_pixel_loss(cfg, sc, lay, bank=bank)
    opt = optim.Adam(1e-4)
    state = opt.init(tunable)
    step = placement_cli.make_finetune_step(loss_fn, opt, mesh)
    batch = [torch.from_numpy(arrays[k]).to(dev) for k in ("codes", "ids", "valid", "gt")]
    tunable, state, loss = step(tunable, state, *batch)
    p = tunable[0] if joint else tunable
    return {"loss": np.array(float(loss)), **_numpy(p, "p_")}


TASKS = {name[len("task_"):]: fn for name, fn in globals().items() if name.startswith("task_")}


def run_job(path: str) -> None:
    """Run every task of the job file on this rank; rank (0, 0) saves each
    result (or the error) to the task's ``out``."""
    with open(path) as f:
        tasks = json.load(f)
    main = int(os.environ.get(pmesh.RANK_ENV, "0")) == 0
    for t in tasks:
        try:
            result = TASKS[t["task"]](**t.get("args", {}))
        except Exception:  # noqa: BLE001  (recorded for the test to report)
            result = {"error": np.array(traceback.format_exc())}
        if main:
            np.savez(t["out"] + ".tmp.npz", **result)
            os.replace(t["out"] + ".tmp.npz", t["out"])


# -- the dry run ------------------------------------------------------------
def dryrun(n: int) -> None:
    """The four sub-checks on this rank of an n-rank group."""
    dev = _device()
    model_par = 2 if n % 2 == 0 else 1
    mesh = make_mesh(n // model_par, model_par)
    mcfg = ModelConfig(max_length=24, sheet_height=16, sheet_width=48)
    tcfg = TrainConfig(batch_size=2 * n, num_samples=64)
    b = tcfg.batch_size
    codes = torch.full((b, mcfg.max_length), 65, dtype=torch.int32, device=dev)
    targets = torch.ones(b, mcfg.sheet_height, mcfg.sheet_width, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)

    # (1) DP+TP step and eval.
    state = shard_state(mesh, _init_state(mcfg, tcfg, 0, dev))
    state, loss = tstep.train_step(state, *shard_batch(mesh, codes, targets), 1e-3, gen, mcfg, tcfg, mesh)
    assert torch.isfinite(loss), f"non-finite loss {loss}"
    assert state.params["out_w"].shape[1] == mcfg.sheet_height * mcfg.sheet_width // model_par
    nv = 4 * b
    ds = DeviceDataset(torch.full((nv, mcfg.max_length), 66, dtype=torch.int32, device=dev),
                       torch.full((nv, mcfg.sheet_height, mcfg.sheet_width), 128, dtype=torch.uint8, device=dev))
    idx = shard_batch_idx(mesh, torch.arange(nv, device=dev).reshape(4, b))
    val = tstep.eval_epoch(state.params, ds, idx, shard_batch_idx(mesh, torch.ones(4, b, device=dev)), mcfg, mesh)
    assert torch.isfinite(val), f"non-finite val loss {val}"
    _ok(f"dp+tp train_step + eval (mesh {mesh.data}x{mesh.model})")

    # (2) conv_ps under DP.
    mesh_dp = make_mesh(n, 1)
    mcfg_ps = dataclasses.replace(mcfg, decoder="conv_ps", decoder_grid=(4, 6), decoder_channels=(32, 32, 16, 8, 8))
    st_ps = shard_state(mesh_dp, _init_state(mcfg_ps, tcfg, 2, dev))
    st_ps, loss_ps = tstep.train_step(st_ps, *shard_batch(mesh_dp, codes, targets), 1e-3, gen, mcfg_ps, tcfg, mesh_dp)
    assert torch.isfinite(loss_ps), f"non-finite conv_ps loss {loss_ps}"
    _ok(f"conv_ps sharded train_step (dp={n})")

    # (3) The explicit DP step, with each fused attention flag.
    for flag in ("fused_attention", "fused_attention_v2"):
        mc = dataclasses.replace(mcfg, **{flag: True})
        st_sm, loss_sm = make_shard_map_train_step(mesh_dp, mc, tcfg)(_init_state(mc, tcfg, 4, dev), codes, targets,
                                                                        1e-3, 5)
        assert torch.isfinite(loss_sm), f"non-finite explicit DP loss {loss_sm} ({flag})"
    _ok(f"explicit DP train_step with fused_attention and fused_attention_v2 (dp={n})")

    # (4) The sharded checkpoint round trip.
    from ..utils.checkpoint import CheckpointManager

    ckdir = tempfile.mkdtemp(prefix="afr_dryrun_ckpt_") if mesh.is_main else None
    holder = [ckdir]
    if n > 1:
        torch.distributed.broadcast_object_list(holder, src=0)
    try:
        mgr = CheckpointManager(holder[0], keep=1)
        mgr.save(1, state, state.params, {"dryrun": True}, mesh=mesh)
        if n > 1:
            torch.distributed.barrier()
        _, restored, _, host = mgr.restore(1, template=state, mesh=mesh)
        assert host.get("dryrun") is True
        for k, v in state.params.items():
            assert torch.equal(restored.params[k].detach(), v.detach()), f"restore changed {k}"
        assert restored.params["out_w"].shape == state.params["out_w"].shape, "restore changed out_w's shard"
    finally:
        if n > 1:
            torch.distributed.barrier()
        if ckdir:
            shutil.rmtree(ckdir, ignore_errors=True)
    _ok("sharded checkpoint save/restore roundtrip")


def _ok(what: str) -> None:
    print(f"dryrun sub-check ok: {what}", flush=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ai_font_renderer_tpu_torch.tools.dryrun_multichip")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="cuda (a card a rank, NCCL) or cpu (gloo)")
    ap.add_argument("--backend", default=None, help="gloo: ranks that share cards")
    ap.add_argument("--job", default=None, help="a JSON job file of tasks to run on the ranks")
    ap.add_argument("--timeout", type=float, default=None, help="seconds before the ranks are killed")
    argv = sys.argv[1:] if argv is None else argv
    args = ap.parse_args(argv)
    if not pmesh.is_rank():
        code = pmesh.launch(["-m", "ai_font_renderer_tpu_torch.tools.dryrun_multichip", *argv], args.ranks,
                            args.device, args.backend, args.timeout)
        if code == 0 and args.job is None:
            print("dryrun_multichip ok", flush=True)
        return code
    pmesh.init_rank()
    try:
        if args.job:
            run_job(args.job)
        else:
            dryrun(args.ranks)
    finally:
        pmesh.finish_rank()
    return 0


if __name__ == "__main__":
    sys.exit(main())
