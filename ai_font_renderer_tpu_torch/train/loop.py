"""The training loop: device epochs + host control.

The port of ai_font_renderer_tpu/train/loop.py: the 80/20 split, the epoch
loop with validation, ReduceLROnPlateau or the cosine schedule, early
stopping with a best-weights copy, a wall-clock budget, eval renders, the
run manifests and ``metrics.jsonl``, and step checkpoints with a resume that
replays the uninterrupted run. The numerics run on the dataset's device;
the host shuffles indices, reads two scalars per epoch, steps the scheduler
and logs.

Each epoch's dropout generator is seeded from (``tcfg.seed``, epoch), so a
resumed run draws the same masks as an uninterrupted one without storing
any generator state; the shuffles replay from ``default_rng(seed + 1)``.

On a mesh (``mesh``, parallel/mesh.py) every rank runs this loop: the
corpus is replicated, each rank takes its columns of the batch indices and
its shard of the state, and the step averages over the data axis and splits
the projection over the model axis (train/step.py). Every rank draws the
same shuffles and dropout generators and reads the same losses, so they
take the same decisions; rank (0, 0) alone logs and writes the manifests,
``metrics.jsonl``, the eval renders and the checkpoints.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..config import ModelConfig, TrainConfig
from ..fontgen.dataset import DeviceDataset, split_permutation, split_sizes
from ..parallel.sharding import gather_params, shard_batch_idx, shard_state
from ..utils.checkpoint import CheckpointManager
from ..utils.metrics import MetricsLogger, Stopwatch
from . import step as train_step_mod
from .manifests import write_config_manifest, write_results_manifest
from .schedule import CosineSchedule, EarlyStopping, ReduceLROnPlateau


@dataclasses.dataclass
class TrainResult:
    params: dict
    best_val_loss: float
    final_epoch: int
    early_stopped: bool
    final_lr: float
    history: list


def _val_batches(val_idx: np.ndarray, batch_size: int):
    """Pad validation indices to whole batches with zero-weight repeats."""
    n = len(val_idx)
    steps = max(1, -(-n // batch_size))
    padded = np.zeros(steps * batch_size, np.int32)
    padded[:n] = val_idx
    padded[n:] = val_idx[-1] if n else 0
    weights = np.zeros(steps * batch_size, np.float32)
    weights[:n] = 1.0
    return (
        padded.reshape(steps, batch_size),
        weights.reshape(steps, batch_size),
    )


def epoch_generator(seed: int, epoch: int, device: torch.device) -> torch.Generator:
    """The dropout generator of one epoch, seeded from (seed, epoch)."""
    value = int(np.random.SeedSequence([seed, epoch]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(value)


def _detached_copy(params: dict) -> dict:
    return {k: v.detach().clone() for k, v in params.items()}


def _silent(*args, **kwargs) -> None:
    pass


def _all_agree(mesh, flag: bool, device) -> bool:
    """``flag``, or on a mesh whether it holds on any rank, so that every
    rank stops at the same epoch."""
    return flag if mesh is None else mesh.any(flag, device)


def _refuse_on_a_mesh(mcfg: ModelConfig, tcfg: TrainConfig) -> None:
    """The JAX package's two refusals on a mesh of more than one device
    (its train/loop.py), with its messages."""
    if tcfg.fused_dw_adamw:
        raise ValueError(
            "fused_dw_adamw is single-device only; train on a mesh "
            "with the standard step (TrainConfig(fused_dw_adamw=False))"
        )
    if mcfg.fused_attention or mcfg.fused_attention_v2:
        raise ValueError(
            "the fused attention kernels do not compose with this "
            "GSPMD sharding path (pallas_call is opaque to it); use "
            "the explicit shard_map DP step instead "
            "(parallel.make_shard_map_train_step — kernels run "
            "per-shard there, tested in test_parallel.py), or train "
            "with fused_attention=False / fused_attention_v2=False"
        )


def train(
    dataset: DeviceDataset,
    mcfg: ModelConfig = ModelConfig(),
    tcfg: TrainConfig = TrainConfig(),
    output_dir: str | None = None,
    eval_strings: list[str] | None = None,
    checkpoint_dir: str | None = None,
    resume: bool = False,
    log=print,
    state=None,
    mesh=None,
) -> TrainResult:
    """Train the font renderer on ``dataset``'s device; returns the best
    parameters and the run's statistics (on a mesh, the whole parameters on
    every rank).

    ``state``: the starting state (e.g. carried from the JAX package by
    ``train_state_from_jax``); by default parameters are drawn by
    ``font_renderer.init`` from a CPU generator seeded with ``tcfg.seed``
    (the same weights on every device) with zero moments. Its type must
    match ``tcfg.fused_dw_adamw``.
    """
    device = dataset.codes.device
    writes = mesh is None or mesh.is_main
    if not writes:
        log = _silent
    n = dataset.num_samples
    train_size, val_size = split_sizes(n, tcfg.validation_split)
    # Clamp to the train split, not the dataset, so the epoch reshape fits.
    batch_size = max(1, min(tcfg.batch_size, train_size))
    if mesh is not None:
        # Every rank takes equal rows: round the batch down to a multiple
        # of the data axis.
        batch_size = max(mesh.data, (batch_size // mesh.data) * mesh.data)
    if mesh is not None and mesh.size > 1:
        _refuse_on_a_mesh(mcfg, tcfg)
    log(f"Dataset split: {train_size} training samples, {val_size} validation samples")

    perm = split_permutation(n, tcfg.seed)
    train_idx = perm[:train_size].astype(np.int64)
    val_idx = perm[train_size:].astype(np.int64)
    steps_per_epoch = max(1, train_size // batch_size)
    val_batch_idx, val_weights = (torch.from_numpy(a).to(device) for a in _val_batches(val_idx, batch_size))
    val_batch_idx = val_batch_idx.long()

    if mesh is not None:
        val_batch_idx, val_weights = shard_batch_idx(mesh, val_batch_idx), shard_batch_idx(mesh, val_weights)
    if output_dir and writes:
        write_config_manifest(output_dir, mcfg, tcfg, batch_size, n)

    if state is None:
        from ..models import font_renderer

        params = font_renderer.init(torch.Generator().manual_seed(tcfg.seed), mcfg, "cpu")
        state = train_step_mod.state_from_params({k: v.to(device) for k, v in params.items()}, tcfg)
    if isinstance(state, train_step_mod.FusedTrainState) != tcfg.fused_dw_adamw:
        raise ValueError(
            f"a {type(state).__name__} does not match fused_dw_adamw={tcfg.fused_dw_adamw}"
        )
    if mesh is not None:
        state = shard_state(mesh, state)
    scheduler = ReduceLROnPlateau(
        lr=tcfg.learning_rate,
        factor=tcfg.scheduler_factor,
        patience=tcfg.scheduler_patience,
        min_lr=tcfg.min_learning_rate,
    )
    cosine = (
        CosineSchedule(
            peak_lr=tcfg.peak_learning_rate or tcfg.learning_rate,
            total_epochs=tcfg.num_epochs,
            warmup_epochs=tcfg.warmup_epochs,
            min_lr=tcfg.min_learning_rate,
        )
        if tcfg.schedule == "cosine"
        else None
    )
    early = EarlyStopping(patience=tcfg.early_stopping_patience)
    ckpt = CheckpointManager(checkpoint_dir) if checkpoint_dir else None
    start_epoch = 0
    if ckpt and resume and ckpt.latest_step() is not None:
        step_num, state, best, host = ckpt.restore(None, template=state, mesh=mesh)
        if host.get("has_best"):
            # The historical best snapshot, so a resumed run that never
            # improves still returns the true best.
            early.best_state = best
        start_epoch = step_num + 1
        scheduler.lr = host["lr"]
        scheduler.best = host["scheduler_best"]
        scheduler.num_bad_epochs = host["scheduler_bad_epochs"]
        early.best_loss = host["best_val_loss"]
        early.counter = host["early_counter"]
        log(f"Resumed from checkpoint at epoch {step_num}")

    metrics = MetricsLogger(
        f"{output_dir}/metrics.jsonl" if output_dir and writes else None,
        resume=start_epoch > 0,
    )
    shuffle_rng = np.random.default_rng(tcfg.seed + 1)
    # Replay the shuffles of the epochs before start_epoch, so a resumed run
    # draws the permutations an uninterrupted run would.
    for _ in range(start_epoch):
        shuffle_rng.permutation(train_size)
    history: list[dict] = []
    lr = scheduler.lr
    epoch = start_epoch - 1
    stopped = False
    watch = Stopwatch()
    train_t0 = time.perf_counter()

    for epoch in range(start_epoch, tcfg.num_epochs):
        if cosine is not None:
            lr = cosine.lr_at(epoch)
        epoch_perm = shuffle_rng.permutation(train_size)[: steps_per_epoch * batch_size]
        batch_idx = torch.from_numpy(train_idx[epoch_perm].reshape(steps_per_epoch, batch_size)).to(device)
        if mesh is not None:
            batch_idx = shard_batch_idx(mesh, batch_idx)
        state, train_loss, val_loss = train_step_mod.train_eval_epoch(
            state, dataset, batch_idx, val_batch_idx, val_weights, lr,
            epoch_generator(tcfg.seed, epoch, device), mcfg, tcfg, mesh,
        )
        val_loss = float(val_loss)
        train_loss = float(train_loss)
        if cosine is None:
            lr = scheduler.step(val_loss)
        is_best = early.update(val_loss, None)
        if is_best:
            # A real copy: the next epoch updates the parameters in place.
            early.best_state = _detached_copy(state.params)

        seconds = watch.lap()
        history.append(
            {
                "epoch": epoch,
                "train_loss": train_loss,
                "val_loss": val_loss,
                "lr": lr,
                "seconds": seconds,
            }
        )
        metrics.log(
            epoch=epoch,
            train_loss=train_loss,
            val_loss=val_loss,
            lr=lr,
            seconds=seconds,
            samples_per_sec=steps_per_epoch * batch_size / max(seconds, 1e-9),
        )

        if epoch % tcfg.eval_every == 0:
            status = (
                f"Epoch {epoch}, Train Loss: {train_loss:.6f}, "
                f"Val Loss: {val_loss:.6f}, LR: {lr:.6f}"
            )
            if is_best:
                status += " (New Best)"
            log(status)
            if output_dir and eval_strings:
                from ..render.render import render_strings

                params = state.params if mesh is None else gather_params(mesh, state.params)
                if writes:
                    render_strings(params, eval_strings, f"{output_dir}/epoch_{epoch}", mcfg)
        elif is_best:
            log(f"Epoch {epoch}, New best validation loss: {val_loss:.6f}")

        if ckpt and tcfg.checkpoint_every and (
            epoch % tcfg.checkpoint_every == 0 or epoch == tcfg.num_epochs - 1
        ):
            ckpt.save(
                epoch,
                state,
                # The current parameters stand in until a best exists;
                # has_best tells the restore to ignore them then.
                early.best_state if early.best_state is not None else state.params,
                {
                    "format": 2,
                    "has_best": early.best_state is not None,
                    "lr": lr,
                    "scheduler_best": scheduler.best,
                    "scheduler_bad_epochs": scheduler.num_bad_epochs,
                    "best_val_loss": early.best_loss,
                    "early_counter": early.counter,
                    "epoch": epoch,
                },
                mesh=mesh,
            )

        if early.should_stop:
            log(f"Early stopping at epoch {epoch}, Best Val Loss: {early.best_loss:.6f}")
            stopped = True
            break

        if tcfg.max_train_seconds is not None and _all_agree(
            mesh, time.perf_counter() - train_t0 >= tcfg.max_train_seconds, device
        ):
            log(
                f"Time budget ({tcfg.max_train_seconds:.0f}s) reached at "
                f"epoch {epoch}, Best Val Loss: {early.best_loss:.6f}"
            )
            stopped = True
            break

    best_params = early.best_state if early.best_state is not None else _detached_copy(state.params)
    if mesh is not None:
        best_params = gather_params(mesh, best_params)
    if not stopped:
        log(f"Training completed, Best Val Loss: {early.best_loss:.6f}")

    final_epoch = epoch + 1 if not stopped else epoch
    if output_dir and writes:
        write_results_manifest(output_dir, final_epoch, early.best_loss, lr, stopped)
    return TrainResult(
        params=best_params,
        best_val_loss=early.best_loss,
        final_epoch=final_epoch,
        early_stopped=stopped,
        final_lr=lr,
        history=history,
    )
