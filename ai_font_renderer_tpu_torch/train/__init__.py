"""Training: device epochs + host-side control (scheduler, early stop)."""

from .loop import TrainResult, train
from .schedule import CosineSchedule, EarlyStopping, ReduceLROnPlateau
from .step import (
    FusedTrainState,
    TrainState,
    eval_epoch,
    init_fused_state,
    init_state,
    mse_loss,
    train_epoch,
    train_eval_epoch,
    train_state_from_jax,
    train_step,
)

__all__ = [
    "CosineSchedule",
    "EarlyStopping",
    "FusedTrainState",
    "ReduceLROnPlateau",
    "TrainResult",
    "TrainState",
    "eval_epoch",
    "init_fused_state",
    "init_state",
    "mse_loss",
    "train",
    "train_epoch",
    "train_eval_epoch",
    "train_state_from_jax",
    "train_step",
]
