"""Host-side training control state: plateau LR scheduling + early stopping.

Pure-Python replicas of the reference's control loop so loss-parity claims
hold step for step:

  * :class:`ReduceLROnPlateau` — semantics-exact vs torch's scheduler as the
    reference configures it (model.py:276-278: mode='min', factor=0.7,
    patience=20, min_lr=1e-6) including torch's defaults the reference
    inherits (threshold=1e-4 relative, cooldown=0): lr is reduced when no
    "significant" improvement (rel. 1e-4) has been seen for > patience
    epochs.
  * :class:`EarlyStopping` — strict-improvement patience counter with
    best-weights snapshot/restore (model.py:280-283,339-346,362-371).

Both are plain mutable state *around* the jitted train step — control
decisions happen on host once per epoch, so nothing here touches the
compiled graph.

The port's own copy of ai_font_renderer_tpu/train/schedule.py, code unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class ReduceLROnPlateau:
    lr: float
    factor: float = 0.7
    patience: int = 20
    min_lr: float = 1e-6
    threshold: float = 1e-4  # torch default, relative mode
    cooldown: int = 0

    best: float = float("inf")
    num_bad_epochs: int = 0
    cooldown_counter: int = 0

    def _is_better(self, metric: float) -> bool:
        return metric < self.best * (1.0 - self.threshold)

    def step(self, metric: float) -> float:
        """Record one epoch's metric; returns the (possibly reduced) lr."""
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.lr


@dataclass
class CosineSchedule:
    """Linear warmup -> cosine decay; the fast (non-parity) profile."""

    peak_lr: float
    total_epochs: int
    warmup_epochs: int = 1
    min_lr: float = 1e-6

    def lr_at(self, epoch: int) -> float:
        import math

        if self.warmup_epochs > 0 and epoch < self.warmup_epochs:
            return self.peak_lr * (epoch + 1) / self.warmup_epochs
        span = max(1, self.total_epochs - self.warmup_epochs)
        t = min(1.0, (epoch - self.warmup_epochs) / span)
        return self.min_lr + 0.5 * (self.peak_lr - self.min_lr) * (
            1.0 + math.cos(math.pi * t)
        )


@dataclass
class EarlyStopping:
    """Patience on strict val-loss improvement, keeping the best snapshot."""

    patience: int = 70
    best_loss: float = float("inf")
    counter: int = 0
    best_state: object = field(default=None, repr=False)

    def update(self, val_loss: float, state) -> bool:
        """Returns True if this epoch is a new best (snapshot taken)."""
        if val_loss < self.best_loss:
            self.best_loss = val_loss
            self.counter = 0
            self.best_state = state
            return True
        self.counter += 1
        return False

    @property
    def should_stop(self) -> bool:
        return self.counter >= self.patience
