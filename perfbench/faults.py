"""Faults planted in the program underneath a run, to read what the check
makes of a broken timed path (``readings.py --fault``, and the CPU tests).
The benchmark's own runs plant none.

* ``unchanged``: a training call that returns its state unchanged (it runs,
  and reports its loss, but the state it hands back is the one it got);
* ``half_batch``: half of each batch left out, the mean taken over the rest.

``late`` spares the calls of one step, the first steps that set-up checks,
so that only calls of the window's shape (the warm calls, the checked call
and the window's) carry the fault: what a change to multi-step calls alone
would break.
"""

from __future__ import annotations

import contextlib

import torch


def _state_tensors(state) -> list[torch.Tensor]:
    out = [*state.params.values(), *state.mu.values(), *state.nu.values()]
    return out + [getattr(state, k) for k in ("mu_w", "nu_w") if hasattr(state, k)]


class _HalfBatch:
    """A dataset whose batches keep their first half of rows."""

    def __init__(self, dataset):
        self.dataset = dataset

    def gather_batch(self, idx):
        return self.dataset.gather_batch(idx[: idx.shape[0] // 2])


@contextlib.contextmanager
def planted(name: str, late: bool = False):
    """The program with fault ``name`` planted in ``train.step.train_epoch``,
    until the block ends."""
    from ai_font_renderer_tpu_torch.train import step

    if name not in ("unchanged", "half_batch"):
        raise ValueError(f"unknown fault {name!r}")
    real = step.train_epoch

    def fake(state, dataset, batch_idx, *args, **kwargs):
        if late and batch_idx.shape[0] == 1:
            return real(state, dataset, batch_idx, *args, **kwargs)
        if name == "half_batch":
            return real(state, _HalfBatch(dataset), batch_idx, *args, **kwargs)
        before = [t.detach().clone() for t in _state_tensors(state)]
        count = state.count
        state, loss = real(state, dataset, batch_idx, *args, **kwargs)
        with torch.no_grad():
            for t, b in zip(_state_tensors(state), before):
                t.copy_(b)
        state.count = count
        return state, loss

    step.train_epoch = fake
    try:
        yield
    finally:
        step.train_epoch = real
