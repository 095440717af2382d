"""Sharding rules: which parameter and batch axes live on which mesh axis.

The port of ai_font_renderer_tpu/parallel/sharding.py, with the same rules:

* ``out_w`` [6400, 19200], 99.99% of the parameters, splits its output
  columns over the ``model`` axis (column parallelism): each rank computes a
  [B/data, 19200/model] slice of the sheet, through K1 on its shard under
  ``use_pallas_output``; ``out_b`` splits with it; every other parameter is
  replicated;
* batches split over ``data``; the AdamW moments follow their parameter,
  ``FusedTrainState``'s ``mu_w``/``nu_w`` follow out_w;
* the corpus on the device is replicated, so each rank gathers its batches
  locally.

Where the JAX package places global arrays on the mesh, a rank here holds
its own shard as a plain contiguous tensor (what the kernels' entry points
take), and :func:`gather_params`/:func:`gather_state` put the whole back
together. The same weights come from the same seed on every rank, so a
replicated tensor needs no communication.
"""

from __future__ import annotations

import torch

from .mesh import DATA_AXIS, MODEL_AXIS, Mesh


def param_spec(name: str) -> tuple:
    """The mesh axis of each dimension of parameter ``name`` (None:
    replicated), as the JAX package's PartitionSpec."""
    if name == "out_w":
        return (None, MODEL_AXIS)
    if name == "out_b":
        return (MODEL_AXIS,)
    return ()


def _split(mesh: Mesh, name: str, t: torch.Tensor) -> torch.Tensor:
    if MODEL_AXIS not in param_spec(name) or mesh.model == 1:
        return t
    return mesh.columns(t.detach()).clone().requires_grad_(t.requires_grad)


def _join(mesh: Mesh, name: str, t: torch.Tensor) -> torch.Tensor:
    if MODEL_AXIS not in param_spec(name) or mesh.model == 1:
        return t
    return mesh.gather_columns(t.detach()).requires_grad_(t.requires_grad)


def shard_params(mesh: Mesh, params: dict) -> dict:
    """This rank's shard of each parameter (a copy where split)."""
    return {k: _split(mesh, k, v) for k, v in params.items()}


def gather_params(mesh: Mesh, params: dict) -> dict:
    """The whole parameters from every rank's shards, on every rank (a
    collective: every rank of the mesh calls it)."""
    return {k: _join(mesh, k, v) for k, v in params.items()}


def _map_state(fn, mesh: Mesh, state):
    from ..train.step import FusedTrainState, TrainState

    moments = {k: fn(mesh, k, v) for k, v in state.mu.items()}, {k: fn(mesh, k, v) for k, v in state.nu.items()}
    params = {k: fn(mesh, k, v) for k, v in state.params.items()}
    if isinstance(state, FusedTrainState):
        return FusedTrainState(params, *moments, fn(mesh, "out_w", state.mu_w), fn(mesh, "out_w", state.nu_w),
                               state.count)
    return TrainState(params, *moments, state.count)


def shard_state(mesh: Mesh, state):
    """This rank's shard of a TrainState or FusedTrainState: parameters by
    :func:`param_spec`, each moment like its parameter."""
    return _map_state(_split, mesh, state)


def gather_state(mesh: Mesh, state):
    """The whole state from every rank's shards (a collective)."""
    return _map_state(_join, mesh, state)


def replicate(mesh: Mesh, tree):
    """A tree every rank holds whole: each rank keeps its own copy, built
    from the same seed, so there is nothing to move."""
    return tree


def shard_batch(mesh: Mesh, codes: torch.Tensor, targets: torch.Tensor):
    """This rank's rows of a batch, split over the data axis."""
    rows = mesh.data_rows(codes.shape[0])
    return codes[rows], targets[rows]


def shard_batch_idx(mesh: Mesh, batch_idx: torch.Tensor) -> torch.Tensor:
    """This rank's columns of per-epoch batch indices [steps, B]."""
    return batch_idx[:, mesh.data_rows(batch_idx.shape[1])]


__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "gather_params",
    "gather_state",
    "param_spec",
    "replicate",
    "shard_batch",
    "shard_batch_idx",
    "shard_params",
    "shard_state",
]
