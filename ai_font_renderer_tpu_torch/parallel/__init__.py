"""Parallelism: the device mesh and its sharding rules (DP batch, TP output
projection), the explicit DP step, and the launcher of ranks."""

from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, launch, make_mesh, single_device_mesh
from .shard_map_step import make_shard_map_train_step
from .sharding import (
    gather_params,
    gather_state,
    param_spec,
    replicate,
    shard_batch,
    shard_batch_idx,
    shard_params,
    shard_state,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "gather_params",
    "gather_state",
    "launch",
    "make_mesh",
    "make_shard_map_train_step",
    "param_spec",
    "replicate",
    "shard_batch",
    "shard_batch_idx",
    "shard_params",
    "shard_state",
    "single_device_mesh",
]
