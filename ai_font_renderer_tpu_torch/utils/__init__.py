"""Utilities of the port: weight files, step checkpoints, run metrics,
profiling."""

from .checkpoint import MODEL_FILENAME, CheckpointManager, load_params_with_config, save_params
from .profiling import device_memory_stats, timed, trace

__all__ = [
    "MODEL_FILENAME",
    "CheckpointManager",
    "load_params_with_config",
    "save_params",
    "device_memory_stats",
    "timed",
    "trace",
]
