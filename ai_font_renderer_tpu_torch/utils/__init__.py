"""Utilities of the port: weight files, step checkpoints, run metrics."""

from .checkpoint import MODEL_FILENAME, CheckpointManager, load_params_with_config, save_params

__all__ = ["MODEL_FILENAME", "CheckpointManager", "load_params_with_config", "save_params"]
