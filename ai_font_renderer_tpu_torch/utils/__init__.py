"""Utilities of the port: weight files."""

from .checkpoint import MODEL_FILENAME, load_params_with_config, save_params

__all__ = ["MODEL_FILENAME", "load_params_with_config", "save_params"]
