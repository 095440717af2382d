"""Model weights in one npz file, interchangeable with the JAX package's.

Same format as ai_font_renderer_tpu/utils/checkpoint.py: one array per flat
parameter key plus a ``__config__`` entry holding the architecture fields
as JSON. A file written by either package loads in the other with the same
arrays and config. Full training-state checkpoints and ``.pth`` interop
come with later slices of the port.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from ..config import ModelConfig
from ..device import resolve_device
from ..models.font_renderer import infer_model_config, params_from_jax

MODEL_FILENAME = "font_renderer.npz"

# Architecture fields persisted inside the npz. Runtime knobs (bf16_matmul,
# fused_attention, ...) change how the weights run, not the function they
# define, and are not saved.
_CONFIG_KEY = "__config__"
_CONFIG_FIELDS = (
    "vocab_size",
    "embedding_dim",
    "num_heads",
    "max_length",
    "hidden_dim",
    "num_blocks",
    "sheet_height",
    "sheet_width",
    "decoder",
    "decoder_grid",
    "decoder_channels",
)


def _refuse_pth(filename: str) -> None:
    if filename.endswith(".pth"):
        raise NotImplementedError(
            ".pth interop comes with a later slice of the port "
            "(ROADMAP queue 1, item 10); use an .npz file"
        )


def save_params(params, filename: str = MODEL_FILENAME, mcfg: ModelConfig | None = None) -> None:
    """Save weights (tensors or arrays) to one npz; with ``mcfg``, embed its
    architecture fields as the ``__config__`` JSON entry."""
    _refuse_pth(filename)
    flat = {
        k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        for k, v in params.items()
    }
    if mcfg is not None:
        flat[_CONFIG_KEY] = np.array(json.dumps({f: getattr(mcfg, f) for f in _CONFIG_FIELDS}))
    d = os.path.dirname(filename)
    if d:
        os.makedirs(d, exist_ok=True)
    np.savez(filename, **flat)
    print(f"Model saved to {filename}")


def load_params_with_config(
    filename: str = MODEL_FILENAME,
    base="default",
    device: str | torch.device | None = None,
):
    """Load weights plus their architecture config -> (params, mcfg | None).

    The config comes from the ``__config__`` entry when the file has one,
    else from the shapes (``infer_model_config``). ``base`` supplies the
    fields a file does not fix; ``base=None`` returns (params, None).
    """
    _refuse_pth(filename)
    dev = resolve_device(device)
    with np.load(filename) as z:
        cfg_json = str(z[_CONFIG_KEY][()]) if _CONFIG_KEY in z.files else None
        arrays = {k: z[k] for k in z.files if k != _CONFIG_KEY}
    params = params_from_jax(arrays, dev)
    print(f"Model loaded from {filename}")
    if base is None:
        return params, None
    base_cfg = ModelConfig() if base == "default" else base
    if cfg_json is not None:
        kw = json.loads(cfg_json)
        for tup_field in ("decoder_grid", "decoder_channels"):
            if tup_field in kw:
                kw[tup_field] = tuple(kw[tup_field])
        return params, dataclasses.replace(base_cfg, **kw)
    return params, infer_model_config(params, base_cfg)
