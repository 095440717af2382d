"""What the benchmark takes from the program: its configs, built from a
configuration file, and the kernel flags of a profile word. Nothing else
of the program is imported here."""

from __future__ import annotations

import dataclasses
import os

# The program's --kernels words (tools/_common.py): ModelConfig and
# TrainConfig fields each sets.
KERNEL_FLAGS = {
    "output": ({"use_pallas_output": True}, {}),
    "fused": ({"use_pallas_output": True}, {"fused_dw_adamw": True}),
    "attention": ({"fused_attention": True}, {}),
    "attention_v2": ({"fused_attention_v2": True}, {}),
}


def configs(cfg: dict, model_changes: dict | None = None):
    """(ModelConfig, TrainConfig, SheetSpec) of a configuration file's
    ``model``, ``train`` and ``kernels``; ``model_changes`` replaces model
    fields (a control's lower-precision path)."""
    from ai_font_renderer_tpu_torch.config import ModelConfig, SheetSpec, TrainConfig

    mkw, tkw = dict(cfg["model"]), dict(cfg["train"])
    for word in filter(None, (w.strip() for w in cfg["kernels"].split(","))):
        if word == "none":
            continue
        if word not in KERNEL_FLAGS:
            raise ValueError(f"kernels {cfg['kernels']!r}: unknown {word!r}")
        mkw.update(KERNEL_FLAGS[word][0])
        tkw.update(KERNEL_FLAGS[word][1])
    mkw.update(model_changes or {})
    mcfg = ModelConfig(**mkw)
    spec = dataclasses.replace(SheetSpec(), width=mcfg.sheet_width, height=mcfg.sheet_height,
                               max_chars=mcfg.max_length)
    return mcfg, TrainConfig(**tkw), spec


def font_path(cfg: dict) -> str:
    from ai_font_renderer_tpu_torch.config import ASSETS_DIR

    return os.path.abspath(os.path.join(ASSETS_DIR, cfg["font"]))
