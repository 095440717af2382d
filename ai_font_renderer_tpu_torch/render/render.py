"""Batched inference: strings -> sheets -> BMPs; chunked atlas rendering.

The port of ai_font_renderer_tpu/render/render.py. A whole list of strings
is one forward pass on the device that holds the weights. The launches are
asynchronous: only a fetch to the host (``.cpu()``) waits for the card, so
``render_batch_u8_async`` lets a caller queue several batches and fetch
them in order while the card works ahead.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import ModelConfig
from ..fontgen.bmp import write_bmp
from ..fontgen.layout import encode_codes
from ..models import font_renderer
from ..ops.quantized import apply_quantized_int8


def _codes(params, strings: list[str], mcfg: ModelConfig) -> torch.Tensor:
    """Encoded strings on the weights' device. On the card the copy goes
    through pinned memory without a stream sync, so queued work keeps
    running while the host encodes the next batch."""
    codes = torch.from_numpy(encode_codes(strings, mcfg.max_length))
    device = params["embedding"].device
    if device.type == "cuda":
        return codes.pin_memory().to(device, non_blocking=True)
    return codes


def _forward(params, codes: torch.Tensor, mcfg: ModelConfig) -> torch.Tensor:
    """Inference forward, dispatching on the weights' format: a serving
    bundle of ``ops.quantized.quantize_params`` (``out_w_q`` and
    ``out_w_scale`` in place of ``out_w``) runs the int8 x int8 projection,
    anything else ``font_renderer.apply``."""
    if "out_w_q" in params:
        return apply_quantized_int8(params, codes, mcfg)
    return font_renderer.apply(params, codes, mcfg)


@torch.inference_mode()
def render_batch(params, strings: list[str], mcfg: ModelConfig = ModelConfig()) -> np.ndarray:
    """Render strings in one forward pass -> float32 [N, H, W] on the host."""
    return _forward(params, _codes(params, strings, mcfg), mcfg).cpu().numpy()


@torch.inference_mode()
def render_batch_u8_async(
    params, strings: list[str], mcfg: ModelConfig = ModelConfig()
) -> torch.Tensor:
    """Launch a uint8 render and return the DEVICE tensor [N, H, W] without
    waiting. round(x * 255) runs on the device (half to even, as
    ``jnp.round``), so the host fetch moves a quarter of the f32 bytes."""
    sheets = _forward(params, _codes(params, strings, mcfg), mcfg)
    return torch.round(sheets * 255.0).to(torch.uint8)


def render_strings(
    params, strings: list[str], output_dir: str, mcfg: ModelConfig = ModelConfig()
) -> list[str]:
    """Render strings to ``{output_dir}/string_{idx}.bmp`` in one forward
    pass; warns about each string cut at max_length."""
    os.makedirs(output_dir, exist_ok=True)
    for s in strings:
        if len(s) > mcfg.max_length:
            print(
                f"Warning: String truncated to {mcfg.max_length} characters: "
                f"{s[: mcfg.max_length]}"
            )
    sheets = render_batch(params, strings, mcfg)
    paths = []
    for idx, sheet in enumerate(sheets):
        path = os.path.join(output_dir, f"string_{idx}.bmp")
        write_bmp(path, sheet)
        paths.append(path)
    print(f"Saved {len(strings)} rendered strings to {output_dir}/")
    return paths


@torch.inference_mode()
def render_atlas(
    params, strings: list[str], mcfg: ModelConfig = ModelConfig(), chunk: int = 1024
) -> torch.Tensor:
    """Render a large batch of sheets on the device in fixed-size chunks
    (the tail chunk padded with empty strings) -> device tensor [N, H, W].
    Nothing is fetched: callers time or consume it as they need."""
    codes = _codes(params, strings, mcfg)
    n = codes.shape[0]
    outs = []
    for start in range(0, n, chunk):
        part = codes[start : start + chunk]
        if part.shape[0] < chunk:
            part = torch.nn.functional.pad(part, (0, 0, 0, chunk - part.shape[0]))
        outs.append(_forward(params, part, mcfg))
    return torch.cat(outs, dim=0)[:n]
