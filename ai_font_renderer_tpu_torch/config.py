"""Configuration of the PyTorch/CUDA port.

Its own copy of the JAX package's ``ModelConfig``, ``SheetSpec`` and
``replace`` (ai_font_renderer_tpu/config.py): the same fields, names and
defaults, so a config and a checkpoint mean the same thing in both
packages. ``TrainConfig`` comes with the training slice.

Three fields select the Hopper kernels of this package instead of the plain
PyTorch code: ``use_pallas_output`` (ops/fused_output.py),
``fused_attention`` and ``fused_attention_v2`` (ops/fused_attention.py).
The names stay those of the JAX package. The TPU tile fields
(``fused_attention_tile``, ``fa2_tile_fwd``, ``fa2_tile_bwd``) are kept for
checkpoint and config parity but gate nothing here: the CUDA attention
kernel takes any batch.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class SheetSpec:
    """Geometry of a rendered text sheet: 240x80, 12 px font, 1.2x line
    height, no padding, at most 100 characters."""

    width: int = 240
    height: int = 80
    font_size: float = 12.0
    line_height_factor: float = 1.2
    padding: float = 0.0
    max_chars: int = 100

    @property
    def line_height(self) -> float:
        return self.font_size * self.line_height_factor

    @property
    def pixels(self) -> int:
        return self.width * self.height


@dataclass(frozen=True)
class ModelConfig:
    """AttentionFontRenderer hyperparameters (same fields as the JAX
    package's ModelConfig)."""

    vocab_size: int = 128
    embedding_dim: int = 32
    num_heads: int = 4
    max_length: int = 100
    hidden_dim: int = 64
    # Number of (MHA -> residual -> post-LN) blocks before fc1; block-0
    # weights keep their flagship names, block i>0 carries a _b{i} suffix.
    num_blocks: int = 1
    dropout_rate: float = 0.2
    fc_dropout_rate: float = 0.25
    sheet_height: int = 80
    sheet_width: int = 240
    pos_init_std: float = 0.02
    # Output projection with bf16 operands and f32 accumulation.
    bf16_matmul: bool = True
    # Output projection through the fused GEMM+bias+clamp CUDA kernel
    # (ops/fused_output.py); implies bf16 operands.
    use_pallas_output: bool = False
    # Attention/MLP frontend activations in bf16 (LayerNorm and softmax
    # statistics stay f32).
    bf16_frontend: bool = False
    bits_dropout: bool = False
    # Attention block 0 through the fused attention CUDA kernel
    # (ops/fused_attention.py); v2 takes precedence when both are set.
    fused_attention: bool = False
    fused_attention_tile: int = 8
    fused_attention_v2: bool = False
    fa2_tile_fwd: int = 64
    fa2_tile_bwd: int = 32
    # "linear" is the only decoder of this slice; "conv"/"conv_ps" raise.
    decoder: str = "linear"
    decoder_grid: tuple[int, int] = (5, 20)
    decoder_channels: tuple[int, ...] = (128, 128, 64, 32, 16)
    bf16_cotangent: bool = False
    leaky_clamp: float = 0.0


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
