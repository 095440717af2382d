"""Configuration of the PyTorch/CUDA port.

Its own copy of the JAX package's ``ModelConfig``, ``TrainConfig``,
``SheetSpec``, font paths and ``replace`` (ai_font_renderer_tpu/config.py):
the same fields, names and defaults, so a config and a checkpoint mean the
same thing in both packages.

Four fields select the Hopper kernels of this package instead of the plain
PyTorch code: ``ModelConfig.use_pallas_output`` (ops/fused_output.py: K1
forward, K2/K3 backward), ``ModelConfig.fused_attention`` and
``fused_attention_v2`` (ops/fused_attention.py: K5/K6 and K7/K8, forward
with dropout and backward, so both serve and train) and
``TrainConfig.fused_dw_adamw`` (ops/fused_dw_adamw.py, K4). The names stay
those of the JAX package. Fields kept for config parity that gate nothing
here: the TPU tile fields (``fused_attention_tile``, ``fa2_tile_fwd``,
``fa2_tile_bwd``; the CUDA attention kernels take any batch, and their
dropout mask does not depend on a tile) and ``TrainConfig.prng_impl``
(the port draws dropout from a ``torch.Generator`` and, inside the
attention kernels, from Philox, whatever JAX PRNG the field names).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

ASSETS_DIR = os.path.join(os.path.dirname(__file__), "..", "assets")
FIRACODE_PATH = os.path.abspath(os.path.join(ASSETS_DIR, "FiraCode-Retina.ttf"))
MONTSERRAT_PATH = os.path.abspath(os.path.join(ASSETS_DIR, "Montserrat-Regular.ttf"))

# Printable ASCII charset rendered into the glyph atlas. Index 0 is space,
# which must be ink-free (it doubles as the blank grid cell).
PRINTABLE_ASCII = "".join(chr(c) for c in range(32, 127))


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
    # "linear": the 6400x19200 projection. "conv": a pyramid of nearest
    # resize + 3x3 conv stages from a decoder_grid latent image of the slots;
    # "conv_ps": 3x3 convs at low resolution, each followed by a pixel shuffle.
    decoder: str = "linear"
    decoder_grid: tuple[int, int] = (5, 20)
    decoder_channels: tuple[int, ...] = (128, 128, 64, 32, 16)
    bf16_cotangent: bool = False
    leaky_clamp: float = 0.0

    def __post_init__(self):
        """The decoder fields' rules, which the JAX package checks when it
        initialises or plans a conv decoder."""
        if self.decoder not in ("linear", "conv", "conv_ps"):
            raise ValueError(f"decoder must be linear|conv|conv_ps, got {self.decoder!r}")
        if self.decoder == "linear":
            return
        gh, gw = self.decoder_grid
        if gh * gw != self.max_length:
            raise ValueError(
                f"decoder_grid {self.decoder_grid} must tile max_length={self.max_length}"
            )
        if self.decoder == "conv_ps" and (self.sheet_height % gh or self.sheet_width % gw):
            raise ValueError(
                f"decoder_grid {self.decoder_grid} must divide the sheet "
                f"({self.sheet_height}x{self.sheet_width}) for conv_ps"
            )


@dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (same fields and defaults as the JAX
    package's TrainConfig)."""

    num_epochs: int = 10000
    learning_rate: float = 1e-3
    batch_size: int = 1024
    early_stopping_patience: int = 70
    validation_split: float = 0.2
    weight_decay: float = 5e-4
    adam_b1: float = 0.9
    adam_b2: float = 0.99
    scheduler_patience: int = 20
    scheduler_factor: float = 0.7
    min_learning_rate: float = 1e-6
    seed: int = 42
    num_samples: int = 150000
    # "plateau": ReduceLROnPlateau on the val loss; "cosine": linear warmup
    # then cosine decay to min_learning_rate over num_epochs.
    schedule: str = "plateau"
    warmup_epochs: int = 1
    peak_learning_rate: float | None = None  # cosine peak; None -> learning_rate
    # Kept for config parity; gates nothing in the port (see the module doc).
    prng_impl: str = "rbg"
    # AdamW's first moment stored in bf16 (rounded to nearest even); the
    # update itself runs in f32 and the second moment stays f32.
    adam_mu_bf16: bool = True
    # The output projection's dW and its AdamW update fused into one CUDA
    # kernel (ops/fused_dw_adamw.py, K4): out_w's gradient never reaches
    # device memory.
    fused_dw_adamw: bool = False
    # The projection's backward written out by hand: the masked cotangent
    # is rounded to bf16 once and feeds both backward products. Requires
    # decoder='linear', leaky_clamp=0 and use_pallas_output=False.
    handrolled_bwd: bool = False
    # Recomputation of the frontend in the hand-rolled step's backward:
    # "none" stores every activation; "dots" keeps the matrix products'
    # outputs and recomputes the rest; "full" recomputes the whole frontend.
    remat_frontend: str = "none"
    # Wall-clock training budget in seconds (None = unlimited), checked
    # after each epoch; stops like early stopping.
    max_train_seconds: float | None = None
    eval_every: int = 5  # log + render the eval strings every N epochs
    checkpoint_every: int = 25  # 0 = only the final epoch

    def __post_init__(self):
        if self.remat_frontend not in ("none", "dots", "full"):
            raise ValueError(
                f"remat_frontend must be none|dots|full, got "
                f"{self.remat_frontend!r}"
            )
        if self.remat_frontend != "none" and not self.handrolled_bwd:
            raise ValueError(
                "remat_frontend only applies to the hand-rolled step; "
                "set handrolled_bwd=True"
            )


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
