"""Hand-written CUDA kernels of the serving path, each beside its plain
PyTorch version."""

from .fused_attention import fused_attention, fused_attention2, fused_attention_reference
from .fused_output import fused_output, fused_output_reference

__all__ = [
    "fused_attention",
    "fused_attention2",
    "fused_attention_reference",
    "fused_output",
    "fused_output_reference",
]
