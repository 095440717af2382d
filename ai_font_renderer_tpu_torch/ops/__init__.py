"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version."""

from .fused_attention import (
    fused_attention,
    fused_attention2,
    fused_attention2_backward,
    fused_attention_backward,
    fused_attention_backward_reference,
    fused_attention_reference,
)
from .fused_dw_adamw import (
    fused_dw_adamw,
    fused_dw_adamw_reference,
    fused_dw_adamw_xt,
    fused_dw_adamw_xt_reference,
)
from .fused_output import (
    FusedOutputFunction,
    dx_operands_reference,
    fused_output,
    fused_output_dw,
    fused_output_dw_reference,
    fused_output_dx,
    fused_output_dx_reference,
    fused_output_fwd,
    fused_output_reference,
    gemm_bf16_mn,
    gemm_bf16_mn_reference,
    gemm_bf16_tn,
    gemm_bf16_tn_reference,
    round_bf16,
    round_bf16_reference,
)

__all__ = [
    "FusedOutputFunction",
    "dx_operands_reference",
    "fused_attention",
    "fused_attention2",
    "fused_attention2_backward",
    "fused_attention_backward",
    "fused_attention_backward_reference",
    "fused_attention_reference",
    "fused_dw_adamw",
    "fused_dw_adamw_reference",
    "fused_dw_adamw_xt",
    "fused_dw_adamw_xt_reference",
    "fused_output",
    "fused_output_dw",
    "fused_output_dw_reference",
    "fused_output_dx",
    "fused_output_dx_reference",
    "fused_output_fwd",
    "fused_output_reference",
    "gemm_bf16_mn",
    "gemm_bf16_mn_reference",
    "gemm_bf16_tn",
    "gemm_bf16_tn_reference",
    "round_bf16",
    "round_bf16_reference",
]
