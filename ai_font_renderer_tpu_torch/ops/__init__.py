"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (among them ``gather_rows``, the embedding gathers' backward, which
replaces XLA's scatter-add rather than a Pallas kernel); and ``quantized``,
int8 serving on cuBLASLt's int8 product, which the JAX package computes
with XLA rather than a Pallas kernel.

Importing this package registers the ``torch.library`` operators that an
exported program's graph calls (``afr::fused_output_fwd``,
``afr::attention_fwd``, ``afr::int8_product``); it imports nothing else of
the port."""

from .fused_attention import (
    attention_mma_attributes,
    attention_mma_bwd,
    attention_mma_fwd,
    attention_wide_attributes,
    attention_wide_bwd,
    attention_wide_fwd,
    attention_wide_plan,
    fused_attention,
    fused_attention2,
    fused_attention2_backward,
    fused_attention_attributes,
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
    bf16_shadow,
    dx_operands_reference,
    fused_output,
    fused_output_dw,
    fused_output_dw_reference,
    fused_output_dx,
    fused_output_dx_reference,
    fused_output_fwd,
    fused_output_reference,
    gemm_bf16_bias_clamp,
    gemm_bf16_bias_clamp_reference,
    gemm_bf16_mn,
    gemm_bf16_mn_reference,
    gemm_bf16_tn,
    gemm_bf16_tn_reference,
    round_bf16,
    round_bf16_reference,
)
from .gather_rows import (
    gather_rows_attributes,
    gather_rows_backward,
    gather_rows_backward_reference,
    gather_rows_plan,
)
from .quantized import int8_product

__all__ = [
    "FusedOutputFunction",
    "attention_mma_attributes",
    "attention_mma_bwd",
    "attention_mma_fwd",
    "attention_wide_attributes",
    "attention_wide_bwd",
    "attention_wide_fwd",
    "attention_wide_plan",
    "bf16_shadow",
    "dx_operands_reference",
    "fused_attention",
    "fused_attention2",
    "fused_attention2_backward",
    "fused_attention_attributes",
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
    "gather_rows_attributes",
    "gather_rows_backward",
    "gather_rows_backward_reference",
    "gather_rows_plan",
    "gemm_bf16_bias_clamp",
    "gemm_bf16_bias_clamp_reference",
    "gemm_bf16_mn",
    "gemm_bf16_mn_reference",
    "gemm_bf16_tn",
    "gemm_bf16_tn_reference",
    "int8_product",
    "round_bf16",
    "round_bf16_reference",
]
