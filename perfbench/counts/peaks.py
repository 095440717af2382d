"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), dense, at the full
700 W power limit: NVIDIA's data sheet."""

FLOPS = {"bf16": 989e12, "f32": 67e12}  # tensor cores bf16; f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
