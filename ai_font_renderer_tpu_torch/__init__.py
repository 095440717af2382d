"""PyTorch/CUDA port of the font renderer, for one NVIDIA H100.

Mirrors the module layout of ``ai_font_renderer_tpu`` (the JAX reference)
and imports nothing from it. Plain tensor code is PyTorch; the TPU kernels
of the serving path are hand-written CUDA kernels for sm_90a under
``csrc/``, built at first use.
"""

__version__ = "0.1.0"
