"""Device choice for every entry point of the port.

Entry points run on ``cuda`` unless the caller asks for ``"cpu"``. When
``cuda`` is asked for and there is no card, they raise: nothing silently
continues on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None``/``"cuda"`` -> the card (raises without one); ``"cpu"`` -> CPU.

    Also switches TF32 off for float32 products and convolutions: the JAX
    package computes its float32 work at full precision, and the port is
    held against it.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was asked for but torch.cuda.is_available() is False; "
            "pass device='cpu' (CLI: --device cpu) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
