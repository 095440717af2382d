"""Gathers of table rows whose gradient is taken: the flagship's and the
placement net's embeddings, the placement head's advance and kern tables,
the SIREN bank's and the multifont model's embeddings."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gather_rows(table: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """table[codes]: a 1-D table's entries, else its rows. The backward sums
    each row's gradients in a fixed order on either device, so a resumed
    run replays the uninterrupted one bit for bit:

    * on the CPU through ``F.embedding``, whose backward is bit-equal to
      the JAX package's gather VJP; the index form's CPU backward adds
      across threads in no fixed order;
    * on the card through the index form (``index_put_`` with
      accumulation, a sorted reduction). ``F.embedding``'s CUDA backward
      is faster there but differs from run to run in the last bits
      (``chip_smoke.py``, phase 10, ``_embedding_backward_forms``).
    """
    if table.device.type != "cpu":
        return table[codes]
    if table.dim() == 1:
        return F.embedding(codes, table[:, None])[..., 0]
    return F.embedding(codes, table)
