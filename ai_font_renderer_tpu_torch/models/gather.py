"""Gathers of table rows whose gradient is taken: the flagship's and the
placement net's embeddings, the placement head's advance and kern tables,
the SIREN bank's and the multifont model's embeddings."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ..ops.gather_rows import gather_rows_backward


class _GatherRowsFunction(torch.autograd.Function):
    """table [V, E] gathered at codes: forward ``table[codes]``, backward
    ``ops.gather_rows_backward``, the kernels' fixed order of sums."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(codes)
        ctx.num_rows = table.shape[0]
        return table[codes]

    @staticmethod
    @once_differentiable
    def backward(ctx, grad: torch.Tensor):
        (codes,) = ctx.saved_tensors
        return gather_rows_backward(codes.contiguous(), grad.contiguous(), ctx.num_rows, grad.dtype), None


def gather_rows(table: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """table[codes]: a 1-D table's entries, else its rows. The backward sums
    each row's gradients in a fixed order on either device, so a resumed
    run replays the uninterrupted one bit for bit:

    * on the CPU through ``F.embedding``, whose backward is bit-equal to
      the JAX package's gather VJP; the index form's CPU backward adds
      across threads in no fixed order;
    * on the card through ``ops.gather_rows_backward`` (csrc/gather_rows.cu):
      for an f32 table, f32 sums in an order set by the shapes alone; for a
      bf16 table, the index form's order (each row's tokens in token
      order), which the benchmark's reference computes, and its bits at
      widths 32 and 64 (the card tests). The index
      form's backward (``index_put_`` with accumulation) walked each row's
      duplicates in series, waiting on two loads for each, and
      ``F.embedding``'s CUDA backward differs from run to run in the last
      bits (``chip_smoke.py``, phase 10, ``_embedding_backward_forms``).
      Without a gradient to take, the card gathers ``table[codes]``.
    """
    if table.device.type == "cpu":
        if table.dim() == 1:
            return F.embedding(codes, table[:, None])[..., 0]
        return F.embedding(codes, table)
    if not (torch.is_grad_enabled() and table.requires_grad):
        return table[codes]
    if table.dim() == 1:
        return _GatherRowsFunction.apply(table[:, None], codes)[..., 0]
    return _GatherRowsFunction.apply(table, codes)
