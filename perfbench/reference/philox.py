"""Philox4x32-10 in plain PyTorch: a frozen copy of the generator that the
program's attention kernels draw their dropout bits from.

The counter-based generator of Salmon et al., "Parallel random numbers: as
easy as 1, 2, 3" (SC 2011), with Random123's constants and 10 rounds. The
dropout mask of the attention probabilities [B, H, S, S] draws one 32-bit
word per element: element ``o = ((b*H + h)*S + s)*S + t`` (its flat offset)
takes word ``o & 3`` of the 4-word block at counter ``o >> 2``, under the
key (seed, SALT), and is kept where its word is below ``keep_threshold``.
"""

from __future__ import annotations

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
SALT = 0x41465231  # the key's second word; the first is the seed
ROUNDS = 10
_U32 = 0xFFFFFFFF


def keep_threshold(rate: float) -> int:
    """Words below this are kept: min(int((1 - rate) * 2^32), 2^32 - 1), as
    the JAX package computes it (ops/fused_attention.py:270)."""
    return min(int((1.0 - rate) * 2**32), 2**32 - 1)


def _mulhilo(a: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of a * m for uint32 values held in int64; m is
    split into 16-bit halves so that no product leaves int64."""
    x = a * (m >> 16)  # < 2^48
    y = a * (m & 0xFFFF)  # < 2^48
    hi = (x + (y >> 16)) >> 16
    lo = (((x & 0xFFFF) << 16) + y) & _U32
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 of the counter (c0, c1, c2, c3) under the key (k0, k1):
    uint32 words held in int64 tensors (or ints) that broadcast together.
    Returns the 4 output words."""
    for r in range(ROUNDS):
        if r:
            k0 = (k0 + W0) & _U32
            k1 = (k1 + W1) & _U32
        hi0, lo0 = _mulhilo(c0, M0)
        hi1, lo1 = _mulhilo(c2, M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def dropout_bits(seed: torch.Tensor, shape, batch_start: int = 0) -> torch.Tensor:
    """The uint32 words (as int64) of the probabilities [B, H, S, S] of
    samples ``batch_start`` .. ``batch_start + B - 1``: word ``o & 3`` of
    block ``o >> 2`` for each element's flat offset ``o`` in the whole
    batch. ``seed`` is a 1-element integer tensor; its device is used."""
    B, H, S, T = shape
    per_sample = H * S * T
    start = batch_start * per_sample
    n = B * per_sample
    first, last = start >> 2, (start + n - 1) >> 2
    counters = torch.arange(first, last + 1, device=seed.device, dtype=torch.int64)
    zero = torch.zeros_like(counters)
    key0 = seed.reshape(()).to(torch.int64) & _U32
    words = torch.stack(philox4x32_10(counters & _U32, counters >> 32, zero, zero, key0, SALT), dim=-1)
    words = words.reshape(-1)
    lo = start - (first << 2)
    return words[lo : lo + n].reshape(B, H, S, T)


def dropout_keep(seed: torch.Tensor, shape, rate: float, batch_start: int = 0) -> torch.Tensor:
    """The keep mask (bool [B, H, S, S]) of the attention probabilities at
    dropout ``rate`` under ``seed``."""
    return dropout_bits(seed, shape, batch_start) < keep_threshold(rate)
