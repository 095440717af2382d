"""Model inputs from strings (own copy of the JAX package's encode_codes)."""

from __future__ import annotations

import numpy as np


def encode_codes(strings: list[str], max_chars: int) -> np.ndarray:
    """ord() codes masked to 7 bits, zero-padded to ``max_chars`` -> int32
    [N, max_chars]. Longer strings are cut at ``max_chars``.

    One UTF-32 encode of all strings, each padded with NULs (code 0, the
    padding code), instead of an ord() per character: the Python loop cost
    tens of milliseconds for a 4096-string atlas."""
    padded = "".join(s[:max_chars].ljust(max_chars, "\0") for s in strings)
    raw = np.frombuffer(padded.encode("utf-32-le", "surrogatepass"), np.uint32)
    return (raw & 0x7F).astype(np.int32).reshape(len(strings), max_chars)
