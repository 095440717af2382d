"""Text layout: model inputs from strings, word wrap and monospace grids.

The port's own copy of ai_font_renderer_tpu/fontgen/layout.py. The layout
is the reference generator's canvas layout: greedy word wrap over
``split(" ")`` tokens, a line pushed only when the candidate overflows AND
the current line is non-empty (consecutive spaces give empty tokens that
extend the line with bare separators, an all-space string wraps to zero
lines); text width is the sum of per-character advances plus pair kerning.
For a monospace font every character lands on a fixed (line, slot) cell,
which makes sheet synthesis a static einsum (``sheets.py``).
"""

from __future__ import annotations

import numpy as np

from ..config import SheetSpec


class AdvanceTable:
    """Per-character advance widths (px) for a charset, plus pair kerning."""

    def __init__(self, charset: str, advances_px: np.ndarray, kerning=None):
        self.charset = charset
        self.advances_px = np.asarray(advances_px, np.float64)
        self._index = {c: i for i, c in enumerate(charset)}
        self.kerning = kerning  # fontgen.kerning.KerningTable or None
        self.is_monospace = bool(
            len(advances_px) > 0
            and np.all(advances_px == advances_px[0])
            and not (kerning and len(kerning))
        )

    def char_index(self, ch: str) -> int:
        """Charset index for ``ch``; unknown chars map to index 0 (space)."""
        return self._index.get(ch, 0)

    def kern(self, left: str, right: str) -> float:
        return self.kerning.get(left, right) if self.kerning else 0.0

    def measure(self, text: str) -> float:
        """Shaped width: advance sum + pair-kern adjustments."""
        if self.is_monospace:  # every char advances the same
            return len(text) * float(self.advances_px[0])
        w = float(sum(self.advances_px[self.char_index(c)] for c in text))
        if self.kerning:
            w += sum(self.kern(a, b) for a, b in zip(text, text[1:]))
        return w


def wrap_text(text: str, advances: AdvanceTable, max_width: float) -> list[str]:
    """Greedy word wrap, the reference generator's rule."""
    words = text.split(" ")
    lines: list[str] = []
    current = ""
    for word in words:
        test = f"{current} {word}" if current else word
        if advances.measure(test) > max_width and current:
            lines.append(current)
            current = word
        else:
            current = test
    if current:
        lines.append(current)
    return lines


def layout_to_grid(
    text: str,
    advances: AdvanceTable,
    spec: SheetSpec,
    n_lines: int,
    n_slots: int,
) -> np.ndarray:
    """Lay out one string onto the monospace (line, slot) grid -> int16
    [n_lines, n_slots] of charset indices; 0 (space, ink-free) marks empty
    cells. Characters past the last slot are dropped (clipped at the sheet
    edge); strings longer than ``spec.max_chars`` are cut first."""
    if len(text) > spec.max_chars:
        text = text[: spec.max_chars]
    grid = np.zeros((n_lines, n_slots), np.int16)
    lines = wrap_text(text, advances, spec.width - 2 * spec.padding)
    for li, line in enumerate(lines[:n_lines]):
        for j, ch in enumerate(line[:n_slots]):
            grid[li, j] = advances.char_index(ch)
    return grid


def encode_codes(strings: list[str], max_chars: int) -> np.ndarray:
    """ord() codes masked to 7 bits, zero-padded to ``max_chars`` -> int32
    [N, max_chars]. Longer strings are cut at ``max_chars``.

    One UTF-32 encode of all strings, each padded with NULs (code 0, the
    padding code), instead of an ord() per character: the Python loop cost
    tens of milliseconds for a 4096-string atlas."""
    padded = "".join(s[:max_chars].ljust(max_chars, "\0") for s in strings)
    raw = np.frombuffer(padded.encode("utf-32-le", "surrogatepass"), np.uint32)
    return (raw & 0x7F).astype(np.int32).reshape(len(strings), max_chars)


def encode_grids(
    strings: list[str],
    advances: AdvanceTable,
    spec: SheetSpec,
    n_lines: int,
    n_slots: int,
) -> np.ndarray:
    """Batch version of :func:`layout_to_grid` -> int16 [N, n_lines, n_slots]."""
    out = np.zeros((len(strings), n_lines, n_slots), np.int16)
    for i, s in enumerate(strings):
        out[i] = layout_to_grid(s, advances, spec, n_lines, n_slots)
    return out
