"""Reproducible random-text corpus generator.

Bit-exact reimplementation of the reference's seeded text generation
(generate_font.ts:164-199: a 32-bit LCG ``seed = seed*1664525 + 1013904223
mod 2^32`` normalized to [0,1), driving word lengths of 1-10 chars from A-Z,
space separated, total length uniform in [min_len, max_len]; per-sample seed
``index + 42``, generate_font.ts:204). Reproducing the exact 150k-string
corpus lets renders be compared against the reference pipeline string-for-
string.

The LCG multiply stays below 2^53 so JS float64 arithmetic is exact; plain
Python ints reproduce it bit-for-bit.

The port's own copy of ai_font_renderer_tpu/fontgen/textgen.py, code unchanged,
so both packages build the same corpus and glyphs.
"""

from __future__ import annotations

LCG_MULT = 1664525
LCG_INC = 1013904223
LCG_MOD = 4294967296  # 2^32


class SeededRandom:
    """The reference's LCG stream (generate_font.ts:164-170)."""

    __slots__ = ("seed",)

    def __init__(self, seed: int):
        self.seed = seed

    def __call__(self) -> float:
        self.seed = (self.seed * LCG_MULT + LCG_INC) % LCG_MOD
        return self.seed / LCG_MOD


def generate_text(seed: int, min_length: int = 10, max_length: int = 100) -> str:
    """One corpus string, bit-exact vs generate_font.ts:173-199."""
    random = SeededRandom(seed)
    parts: list[str] = []
    length = int(random() * (max_length - min_length + 1)) + min_length
    remaining = length
    while remaining > 0:
        word_len = min(int(random() * 10) + 1, remaining)
        word = "".join(chr(65 + int(random() * 26)) for _ in range(word_len))
        parts.append(word)
        remaining -= word_len
        if remaining > 0:
            parts.append(" ")
            remaining -= 1
    return "".join(parts)


def generate_corpus(
    num_samples: int,
    base_seed: int = 42,
    min_length: int = 10,
    max_length: int = 100,
) -> list[str]:
    """The full corpus: sample i uses seed ``i + base_seed``.

    (generate_font.ts:203-205 — note the reference numbers *files* 1-based
    but seeds 0-based: sample i -> seed i+42 -> file (i+1).bmp.)
    """
    return [generate_text(i + base_seed, min_length, max_length) for i in range(num_samples)]
