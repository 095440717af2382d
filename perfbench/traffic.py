"""The one generator every traffic mix goes through.

A mix is a data file, ``perfbench/traffic/<mix>.json``; its ``kind`` names
the driver that runs it (``perfbench/<kind>_cell.py``) and the rest are
parameters read here and there: the corpus's string lengths and base seed,
and the sizes of a call. The corpus is the reference's LCG text
(generate_font.ts:173-205), built by the program's own corpus builders.
The run's ``--seed`` draws everything else: the train/validation split,
each epoch's shuffle, the weights and the dropout, so two seeds do the
same amount of work in another order.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent


def load(name: str, root: Path = HERE) -> dict:
    """The mix's parameters, from ``traffic/<name>.json`` under ``root`` (the
    benchmark's directory)."""
    return json.loads((root / "traffic" / f"{name}.json").read_text())


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one use (``stream``) of the run's seed."""
    return np.random.default_rng([int(seed), int(stream)])


def torch_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for a torch.Generator, from the run's seed and a use."""
    return int(np.random.SeedSequence([int(seed), int(stream)]).generate_state(1, np.uint64)[0] >> 1)


def build_dataset(font_path: str, n: int, mix: dict, spec, device):
    """The training corpus on ``device`` through the program's entry points
    (``build_device_dataset``, the monospace grid, or
    ``build_device_dataset_prop``, the proportional pen walk): the first
    ``n`` strings of the mix's corpus, targets synthesized on the device and
    kept 8-bit. Those builders make the reference's 10-100 character
    strings only."""
    from ai_font_renderer_tpu_torch.fontgen import (bake_atlas, bake_prop_atlas, build_device_dataset,
                                                    build_device_dataset_prop)
    from ai_font_renderer_tpu_torch.fontgen.dataset import font_is_monospace

    if (mix["min_length"], mix["max_length"]) != (10, 100):
        raise ValueError(f"lengths {mix['min_length']}-{mix['max_length']}: the program's corpus builders "
                         "make 10-100 characters")
    if font_is_monospace(font_path):
        return build_device_dataset(bake_atlas(font_path, spec), n, mix["corpus_seed"], device=device)
    return build_device_dataset_prop(bake_prop_atlas(font_path, spec), n, mix["corpus_seed"], device=device)


def train_split(n: int, validation_split: float, seed: int) -> np.ndarray:
    """The training rows of an ``n``-row corpus: the loop's 80/20 split
    (``split_sizes``), its permutation drawn from the seed."""
    val = int(validation_split * n)
    return seed_rng(seed, 1).permutation(n)[: n - val].astype(np.int64)


class BatchStream:
    """Batches of training rows, epoch after epoch, each epoch a fresh
    shuffle of ``rows`` drawn from the seed and cut to whole batches, as
    the training loop draws them. ``take(k)`` gives the next ``k`` batches
    as a [k, B] index tensor on ``device``; batches never span two epochs,
    so a call ends where its epoch ends."""

    def __init__(self, rows: np.ndarray, batch: int, seed: int, device):
        self.rows, self.batch, self.device = rows, batch, device
        self.rng = seed_rng(seed, 2)
        self.steps = len(rows) // batch
        if self.steps < 1:
            raise ValueError(f"{len(rows)} training rows make no batch of {batch}")
        self.epoch = None
        self.pos = self.steps

    def take(self, k: int) -> torch.Tensor:
        if self.pos == self.steps:
            perm = self.rng.permutation(len(self.rows))[: self.steps * self.batch]
            self.epoch = torch.from_numpy(self.rows[perm].reshape(self.steps, self.batch)).to(self.device)
            self.pos = 0
        k = min(k, self.steps - self.pos)
        out = self.epoch[self.pos : self.pos + k]
        self.pos += k
        return out
