"""Dataset assembly: corpus -> tensors on the device, for monospace and
proportional fonts, and the reference's disk format read back.

The port of ai_font_renderer_tpu/fontgen/dataset.py. The corpus lives on
the device:

  * ``codes``      int32 [N, 100]  model inputs (ord codes, zero-padded);
  * ``targets_u8`` uint8 [N, H, W] sheets synthesized once on the device by
    the atlas einsum and kept 8-bit (2.9 GB for 150k samples);

and a batch is gathered and dequantized on the device, so the host never
touches pixel data. The host-side layout (strings -> grids -> codes) is
cached under ``.cache/torch_corpus/``, a directory of the port's own.
A proportional font (Montserrat) is laid out by the pen walk of
``proportional.py`` and synthesized by its einsums. Synthesis runs in
chunks and pads none: the JAX package pads the last chunk to keep one
compiled shape, which eager torch does not need, and the rows are the same.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

from ..config import PRINTABLE_ASCII, SheetSpec
from ..device import resolve_device
from .atlas import GlyphAtlas, bake_atlas
from .layout import encode_codes, encode_grids
from .proportional import (
    PropAtlas,
    _synth,
    bake_prop_atlas,
    encode_prop_grids,
    prop_synth_operands,
    synthesize_prop_host,
)
from .sheets import make_synth_ops, synthesize_sheets, synthesize_sheets_host
from .textgen import generate_corpus


@dataclass
class DeviceDataset:
    """Device-resident corpus: inputs + 8-bit targets."""

    codes: torch.Tensor  # int32 [N, max_chars]
    targets_u8: torch.Tensor  # uint8 [N, H, W]

    @property
    def num_samples(self) -> int:
        return self.codes.shape[0]

    def gather_batch(self, idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Gather a batch on the device; targets dequantized to f32."""
        return self.codes[idx], self.targets_u8[idx].float() / 255.0


def _cache_root() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(__file__))), ".cache")


def build_layouts(
    atlas: GlyphAtlas,
    num_samples: int,
    base_seed: int = 42,
    cache_dir: str | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Generate the corpus strings and lay them out: (codes int32
    [N, max_chars], grids int16 [N, L, S]). Sample i uses seed i + base_seed.
    Cached on disk by corpus parameters."""
    cache_dir = cache_dir or os.path.join(_cache_root(), "torch_corpus")
    spec = atlas.spec
    payload = {
        "n": num_samples,
        "seed": base_seed,
        "spec": [spec.width, spec.height, spec.font_size, spec.max_chars],
        "grid": [atlas.n_lines, atlas.n_slots],
        "charset": atlas.charset,
        "adv": atlas.advance_px,
    }
    key = hashlib.sha1(json.dumps(payload, sort_keys=True).encode()).hexdigest()[:16]
    path = os.path.join(cache_dir, f"corpus_{key}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return z["codes"], z["grids"]

    # The native C++ generator (the bit-exact twin, ~100x faster) when the
    # layout fits its assumptions: printable-ASCII charset indexed by
    # code - 32, monospace advances, no padding. Python otherwise.
    from . import native

    out = None
    if atlas.charset == PRINTABLE_ASCII and atlas.advance_table().is_monospace and spec.padding == 0:
        out = native.generate_corpus_grids(
            num_samples, base_seed, 10, 100, float(atlas.advance_px),
            int(spec.width - 2 * spec.padding), atlas.n_lines, atlas.n_slots, spec.max_chars,
        )
    if out is None:
        texts = generate_corpus(num_samples, base_seed=base_seed)
        out = (
            encode_codes(texts, spec.max_chars),
            encode_grids(texts, atlas.advance_table(), spec, atlas.n_lines, atlas.n_slots),
        )
    codes, grids = out
    os.makedirs(cache_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez_compressed(tmp, codes=codes, grids=grids)
    os.replace(tmp, path)
    return codes, grids


def build_device_dataset(
    atlas: GlyphAtlas,
    num_samples: int,
    base_seed: int = 42,
    synth_batch: int = 4096,
    cache_dir: str | None = None,
    device: str | torch.device | None = None,
    subset: np.ndarray | None = None,
) -> DeviceDataset:
    """Corpus -> device tensors, synthesizing every target on ``device``
    once, in f32 chunks of ``synth_batch`` sheets.

    ``subset``: optional indices into the ``num_samples`` corpus: layouts
    are computed for the whole corpus, so sample i is the same whatever the
    subset, but only these rows are synthesized and kept.
    """
    codes, grids = build_layouts(atlas, num_samples, base_seed, cache_dir)
    if subset is not None:
        codes, grids = codes[subset], grids[subset]
    dev = resolve_device(device)
    ops = make_synth_ops(atlas, dev)
    grids_t = torch.from_numpy(grids.astype(np.int32)).to(dev)
    chunks = [
        torch.round(synthesize_sheets(ops, grids_t[s : s + synth_batch]) * 255.0).to(torch.uint8)
        for s in range(0, len(grids), synth_batch)
    ]
    targets = torch.cat(chunks) if chunks else torch.zeros((0, ops.height, ops.width), dtype=torch.uint8, device=dev)
    return DeviceDataset(codes=torch.from_numpy(codes).to(dev), targets_u8=targets)


def _to_u8(sheets: torch.Tensor) -> torch.Tensor:
    return torch.round(sheets * 255.0).to(torch.uint8)


def build_device_dataset_prop(
    atlas: PropAtlas,
    num_samples: int,
    base_seed: int = 42,
    synth_batch: int = 1024,
    device: str | torch.device | None = None,
) -> DeviceDataset:
    """Proportional-font corpus -> device tensors (the Montserrat config):
    the same corpus strings, laid out with the font's advances and kerning
    on the coarse placement grid, synthesized on ``device`` in chunks of
    ``synth_batch`` sheets."""
    texts = generate_corpus(num_samples, base_seed=base_seed)
    codes = encode_codes(texts, atlas.spec.max_chars)
    grids = encode_prop_grids(texts, atlas)
    dev = resolve_device(device)
    ops = prop_synth_operands(atlas, dev)
    grids_t = torch.from_numpy(grids).to(dev)
    chunks = [_to_u8(_synth(*ops, grids_t[s : s + synth_batch])) for s in range(0, num_samples, synth_batch)]
    spec = atlas.spec
    targets = torch.cat(chunks) if chunks else torch.zeros((0, spec.height, spec.width), dtype=torch.uint8, device=dev)
    return DeviceDataset(codes=torch.from_numpy(codes).to(dev), targets_u8=targets)


def synthesize_ground_truth(
    atlas,
    strings: list[str],
    on_device: bool = False,
    synth_batch: int = 1024,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Ground-truth sheets float32 [N, H, W] for any strings, either atlas
    type: what a perfect model would output. The numpy oracle by default;
    ``on_device=True`` synthesizes in chunks of ``synth_batch`` on
    ``device`` (the card unless ``"cpu"``), on the same 8-bit grid."""
    if isinstance(atlas, GlyphAtlas):
        grids = encode_grids(strings, atlas.advance_table(), atlas.spec, atlas.n_lines, atlas.n_slots)
        if not on_device:
            return synthesize_sheets_host(atlas, grids)
        synth = partial(synthesize_sheets, make_synth_ops(atlas, resolve_device(device)))
    else:
        grids = encode_prop_grids(strings, atlas)
        if not on_device:
            return synthesize_prop_host(atlas, grids)
        synth = partial(_synth, *prop_synth_operands(atlas, resolve_device(device)))
    grids_t = torch.from_numpy(grids.astype(np.int32))
    chunks = [synth(grids_t[s : s + synth_batch]).cpu().numpy() for s in range(0, len(grids), synth_batch)]
    if not chunks:
        return np.zeros((0, atlas.spec.height, atlas.spec.width), np.float32)
    return np.concatenate(chunks)


def bake_font_atlas(font_path: str, proportional: bool = False):
    """The atlas for ``font_path``: the fixed-grid :class:`GlyphAtlas` by
    default, the proportional variant atlas with ``proportional=True``."""
    return bake_prop_atlas(font_path) if proportional else bake_atlas(font_path)


def unit_ground_truth(atlas, strings: list[str]) -> np.ndarray:
    """float32 ground-truth sheets in [0, 1] for ``strings``, either atlas
    type: :func:`synthesize_ground_truth` as a plain np.float32 array."""
    return np.asarray(synthesize_ground_truth(atlas, strings), np.float32)


def load_string_dataset(
    data_dir: str = "train_input",
    num_samples: int = 50000,
    sheet_height: int = 80,
    sheet_width: int = 240,
    max_chars: int = 100,
) -> tuple[np.ndarray, np.ndarray]:
    """Read a dataset written in the reference's file format (line i of
    ``data.txt`` is ``(i+1).bmp``) -> (codes int32 [N, max_chars], targets
    float32 [N, H, W]). Raises ValueError on too few strings and
    FileNotFoundError on a missing image."""
    from .bmp import read_bmp

    strings_path = os.path.join(data_dir, "data.txt")
    with open(strings_path) as f:
        strings = f.read().splitlines()
    if len(strings) < num_samples:
        raise ValueError(
            f"Not enough strings in {strings_path}. "
            f"Expected {num_samples}, got {len(strings)}"
        )
    targets = np.zeros((num_samples, sheet_height, sheet_width), np.float32)
    for i in range(num_samples):
        image_path = os.path.join(data_dir, f"{i + 1}.bmp")
        if not os.path.exists(image_path):
            raise FileNotFoundError(f"Image file not found: {image_path}")
        targets[i] = read_bmp(image_path)
    codes = encode_codes(strings[:num_samples], max_chars)
    return codes, targets


def device_dataset_from_disk(
    data_dir: str,
    num_samples: int,
    sheet_height: int = 80,
    sheet_width: int = 240,
    max_chars: int = 100,
    device: str | torch.device | None = None,
) -> DeviceDataset:
    """A disk dataset -> uint8 tensors on ``device``, ready to train on."""
    codes, targets = load_string_dataset(data_dir, num_samples, sheet_height, sheet_width, max_chars)
    dev = resolve_device(device)
    u8 = np.round(targets * 255.0).astype(np.uint8)
    return DeviceDataset(codes=torch.from_numpy(codes).to(dev), targets_u8=torch.from_numpy(u8).to(dev))


def font_is_monospace(font_path: str, charset: str | None = None) -> bool:
    """True when the fixed-grid pipeline is exact for ``font_path``: one
    advance for every charset glyph AND no kern pairs. FiraCode: monospace
    (0 pairs); Montserrat: proportional (2533 pairs)."""
    from .kerning import KerningTable
    from .ttf import TrueTypeFont

    charset = charset or PRINTABLE_ASCII
    font = TrueTypeFont.load(font_path)
    if len({font.advance(font.glyph_id(ord(c))) for c in charset}) != 1:
        return False
    return len(KerningTable(font_path, charset, SheetSpec().font_size)) == 0


def split_sizes(n: int, validation_split: float) -> tuple[int, int]:
    """(train_size, val_size): the validation share rounded down."""
    val = int(validation_split * n)
    return n - val, val


def split_permutation(n: int, seed: int) -> np.ndarray:
    """The train/val split permutation: numpy PCG64 seeded with ``seed``,
    the JAX package's permutation."""
    return np.random.default_rng(seed).permutation(n)
