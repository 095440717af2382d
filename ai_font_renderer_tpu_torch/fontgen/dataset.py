"""Dataset assembly: corpus -> tensors on the device (monospace fonts).

The port of the monospace half of ai_font_renderer_tpu/fontgen/dataset.py.
The corpus lives on the device:

  * ``codes``      int32 [N, 100]  model inputs (ord codes, zero-padded);
  * ``targets_u8`` uint8 [N, H, W] sheets synthesized once on the device by
    the atlas einsum and kept 8-bit (2.9 GB for 150k samples);

and a batch is gathered and dequantized on the device, so the host never
touches pixel data. The host-side layout (strings -> grids -> codes) is
cached under ``.cache/torch_corpus/``, a directory of the port's own.
Proportional fonts (Montserrat) come with a later slice.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..config import PRINTABLE_ASCII, SheetSpec
from ..device import resolve_device
from .atlas import GlyphAtlas
from .layout import encode_codes, encode_grids
from .sheets import make_synth_ops, synthesize_sheets
from .textgen import generate_corpus

_PROPORTIONAL = (
    "{font} is a proportional font (several advances or kern pairs); its "
    "dataset path comes with a later slice of the port (ROADMAP queue 1, "
    "item 7). Train with a monospace font such as the default FiraCode."
)


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


def require_monospace(font_path: str) -> None:
    """Raise for a font this slice of the port cannot lay out."""
    if not font_is_monospace(font_path):
        raise NotImplementedError(_PROPORTIONAL.format(font=os.path.basename(font_path)))


def split_sizes(n: int, validation_split: float) -> tuple[int, int]:
    """(train_size, val_size): the validation share rounded down."""
    val = int(validation_split * n)
    return n - val, val


def split_permutation(n: int, seed: int) -> np.ndarray:
    """The train/val split permutation: numpy PCG64 seeded with ``seed``,
    the JAX package's permutation."""
    return np.random.default_rng(seed).permutation(n)
