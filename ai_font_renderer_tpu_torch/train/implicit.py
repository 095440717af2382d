"""Training of the implicit glyph families (SIREN, multifont, SDF) in PyTorch.

The port of ai_font_renderer_tpu/train/implicit.py. The models are small
and their datasets are baked glyph tensors on the device, so a run is one
loop of full-batch Adam steps under optax's cosine decay (alpha 0.01): no
step waits for the host, and the losses stay on the device until the run
ends. (The JAX package scans its steps in chunks of 500 device calls to
keep each program short on its accelerator; the chunks do not change the
function.) With ``item_batch`` each step trains on that many rows drawn
uniformly with replacement from a ``torch.Generator`` seeded ``seed``.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from ..config import PRINTABLE_ASCII
from ..device import resolve_device
from ..fontgen.glyphs import rasterize_charset, sdf_charset
from ..models import multifont as mf
from ..models import siren
from .optim import Adam, cosine_decay_schedule


def _scan_train(loss_fn, params: dict, steps: int, lr: float, data_tuple, item_batch: int | None = None,
                seed: int = 0):
    """``steps`` Adam updates of ``params`` (copied; the caller's stay as
    they are) on ``loss_fn(params, *data_tuple)`` -> (params, losses
    [steps] on the device). ``item_batch`` rows a step when it is below the
    rows of ``data_tuple`` (the leading axis of every array in it)."""
    opt = Adam(cosine_decay_schedule(lr, steps, alpha=0.01))
    params = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    state = opt.init(params)
    n_items = data_tuple[0].shape[0]
    dev = data_tuple[0].device
    gen = None
    if item_batch is not None and item_batch < n_items:
        gen = torch.Generator(device=dev).manual_seed(seed)
    leaves = list(params.values())
    losses = []
    args = data_tuple
    for _ in range(steps):
        if gen is not None:
            idx = torch.randint(0, n_items, (item_batch,), generator=gen, device=dev)
            args = tuple(a.index_select(0, idx) for a in data_tuple)
        loss = loss_fn(params, *args)
        opt.update_(params, torch.autograd.grad(loss, leaves), state)
        losses.append(loss.detach())
    out = {k: v.detach() for k, v in params.items()}
    return out, torch.stack(losses) if losses else torch.zeros(0, device=dev)


def _targets(font_path: str, charset: str, cell: int, mode: str) -> np.ndarray:
    """[len(charset), cell, cell] coverage, or signed distances scaled by
    4 / cell to about [-1, 1]."""
    if mode == "sdf":
        return sdf_charset(font_path, charset, cell) / (cell / 4.0)
    return rasterize_charset(font_path, charset, cell)


def train_siren(
    font_path: str,
    cfg: siren.SirenConfig | None = None,
    charset: str = PRINTABLE_ASCII,
    steps: int = 2000,
    lr: float = 2e-4,
    seed: int = 42,
    glyph_batch: int | None = None,
    device: str | torch.device | None = None,
):
    """Fit the implicit glyph MLP to a rasterized charset on ``device``
    (the card unless "cpu"), from ``siren.init`` of a generator seeded
    ``seed`` -> (params, losses float32 [steps] numpy, targets numpy)."""
    dev = resolve_device(device)
    cfg = cfg or siren.SirenConfig(n_chars=len(charset))
    t = _targets(font_path, charset, cfg.cell, cfg.mode)
    targets = torch.from_numpy(np.ascontiguousarray(t.reshape(len(charset), -1))).to(dev)
    coords = siren.grid_coords(cfg.cell, dev).expand(len(charset), -1, -1)
    char_ids = torch.arange(len(charset), device=dev)
    params = siren.init(torch.Generator().manual_seed(seed), cfg, device=dev)
    params, losses = _scan_train(
        partial(siren.loss_fn, cfg=cfg), params, steps, lr, (char_ids, coords, targets),
        item_batch=glyph_batch, seed=seed,
    )
    return params, losses.cpu().numpy(), t


def train_multifont(
    font_paths: list[str],
    cfg: mf.MultiFontConfig | None = None,
    charset: str = PRINTABLE_ASCII,
    steps: int = 3000,
    lr: float = 2e-4,
    seed: int = 42,
    device: str | torch.device | None = None,
):
    """Fit the font-conditioned implicit model on several fonts at once, on
    ``device`` -> (params, losses float32 [steps] numpy, targets [F, C,
    cell, cell] numpy)."""
    dev = resolve_device(device)
    cfg = cfg or mf.MultiFontConfig(n_fonts=len(font_paths), n_chars=len(charset))
    t = np.stack([_targets(p, charset, cfg.cell, cfg.mode) for p in font_paths])  # [F, C, cell, cell]
    F, C = t.shape[:2]
    targets = torch.from_numpy(np.ascontiguousarray(t.reshape(F * C, -1))).to(dev)
    coords = siren.grid_coords(cfg.cell, dev).expand(F * C, -1, -1)
    font_ids = torch.arange(F, device=dev).repeat_interleave(C)
    char_ids = torch.arange(C, device=dev).repeat(F)
    params = mf.init(torch.Generator().manual_seed(seed), cfg, device=dev)
    params, losses = _scan_train(
        partial(mf.loss_fn, cfg=cfg), params, steps, lr, (font_ids, char_ids, coords, targets),
    )
    return params, losses.cpu().numpy(), t
