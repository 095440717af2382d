"""A/B train-step timing across ModelConfig speed profiles.

The port of tools/ab_profiles.py, with its profiles by the same names and
configs. Each profile runs 20-step train+eval epochs (``train_eval_epoch``:
the state threads through, the epoch ends in a fetch of its train loss),
alternating profiles across 5 rounds to cancel clock drift; the best round
is reported. Codes are random capitals, targets random bytes, 4 batches of
them indexed by every epoch.

    python -m ai_font_renderer_tpu_torch.tools.ab_profiles [profile ...] [--kernels K] [--device cpu]

Profiles: parity, fast (bf16_frontend + bits_dropout), cotangent (fast +
bf16_cotangent), conv, conv_ps, handrolled, fast_handrolled,
fast_hr_rematdots, fast_hr_rematfull. Default: fast fast_handrolled.
``--kernels`` (tools/_common.py) sets the kernel flags on every profile.
"""

from __future__ import annotations

import sys
import time

import torch

from ..config import ModelConfig, TrainConfig, replace
from ..fontgen.dataset import DeviceDataset
from ..models import font_renderer
from ..train.step import state_from_params, train_eval_epoch
from . import _common

# name -> (ModelConfig, TrainConfig), as the JAX tool's PROFILES.
PROFILES = {
    "parity": (ModelConfig(), TrainConfig()),
    "fast": (ModelConfig(bf16_frontend=True, bits_dropout=True), TrainConfig()),
    "cotangent": (
        ModelConfig(bf16_frontend=True, bits_dropout=True, bf16_cotangent=True),
        TrainConfig(),
    ),
    "conv": (
        ModelConfig(decoder="conv", bf16_frontend=True, bits_dropout=True),
        TrainConfig(),
    ),
    "conv_ps": (
        ModelConfig(decoder="conv_ps", bf16_frontend=True, bits_dropout=True),
        TrainConfig(),
    ),
    "handrolled": (ModelConfig(), TrainConfig(handrolled_bwd=True)),
    "fast_handrolled": (
        ModelConfig(bf16_frontend=True, bits_dropout=True),
        TrainConfig(handrolled_bwd=True),
    ),
    "fast_hr_rematdots": (
        ModelConfig(bf16_frontend=True, bits_dropout=True),
        TrainConfig(handrolled_bwd=True, remat_frontend="dots"),
    ),
    "fast_hr_rematfull": (
        ModelConfig(bf16_frontend=True, bits_dropout=True),
        TrainConfig(handrolled_bwd=True, remat_frontend="full"),
    ),
}


def configs(name: str, kernels: str = "none", widths: dict | None = None, batch: int | None = None):
    """(mcfg, tcfg) of profile ``name`` with the flags of ``kernels``, the
    ModelConfig fields of ``widths`` and the batch size ``batch``."""
    mcfg, tcfg = PROFILES[name]
    mcfg = replace(mcfg, **(widths or {}))
    if batch is not None:
        tcfg = replace(tcfg, batch_size=batch)
    return _common.with_kernels(kernels, mcfg, tcfg)


def random_corpus(mcfg: ModelConfig, n: int, device, seed: int = 0) -> DeviceDataset:
    """``n`` samples of random capitals and random u8 target sheets on
    ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    codes = torch.randint(65, 91, (n, mcfg.max_length), generator=g, device=device, dtype=torch.int32)
    targets = torch.randint(0, 256, (n, mcfg.sheet_height, mcfg.sheet_width), generator=g, device=device,
                            dtype=torch.int32).to(torch.uint8)
    return DeviceDataset(codes, targets)


def fresh_state(mcfg: ModelConfig, tcfg: TrainConfig, device, seed: int = 0):
    """Weights from ``seed`` and zero moments: a FusedTrainState when
    ``tcfg.fused_dw_adamw``."""
    return state_from_params(font_renderer.init(torch.Generator(device=device).manual_seed(seed), mcfg, device), tcfg)


def main(argv: list[str] | None = None, widths: dict | None = None, batch: int | None = None,
         steps: int = 20, rounds: int = 5) -> dict:
    rest, dev, kernels = _common.start(sys.argv[1:] if argv is None else argv)
    names = rest or ["fast", "fast_handrolled"]
    cfgs = {nm: configs(nm, kernels, widths, batch) for nm in names}
    b = next(iter(cfgs.values()))[1].batch_size
    n = 4 * b
    ds = random_corpus(cfgs[names[0]][0], n, dev)
    batch_idx = torch.arange(steps * b, device=dev).reshape(steps, b) % n
    val_idx = batch_idx[:2]
    val_w = torch.ones(2, b, device=dev)
    lr = 1e-3

    def epoch(nm, st, r):
        mcfg, tcfg = cfgs[nm]
        gen = torch.Generator(device=dev).manual_seed(1000 + r)
        st, tl, _ = train_eval_epoch(st, ds, batch_idx, val_idx, val_w, lr, gen, mcfg, tcfg)
        float(tl)
        return st

    states = {}
    for nm in names:
        mcfg, tcfg = cfgs[nm]
        states[nm] = epoch(nm, fresh_state(mcfg, tcfg, dev), -1)  # warm
    best = {nm: float("inf") for nm in names}
    for r in range(rounds):  # alternate profiles each round
        for nm in names:
            t0 = time.perf_counter()
            states[nm] = epoch(nm, states[nm], r)
            best[nm] = min(best[nm], time.perf_counter() - t0)
    for nm in names:
        print(f"{nm}: {1e3 * best[nm] / steps:.2f} ms/step (epoch best {best[nm]:.3f}s)", flush=True)
    return {nm: 1e3 * best[nm] / steps for nm in names}


if __name__ == "__main__":
    main()
