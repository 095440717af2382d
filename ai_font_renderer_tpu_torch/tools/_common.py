"""What the port's measurement tools share: the two flags the port adds to
a JAX tool's arguments (``--device``, ``--kernels``), the card's line, and
chained timing that ends on the device.

``--kernels`` keeps the CLI's words: ``none``, or a comma-separated subset
of ``output`` (K1 forward, K2/K3 backward: ``use_pallas_output``),
``fused`` (``output`` + K4: ``fused_dw_adamw``), ``attention`` (K5/K6:
``fused_attention``) and ``attention_v2`` (K7/K8: ``fused_attention_v2``).
The paths PERF.md reports are ``fused``, ``fused,attention`` (attn_v1) and
the profile ``fast_hr_rematdots`` with ``attention_v2`` (attn_v2_fast).
"""

from __future__ import annotations

import subprocess
import time

import torch

from ..config import replace
from ..device import resolve_device

_FLAGS = {
    "output": ({"use_pallas_output": True}, {}),
    "fused": ({"use_pallas_output": True}, {"fused_dw_adamw": True}),
    "attention": ({"fused_attention": True}, {}),
    "attention_v2": ({"fused_attention_v2": True}, {}),
}


def split_flags(argv: list[str]) -> tuple[list[str], str | None, str]:
    """(the JAX tool's own arguments, --device, --kernels) from ``argv``;
    both flags take ``--flag value`` or ``--flag=value``."""
    rest, found = [], {"--device": None, "--kernels": "none"}
    it = iter(argv)
    for a in it:
        name, eq, value = a.partition("=")
        if name in found:
            found[name] = value if eq else next(it, None)
            if found[name] is None:
                raise SystemExit(f"{name} needs a value")
        else:
            rest.append(a)
    return rest, found["--device"], found["--kernels"]


def with_kernels(kernels: str, mcfg, tcfg):
    """(mcfg, tcfg) with the flags of ``kernels`` (module note) set."""
    names = [n.strip() for n in kernels.split(",") if n.strip() and n.strip() != "none"]
    unknown = [n for n in names if n not in _FLAGS]
    if unknown:
        raise ValueError(f"--kernels {kernels}: unknown {unknown}; take none or a comma-separated subset of "
                         f"{', '.join(_FLAGS)}")
    for n in names:
        mkw, tkw = _FLAGS[n]
        mcfg, tcfg = replace(mcfg, **mkw), replace(tcfg, **tkw) if tcfg is not None else None
    return mcfg, tcfg


def card_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them; on the
    CPU, says so."""
    if device.type != "cuda":
        return "cpu (--device cpu: no card, no device time)"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def start(argv: list[str]) -> tuple[list[str], torch.device, str]:
    """Parse the port's flags, resolve the device (raises without a card
    unless ``--device cpu``) and print the card's line first ->
    (the tool's own arguments, device, kernels)."""
    rest, device, kernels = split_flags(argv)
    dev = resolve_device(device)
    print(card_line(dev), flush=True)
    return rest, dev, kernels


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def best_s(run, iters: int, rounds: int, device: torch.device, finish=None) -> float:
    """Best of ``rounds`` windows of ``iters`` chained calls of ``run()``,
    in seconds a window, after one warm call. ``run`` feeds its state back
    in itself; ``finish`` (default: a device sync) closes each window, as
    the JAX tools' scalar fetch does."""
    finish = finish or (lambda: sync(device))
    run()
    finish()
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        finish()
        best = min(best, time.perf_counter() - t0)
    return best


def sheet_dataset(font_path: str, mcfg, samples: int, device: torch.device):
    """The training corpus of ``samples`` strings for ``font_path`` at
    ``mcfg``'s sheet geometry, on ``device``, as the CLI builds it: the
    monospace grid (FiraCode) or the proportional pen walk (Montserrat)."""
    from ..cli import _build_dataset
    from ..config import TrainConfig

    return _build_dataset(mcfg, TrainConfig(num_samples=samples), font_path, device)[1]


def train_recipe(name: str, font_path: str, mcfg, tcfg, samples: int, device: torch.device, out: str,
                 weights: str, resume: bool = False):
    """One training run of a runner tool: the corpus, ``train`` with the
    test strings rendered every ``tcfg.eval_every`` epochs and checkpoints
    under ``out/ckpt``, the final renders and the weights (with their
    config) at ``out/weights`` -> (TrainResult, seconds the corpus took)."""
    from ..cli import TEST_STRINGS
    from ..render import render_strings
    from ..train import train
    from ..utils.checkpoint import save_params

    t0 = time.time()
    ds = sheet_dataset(font_path, mcfg, samples, device)
    data_s = time.time() - t0
    print(f"[{name}] dataset resident in {data_s:.1f}s", flush=True)
    r = train(ds, mcfg, tcfg, output_dir=out, eval_strings=TEST_STRINGS, checkpoint_dir=f"{out}/ckpt", resume=resume)
    render_strings(r.params, TEST_STRINGS, out, mcfg)
    save_params(r.params, f"{out}/{weights}", mcfg)
    return r, data_s
