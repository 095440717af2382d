"""The model's weights, drawn from the run's seed on the device.

The leaves and init distributions of the configuration's decoder
(``reference/<decoder>.py``'s ``leaves``) in two draws, one uniform and one
normal, over all leaves at once, in f32 as the model serves and trains
them. The program starts from these tensors; the reference draws them
again from the same seed.
"""

from __future__ import annotations

import torch

from .reference import arch


def init(m: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """{key: f32 tensor on ``device``} for model ``m`` from ``seed``."""
    uniform, normal, const = arch(m).leaves(m)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    params = {}
    for table, draw in ((uniform, torch.rand), (normal, torch.randn)):
        sizes = [torch.Size(shape).numel() for shape, _ in table.values()]
        values = draw(sum(sizes), generator=gen, device=device)
        for (key, (shape, scale)), part in zip(table.items(), values.split(sizes)):
            part = part.view(shape)
            params[key] = (part * 2.0 - 1.0) * scale if draw is torch.rand else part * scale
    for key, (shape, value) in const.items():
        params[key] = torch.full(shape, value, device=device)
    return params
