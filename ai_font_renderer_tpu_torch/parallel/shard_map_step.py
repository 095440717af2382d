"""The explicit-collective data-parallel training step.

The port of ai_font_renderer_tpu/parallel/shard_map_step.py. There,
``shard_map`` splits the batch over the ``data`` axis, each device takes
the gradients of its shard, and a hand-placed ``pmean`` averages them
before a replicated AdamW update. Here each rank does the same: it takes
its rows of the batch, the gradients of the standard step's loss on them,
one ``all_reduce`` of the gradients and the loss divided by ``data``
(``Mesh.data_mean``), then the AdamW update every rank applies alike, so
the state stays replicated.

Everything inside the step is local to a rank, so the port's kernels run in
it as they do on one device: the fused attention flags (K5/K6, K7/K8 or the
general build), and K1/K2/K3 under ``use_pallas_output``. Each rank's
dropout generator is derived from (seed, data index), the counterpart of
``fold_in(key, axis_index(data))``: the ranks draw independent masks, not
the one-device step's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ModelConfig, TrainConfig
from ..train.step import FusedTrainState, _standard_grads, _update
from .mesh import Mesh


def rank_generator(seed: int, index: int, device) -> torch.Generator:
    """The dropout generator of the rank at ``index`` on the data axis."""
    value = int(np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(value)


def make_shard_map_train_step(mesh: Mesh, mcfg: ModelConfig, tcfg: TrainConfig):
    """The DP step with an explicit gradient mean: ``step(state, codes,
    targets, lr, seed) -> (state, loss)``. The state is replicated (the
    whole parameters on every rank) and updated in place; codes and targets
    are the whole batch, of which each rank takes its rows; ``seed`` seeds
    the ranks' dropout generators. The step is the standard one (autograd
    through the model), as the JAX package's."""

    def step(state, codes, targets, lr: float, seed: int):
        if isinstance(state, FusedTrainState):
            raise ValueError("the explicit DP step updates a TrainState; fused_dw_adamw is single-device only")
        rows = mesh.data_rows(codes.shape[0])
        generator = rank_generator(seed, mesh.data_index, codes.device)
        loss, grads = _standard_grads(state, codes[rows], targets[rows], generator, mcfg, tcfg)
        loss, grads = mesh.data_mean(loss, grads)
        _update(state, grads, lr, tcfg)
        return state, loss

    return step
