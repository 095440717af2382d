"""optax's Adam and AdamW, and the schedules the trainers use, over trees of
tensors.

A tree is a tensor, or a dict, tuple or list of trees: a parameter dict, or
the joint fine-tune's (placement, siren) pair. The update is optax's
(``scale_by_adam`` -> ``add_decayed_weights`` for AdamW ->
``scale_by_learning_rate``), in place, in f32:

    mu <- (1-b1)*g + b1*mu             (stored bf16 when mu is bf16)
    nu <- (1-b2)*g^2 + b2*nu
    u  <- (mu/(1-b1^t)) / (sqrt(nu/(1-b2^t)) + eps) + wd*p
    p  <- p - lr(t-1)*u

with t the update's number counted from 1 and the bias corrections in f32,
as optax computes them. A schedule is a function of the number of updates
taken before this one (optax's ``count``), evaluated on the host: nothing
here waits for the card. Every leaf updates, whether its gradient is None
(a leaf the loss does not read: its moments decay and AdamW still decays
it) or not, as optax updates every leaf of the tree.
"""

from __future__ import annotations

import math

import numpy as np
import torch

EPS = 1e-8
_CHUNK = 1 << 22  # elements per update chunk: 16 MB of f32 temporaries


def tree_leaves(tree) -> list:
    """The tensors of ``tree`` in a fixed order: a dict's in its key order,
    a tuple's or list's in theirs."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    """``tree`` with each tensor replaced by ``fn(tensor)``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _bias_correction(decay: float, count: int) -> float:
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``. optax multiplies a moment by its
    decay as a scalar of the moment's own dtype, so with a bf16 mu b1 = 0.9
    becomes 0.8984375; the product and the sum stay f32."""
    return float(torch.tensor(value, dtype=dtype))


@torch.no_grad()
def adam_(params, grads, mus, nus, lr: float, count: int, b1: float, b2: float,
          weight_decay: float = 0.0, eps: float = EPS) -> None:
    """One optax Adam(W) update over matching lists of tensors, in place, in
    chunks of at most ``_CHUNK`` elements. ``count`` is the update's number
    (from 1); a None gradient counts as zeros."""
    bc1, bc2 = _bias_correction(b1, count), _bias_correction(b2, count)
    for p, g, mu, nu in zip(params, grads, mus, nus):
        if g is None:
            g = torch.zeros_like(p)
        chunks = (p.view(-1), g.reshape(-1), mu.view(-1), nu.view(-1))
        for pc, gc, mc, nc in zip(*(t.split(_CHUNK) for t in chunks)):
            m = mc.float().mul_(_in_dtype(b1, mc.dtype)).add_(gc, alpha=1 - b1)
            nc.mul_(b2).addcmul_(gc, gc, value=1 - b2)
            denom = (nc / bc2).sqrt_().add_(eps)
            u = (m / bc1).div_(denom)
            if weight_decay:
                u.add_(pc, alpha=weight_decay)
            pc.add_(u, alpha=-lr)
            mc.copy_(m)


class Adam:
    """optax's ``adam`` (``weight_decay`` 0) or ``adamw`` over a tree, with
    optax's defaults b1 0.9, b2 0.999, eps 1e-8. ``learning_rate`` is a
    float or a schedule: a function of optax's count (the updates taken so
    far) to a float. The state is a plain dict (``count``, and ``mu``/``nu``
    trees shaped like the parameters), so it saves with ``torch.save`` and
    loads with ``weights_only``."""

    def __init__(self, learning_rate, weight_decay: float = 0.0):
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    def init(self, params) -> dict:
        return {"count": 0, "mu": tree_map(torch.zeros_like, params), "nu": tree_map(torch.zeros_like, params)}

    def update_(self, params, grads, state: dict) -> None:
        """Apply one update to ``params`` (a tree) from ``grads`` (a list
        of tensors or None, in ``tree_leaves`` order) and advance
        ``state``, all in place."""
        lr = self.lr(state["count"])
        state["count"] += 1
        adam_(tree_leaves(params), grads, tree_leaves(state["mu"]), tree_leaves(state["nu"]), lr,
              state["count"], 0.9, 0.999, self.weight_decay)


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0):
    """optax's: init_value * ((1 - alpha) * 0.5 * (1 + cos(pi * min(count,
    decay_steps) / decay_steps)) + alpha), in f32."""
    if not decay_steps > 0:
        raise ValueError(f"the cosine_decay_schedule requires positive decay_steps, got {decay_steps}")
    f = np.float32

    def schedule(count: int) -> float:
        c = f(min(count, decay_steps))
        cosine = f(0.5) * (f(1.0) + np.cos(f(math.pi) * c / f(decay_steps)))
        return float(f(init_value) * ((f(1.0) - f(alpha)) * cosine + f(alpha)))

    return schedule


def linear_schedule(init_value: float, end_value: float, transition_steps: int):
    """optax's: from init_value to end_value over transition_steps, then
    end_value; a constant init_value when transition_steps <= 0."""
    if transition_steps <= 0:
        return lambda count: init_value
    f = np.float32

    def schedule(count: int) -> float:
        frac = f(1.0) - f(min(max(count, 0), transition_steps)) / f(transition_steps)
        return float((f(init_value) - f(end_value)) * frac + f(end_value))

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0):
    """optax's: linear warmup from init_value to peak_value over
    warmup_steps, then a cosine decay to end_value over the remaining
    decay_steps - warmup_steps."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)
    return lambda count: warm(count) if count < warmup_steps else decay(count - warmup_steps)
