"""The numbers that decide ``correct``, and the reference runs behind them.

Set-up takes the first steps, one call of one step each, then
``check_calls`` calls of the window's shape: the first warms them up, the
last runs warmed. The reference checks each in its own run:

* the first steps from the run's initial weights (drawn again from the
  seed), zero moments and the dropout generator's state before the first
  step, following its own state and reading nothing the program made;
* each call from the program's state before it (parameters, both moments,
  the step count, copied to the host) and the generator's state then, over
  the same rows. Following its own state from the start, the reference
  drifts from the program by rounding within twenty steps further than a
  half batch moves it (PERF.md), so a call is held from the state the
  program handed it.

Six numbers, each a share:

* ``loss_gap``: the largest |program - reference| / reference over the
  first steps' losses;
* ``grad_gap``: over the leaves, the gap between the norms of the first
  step's gradients as AdamW got them, sqrt(sum(nu) / (1 - b2)) of each
  side's second moment after one step, over the larger of the reference's
  norm of that leaf and of the median leaf;
* ``change_gap``: the same of the norms of each leaf's change over the
  first steps, over the leaves whose first reference gradient is at least
  a thousandth of the median leaf's (a leaf whose gradient is nought to
  rounding, as a key's bias under softmax, moves under Adam by round-off
  alone);
* ``call_loss_gap``, ``call_grad_gap``, ``call_change_gap``: the worst over
  the checked calls of the same three of a call: its mean loss; the norms
  of its gradients as AdamW got them, per leaf sqrt(sum_i b2^(k-i)
  |g_i|^2) over its k steps, from the sums of the second moment before and
  after it (nu after = b2^k nu before + (1 - b2) sum_i b2^(k-i) g_i^2),
  here the median leaf's gap, since a leaf whose late gradients are a few
  hundredths of its first, summed from batches that mostly cancel, reads
  percents of rounding (PERF.md); each leaf's change over it, over the
  leaves whose reference gradient in that call is at least a thousandth
  of the median leaf's.
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

from . import arch, common

CHUNK = 1 << 24  # elements a reduction takes at once, so that no leaf is copied whole


def host_copy(tensors: dict) -> dict:
    """The tensors copied to the host, so that a snapshot adds nothing to the
    device's peak: into pinned memory from a card, which copies several
    times as fast as pageable memory."""
    out, cuda = {}, False
    for k, v in tensors.items():
        cuda = cuda or v.is_cuda
        out[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=v.is_cuda).copy_(v.detach(), non_blocking=v.is_cuda)
    if cuda:
        torch.cuda.synchronize()
    return out


def nu_sums(nu: dict) -> dict:
    """{leaf: the sum of its second moment}, in float64."""
    return {k: float(sum(c.double().sum() for c in v.detach().reshape(-1).split(CHUNK))) for k, v in nu.items()}


def grad_norms(after: dict, before: dict | None, b2: float, steps: int) -> dict:
    """{leaf: sqrt(sum_i b2^(steps-i) |g_i|^2)} of the ``steps`` gradients that
    AdamW took between two readings of its second moment's sums (``before``
    None: from zero moments)."""
    decay = b2**steps
    return {k: math.sqrt(max(a - decay * (before[k] if before else 0.0), 0.0) / (1.0 - b2))
            for k, a in after.items()}


def change_norms(params: dict, before: dict) -> dict:
    """{leaf: the norm of params - before}; ``before`` may be on the host."""
    out = {}
    for k, p in params.items():
        flat, old = p.detach().reshape(-1), before[k].reshape(-1)
        total = sum((flat[a : a + CHUNK].double() - old[a : a + CHUNK].to(flat.device, torch.float64)).square().sum()
                    for a in range(0, flat.numel(), CHUNK))
        out[k] = math.sqrt(float(total))
    return out


def _steps(params: dict, mu: dict, nu: dict, count: int, rows: list, data: tuple, gen, m: dict, t: dict,
           fused: bool, num, after_step=None) -> list:
    """The reference's AdamW steps over ``rows`` ([B] index tensors) of
    ``data`` (codes, targets_u8), in place on ``params`` (leaves that
    require a gradient), ``mu`` and ``nu``, the first step counted
    ``count + 1``; -> the steps' losses (device scalars).
    ``after_step(step)`` runs after each step."""
    net = arch(m)
    codes_all, targets_all = data
    losses = []
    for step, idx in enumerate(rows, start=count + 1):
        codes, targets = codes_all[idx], targets_all[idx]
        d = net.train_output(params, codes, m, num, gen, fused) - targets.reshape(len(idx), -1).float() / 255.0
        loss = (d * d).mean()
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()), allow_unused=True)))
        grads = {k: torch.zeros_like(params[k]) if g is None else g for k, g in grads.items()}
        common.adamw_(params, grads, mu, nu, t["learning_rate"], step, t, ("out_w",) if fused else ())
        losses.append(loss.detach())
        del d, loss, grads
        if after_step:
            after_step(step)
    return losses


def _generator(state: torch.Tensor, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.set_state(state)
    return gen


def first_reference(params0: dict, rows: list, data: tuple, gen_state: torch.Tensor, m: dict, t: dict,
                    fused: bool, lower: str | None = None) -> dict:
    """The reference's first steps from ``params0`` and zero moments, dropout
    drawn from a generator set to ``gen_state`` -> {"losses", "grad_norms",
    "change_norms"}."""
    common.plain_numerics()
    device = data[0].device
    params = {k: v.detach().clone().requires_grad_() for k, v in params0.items()}
    mu_dt = torch.bfloat16 if t.get("adam_mu_bf16", True) else torch.float32
    mu = {k: torch.zeros_like(v, dtype=mu_dt) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    out = {}

    def after_step(step):
        if step == 1:
            out["grad_norms"] = grad_norms(nu_sums(nu), None, t["adam_b2"], 1)

    losses = _steps(params, mu, nu, 0, rows, data, _generator(gen_state, device), m, t, fused,
                    common.Numerics(m, lower), after_step)
    out["losses"] = [float(x) for x in losses]
    out["change_norms"] = change_norms(params, params0)
    return out


def call_reference(start: dict, rows: list, data: tuple, m: dict, t: dict, fused: bool,
                   lower: str | None = None) -> dict:
    """The reference's steps of one call from the program's state before it,
    ``start`` {"params", "mu", "nu" (host tensors a leaf), "count",
    "gen_state"} -> {"call_loss", "call_grad_norms", "call_change_norms"}."""
    common.plain_numerics()
    device = data[0].device
    params = {k: v.to(device, copy=True).requires_grad_() for k, v in start["params"].items()}
    mu = {k: v.to(device, copy=True) for k, v in start["mu"].items()}
    nu = {k: v.to(device, copy=True) for k, v in start["nu"].items()}
    before = nu_sums(nu)
    losses = _steps(params, mu, nu, start["count"], rows, data, _generator(start["gen_state"], device), m, t,
                    fused, common.Numerics(m, lower))
    return {"call_loss": float(torch.stack(losses).mean()),
            "call_grad_norms": grad_norms(nu_sums(nu), before, t["adam_b2"], len(rows)),
            "call_change_norms": change_norms(params, start["params"])}


def _leaf_gap(prog: dict, refn: dict, keys, over=max) -> float:
    """``over`` (the worst, or the median) of the leaves' gaps, each over the
    larger of the reference's norm of that leaf and of the median leaf."""
    floor = statistics.median(refn.values())
    return over([abs(prog[k] - refn[k]) / max(refn[k], floor) for k in keys] or [0.0])


def _moved(grads: dict) -> list:
    floor = statistics.median(grads.values())
    return [k for k in grads if grads[k] >= 1e-3 * floor]


def train_numbers(prog: dict, refr: dict) -> dict:
    """The six numbers of a training check from the program's and the
    reference's readings: each {"losses", "grad_norms", "change_norms",
    "calls": [{"call_loss", "call_grad_norms", "call_change_norms"}]}."""
    g = refr["grad_norms"]
    calls = [(p["call_loss"], r["call_loss"], p["call_grad_norms"], r["call_grad_norms"], p["call_change_norms"],
              r["call_change_norms"]) for p, r in zip(prog["calls"], refr["calls"], strict=True)]
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], refr["losses"])),
        "grad_gap": _leaf_gap(prog["grad_norms"], g, g),
        "change_gap": _leaf_gap(prog["change_norms"], refr["change_norms"], _moved(g)),
        "call_loss_gap": max(abs(pl - rl) / abs(rl) for pl, rl, *_ in calls),
        "call_grad_gap": max(_leaf_gap(pg, rg, rg, statistics.median) for _, _, pg, rg, _, _ in calls),
        "call_change_gap": max(_leaf_gap(pc, rc, _moved(rg)) for _, _, _, rg, pc, rc in calls),
    }


def passes(numbers: dict, limits: dict) -> bool:
    """Whether every number is within its limit (a missing number or limit,
    or one that is not finite, fails)."""
    return all(k in numbers and np.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in limits)
