"""Training steps and epochs: MSE, optax-exact AdamW, the standard, hand-rolled
and fused steps, and the epoch loops.

The port of ai_font_renderer_tpu/train/step.py. PyTorch runs eagerly, so an
epoch is a Python loop over its batches, each gathered from the corpus on
the device; nothing in it waits for the card, and the losses stay on the
device until the caller reads them after the epoch. Dropout masks come from
the ``torch.Generator`` passed in. A step updates the state IN PLACE (the
JAX step donates its buffers) and returns it with the batch loss.

AdamW has optax's semantics (``make_optimizer`` in the JAX package:
scale_by_adam -> add_decayed_weights -> scale(-1), times lr), written as
plain tensor code over chunks of at most 4M elements (train/optim.py), so
the 123M-parameter projection needs no full-size temporaries:

    mu <- b1*mu + (1-b1)*g            (f32; stored bf16 when adam_mu_bf16)
    nu <- b2*nu + (1-b2)*g^2
    u  <- (mu/(1-b1^t)) / (sqrt(nu/(1-b2^t)) + eps) + wd*p
    p  <- p - lr*u

Steps:

* standard (``_standard_grads``): autograd through ``font_renderer.apply``;
  with ``use_pallas_output`` the projection is the K1/K2/K3 autograd
  function (ops/fused_output.py) and dW (491.5 MB) is materialised, as on
  the JAX path.
* hand-rolled (``TrainConfig.handrolled_bwd``): the projection, clamp and
  MSE written out; the masked cotangent is rounded once and feeds both
  backward products. ``remat_frontend`` recomputes the frontend.
* fused (``TrainConfig.fused_dw_adamw``, :class:`FusedTrainState`): the same
  written-out projection, then K4 (ops/fused_dw_adamw.py) sums out_w's
  gradient and applies its AdamW update in one pass. With
  ``use_pallas_output`` the forward product is K1 and dX is K2.

Every step emits the same spans (utils/profiling.py): ``train.forward``,
``train.backward`` and ``train.update``, inside ``train_epoch``'s
``train.epoch``, ``train.step`` and ``train.gather``. In the fused step
``train.update`` holds K4, which forms out_w's gradient in the same pass.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
from torch.utils import checkpoint as ckpt

from ..config import ModelConfig, TrainConfig
from ..device import resolve_device
from ..models import font_renderer
from ..ops.fused_dw_adamw import fused_dw_adamw
from ..ops.fused_output import _k1, _k2, clamp_mask
from ..utils.profiling import span
from .optim import EPS, adam_


@dataclass
class TrainState:
    """Parameters (leaves that require a gradient) and AdamW's moments, one
    per parameter; ``count`` is the number of steps taken."""

    params: dict
    mu: dict
    nu: dict
    count: int = 0


@dataclass
class FusedTrainState:
    """State of the fused step: ``mu``/``nu`` cover every parameter except
    out_w, whose moments ``mu_w``/``nu_w`` K4 updates in place."""

    params: dict
    mu: dict
    nu: dict
    mu_w: torch.Tensor
    nu_w: torch.Tensor
    count: int = 0


def _mu_dtype(tcfg: TrainConfig) -> torch.dtype:
    return torch.bfloat16 if tcfg.adam_mu_bf16 else torch.float32


def _moments(params: dict, tcfg: TrainConfig) -> tuple[dict, dict]:
    mu = {k: torch.zeros_like(v, dtype=_mu_dtype(tcfg)) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    return mu, nu


def _trainable(params: dict) -> dict:
    """Own copies of ``params`` as leaves that require a gradient: a step
    updates them in place and must not write into the caller's tensors."""
    return {k: v.detach().clone().requires_grad_() for k, v in params.items()}


def _check_fused(mcfg: ModelConfig) -> None:
    if mcfg.decoder != "linear":
        raise ValueError(
            "fused_dw_adamw fuses the linear decoder's out_w update; "
            f"decoder={mcfg.decoder!r} has no out_w"
        )
    if mcfg.leaky_clamp > 0.0:
        raise ValueError(
            "the fused step hand-codes the hard clamp's gradient mask; "
            "leaky_clamp requires the standard step"
        )


def _state(params: dict, tcfg: TrainConfig, fused: bool):
    params = _trainable(params)
    if not fused:
        return TrainState(params, *_moments(params, tcfg))
    rest = {k: v for k, v in params.items() if k != "out_w"}
    w = params["out_w"]
    return FusedTrainState(
        params, *_moments(rest, tcfg),
        mu_w=torch.zeros_like(w, dtype=_mu_dtype(tcfg)), nu_w=torch.zeros_like(w),
    )


def state_from_params(params: dict, tcfg: TrainConfig):
    """A fresh state (zero moments, count 0) around ``params``: a
    :class:`FusedTrainState` when ``tcfg.fused_dw_adamw``."""
    return _state(params, tcfg, tcfg.fused_dw_adamw)


def init_state(generator: torch.Generator, mcfg: ModelConfig, tcfg: TrainConfig, device=None) -> TrainState:
    """Parameters from ``generator`` (font_renderer.init) and zero moments."""
    return _state(font_renderer.init(generator, mcfg, device), tcfg, fused=False)


def init_fused_state(generator: torch.Generator, mcfg: ModelConfig, tcfg: TrainConfig, device=None) -> FusedTrainState:
    _check_fused(mcfg)
    return _state(font_renderer.init(generator, mcfg, device), tcfg, fused=True)


def _to_tensor(value, device: torch.device) -> torch.Tensor:
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":  # numpy has no bf16: carry the bits
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def train_state_from_jax(state, device=None):
    """The JAX package's ``TrainState`` or ``FusedTrainState`` -> the port's.

    Reads, without importing JAX, ``state.params`` and the optax
    ``ScaleByAdamState`` (count, mu, nu) at ``state.opt_state[0]``, plus
    ``mu_w``, ``nu_w`` and ``count`` of a fused state; every leaf goes
    through ``np.asarray`` (bf16 moments keep their bits)."""
    dev = resolve_device(device)
    params = _trainable({k: _to_tensor(v, dev) for k, v in state.params.items()})
    adam = state.opt_state[0]
    mu = {k: _to_tensor(v, dev) for k, v in adam.mu.items()}
    nu = {k: _to_tensor(v, dev) for k, v in adam.nu.items()}
    if hasattr(state, "mu_w"):
        return FusedTrainState(
            params, mu, nu, _to_tensor(state.mu_w, dev), _to_tensor(state.nu_w, dev),
            int(np.asarray(state.count)),
        )
    return TrainState(params, mu, nu, int(np.asarray(adam.count)))


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Plain MSE over all pixels, f32."""
    d = pred.float() - target.float()
    return (d * d).mean()


def adamw_(params, grads, mus, nus, lr: float, tcfg: TrainConfig, count: int) -> None:
    """optax's AdamW with ``tcfg``'s betas and weight decay over matching
    lists of tensors, in place (``optim.adam_``). ``count`` is the step
    after its increment."""
    adam_(params, grads, mus, nus, lr, count, tcfg.adam_b1, tcfg.adam_b2, tcfg.weight_decay)


def loss_fn(params, codes, targets, mcfg, generator):
    """The training loss: MSE of the dropout forward's sheets."""
    pred = font_renderer.apply(params, codes, mcfg, train=True, generator=generator)
    return mse_loss(pred, targets)


def _column_parallel(params, mesh) -> bool:
    """Whether out_w is split by columns over the mesh's model axis."""
    return mesh is not None and mesh.model > 1 and "out_w" in params


def _standard_grads(state: TrainState, codes, targets, generator, mcfg, tcfg, mesh=None):
    """(loss, {key: gradient}) of the MSE through autograd. On a mesh whose
    model axis splits out_w, this rank's column shard of the sheet: flat
    enters the projection through ``mesh.model_input`` (its cotangent, the
    partial dflat of each shard, summed over the model axis) and the loss
    sums every shard's squares (``mesh.model_sum``)."""
    params = state.params
    keys = list(params)
    with span("train.forward"):
        if not _column_parallel(params, mesh):
            loss = loss_fn(params, codes, targets, mcfg, generator)
        else:
            flat = font_renderer.frontend(params, codes, mcfg, train=True, generator=generator)
            out = font_renderer.project(params, mesh.model_input(flat), mcfg, train=True)
            d = out - mesh.columns(targets.reshape(targets.shape[0], -1)).float()
            loss = mesh.model_sum((d * d).sum()) / (d.numel() * mesh.model)
    with span("train.backward"):
        grads = torch.autograd.grad(loss, [params[k] for k in keys])
    return loss.detach(), dict(zip(keys, grads))


def _update(state, grads: dict, lr, tcfg: TrainConfig) -> None:
    """AdamW on every parameter of ``grads``, in place; counts the step."""
    keys = list(grads)
    state.count += 1
    with span("train.update"):
        adamw_(
            [state.params[k] for k in keys], [grads[k] for k in keys], [state.mu[k] for k in keys],
            [state.nu[k] for k in keys], lr, tcfg, state.count,
        )


def _save_products(ctx, op, *args, **kwargs):
    """Selective checkpointing policy of remat_frontend="dots": keep the
    outputs of the matrix products, recompute everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _frontend(rest: dict, codes, mcfg, generator, remat: str = "none") -> torch.Tensor:
    """The frontend under autograd, recomputed in the backward for
    ``remat`` "dots" or "full". torch.utils.checkpoint replays only the
    default generators' state, never an explicit ``torch.Generator``'s, so
    the function restores ``generator`` itself before each run: the
    recomputation draws the same dropout masks as the forward did."""
    keys = list(rest)

    def front(*vals):
        return font_renderer.frontend(dict(zip(keys, vals)), codes, mcfg, train=True, generator=generator)

    vals = [rest[k] for k in keys]
    if remat == "none":
        return front(*vals)
    # A mesh rank's BatchRows draws from the generator it wraps.
    source = generator.generator if isinstance(generator, font_renderer.BatchRows) else generator
    start = source.get_state()

    def replay(*vals):
        source.set_state(start)
        return front(*vals)

    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(ckpt.create_selective_checkpoint_contexts, _save_products)
    return ckpt.checkpoint(replay, *vals, use_reentrant=False, preserve_rng_state=False, **kw)


def _projection(flat, params, targets, mcfg, mesh=None):
    """The written-out projection + clamp + MSE. Returns (loss, out, g, gm,
    flat_dt): g = dL/dout unmasked, gm = g where 0 < out < 1, and flat
    rounded to bf16 under bf16_matmul. With ``use_pallas_output`` (which
    implies bf16) the forward product is K1, and flat_dt is K1's own bf16
    operand (a [B, K] view of its padded x16). With a column-parallel
    ``mesh``, out is this rank's shard and the loss sums every shard's."""
    w, b = params["out_w"], params["out_b"]
    if mcfg.use_pallas_output:
        # w itself (this runs under no_grad): its bf16 shadow is keyed on it.
        out, x16, _ = _k1(flat.contiguous(), w, b.detach())
        flat_dt = x16[:, : flat.shape[1]]
    else:
        dt = torch.bfloat16 if mcfg.bf16_matmul else torch.float32
        flat_dt = flat.to(dt)
        out = (flat_dt.float() @ w.detach().to(dt).float() + b.detach()).clamp(0.0, 1.0)
    tflat = targets.reshape(targets.shape[0], -1).float()
    if mesh is None:
        d = out - tflat
        n = d.numel()
        loss = (d * d).mean()
    else:
        d = out - mesh.columns(tflat)
        n = d.numel() * mesh.model
        loss = mesh.model_sum((d * d).sum()) / n
    g = (2.0 / n) * d
    gm = torch.where(clamp_mask(out), g, 0.0)
    return loss, out, g, gm, flat_dt


def _dflat(out, g, gm, w, mcfg):
    """(dL/dflat, gm_dt): gm_dt is gm in the product dtype and dL/dflat =
    gm_dt @ w^T with w in that dtype. Under ``use_pallas_output`` that is
    K2, which masks and rounds g itself; gm_dt is then K2's own bf16
    operand (a [B, N] view of its padded gm16). Plain f32 sums otherwise."""
    if mcfg.use_pallas_output:
        dflat, gm16 = _k2(g, out, w)
        return dflat, gm16[:, : g.shape[1]]
    gm_dt = gm.to(torch.bfloat16 if mcfg.bf16_matmul else torch.float32)
    return gm_dt.float() @ w.to(gm_dt.dtype).float().T, gm_dt


def _handrolled_grads(state: TrainState, codes, targets, generator, mcfg, tcfg, mesh=None):
    """(loss, {key: gradient}) with the projection's backward written out:
    the masked cotangent is rounded once and feeds both backward products;
    the frontend differentiates through autograd (recomputed under
    ``remat_frontend``). The only numerical change from the standard step
    is that rounding of the projection's cotangent. On a column-parallel
    ``mesh`` each rank's dflat is summed over the model axis."""
    if mcfg.decoder != "linear" or mcfg.leaky_clamp > 0.0 or mcfg.use_pallas_output:
        raise ValueError(
            "handrolled_bwd hand-codes the linear projection + hard-clamp "
            "backward; it requires decoder='linear', leaky_clamp=0, and "
            "use_pallas_output=False"
        )
    params = state.params
    rest = {k: v for k, v in params.items() if k not in ("out_w", "out_b")}
    shard = mesh if _column_parallel(params, mesh) else None
    w = params["out_w"]
    with span("train.forward"):
        flat = _frontend(rest, codes, mcfg, generator, tcfg.remat_frontend)
        with torch.no_grad():
            loss, out, g, gm, flat_dt = _projection(flat.detach(), params, targets, mcfg, shard)
    with span("train.backward"):
        with torch.no_grad():
            dflat, gm_dt = _dflat(out, g, gm, w, mcfg)
            if shard is not None:
                dflat = shard.model_sum(dflat)
            grads = {"out_b": gm.sum(0), "out_w": flat_dt.float().T @ gm_dt.float()}
        grads.update(zip(rest, torch.autograd.grad(flat, list(rest.values()), dflat)))
    return loss, {k: grads[k] for k in params}


def _fused_step(state: FusedTrainState, codes, targets, lr, generator, mcfg, tcfg):
    """One step with K4 on the output projection: the same forward, MSE and
    AdamW as the standard step, but out_w's gradient never reaches device
    memory. The bf16 input and masked cotangent that K4 reads are the
    operands of the forward and dX products: under ``use_pallas_output``
    the very x16 and gm16 that K1 and K2 formed."""
    _check_fused(mcfg)
    params = state.params
    rest = {k: v for k, v in params.items() if k not in ("out_w", "out_b")}
    w = params["out_w"]
    with span("train.forward"):
        flat = _frontend(rest, codes, mcfg, generator)
        with torch.no_grad():
            loss, out, g, gm, flat_dt = _projection(flat.detach(), params, targets, mcfg)
    with span("train.backward"):
        with torch.no_grad():
            dflat, gm_dt = _dflat(out, g, gm, w, mcfg)
            grads = {"out_b": gm.sum(0)}
        grads.update(zip(rest, torch.autograd.grad(flat, list(rest.values()), dflat)))
    keys = [k for k in params if k != "out_w"]
    state.count += 1
    # K4 forms out_w's gradient and applies its update in one pass, so this
    # span holds that dW product too.
    with span("train.update"):
        adamw_(
            [params[k] for k in keys], [grads[k] for k in keys], [state.mu[k] for k in keys],
            [state.nu[k] for k in keys], lr, tcfg, state.count,
        )
        with torch.no_grad():
            fused_dw_adamw(
                flat_dt, gm_dt, w, state.mu_w, state.nu_w, lr, tcfg.weight_decay,
                tcfg.adam_b1, tcfg.adam_b2, state.count, EPS,
            )
    return state, loss


def train_step(state, codes, targets, lr: float, generator, mcfg: ModelConfig, tcfg: TrainConfig, mesh=None):
    """One optimizer step on a batch -> (state, loss); the step the configs
    select: fused (a :class:`FusedTrainState`), hand-rolled, or standard.

    ``mesh`` (parallel.Mesh): the step of one rank, the counterpart of the
    JAX package's step under GSPMD shardings. codes and targets are this
    rank's rows of the batch and the state its shard (parallel.shard_state);
    ``generator`` is the one every rank shares, so the dropout masks are the
    one-device step's. The loss and gradients are averaged over the data
    axis, and with out_w split over the model axis the projection is
    column-parallel. A mesh of one device takes the one-device step. The
    fused step (K4) runs on one device only, as in the JAX package."""
    if mesh is not None and mesh.data > 1:
        start = mesh.data_index * codes.shape[0]
        generator = font_renderer.BatchRows(generator, start, start + codes.shape[0], codes.shape[0] * mesh.data)
    if isinstance(state, FusedTrainState):
        if mesh is not None and mesh.size > 1:
            raise ValueError("fused_dw_adamw is single-device only; train on a mesh with the standard step")
        return _fused_step(state, codes, targets, lr, generator, mcfg, tcfg)
    grads_fn = _handrolled_grads if tcfg.handrolled_bwd else _standard_grads
    loss, grads = grads_fn(state, codes, targets, generator, mcfg, tcfg, mesh)
    if mesh is not None:
        loss, grads = mesh.data_mean(loss, grads)
    _update(state, grads, lr, tcfg)
    return state, loss


def train_epoch(state, dataset, batch_idx: torch.Tensor, lr: float, generator, mcfg, tcfg, mesh=None):
    """One epoch over ``batch_idx`` [steps, B] (sample indices on the
    dataset's device; on a mesh, this rank's columns of them) -> (state,
    mean train loss as a device scalar)."""
    losses = []
    with span("train.epoch"):
        for idx in batch_idx:
            with span("train.step"):
                with span("train.gather"):
                    codes, targets = dataset.gather_batch(idx)
                state, loss = train_step(state, codes, targets, lr, generator, mcfg, tcfg, mesh)
            losses.append(loss)
        return state, torch.stack(losses).mean()


@torch.no_grad()
def eval_epoch(params, dataset, batch_idx: torch.Tensor, weights: torch.Tensor, mcfg: ModelConfig,
               mesh=None) -> torch.Tensor:
    """Validation (no dropout) -> the sample-weighted mean MSE as a device
    scalar; ``weights`` [steps, B] is 0 for the padding of the last batch.
    On a mesh each rank holds its columns of ``batch_idx`` and ``weights``
    and its shard of the parameters; the sums cover every rank's."""
    sums = torch.zeros((), device=batch_idx.device)
    counts = torch.zeros((), device=batch_idx.device)
    for idx, w in zip(batch_idx, weights):
        codes, targets = dataset.gather_batch(idx)
        if _column_parallel(params, mesh):
            out = font_renderer.project(params, font_renderer.frontend(params, codes, mcfg), mcfg)
            d = out - mesh.columns(targets.reshape(targets.shape[0], -1))
            per_sample = mesh.model_sum((d * d).sum(1)) / (d.shape[1] * mesh.model)
        else:
            pred = font_renderer.apply(params, codes, mcfg)
            per_sample = ((pred - targets) ** 2).mean(dim=(1, 2))
        sums += (per_sample * w).sum()
        counts += w.sum()
    if mesh is not None:
        sums, counts = mesh.data_sum(sums), mesh.data_sum(counts)
    return sums / counts.clamp(min=1.0)


def train_eval_epoch(state, dataset, batch_idx, val_batch_idx, val_weights, lr, generator, mcfg, tcfg, mesh=None):
    """A training epoch then a validation pass -> (state, train loss, val
    loss), both device scalars."""
    state, train_loss = train_epoch(state, dataset, batch_idx, lr, generator, mcfg, tcfg, mesh)
    return state, train_loss, eval_epoch(state.params, dataset, val_batch_idx, val_weights, mcfg, mesh)
