"""Learned glyph placement in PyTorch, its inference half: char codes ->
per-slot glyph positions.

The port of ai_font_renderer_tpu/models/placement.py (``init`` to
``line_logits``). A placement transformer, the flagship's frontend
(``font_renderer.features``) with a per-slot head, reads the raw char codes
and emits, for every input slot, the glyph's advance-midpoint x, its
baseline y (base-scale sheet px) and a visibility logit. The head's kind is
carried by the weights: ``place_w`` [hidden, 3] is the regression head,
[hidden, 2 + L] the line head (y decoded from L line logits), and with
``place_adv``/``place_kern`` present [hidden, 3 + L] the structured head (x
derived from the predicted break structure by :func:`structured_x`).

With ``fused_attention`` or ``fused_attention_v2`` in the config the
frontend's attention block runs through the port's attention kernels, as
the flagship's does. Everything else here is plain PyTorch: the JAX
package computes these products in XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ModelConfig, SheetSpec
from ..device import resolve_device
from . import font_renderer


def init(
    generator: torch.Generator,
    cfg: ModelConfig = ModelConfig(),
    *,
    lines: int = 0,
    advances: np.ndarray | None = None,
    kerning: np.ndarray | None = None,
    uncertainty: bool = False,
    device: str | torch.device | None = None,
) -> dict[str, torch.Tensor]:
    """Frontend params (``font_renderer.init_frontend``) + a per-slot head.

    ``lines=0``: the regression head, 3 units (x, y, visibility).
    ``lines=L`` (L >= 2): the line head, 2 + L units (x, visibility,
    line logits). ``advances`` (an ASCII-indexed [128] advance table, px;
    needs ``lines >= 2``): the structured head, 3 + L units (x residual,
    visibility, contribution, line logits), with the advance table and the
    [128, 128] ``kerning`` table (zeros when None) as ``place_adv`` and
    ``place_kern``. ``uncertainty`` adds ``loss_logvar`` [4], zeros. The
    head's weights are U(+-1/sqrt(hidden)), its bias zero; the draws follow
    the frontend's on ``generator``."""
    if lines == 1:
        raise ValueError("lines must be 0 (regression head) or >= 2")
    if advances is not None and lines < 2:
        raise ValueError("the structured head requires lines >= 2")
    dev = resolve_device(device)
    params = font_renderer.init_frontend(generator, cfg, generator.device)
    h = cfg.hidden_dim
    if advances is not None:
        n_out = 3 + lines
        adv = np.asarray(advances, np.float32)
        if adv.shape != (128,):
            raise ValueError("advances must be an ASCII-indexed [128] table")
        kern = np.zeros((128, 128), np.float32) if kerning is None else np.asarray(kerning, np.float32)
        if kern.shape != (128, 128):
            raise ValueError("kerning must be an ASCII-indexed [128,128] table")
        params["place_adv"] = torch.from_numpy(adv.copy())
        params["place_kern"] = torch.from_numpy(kern.copy())
    else:
        n_out = 3 if lines == 0 else 2 + lines
    bound = 1.0 / h**0.5
    u = torch.rand((h, n_out), generator=generator, device=generator.device)
    params["place_w"] = (u * 2.0 - 1.0) * bound
    params["place_b"] = torch.zeros(n_out)
    if uncertainty:
        params["loss_logvar"] = torch.zeros(4)
    return {k: v.to(dev) for k, v in params.items()}


def head_structured(params) -> bool:
    """True for the structured (derived-x) head."""
    return "place_adv" in params


def head_lines(params) -> int:
    """0 for the regression head, L for a line-aware head."""
    n = params["place_w"].shape[1]
    if head_structured(params):
        return n - 3
    return 0 if n == 3 else n - 2


def _head(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return x.float() @ w + b


def structured_x(
    params,
    codes: torch.Tensor,
    contrib_logit: torch.Tensor,
    line_log: torch.Tensor,
    spec: SheetSpec = SheetSpec(),
    detach: bool = False,
    hard: bool = False,
) -> torch.Tensor:
    """Per-slot glyph-midpoint x derived from the predicted break structure:
    slot i's midpoint is

        padding + sum_{j<i, same line, contributing} advance_j
                + sum_{j<=i, same line, pair intra-line} kern(c_{j-1}, c_j)
                + advance_i / 2

    with "same line" the inner product of the two slots' line
    distributions and "contributing" the contribution sigmoid (soft), or
    the argmax line's one-hot and ``contrib_logit > 0`` (``hard``).
    ``detach`` stops gradients at the structure probabilities. Slot 0 has
    no predecessor: its kern is 0. codes [B, S] -> x [B, S]."""
    codes = codes.long()
    adv = params["place_adv"][codes]  # [B, S]
    kern = params["place_kern"][codes[:, :-1], codes[:, 1:]]  # [B, S-1]
    kern = F.pad(kern, (1, 0))
    if detach:
        contrib_logit, line_log = contrib_logit.detach(), line_log.detach()
    if hard:
        p_line = F.one_hot(line_log.argmax(-1), line_log.shape[-1]).float()  # [B, S, L]
        c = (contrib_logit > 0).float()  # [B, S]
    else:
        p_line = torch.softmax(line_log, dim=-1)
        c = torch.sigmoid(contrib_logit)
    same = torch.einsum("bil,bjl->bij", p_line, p_line)  # [B, S, S]
    c_prev = F.pad(c[:, :-1], (1, 0))
    same_prev = F.pad(torch.einsum("bjl,bjl->bj", p_line[:, :-1], p_line[:, 1:]), (1, 0))  # same(j-1, j)
    step = c * adv
    kstep = kern * c * c_prev * same_prev
    S = codes.shape[1]
    ones = torch.ones((S, S), device=codes.device)
    strict, incl = torch.tril(ones, -1), torch.tril(ones, 0)
    return (
        float(spec.padding)
        + torch.einsum("bij,bj->bi", same * strict, step)
        + torch.einsum("bij,bj->bi", same * incl, kstep)
        + 0.5 * adv
    )


def monotone_lines(line_log: torch.Tensor, weight: torch.Tensor | None = None) -> torch.Tensor:
    """Viterbi decode of per-slot line indices under the layout engine's
    invariant: in slot order the line index starts at 0, never falls and
    rises by at most one a slot. Maximises sum_s w_s * log p(l_s | slot s)
    over those paths; ``weight`` [B, S] (optional) scales each slot's log
    probabilities. Returns [B, S] int64.

    Both scans are loops over the S slots on the tensors' device. A path
    into line l comes up from l - 1 only where that score is strictly
    greater (``up > prev``): ties stay on the lower line. The last slot's
    line is the first maximum of the final scores (``argmax``, as
    ``jnp.argmax``), and the backward scan walks from it to slot 0."""
    logp = torch.log_softmax(line_log, dim=-1)  # [B, S, L]
    if weight is not None:
        logp = logp * weight[..., None]
    B, S, L = logp.shape
    start = torch.full((L,), float("-inf"), device=logp.device)
    start[0] = 0.0  # line 0 first
    prev = logp[:, 0] + start
    came_up = []
    for s in range(1, S):
        up = F.pad(prev[:, :-1], (1, 0), value=float("-inf"))
        came_up.append(up > prev)
        prev = logp[:, s] + torch.maximum(prev, up)
    line = prev.argmax(-1)  # [B]
    out = [line]
    for ch in reversed(came_up):
        line = line - ch.gather(1, line[:, None])[:, 0].long()
        out.append(line)
    return torch.stack(out[::-1], dim=1)


def apply(
    params,
    codes: torch.Tensor,
    cfg: ModelConfig = ModelConfig(),
    *,
    train: bool = False,
    generator: torch.Generator | None = None,
    hard: bool = False,
    monotone: bool = False,
    spec: SheetSpec = SheetSpec(),
) -> tuple[torch.Tensor, torch.Tensor]:
    """codes [B, S] -> (midpoints [B, S, 2] sheet px, visibility logits [B, S]).

    midpoints[..., 0] is the glyph's advance-midpoint x, [..., 1] its
    baseline y, both at base scale. A line head's y is the line
    distribution's expectation sum_l p_l (l + 1) line_height, or with
    ``hard`` the argmax line's baseline; the structured head's x comes
    from :func:`structured_x` (soft or ``hard``) plus the residual.
    ``monotone`` (implies ``hard``) decodes the lines jointly with
    :func:`monotone_lines`, weighted by the contribution (structured head)
    or visibility (line head) probability. Both are no-ops for the
    regression head."""
    x = font_renderer.features(params, codes, cfg, train=train, generator=generator)
    out = _head(x, params["place_w"], params["place_b"])  # [B, S, 3 | 2+L | 3+L]
    L = head_lines(params)
    if L == 0:
        return out[..., :2], out[..., 2]
    hard = hard or monotone
    baselines = (torch.arange(L, dtype=torch.float32, device=out.device) + 1.0) * spec.line_height
    off, weight_col = (3, 2) if head_structured(params) else (2, 1)
    llog = out[..., off:]
    if monotone:
        lines = monotone_lines(llog, torch.sigmoid(out[..., weight_col]))
        llog = F.one_hot(lines, L).float() * 1e4
    y = baselines[llog.argmax(-1)] if hard else torch.softmax(llog, dim=-1) @ baselines
    if head_structured(params):
        px = structured_x(params, codes, out[..., 2], llog, spec, hard=hard) + out[..., 0]
        return torch.stack([px, y], dim=-1), out[..., 1]
    return torch.stack([out[..., 0], y], dim=-1), out[..., 1]


def line_logits(
    params,
    codes: torch.Tensor,
    cfg: ModelConfig = ModelConfig(),
    *,
    train: bool = False,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Raw per-slot line logits [B, S, L] (line-aware heads only)."""
    if head_lines(params) == 0:
        raise ValueError("regression head has no line logits")
    x = font_renderer.features(params, codes, cfg, train=train, generator=generator)
    off = 3 if head_structured(params) else 2
    return _head(x, params["place_w"], params["place_b"])[..., off:]
