"""Learned glyph placement in PyTorch: char codes -> per-slot glyph
positions, and the supervision that trains it.

The port of ai_font_renderer_tpu/models/placement.py. A placement
transformer, the flagship's frontend (``font_renderer.features``) with a
per-slot head, reads the raw char codes and emits, for every input slot,
the glyph's advance-midpoint x, its baseline y (base-scale sheet px) and a
visibility logit. The head's kind is carried by the weights: ``place_w``
[hidden, 3] is the regression head, [hidden, 2 + L] the line head (y
decoded from L line logits), and with ``place_adv``/``place_kern`` present
[hidden, 3 + L] the structured head (x derived from the predicted break
structure by :func:`structured_x`).
:func:`placement_targets` replays the layout engine on the host for the
per-slot targets, and :func:`loss_fn` is the supervised loss over them.

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


def placement_targets(
    strings: list[str],
    table,
    spec: SheetSpec = SheetSpec(),
    max_glyphs: int = 100,
    full: bool = False,
    margins: bool = False,
):
    """The layout engine's targets, indexed by ORIGINAL character slot (host
    numpy, the JAX package's code): (midpoints [N, S, 2] f32, visible [N, S]
    bool), S = spec.max_chars. A visible slot holds the advance-midpoint x
    and baseline y the engine gives its glyph; spaces, unknown chars,
    separators a line break consumes and glyphs past ``max_glyphs`` are
    invisible, their midpoints 0. ``table`` is a fontgen AdvanceTable.

    ``full`` adds the structured head's supervision: (line_idx [N, S] int32,
    contrib [N, S] bool); a slot contributes when the engine's pen walks
    over it, and line_idx is its line (0 where it does not). ``margins``
    appends the per-slot decision margin [N, S] f32: for each word placed
    against a non-empty line, |measure(candidate) - usable width| on its
    slots and its separator; +inf elsewhere."""
    S = spec.max_chars
    adv = table.advances_px
    idx = {c: i for i, c in enumerate(table.charset)}
    max_width = spec.width - 2 * spec.padding
    n = len(strings)
    mids = np.zeros((n, S, 2), np.float32)
    vis = np.zeros((n, S), bool)
    line_idx = np.zeros((n, S), np.int32)
    contrib = np.zeros((n, S), bool)
    margin = np.full((n, S), np.inf, np.float32)
    for si, text in enumerate(strings):
        text = text[:S]
        words = text.split(" ")
        offs: list[int] = []
        pos = 0
        for w in words:
            offs.append(pos)
            pos += len(w) + 1
        # Greedy wrap (wrap_text's rules), each line keeping its chars'
        # original indices. With a non-empty line the candidate joins one
        # separator space (the char before the word), which a break
        # consumes; with an empty one it is the bare word.
        lines: list[list[tuple[int, str]]] = []
        cur_text = ""
        cur_chars: list[tuple[int, str]] = []
        for wi, word in enumerate(words):
            wchars = [(offs[wi] + j, c) for j, c in enumerate(word)]
            if cur_text:
                test = f"{cur_text} {word}"
                tchars = cur_chars + [(offs[wi] - 1, " ")] + wchars
            else:
                test = word
                tchars = wchars
            meas = table.measure(test)
            if cur_text:
                m = abs(meas - max_width)
                for ci, _ in wchars:
                    margin[si, ci] = m
                if offs[wi] > 0:
                    margin[si, offs[wi] - 1] = m
            if meas > max_width and cur_text:
                lines.append(cur_chars)
                cur_text, cur_chars = word, wchars
            else:
                cur_text, cur_chars = test, tchars
        if cur_text:
            lines.append(cur_chars)
        g = 0
        for li, chars in enumerate(lines):
            baseline = (li + 1) * spec.line_height
            pen = float(spec.padding)
            prev = None
            for ci, ch in chars:
                k = idx.get(ch)
                a = adv[0 if k is None else k]
                if prev is not None:
                    pen += table.kern(prev, ch)
                prev = ch
                line_idx[si, ci] = li
                contrib[si, ci] = True
                if k is not None and ch != " " and g < max_glyphs:
                    mids[si, ci, 0] = pen + 0.5 * a
                    mids[si, ci, 1] = baseline
                    vis[si, ci] = True
                    g += 1
                pen += a
    out = [mids, vis]
    if full:
        out += [line_idx, contrib]
    if margins:
        out.append(margin)
    return tuple(out)


def _bce(logit: torch.Tensor, target_f: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid binary cross-entropy (numerically stable form)."""
    return torch.mean(torch.clamp(logit, min=0) - logit * target_f + torch.log1p(torch.exp(-logit.abs())))


def _line_ce(logits: torch.Tensor, tgt: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum(w * -log softmax(logits)[tgt]) / max(sum(w), 1)."""
    logp = torch.log_softmax(logits, dim=-1)
    picked = logp.gather(-1, tgt.long()[..., None])[..., 0]
    return -torch.sum(picked * w) / torch.clamp(torch.sum(w), min=1.0)


def loss_fn(
    params,
    codes: torch.Tensor,
    mids: torch.Tensor,
    vis: torch.Tensor,
    cfg: ModelConfig,
    *,
    generator: torch.Generator | None = None,
    train: bool = True,
    line_tgt: torch.Tensor | None = None,
    contrib_tgt: torch.Tensor | None = None,
    detach_structure: bool = False,
    ce_w: torch.Tensor | None = None,
    spec: SheetSpec = SheetSpec(),
) -> torch.Tensor:
    """The supervised loss: masked position error over visible slots plus
    the visibility BCE, by head.

    Regression head: x/y squared error (px^2). Line head: x squared error +
    100 x the line cross-entropy over visible slots (targets round(y /
    line_height) - 1). Structured head (needs ``line_tgt``/``contrib_tgt``
    from ``placement_targets(..., full=True)``): the derived x's squared
    error + 100 x the line CE over contributing slots + the contribution
    BCE; ``detach_structure`` stops the x error's gradients at the
    structure probabilities. ``ce_w`` [N, S] reweights the line CE per slot
    (weighted mean); the regression head ignores it. With ``loss_logvar``
    in the params the terms combine as sum(exp(-s_i) L_i + s_i) over slots
    0 = position, 1 = line CE, 2 = contribution BCE, 3 = visibility BCE;
    else as a plain sum. ``train`` draws dropout from ``generator``."""
    visf = vis.float()
    n_vis = torch.clamp(torch.sum(visf), min=1.0)
    L = head_lines(params)
    if L == 0:
        pred_xy, logit = apply(params, codes, cfg, train=train, generator=generator, spec=spec)
        pos = torch.sum(torch.sum((pred_xy - mids) ** 2, -1) * visf) / n_vis
        terms = [(0, pos)]
    elif head_structured(params):
        if line_tgt is None or contrib_tgt is None:
            raise ValueError("structured head needs line_tgt/contrib_tgt (placement_targets(..., full=True))")
        x = font_renderer.features(params, codes, cfg, train=train, generator=generator)
        out = _head(x, params["place_w"], params["place_b"])
        logit, llog = out[..., 1], out[..., 3:]
        px = structured_x(params, codes, out[..., 2], llog, spec, detach=detach_structure) + out[..., 0]
        pos_x = torch.sum((px - mids[..., 0]) ** 2 * visf) / n_vis
        cf = contrib_tgt.float()
        cw = cf if ce_w is None else cf * ce_w
        ce = _line_ce(llog, torch.clamp(line_tgt, 0, L - 1), cw)
        terms = [(0, pos_x), (1, 100.0 * ce), (2, _bce(out[..., 2], cf))]
    else:
        x = font_renderer.features(params, codes, cfg, train=train, generator=generator)
        out = _head(x, params["place_w"], params["place_b"])
        logit = out[..., 1]
        pos_x = torch.sum((out[..., 0] - mids[..., 0]) ** 2 * visf) / n_vis
        tgt = torch.clamp(torch.round(mids[..., 1] / spec.line_height).to(torch.int32) - 1, 0, L - 1)
        cw = visf if ce_w is None else visf * ce_w
        terms = [(0, pos_x), (1, 100.0 * _line_ce(out[..., 2:], tgt, cw))]
    terms.append((3, _bce(logit, visf)))
    if "loss_logvar" in params:
        s = params["loss_logvar"]
        return sum(torch.exp(-s[i]) * t + s[i] for i, t in terms)
    return sum(t for _, t in terms)
