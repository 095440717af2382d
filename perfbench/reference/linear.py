"""The reference of the linear decoder (``decoder: "linear"``): the font
renderer's training math in plain PyTorch, and its leaves.

Written from the model's equations (chenglou/ai-font-renderer model.py:
129-204) with the numerics a configuration states:

    x = dropout(embedding[codes]) + pos          (frontend dtype: f32, or bf16)
    x = LayerNorm(x + MHA(x))                    (statistics in f32)
    h = dropout(relu(x @ fc1_w + fc1_b))         -> flat [B, S * hidden], f32
    sheet = clamp(bf16(flat) @ bf16(out_w) + out_b, 0, 1)   (f32 sums)

MHA has the program's roundings: projections in the frontend dtype, f32
logits and softmax, probabilities rounded to the frontend dtype, kept ones
divided by (1 - rate) in that dtype, P @ v summed in f32. A training
forward draws its dropout from one ``torch.Generator`` in the program's
documented order (``features``): the embedding's mask (a uniform f32 draw,
or a uint8 draw with ``bits_dropout``), the attention's Philox seed (an
int32 below 2^31), fc1's mask. The attention's mask is Philox4x32-10 of
that seed (``philox.py``).

The projection's backward follows the step the configuration runs: the
fused step (``fused``) rounds the masked cotangent to bf16 once for both
products, the standard step differentiates the bf16 casts as autograd
does. ``lower="fp8"`` rounds every matrix operand to float8 e4m3 under a
power-of-two scale per tensor (the forward only: the backward passes
through): the control one precision below bf16.
"""

from __future__ import annotations

import math

import torch

from .common import Numerics
from .philox import dropout_keep


def _dropout(x, rate: float, gen, bits: bool):
    keep = 1.0 - rate
    if bits:
        draw = torch.randint(0, 256, tuple(x.shape), generator=gen, device=x.device, dtype=torch.uint8)
        mask = draw < int(keep * 256)
    else:
        mask = torch.rand(tuple(x.shape), generator=gen, device=x.device) < keep
    scale = torch.tensor(keep, dtype=x.dtype)
    return torch.where(mask, x / scale, torch.zeros((), dtype=x.dtype, device=x.device))


def attention(x, p: dict, heads: int, num: Numerics, rate: float = 0.0, seed=None, sfx: str = ""):
    """Multi-head self-attention [B, S, E] -> [B, S, E] in x's dtype, with
    the Philox dropout of ``seed`` at ``rate`` on the probabilities."""
    B, S, E = x.shape
    d = E // heads
    dt = x.dtype
    xo = num.op(x)

    def proj(w, b):
        return xo @ num.op(p[w + sfx]) + p[b + sfx].to(dt)

    q = proj("wq", "bq").reshape(B, S, heads, d)
    k = proj("wk", "bk").reshape(B, S, heads, d)
    v = proj("wv", "bv").reshape(B, S, heads, d)
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) / math.sqrt(d)
    probs = torch.softmax(logits, dim=-1).to(dt)
    if rate > 0.0:
        keep = dropout_keep(seed, (B, heads, S, S), rate)
        scale = torch.tensor(float(torch.tensor(1.0 - rate, dtype=dt)), dtype=dt)
        probs = torch.where(keep, probs / scale, torch.zeros((), dtype=dt, device=x.device))
    out = torch.einsum("bhst,bthd->bshd", num.op(probs).float(), num.op(v).float()).to(dt)
    return num.op(out.reshape(B, S, E)) @ num.op(p["wo" + sfx]) + p["bo" + sfx].to(dt)


def _layer_norm(x, scale, bias, eps: float = 1e-5):
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def frontend(p: dict, codes: torch.Tensor, m: dict, num: Numerics, gen=None) -> torch.Tensor:
    """codes [B, S] -> flat [B, max_length * hidden] f32; dropout when
    ``gen`` is given."""
    B = codes.shape[0]
    S = min(codes.shape[1], m["max_length"])
    codes = codes[:, :S].long()
    dt, bits = num.dt, bool(m.get("bits_dropout"))
    x = num.op(p["embedding"])[codes]
    if gen is not None:
        x = _dropout(x, m["dropout_rate"], gen, bits)
    x = x + p["pos"].to(dt)[:S]
    rate, seed = 0.0, None
    if gen is not None:
        rate = m["dropout_rate"]
        seed = torch.randint(0, 2**31, (1,), generator=gen, device=x.device, dtype=torch.int32)
    a = attention(x, p, m["num_heads"], num, rate, seed)
    x = _layer_norm((x + a).float(), p["ln_scale"], p["ln_bias"]).to(dt)
    for i in range(1, m.get("num_blocks", 1)):
        a = attention(x, p, m["num_heads"], num, sfx=f"_b{i}")
        x = _layer_norm((x + a).float(), p[f"ln_scale_b{i}"], p[f"ln_bias_b{i}"]).to(dt)
    h = torch.relu(x @ num.op(p["fc1_w"]) + p["fc1_b"].to(dt))
    if gen is not None:
        h = _dropout(h, m["fc_dropout_rate"], gen, bits)
    flat = h.float().reshape(B, -1)
    full = m["max_length"] * m["hidden_dim"]
    return torch.nn.functional.pad(flat, (0, full - flat.shape[1]))


class _FusedProjection(torch.autograd.Function):
    """clamp(x16 @ w16 + b, 0, 1), its backward with the masked cotangent
    (0 < out < 1) rounded to bf16 once for both products, f32 sums."""

    @staticmethod
    def forward(ctx, x16, w16, b):
        out = (x16.float() @ w16.float() + b).clamp(0.0, 1.0)
        ctx.save_for_backward(x16, w16, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x16, w16, out = ctx.saved_tensors
        gm = torch.where((out > 0.0) & (out < 1.0), g, 0.0)
        gm16 = gm.to(torch.bfloat16).float()
        return gm16 @ w16.float().T, x16.float().T @ gm16, gm.sum(0)


def project(p: dict, flat: torch.Tensor, m: dict, num: Numerics, train: bool = False, fused: bool = False):
    """flat [B, K] -> clamped sheet rows [B, N]: operands in the projection
    dtype, f32 sums; the leaky clamp while training where the config has
    one."""
    x, w = num.op(flat, num.proj_dt), num.op(p["out_w"], num.proj_dt)
    if fused:
        return _FusedProjection.apply(x, w, p["out_b"])
    sheet = x.float() @ w.float() + p["out_b"]
    y = sheet.clamp(0.0, 1.0)
    slope = m.get("leaky_clamp", 0.0)
    return y + slope * (sheet - y) if train and slope > 0.0 else y


def train_output(p: dict, codes: torch.Tensor, m: dict, num: Numerics, gen, fused: bool) -> torch.Tensor:
    """A training forward: codes [B, S] -> sheet rows [B, H * W], dropout
    drawn from ``gen``."""
    return project(p, frontend(p, codes, m, num, gen), m, num, train=True, fused=fused)


def leaves(m: dict) -> tuple[dict, dict, dict]:
    """The model's leaves and their init distributions (font_renderer.init):
    (uniform {key: (shape, bound)}, normal {key: (shape, std)}, constant
    {key: (shape, value)}). N(0, 1) embedding, N(0, pos_init_std)
    positions, xavier-uniform q/k/v, U(+-1/sqrt(fan_in)) for the other
    weights, zero attention biases, unit LayerNorm scale."""
    e, h, s = m["embedding_dim"], m["hidden_dim"], m["max_length"]
    flat, pixels = s * h, m["sheet_height"] * m["sheet_width"]
    xavier = (6.0 / (e + e)) ** 0.5
    uniform = {"fc1_w": ((e, h), e**-0.5), "fc1_b": ((h,), e**-0.5),
               "out_w": ((flat, pixels), flat**-0.5), "out_b": ((pixels,), flat**-0.5)}
    const = {"ln_scale": ((e,), 1.0), "ln_bias": ((e,), 0.0)}
    for i in range(m.get("num_blocks", 1)):
        sfx = f"_b{i}" if i else ""
        uniform.update({f"w{c}{sfx}": ((e, e), xavier) for c in "qkv"})
        uniform[f"wo{sfx}"] = ((e, e), e**-0.5)
        const.update({f"b{c}{sfx}": ((e,), 0.0) for c in "qkvo"})
        if i:
            const.update({f"ln_scale{sfx}": ((e,), 1.0), f"ln_bias{sfx}": ((e,), 0.0)})
    normal = {"embedding": ((m["vocab_size"], e), 1.0), "pos": ((s, e), m.get("pos_init_std", 0.02))}
    return uniform, normal, const
