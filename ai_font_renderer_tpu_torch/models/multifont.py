"""Multi-font conditioned glyph model in PyTorch: (font_id, char) -> glyph.

The port of ai_font_renderer_tpu/models/multifont.py: the SIREN trunk of
models/siren.py with two conditioning embeddings, the character's and the
font's, whose concatenation drives the FiLM modulation of every hidden
layer, so the coordinate trunk is shared across fonts. ``mode="sdf"``
regresses signed distances instead of coverage. The parameters keep the
JAX package's flat dict (weights [in, out]), so a JAX-initialised dict
carried across by ``params_from_jax`` computes what the JAX model computes.
Every product is a plain f32 ``torch.matmul`` (the entry points switch TF32
off): the JAX package computes this model in XLA, outside any Pallas
kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve_device
from .gather import gather_rows
from .siren import grid_coords


@dataclass(frozen=True)
class MultiFontConfig:
    n_fonts: int = 2
    n_chars: int = 95
    embed_dim: int = 64
    font_dim: int = 16
    hidden_dim: int = 128
    n_layers: int = 4
    w0_first: float = 30.0
    w0_hidden: float = 1.0
    cell: int = 64
    mode: str = "coverage"  # or "sdf"


def init(
    generator: torch.Generator,
    cfg: MultiFontConfig = MultiFontConfig(),
    device: str | torch.device | None = None,
) -> dict[str, torch.Tensor]:
    """The JAX package's distributions, drawn in the order it uses its
    keys: N(0, 0.1^2) char and font embeddings, the first layer U(+-1/2),
    then per hidden layer its weights U(+-sqrt(6/hidden)/w0_hidden) and its
    FiLM weights N(0, 0.01^2), then the output layer U(+-sqrt(6/hidden));
    zero biases. Draws run on the generator's device and land on
    ``device``."""
    dev = resolve_device(device)
    g, h = generator, cfg.hidden_dim
    cond = cfg.embed_dim + cfg.font_dim

    def uniform(shape, bound):
        return (torch.rand(shape, generator=g, device=g.device) * 2.0 - 1.0) * bound

    def normal(shape, std):
        return std * torch.randn(shape, generator=g, device=g.device)

    params = {
        "char_embed": normal((cfg.n_chars, cfg.embed_dim), 0.1),
        "font_embed": normal((cfg.n_fonts, cfg.font_dim), 0.1),
        "w_in": uniform((2, h), 0.5),
        "b_in": torch.zeros(h, device=g.device),
    }
    for i in range(cfg.n_layers):
        params[f"w_{i}"] = uniform((h, h), (6.0 / h) ** 0.5 / cfg.w0_hidden)
        params[f"b_{i}"] = torch.zeros(h, device=g.device)
        params[f"film_w_{i}"] = normal((cond, 2 * h), 0.01)
        params[f"film_b_{i}"] = torch.zeros(2 * h, device=g.device)
    params["w_out"] = uniform((h, 1), (6.0 / h) ** 0.5)
    params["b_out"] = torch.zeros(1, device=g.device)
    return {k: v.to(dev) for k, v in params.items()}


def apply(params, font_ids: torch.Tensor, char_ids: torch.Tensor, coords: torch.Tensor,
          cfg: MultiFontConfig) -> torch.Tensor:
    """[B] fonts x [B] chars x [B, P, 2] coords in [-1, 1]^2 -> [B, P]."""
    cond = torch.cat([gather_rows(params["char_embed"], char_ids.long()),
                      gather_rows(params["font_embed"], font_ids.long())], dim=-1)
    h = torch.sin(cfg.w0_first * (coords @ params["w_in"] + params["b_in"]))
    for i in range(cfg.n_layers):
        film = cond @ params[f"film_w_{i}"] + params[f"film_b_{i}"]  # [B, 2H]
        scale, shift = film.chunk(2, dim=-1)
        z = h @ params[f"w_{i}"] + params[f"b_{i}"]
        z = z * (1.0 + scale[:, None, :]) + shift[:, None, :]
        h = torch.sin(cfg.w0_hidden * z)
    out = (h @ params["w_out"] + params["b_out"])[..., 0]
    if cfg.mode == "coverage":
        out = torch.sigmoid(out)
    return out


def render_atlas(params, cfg: MultiFontConfig) -> torch.Tensor:
    """All fonts x all glyphs in one evaluation: [F, C, cell, cell]."""
    dev = params["char_embed"].device
    coords = grid_coords(cfg.cell, dev)
    f_ids = torch.arange(cfg.n_fonts, device=dev).repeat_interleave(cfg.n_chars)
    c_ids = torch.arange(cfg.n_chars, device=dev).repeat(cfg.n_fonts)
    vals = apply(params, f_ids, c_ids, coords.expand(cfg.n_fonts * cfg.n_chars, -1, -1), cfg)
    return vals.reshape(cfg.n_fonts, cfg.n_chars, cfg.cell, cfg.cell)


def loss_fn(params, font_ids, char_ids, coords, targets, cfg: MultiFontConfig) -> torch.Tensor:
    return torch.mean((apply(params, font_ids, char_ids, coords, cfg) - targets) ** 2)
