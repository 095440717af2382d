"""SIREN glyph bank in PyTorch: (char, x, y) -> coverage.

The port of ai_font_renderer_tpu/models/siren.py: a coordinate MLP with
sine activations whose hidden layers are modulated per glyph by FiLM (the
glyph's embedding -> a scale and a shift per layer). The parameters keep
the JAX package's flat dict (weights [in, out]), so a bank carried across
by ``params_from_jax`` computes what the JAX bank computes.

``sin(w0 * z)`` with w0 = 30 in the first layer multiplies every rounding
of its argument by 30, so the trunk stays in true f32: the port's entry
points switch TF32 off (``device.resolve_device``) and every product here
is a plain f32 ``torch.matmul`` (``compute="bfloat16"``: bf16-rounded
operands, f32 sums, as the JAX package's ``preferred_element_type``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve_device


@dataclass(frozen=True)
class SirenConfig:
    n_chars: int = 95
    embed_dim: int = 64
    hidden_dim: int = 128
    n_layers: int = 4
    w0_first: float = 30.0
    w0_hidden: float = 1.0
    cell: int = 64
    mode: str = "coverage"  # or "sdf"
    # Operand type of the trunk's products; sums are f32 either way.
    compute: str = "float32"


def init(
    generator: torch.Generator,
    cfg: SirenConfig = SirenConfig(),
    device: str | torch.device | None = None,
) -> dict[str, torch.Tensor]:
    """The JAX package's distributions: N(0, 0.1^2) embedding, the first
    layer U(+-1/2) (SIREN's 1/fan_in with fan_in 2), hidden layers
    U(+-sqrt(6/hidden)/w0_hidden), FiLM weights N(0, 0.01^2), the output
    layer U(+-sqrt(6/hidden)), zero biases. Draws run on the generator's
    device in that order and land on ``device``."""
    dev = resolve_device(device)
    g, h = generator, cfg.hidden_dim

    def uniform(shape, bound):
        return (torch.rand(shape, generator=g, device=g.device) * 2.0 - 1.0) * bound

    def normal(shape, std):
        return std * torch.randn(shape, generator=g, device=g.device)

    params = {
        "embed": normal((cfg.n_chars, cfg.embed_dim), 0.1),
        "w_in": uniform((2, h), 0.5),
        "b_in": torch.zeros(h, device=g.device),
    }
    for i in range(cfg.n_layers):
        params[f"w_{i}"] = uniform((h, h), (6.0 / h) ** 0.5 / cfg.w0_hidden)
        params[f"b_{i}"] = torch.zeros(h, device=g.device)
        params[f"film_w_{i}"] = normal((cfg.embed_dim, 2 * h), 0.01)
        params[f"film_b_{i}"] = torch.zeros(2 * h, device=g.device)
    params["w_out"] = uniform((h, 1), (6.0 / h) ** 0.5)
    params["b_out"] = torch.zeros(1, device=g.device)
    return {k: v.to(dev) for k, v in params.items()}


def apply(params, char_ids: torch.Tensor, coords: torch.Tensor, cfg: SirenConfig) -> torch.Tensor:
    """Evaluate at coords for each char: [B] chars x [B, P, 2] -> [B, P].
    coords are in [-1, 1]^2."""
    if cfg.compute == "bfloat16":
        def mm(a, b):
            return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()
    else:
        def mm(a, b):
            return a @ b
    emb = params["embed"][char_ids.long()]  # [B, E]
    h = torch.sin(cfg.w0_first * (mm(coords, params["w_in"]) + params["b_in"]))
    for i in range(cfg.n_layers):
        film = mm(emb, params[f"film_w_{i}"]) + params[f"film_b_{i}"]  # [B, 2H]
        scale, shift = film.chunk(2, dim=-1)
        z = mm(h, params[f"w_{i}"]) + params[f"b_{i}"]
        z = z * (1.0 + scale[:, None, :]) + shift[:, None, :]
        h = torch.sin(cfg.w0_hidden * z)
    out = (mm(h, params["w_out"]) + params["b_out"])[..., 0]  # [B, P]
    if cfg.mode == "coverage":
        out = torch.sigmoid(out)
    return out


def grid_coords(cell: int, device: str | torch.device | None = "cpu") -> torch.Tensor:
    """[cell*cell, 2] coordinates (x, y) in [-1, 1], row-major."""
    xs = (torch.arange(cell, device=device) + 0.5) / cell * 2.0 - 1.0
    yy, xx = torch.meshgrid(xs, xs, indexing="ij")
    return torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1)


def render_atlas(params, cfg: SirenConfig) -> torch.Tensor:
    """Every glyph at full resolution in one evaluation: [C, cell, cell]."""
    dev = params["embed"].device
    coords = grid_coords(cfg.cell, dev)
    char_ids = torch.arange(cfg.n_chars, device=dev)
    vals = apply(params, char_ids, coords.expand(cfg.n_chars, -1, -1), cfg)
    return vals.reshape(cfg.n_chars, cfg.cell, cfg.cell)


def loss_fn(params, char_ids, coords, targets, cfg: SirenConfig) -> torch.Tensor:
    return torch.mean((apply(params, char_ids, coords, cfg) - targets) ** 2)


def render_atlas_chunked(params, cfg: SirenConfig, chunk: int = 128) -> torch.Tensor:
    """The atlas in sequential chunks of ``chunk`` glyphs, so that a large
    charset never holds [n_chars, cell^2, hidden] activations at once. The
    ids are those of the JAX package's ``lax.map``: arange(n_chunks *
    chunk) % n_chars, the last chunk wrapping to the first glyphs, cut back
    to [n_chars, cell, cell]."""
    n = cfg.n_chars
    dev = params["embed"].device
    coords = grid_coords(cfg.cell, dev)
    n_chunks = -(-n // chunk)
    ids = (torch.arange(n_chunks * chunk, device=dev) % n).reshape(n_chunks, chunk)
    parts = [apply(params, part, coords.expand(chunk, -1, -1), cfg) for part in ids]
    return torch.cat(parts).reshape(n_chunks * chunk, cfg.cell, cfg.cell)[:n]

