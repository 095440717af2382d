"""AttentionFontRenderer in PyTorch: char codes -> pixel sheet.

The port of ai_font_renderer_tpu/models/font_renderer.py:

    embed(128->32) + learned positions [100, 32]
    -> MHA(4 heads) -> residual + post-LayerNorm   (x num_blocks)
    -> ReLU(Linear 32->64) -> flatten 6400 (short sequences zero-padded)
    -> decoder -> [80, 240] -> clamp(0, 1)

The decoder is ``cfg.decoder``: "linear", Linear 6400->19200 reshaped to
the sheet; or a conv decoder (:func:`conv_decode`, "conv" or "conv_ps"),
whose weights are shared across positions.

Parameters keep the JAX package's layout at every public function: one
flat dict with its key names, weights as [in, out], separate wq/wk/wv, so a
JAX-initialised dict carried across by :func:`params_from_jax` makes
:func:`apply` compute what ``font_renderer.apply`` computes.
:class:`AttentionFontRenderer` is the same thing as an ``nn.Module`` whose
parameters carry those names.

``train=True`` applies dropout (to the embeddings, the attention
probabilities and fc1's output) with masks drawn from the
``torch.Generator`` passed as ``generator``, in that order, and the leaky
clamp when ``leaky_clamp`` > 0. JAX's key schedule cannot be reproduced
here, so masks differ from the JAX package's; their distribution does
not. With ``fused_attention`` or ``fused_attention_v2`` the attention's
mask comes from the kernels' Philox under a seed drawn from ``generator``
in its place in that order. The conv weights are stored HWIO, as in the
JAX package, and turned to torch's OIHW inside :func:`conv_decode`.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig
from ..device import resolve_device
from ..ops.fused_attention import KEYS as ATTN_KEYS
from ..ops.fused_attention import fused_attention, fused_attention2, fused_attention_reference
from ..ops.fused_output import fused_output
from .gather import gather_rows


def _decoder_plan(cfg: ModelConfig) -> list[tuple[int, int, int, int]]:
    """Conv-decoder stage plan: [(out_h, out_w, c_in, c_out), ...].

    Spatial size doubles per stage from the latent grid, capped at the sheet
    size; the final stage always lands exactly on (sheet_height, sheet_width).
    Channels follow cfg.decoder_channels[1:].
    """
    gh, gw = cfg.decoder_grid
    chans = cfg.decoder_channels
    plan = []
    h, w, cin = gh, gw, chans[0]
    n = len(chans) - 1
    for i, cout in enumerate(chans[1:]):
        h = cfg.sheet_height if i == n - 1 else min(h * 2, cfg.sheet_height)
        w = cfg.sheet_width if i == n - 1 else min(w * 2, cfg.sheet_width)
        plan.append((h, w, cin, cout))
        cin = cout
    return plan


def _ps_factors(ratio: int, n: int) -> list[int]:
    """Split an integer upsampling ratio into n per-stage integer factors
    (2s first, any odd remainder in the last stage); product == ratio."""
    fs = []
    r = ratio
    for _ in range(n - 1):
        f = 2 if (r % 2 == 0 and r > 1) else 1
        fs.append(f)
        r //= f
    fs.append(r)
    return fs


def _decoder_plan_ps(cfg: ModelConfig) -> list[tuple[int, int, int, int]]:
    """Pixel-shuffle decoder plan: [(fy, fx, c_in, c_out), ...]. Each stage
    convolves at the current (low) resolution with c_out * fy * fx output
    channels, then depth-to-space upsamples by (fy, fx)."""
    gh, gw = cfg.decoder_grid
    if cfg.sheet_height % gh or cfg.sheet_width % gw:
        raise ValueError(
            f"decoder_grid {cfg.decoder_grid} must divide the sheet "
            f"({cfg.sheet_height}x{cfg.sheet_width}) for conv_ps"
        )
    chans = cfg.decoder_channels
    n = len(chans) - 1
    fys = _ps_factors(cfg.sheet_height // gh, n)
    fxs = _ps_factors(cfg.sheet_width // gw, n)
    return [(fys[i], fxs[i], chans[i], chans[i + 1]) for i in range(n)]


def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=gen.device)
    return (u * 2.0 - 1.0) * bound


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device)


def init_frontend(
    generator: torch.Generator,
    cfg: ModelConfig = ModelConfig(),
    device: str | torch.device | None = None,
) -> dict[str, torch.Tensor]:
    """The frontend's parameters alone (embedding, positions, attention
    blocks, LayerNorm, fc1): :func:`init`'s first draws, so they equal its
    frontend for the same generator state, without the decoder (the
    placement net, models/placement.py, has none)."""
    dev = resolve_device(device)
    e, h = cfg.embedding_dim, cfg.hidden_dim
    xavier = (6.0 / (e + e)) ** 0.5
    g = generator

    def zeros(n):
        return torch.zeros(n, device=g.device)

    params = {
        "embedding": _normal(g, (cfg.vocab_size, e)),
        "pos": cfg.pos_init_std * _normal(g, (cfg.max_length, e)),
        "wq": _uniform(g, (e, e), xavier),
        "wk": _uniform(g, (e, e), xavier),
        "wv": _uniform(g, (e, e), xavier),
        "bq": zeros(e),
        "bk": zeros(e),
        "bv": zeros(e),
        "wo": _uniform(g, (e, e), 1.0 / e**0.5),
        "bo": zeros(e),
        "ln_scale": torch.ones(e, device=g.device),
        "ln_bias": zeros(e),
        "fc1_w": _uniform(g, (e, h), 1.0 / e**0.5),
        "fc1_b": _uniform(g, (h,), 1.0 / e**0.5),
    }
    for i in range(1, cfg.num_blocks):
        params[f"wq_b{i}"] = _uniform(g, (e, e), xavier)
        params[f"wk_b{i}"] = _uniform(g, (e, e), xavier)
        params[f"wv_b{i}"] = _uniform(g, (e, e), xavier)
        params[f"wo_b{i}"] = _uniform(g, (e, e), 1.0 / e**0.5)
        for b in ("bq", "bk", "bv", "bo", "ln_bias"):
            params[f"{b}_b{i}"] = zeros(e)
        params[f"ln_scale_b{i}"] = torch.ones(e, device=g.device)
    return {k: v.to(dev) for k, v in params.items()}


def init(
    generator: torch.Generator,
    cfg: ModelConfig = ModelConfig(),
    device: str | torch.device | None = None,
) -> dict[str, torch.Tensor]:
    """Initialise parameters with the JAX package's distributions (torch's
    module defaults): N(0,1) embedding, N(0, pos_init_std) positions,
    xavier-uniform q/k/v, U(+-1/sqrt(fan_in)) for the other weights, zero
    attention biases, unit LayerNorm scale; a conv decoder's weights HWIO
    with torch's conv bound U(+-1/sqrt(9 * c_in)) and the ink bias at 1.0
    (white). The numbers differ from JAX's threefry draws; the
    distributions do not. Draws run on the generator's device and land on
    ``device``."""
    dev = resolve_device(device)
    params = init_frontend(generator, cfg, generator.device)
    h = cfg.hidden_dim
    flat = cfg.max_length * h
    pixels = cfg.sheet_height * cfg.sheet_width
    g = generator
    if cfg.decoder == "linear":
        params["out_w"] = _uniform(g, (flat, pixels), 1.0 / flat**0.5)
        params["out_b"] = _uniform(g, (pixels,), 1.0 / flat**0.5)
    else:
        c0 = cfg.decoder_channels[0]
        params["dec_in_w"] = _uniform(g, (h, c0), 1.0 / h**0.5)
        params["dec_in_b"] = _uniform(g, (c0,), 1.0 / h**0.5)
        if cfg.decoder == "conv":
            stages = [(cin, cout) for _, _, cin, cout in _decoder_plan(cfg)]
        else:  # conv_ps: the shuffle factors fold into the output channels
            stages = [(cin, cout * fy * fx) for fy, fx, cin, cout in _decoder_plan_ps(cfg)]
        for i, (cin, kout) in enumerate(stages):
            bound = 1.0 / (9 * cin) ** 0.5
            params[f"dec_w{i}"] = _uniform(g, (3, 3, cin, kout), bound)
            params[f"dec_b{i}"] = _uniform(g, (kout,), bound)
        clast = cfg.decoder_channels[-1]
        params["dec_out_w"] = _uniform(g, (3, 3, clast, 1), 1.0 / (9 * clast) ** 0.5)
        params["dec_out_b"] = torch.ones(1, device=g.device)
    return {k: v.to(dev) for k, v in params.items()}


def param_count(params: Mapping[str, torch.Tensor]) -> int:
    return sum(p.numel() for p in params.values())


def params_from_jax(
    flat: Mapping[str, np.ndarray], device: str | torch.device | None = None
) -> dict[str, torch.Tensor]:
    """A JAX parameter dict (numpy arrays, or anything ``np.asarray``
    takes) -> torch tensors on ``device``. The layouts are the same, so this
    is a copy per leaf with dtype and shape kept."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, copy=True)).to(dev) for k, v in flat.items()}


def params_to_numpy(params: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Inverse of :func:`params_from_jax`: host numpy arrays per key."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def infer_model_config(params: Mapping, base: ModelConfig = ModelConfig()) -> ModelConfig:
    """Recover architecture hyperparameters from a weight dict that carries
    no ``__config__`` entry (same rules as the JAX package): vocab/embed
    from the embedding, max_length from the positions, hidden width from
    fc1, depth from the ``wq_b{i}`` keys, the decoder family from the dec_*
    keys. num_heads is not recoverable from shapes; a non-default embedding
    width assumes 8-wide heads."""
    kw: dict = {}
    v, e = params["embedding"].shape
    kw["vocab_size"] = int(v)
    kw["embedding_dim"] = int(e)
    kw["max_length"] = int(params["pos"].shape[0])
    kw["hidden_dim"] = int(params["fc1_w"].shape[1])
    n_blocks = 1
    while f"wq_b{n_blocks}" in params:
        n_blocks += 1
    if n_blocks > 1:
        kw["num_blocks"] = n_blocks
    if int(e) != base.embedding_dim:
        kw["num_heads"] = max(1, int(e) // 8)
        print(
            f"Warning: inferring num_heads={kw['num_heads']} from "
            f"embedding_dim={e} (8-dim heads assumed) — shapes cannot "
            "determine the head count. Re-save the weights with "
            "save_params(params, path, mcfg) to embed the exact config."
        )
    if "dec_w0" in params:
        n = 0
        while f"dec_w{n}" in params:
            n += 1
        chans = [int(params[f"dec_w{i}"].shape[2]) for i in range(n)]
        chans.append(int(params["dec_out_w"].shape[2]))
        is_resize = all(
            int(params[f"dec_w{i}"].shape[3]) == chans[i + 1] for i in range(n)
        )
        kw["decoder"] = "conv" if is_resize else "conv_ps"
        kw["decoder_channels"] = tuple(chans)
        gh, gw = base.decoder_grid
        ml = kw["max_length"]
        if gh * gw != ml:
            target = base.sheet_height / base.sheet_width
            pairs = [(d, ml // d) for d in range(1, ml + 1) if ml % d == 0]
            gh, gw = min(pairs, key=lambda p: abs(p[0] / p[1] - target))
            kw["decoder_grid"] = (gh, gw)
    else:
        kw["decoder"] = "linear"
    return dataclasses.replace(base, **kw)


def _dropout(x: torch.Tensor, rate: float, generator, train: bool, bits: bool = False) -> torch.Tensor:
    """Inverted dropout with keep probability 1 - rate, masks drawn from
    ``generator``. ``bits``: the mask is a uint8 draw kept where it is below
    int(keep * 256), so the keep probability is quantised to 1/256 (0.8 ->
    0.796875), as the JAX package's bits_dropout; otherwise a uniform f32
    draw kept where it is below keep (jax.random.bernoulli)."""
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    if bits:
        draw = torch.randint(0, 256, x.shape, generator=generator, device=x.device, dtype=torch.uint8)
        mask = draw < int(keep * 256)
    else:
        mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    # x / keep in x's dtype, as jnp rounds the Python scalar to it (0.8 is
    # 0.80078125 in bf16); a 0-dim CPU tensor enters a CUDA op as a scalar.
    scale = torch.tensor(keep, dtype=x.dtype)
    return torch.where(mask, x / scale, torch.zeros((), dtype=x.dtype, device=x.device))


def attention(
    params: Mapping[str, torch.Tensor],
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    train: bool = False,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Multi-head self-attention, x [B, S, E] -> [B, S, E], with dropout on
    the attention probabilities when training (as torch's MultiheadAttention
    applies it). Softmax statistics are f32 whatever x's dtype."""
    drop = None
    if train and cfg.dropout_rate > 0.0:
        def drop(probs):
            return _dropout(probs, cfg.dropout_rate, generator, True, cfg.bits_dropout)

    return fused_attention_reference(x, params, cfg.num_heads, dropout=drop)


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def features(
    params: Mapping[str, torch.Tensor],
    codes: torch.Tensor,
    cfg: ModelConfig = ModelConfig(),
    *,
    train: bool = False,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """codes [B, S] -> per-slot features [B, min(S, max_length), hidden].
    ``train=True`` draws its dropout masks from ``generator``: the
    embedding's, then (with a fused attention flag) the attention kernel's
    seed, or the plain attention's mask, then fc1's."""
    if train and generator is None:
        raise ValueError("train=True needs a torch.Generator for the dropout masks")
    S = min(codes.shape[1], cfg.max_length)
    codes = codes[:, :S].long()
    dt = torch.bfloat16 if cfg.bf16_frontend else torch.float32

    x = gather_rows(params["embedding"].to(dt), codes)  # [B, S, E]
    x = _dropout(x, cfg.dropout_rate, generator, train, cfg.bits_dropout)
    x = x + params["pos"].to(dt)[:S]

    if cfg.fused_attention_v2 or cfg.fused_attention:
        # The JAX package's seed = bits(k_attn) & 0x7FFFFFFF, drawn whether
        # or not the rate is above 0.
        rate, seed = 0.0, None
        if train:
            rate = cfg.dropout_rate
            seed = torch.randint(0, 2**31, (1,), generator=generator, device=x.device, dtype=torch.int32)
        entry = fused_attention2 if cfg.fused_attention_v2 else fused_attention
        attn = entry(x, {k: params[k] for k in ATTN_KEYS}, cfg.num_heads, rate, seed)
    else:
        attn = attention(params, x, cfg, train=train, generator=generator)
    # LayerNorm statistics in f32 even under a bf16 frontend.
    x = _layer_norm((x + attn).float(), params["ln_scale"], params["ln_bias"]).to(dt)

    # Extra blocks use the plain attention, as in the JAX package, whose
    # fused kernels cover block 0 only.
    for i in range(1, cfg.num_blocks):
        sub = {k: params[f"{k}_b{i}"] for k in ATTN_KEYS}
        a = attention(sub, x, cfg, train=train, generator=generator)
        x = _layer_norm(
            (x + a).float(), params[f"ln_scale_b{i}"], params[f"ln_bias_b{i}"]
        ).to(dt)

    x = torch.relu(x @ params["fc1_w"].to(dt) + params["fc1_b"].to(dt))
    return _dropout(x, cfg.fc_dropout_rate, generator, train, cfg.bits_dropout)


def frontend(
    params: Mapping[str, torch.Tensor],
    codes: torch.Tensor,
    cfg: ModelConfig = ModelConfig(),
    *,
    train: bool = False,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Everything before the output projection: codes -> flat [B, 6400] f32,
    short sequences zero-padded to max_length * hidden_dim."""
    B = codes.shape[0]
    flat = features(params, codes, cfg, train=train, generator=generator).float().reshape(B, -1)
    full = cfg.max_length * cfg.hidden_dim
    if flat.shape[1] < full:
        flat = F.pad(flat, (0, full - flat.shape[1]))
    return flat


class ProjBf16Grad(torch.autograd.Function):
    """flat @ w with bf16 operands AND a bf16-rounded cotangent, f32 sums
    (the JAX package's ``_proj_bf16grad`` custom VJP, ModelConfig.
    bf16_cotangent): all three projection products take bf16 operands."""

    @staticmethod
    def forward(ctx, flat, w):
        fb, wb = flat.to(torch.bfloat16), w.to(torch.bfloat16)
        ctx.save_for_backward(fb, wb)
        return fb.float() @ wb.float()

    @staticmethod
    def backward(ctx, g):
        fb, wb = ctx.saved_tensors
        gb = g.to(torch.bfloat16).float()
        dflat = gb @ wb.float().T if ctx.needs_input_grad[0] else None
        dw = fb.float().T @ gb if ctx.needs_input_grad[1] else None
        return dflat, dw


def _conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 "SAME" convolution of NHWC x with HWIO w -> NHWC.
    x's NCHW view is channels-last in memory, as cuDNN's NHWC kernels read
    it, and the result permutes back to NHWC without a copy."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1)


def _resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Nearest resize of NHWC x to [h, w] with half-pixel centres, as
    ``jax.image.resize(..., "nearest")``: torch's "nearest-exact" (its
    "nearest" picks other source columns at ratio 1.5)."""
    return F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="nearest-exact").permute(0, 2, 3, 1)


def _depth_to_space(x: torch.Tensor, fy: int, fx: int) -> torch.Tensor:
    """NHWC [B, h, w, fy*fx*c] -> [B, h*fy, w*fx, c], the channels split as
    (fy, fx, c) with c fastest, as the JAX package's reshape and transpose
    (F.pixel_shuffle orders them (c, fy, fx) and needs fy == fx)."""
    B, hh, ww, k = x.shape
    c = k // (fy * fx)
    x = x.reshape(B, hh, ww, fy, fx, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, hh * fy, ww * fx, c)


def conv_decode(params: Mapping[str, torch.Tensor], flat: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Position-equivariant sheet decoder: flat [B, S*h] -> [B, H, W]
    (before the clamp).

    The frontend's per-slot features are projected to decoder_channels[0]
    and laid out as a [grid_rows, grid_cols] latent image (slot i -> cell
    (i // cols, i % cols)). "conv" upsamples it by nearest resizes
    (:func:`_resize`), each followed by a 3x3 conv + ReLU; "conv_ps"
    convolves at low resolution and then moves channels to space
    (:func:`_depth_to_space`). A final 3x3 conv paints the ink.
    Activations are NHWC and weights HWIO, as in the JAX package. Under
    ``bf16_matmul`` the hidden stages take bf16 operands and give bf16
    outputs; the ink stage is f32.
    """
    B = flat.shape[0]
    dt = torch.bfloat16 if cfg.bf16_matmul else torch.float32
    gh, gw = cfg.decoder_grid
    x = flat.reshape(B, cfg.max_length, cfg.hidden_dim).to(dt)
    x = torch.relu(x @ params["dec_in_w"].to(dt) + params["dec_in_b"].to(dt))
    x = x.reshape(B, gh, gw, cfg.decoder_channels[0])
    if cfg.decoder == "conv":
        for i, (h, w, _, _) in enumerate(_decoder_plan(cfg)):
            x = _resize(x, h, w)
            x = torch.relu(_conv(x, params[f"dec_w{i}"].to(dt)) + params[f"dec_b{i}"].to(dt))
    else:
        for i, (fy, fx, _, _) in enumerate(_decoder_plan_ps(cfg)):
            x = torch.relu(_conv(x, params[f"dec_w{i}"].to(dt)) + params[f"dec_b{i}"].to(dt))
            if fy > 1 or fx > 1:
                x = _depth_to_space(x, fy, fx)
    out = _conv(x.float(), params["dec_out_w"]) + params["dec_out_b"]
    return out[..., 0]


def apply(
    params: Mapping[str, torch.Tensor],
    codes: torch.Tensor,
    cfg: ModelConfig = ModelConfig(),
    *,
    train: bool = False,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Forward pass: int codes [B, <=max_length] -> sheets [B, H, W] in [0, 1].
    ``train=True`` applies dropout (masks from ``generator``) and the leaky
    clamp; gradients flow to every parameter that requires one. A conv
    decoder takes its own path before the projection's options, so
    ``use_pallas_output`` and ``bf16_cotangent`` do not touch it."""
    B = codes.shape[0]
    flat = frontend(params, codes, cfg, train=train, generator=generator)
    if cfg.decoder != "linear":
        return _clamp(conv_decode(params, flat, cfg), cfg, train)
    if cfg.use_pallas_output:
        if cfg.leaky_clamp > 0.0 or cfg.bf16_cotangent:
            raise ValueError(
                "use_pallas_output hard-clamps inside the kernel and owns "
                "its own VJP; it cannot combine with leaky_clamp or "
                "bf16_cotangent"
            )
        sheet = fused_output(flat, params["out_w"], params["out_b"])
        return sheet.reshape(B, cfg.sheet_height, cfg.sheet_width)
    if cfg.bf16_cotangent:
        if not cfg.bf16_matmul:
            raise ValueError(
                "bf16_cotangent runs the forward projection in bf16 too; "
                "it cannot combine with bf16_matmul=False (strict-f32 "
                "parity mode)"
            )
        sheet = ProjBf16Grad.apply(flat, params["out_w"]) + params["out_b"]
    else:
        w = params["out_w"]
        if cfg.bf16_matmul:
            # bf16 operands, f32 sums: a bf16 x bf16 product is exact in f32.
            flat, w = flat.to(torch.bfloat16).float(), w.to(torch.bfloat16).float()
        sheet = flat @ w + params["out_b"]
    return _clamp(sheet.reshape(B, cfg.sheet_height, cfg.sheet_width), cfg, train)


def _clamp(x: torch.Tensor, cfg: ModelConfig, train: bool) -> torch.Tensor:
    """The [0, 1] output clamp; leaky while training when
    ``cfg.leaky_clamp`` > 0: y = clip(x) + s * (x - clip(x)), so a saturated
    pixel keeps a gradient of s. Eval and inference always hard-clamp."""
    y = x.clamp(0.0, 1.0)
    if train and cfg.leaky_clamp > 0.0:
        return y + cfg.leaky_clamp * (x - y)
    return y


class AttentionFontRenderer(nn.Module):
    """The model as an ``nn.Module``. Each parameter is registered under its
    JAX key name (``wq``, ``out_w``, ``wq_b1``, ...), so ``state_dict()`` is
    the flat dict of the JAX package."""

    def __init__(self, params: Mapping[str, torch.Tensor], cfg: ModelConfig = ModelConfig()):
        super().__init__()
        self.cfg = cfg
        for k, v in params.items():
            self.register_parameter(k, nn.Parameter(v.detach(), requires_grad=False))

    def params(self) -> dict[str, torch.Tensor]:
        return dict(self.named_parameters())

    def load_jax_params(self, flat: Mapping[str, np.ndarray]) -> None:
        """Copy a JAX parameter dict (same keys and shapes) into this module."""
        own = self.params()
        if set(flat) != set(own):
            raise KeyError(f"key mismatch: {sorted(set(flat) ^ set(own))}")
        dev = next(iter(own.values())).device
        with torch.no_grad():
            for k, v in params_from_jax(flat, dev).items():
                own[k].copy_(v)

    def forward(self, codes: torch.Tensor) -> torch.Tensor:
        return apply(self.params(), codes, self.cfg)
