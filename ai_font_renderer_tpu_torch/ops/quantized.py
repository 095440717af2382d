"""Int8 weights for serving: the linear decoder's projection in int8.

The port of ai_font_renderer_tpu/ops/quantized.py. The output projection
holds 99.99% of the model's weights; for serving it runs with per-output-
channel symmetric int8 weights,

    W_q[k, n] = round(W[k, n] / s[n]),  s[n] = max_k |W[k, n]| / 127,

either against bf16 activations (``apply_quantized``) or, the serving path
(``apply_quantized_int8``, which ``render`` dispatches to), against int8
activations quantized per row with an int32 accumulator, the outer product
of the two scales folded into the epilogue. Rounding is half to even and
the operations run in the JAX package's order, so equal inputs give equal
int8 operands, equal accumulators and equal f32 sheets.

The int8 x int8 -> int32 product (``int8_product``) is ``torch._int_mm``
on the card (cuBLASLt's int8 tensor-core GEMM): it needs more than 16 rows,
so fewer are padded with zero rows, whose accumulators are zero and are
sliced off, and it reads W_q column-major, so a row-major W_q gets a
column-major copy once, kept while W_q lives. On a CPU tensor the product
is its plain version: the int8 operands multiplied in f64, exact for every
accumulator (|acc| <= 127 * 127 * K, about 1.03e8 at K = 6400, far below
2^53), and cast to int32. ``int8_product.launches`` counts the card's
products.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

# The card's int8 product needs more than 16 rows.
_MIN_ROWS = 17
# Column-major copies of row-major W_q, keyed on W_q itself (by identity,
# so an entry dies with its tensor): (W_q's version when copied, the copy).
_COL_MAJOR = WeakIdKeyDictionary()


def quantize_weights(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 quantization: (w_q int8, scales)."""
    s = torch.clamp(w.abs().amax(dim=0) / 127.0, min=1e-12)
    w_q = torch.round(w / s).clamp(-127, 127).to(torch.int8)
    return w_q, s.float()


def quantized_output(flat: torch.Tensor, w_q: torch.Tensor, scales: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """clamp(bf16(flat) @ W_q + b, 0, 1) with the scale in the epilogue:
    bf16 operands (int8 values are exact in bf16), f32 sums."""
    z = flat.to(torch.bfloat16).float() @ w_q.float()
    return torch.clamp(z * scales + b, 0.0, 1.0)


def quantize_params(params: dict) -> dict:
    """Serving bundle: out_w replaced by (int8 weights, scales)."""
    if "out_w" not in params:
        raise ValueError(
            "int8 serving quantizes the linear decoder's out_w; this "
            "checkpoint has none (conv-decoder model?)"
        )
    w_q, s = quantize_weights(params["out_w"])
    served = {k: v for k, v in params.items() if k != "out_w"}
    served["out_w_q"] = w_q
    served["out_w_scale"] = s
    return served


def apply_quantized(params_q: dict, codes: torch.Tensor, cfg) -> torch.Tensor:
    """Inference forward with the int8-quantized projection."""
    from ..models import font_renderer

    B = codes.shape[0]
    flat = font_renderer.frontend(params_q, codes, cfg, train=False)
    sheet = quantized_output(flat, params_q["out_w_q"], params_q["out_w_scale"], params_q["out_b"])
    return sheet.reshape(B, cfg.sheet_height, cfg.sheet_width)


def quantize_activations(flat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row symmetric int8: (a_q int8, row scales f32)."""
    s = torch.clamp(flat.abs().amax(dim=1) / 127.0, min=1e-12)
    a_q = torch.round(flat / s[:, None]).clamp(-127, 127).to(torch.int8)
    return a_q, s.float()


def int8_product_reference(a_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """a_q [M, K] int8 @ w_q [K, N] int8 -> int32 [M, N], exactly: the
    products summed in f64, where every partial sum is an integer below
    2^53."""
    return (a_q.double() @ w_q.double()).to(torch.int32)


def _col_major(w_q: torch.Tensor) -> torch.Tensor:
    """w_q itself when it is column-major, else its column-major copy,
    made once for each version of w_q (as W's bf16 shadow: an inference
    tensor has no version counter and gets a copy on every call)."""
    if w_q.stride(0) == 1 and w_q.stride(1) == w_q.shape[0]:
        return w_q
    version = None if w_q.is_inference() else w_q._version
    entry = _COL_MAJOR.get(w_q)
    if entry is not None and version is not None and entry[0] == version:
        return entry[1]
    if entry is not None:
        del _COL_MAJOR[w_q], entry
    with torch.inference_mode(False):
        copy = w_q.t().contiguous().t()
    if version is not None:
        _COL_MAJOR[w_q] = (version, copy)
    return copy


def int8_product(a_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """a_q [M, K] int8 @ w_q [K, N] int8 -> int32 [M, N]: ``torch._int_mm``
    on the card (K and N multiples of 8; fewer than 17 rows padded with
    zero rows), the plain version on CPU tensors. Through the operator
    ``afr::int8_product``, which picks one or the other when it runs, so a
    graph traced by ``torch.export`` holds no row count's branch."""
    return torch.ops.afr.int8_product(a_q, w_q)


@torch.library.custom_op("afr::int8_product", mutates_args=())
def _int8_product_op(a_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    if a_q.device.type == "cpu":
        return int8_product_reference(a_q, w_q)
    m, k = a_q.shape
    n = w_q.shape[1]
    if a_q.dtype != torch.int8 or w_q.dtype != torch.int8 or w_q.shape[0] != k or k % 8 or n % 8:
        raise ValueError(
            f"int8_product takes int8 [M, K] @ [K, N] with K and N multiples of 8, got "
            f"{a_q.dtype} {tuple(a_q.shape)} @ {w_q.dtype} {tuple(w_q.shape)}"
        )
    a = a_q.contiguous() if m >= _MIN_ROWS else F.pad(a_q, (0, 0, 0, _MIN_ROWS - m))
    acc = torch._int_mm(a, _col_major(w_q))
    int8_product.launches += 1
    return acc[:m]


@_int8_product_op.register_fake
def _(a_q, w_q):
    return a_q.new_empty((a_q.shape[0], w_q.shape[1]), dtype=torch.int32)


int8_product.launches = 0


def quantized_output_int8(flat: torch.Tensor, w_q: torch.Tensor, scales: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 x int8 product with an int32 accumulator: the activations
    quantized per row, the (row x column) scale outer product folded into
    the epilogue, then the clamp."""
    a_q, a_s = quantize_activations(flat)
    acc = int8_product(a_q, w_q)
    z = acc.float() * (a_s[:, None] * scales[None, :]) + b
    return torch.clamp(z, 0.0, 1.0)


def int8_error_bound(flat: torch.Tensor, w: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """[M, N]: the most ``quantized_output_int8(flat, W_q, scales, b)`` can
    differ from clamp(flat @ w + b, 0, 1) in exact arithmetic. With
    x = a_q a_s + e_x and w = w_q s + e_w, round to nearest gives
    |e_x| <= a_s / 2 and |e_w| <= s / 2 (a row's or column's largest |value|
    maps to 127 exactly, so nothing clips); each product then moves by at
    most |x| s / 2 + a_s |w| / 2 + a_s s / 4, summed over K. The clamp only
    shrinks a difference."""
    a_s = quantize_activations(flat)[1][:, None]
    k = flat.shape[1]
    return (flat.abs().sum(1, keepdim=True) * scales / 2 + a_s * w.abs().sum(0) / 2
            + k * a_s * scales / 4)


def apply_quantized_int8(params_q: dict, codes: torch.Tensor, cfg) -> torch.Tensor:
    """Inference forward with int8 weights AND int8 activations."""
    from ..models import font_renderer

    B = codes.shape[0]
    flat = font_renderer.frontend(params_q, codes, cfg, train=False)
    sheet = quantized_output_int8(flat, params_q["out_w_q"], params_q["out_w_scale"], params_q["out_b"])
    return sheet.reshape(B, cfg.sheet_height, cfg.sheet_width)
