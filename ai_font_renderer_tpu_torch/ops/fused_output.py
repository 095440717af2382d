"""Fused output projection clamp(x @ W + b, 0, 1): the CUDA kernels of its
forward and backward, their plain versions, and the autograd function that
joins them.

Each wrapper launches its kernel of csrc/fused_output.cu on CUDA tensors, for
every shape, or raises; it takes its plain version only for tensors on the
CPU. The kernels replace the TPU kernels of ai_font_renderer_tpu/ops/
fused_output.py:

* ``fused_output_fwd`` -- K1, ``_fwd_kernel``: clamp(bf16(x) @ bf16(w) + b),
  in two kernels: ``round_bf16`` for x, then ``gemm_bf16_bias_clamp``, the
  TMA + wgmma product of csrc/sm90_gemm.cuh with bias and clamp in its
  epilogue, on w's bf16 shadow;
* ``fused_output_dx`` -- K2, ``_dx_kernel``: bf16(g * mask) @ bf16(w)^T, in
  two kernels: ``round_bf16``, the operand pass that masks and rounds g to
  bf16 rows padded to a multiple of 8, then ``gemm_bf16_tn``, the TMA +
  wgmma product of csrc/sm90_gemm.cuh, on w's bf16 shadow;
* ``fused_output_dw`` -- K3, ``_dw_kernel``: bf16(x)^T @ bf16(g * mask), in
  two kernels: ``round_bf16`` for x and for the masked g, then
  ``gemm_bf16_mn``, the TMA + wgmma product on MN-major operands;

with mask = 0 < out < 1: the clamp passes a gradient only strictly inside
its bounds (torch.clamp's own backward also passes it at the bounds).
``fused_output`` is the entry point, :class:`FusedOutputFunction`: K1
forward, K2 and K3 backward, db = sum(g * mask) in PyTorch. Its forward
keeps x16 and w16 for the backward, which forms the masked cotangent gm16
once and hands it to both GEMMs. Unlike the TPU path, which runs its
kernels only when M, K and N are multiples of 128 and otherwise falls back
to plain ops, the CUDA kernels mask the ragged edge.

W's bf16 shadow (``bf16_shadow``): K1 and K2 read W as bf16 rows padded to
a multiple of 8, the operand pass's output. The pass runs again only when W
has changed since the last call (its autograd version counter moved, or it
is another tensor): once a training step where AdamW updates W, once in all
for render and serve. K4 (ops/fused_dw_adamw.py), which updates W itself,
also writes W's new shadow when W has a current one (``_write_shadow``), so
a training run with K4 builds the shadow once.

Launch counts: K1's on ``fused_output.launches``, K2's and K3's on
``fused_output_dx.launches`` and ``fused_output_dw.launches`` (one a call
on CUDA tensors, the autograd function's included); the operand pass on
``round_bf16.launches`` (x16 and, when W has changed, the shadow in a K1
call; gm16 in K2, x16 and gm16 in K3; three in a forward and backward with a
new W) and the GEMMs on ``gemm_bf16_bias_clamp.launches``,
``gemm_bf16_tn.launches`` and ``gemm_bf16_mn.launches``. The shadow counts
its rebuilds on ``bf16_shadow.builds``.

K1's forward is also the ``torch.library`` operator ``afr::fused_output_fwd``
(x, W's shadow, b), with a fake implementation that gives its outputs'
shapes: ``_k1`` calls it, and so does a graph that ``torch.export`` traced
(utils/export.py), which holds W's shadow as a buffer. The operator picks
kernel or plain version by its tensors' device when it runs, so its launches
count inside an exported program too.
"""

from __future__ import annotations

import ctypes

import torch
from torch.utils.weak import WeakIdKeyDictionary

from . import _build

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "afr_round_bf16": ([_PTR] * 3 + [_INT] * 3 + [_PTR], ctypes.c_int),
    "afr_gemm_bf16_tn": ([_PTR] * 3 + [_INT] * 4 + [_PTR], ctypes.c_int),
    "afr_gemm_bf16_mn": ([_PTR] * 3 + [_INT] * 6 + [_PTR], ctypes.c_int),
    "afr_gemm_bf16_bias_clamp": ([_PTR] * 4 + [_INT] * 6 + [_PTR], ctypes.c_int),
    "afr_gemm_bf16_tn_attrs": ([_PTR], ctypes.c_int),
    "afr_gemm_bf16_mn_attrs": ([_PTR], ctypes.c_int),
    "afr_gemm_bf16_bias_clamp_attrs": ([_PTR], ctypes.c_int),
}
# W's bf16 shadows, keyed on W itself (by identity, so an entry dies with its
# tensor): (W's version when the shadow was built, the shadow).
_SHADOWS = WeakIdKeyDictionary()


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 (nearest even) and back to f32: a product of two such
    values is exact in f32."""
    return t.to(torch.bfloat16).float()


def clamp_mask(out: torch.Tensor) -> torch.Tensor:
    """Where the clamp passes a gradient: strictly inside (0, 1)."""
    return (out > 0.0) & (out < 1.0)


def fused_output_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K1's plain version: bf16-rounded operands, an f32 product (TF32 off),
    bias, clamp. It differs from the kernel only in the order of the f32
    sums."""
    return (_bf16(x) @ _bf16(w) + b).clamp(0.0, 1.0)


def fused_output_dx_reference(g: torch.Tensor, out: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K2's plain version: bf16(g * mask) @ bf16(w)^T in f32."""
    return _bf16(torch.where(clamp_mask(out), g, 0.0)) @ _bf16(w).T


def padded_width(n: int) -> int:
    """n rounded up to a multiple of 8: TMA takes rows whose stride is a
    multiple of 16 bytes."""
    return -(-n // 8) * 8


def round_bf16_reference(src: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """The operand pass's plain version: bf16 (nearest even) of src where
    0 < out < 1 and 0 elsewhere (no mask when out is None), zero-padded to
    padded_width(cols) columns."""
    v = src if out is None else torch.where(clamp_mask(out), src, 0.0)
    rows, cols = v.shape
    dst = torch.zeros((rows, padded_width(cols)), dtype=torch.bfloat16, device=v.device)
    dst[:, :cols] = v.to(torch.bfloat16)
    return dst


def dx_operands_reference(g: torch.Tensor, out: torch.Tensor, w: torch.Tensor) -> tuple:
    """K2's two bf16 operands as its operand pass makes them: gm16 [M, Np]
    and w16 [K, Np]."""
    return round_bf16_reference(g, out), round_bf16_reference(w)


def gemm_bf16_tn_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The GEMM's plain version: a [M, L] @ b [K, L]^T of bf16 values, in
    f32 (each product is exact in f32)."""
    return a.float() @ b.float().T


def gemm_bf16_mn_reference(a: torch.Tensor, b: torch.Tensor, k: int | None = None,
                           n: int | None = None) -> torch.Tensor:
    """K3's GEMM's plain version: a[:, :k]^T @ b[:, :n] of bf16 values, in
    f32 (each product is exact in f32); k and n default to the widths."""
    return a[:, :k].float().T @ b[:, :n].float()


def gemm_bf16_bias_clamp_reference(a: torch.Tensor, w16: torch.Tensor, bias: torch.Tensor,
                                   n: int | None = None) -> torch.Tensor:
    """K1's GEMM's plain version: clamp(a[:, :K] @ w16[:, :n] + bias, 0, 1)
    of bf16 values in f32 (each product is exact in f32), K = w16's rows;
    n defaults to w16's width."""
    return (a[:, : w16.shape[0]].float() @ w16[:, :n].float() + bias).clamp(0.0, 1.0)


def fused_output_dw_reference(x: torch.Tensor, g: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """K3's plain version: bf16(x)^T @ bf16(g * mask) in f32."""
    return _bf16(x).T @ _bf16(torch.where(clamp_mask(out), g, 0.0))


def _check(name: str, tensors: dict, shapes: dict) -> torch.device:
    """Device, dtype, contiguity and shape checks shared by the wrappers."""
    dev = next(iter(tensors.values())).device
    for key, t in tensors.items():
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name}: {key} must be a contiguous float32 tensor on {dev}")
        if tuple(t.shape) != shapes[key]:
            raise ValueError(
                f"{name}: shape mismatch, {key} is {tuple(t.shape)}, expected {shapes[key]} "
                f"from " + ", ".join(f"{k} {tuple(v.shape)}" for k, v in tensors.items())
            )
    return dev


def _launch(entry, fn_name: str, args: tuple, dims: tuple, dev: torch.device) -> None:
    """Launch ``fn_name`` on the tensors ``args`` (None passes a null
    pointer) and count it on ``entry``; raise on a non-zero return."""
    with torch.cuda.device(dev):
        lib = _build.load("fused_output", _SIGNATURES)
        ptrs = (None if t is None else t.data_ptr() for t in args)
        rc = getattr(lib, fn_name)(*ptrs, *dims, _build.stream_handle(dev))
    if rc != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: CUDA error {rc}")
    entry.launches += 1


def _require_cuda(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {t.device}")


def fused_output_fwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K1: clamp(bf16(x) @ bf16(w) + b, 0, 1) in f32, no autograd. x [M, K],
    w [K, N], b [N], all float32. On the card: the operand pass for x, w's
    bf16 shadow and the GEMM with bias and clamp. Counts on
    ``fused_output.launches``."""
    return _k1(x, w, b)[0]


def _k1(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> tuple:
    """K1 and its operands: (out, x16, w16), through the operator
    ``afr::fused_output_fwd`` on W's shadow."""
    if x.dim() != 2 or w.dim() != 2 or b.dim() != 1:
        raise ValueError(f"expected x [M,K], w [K,N], b [N]; got {x.shape}, {w.shape}, {b.shape}")
    m, k = x.shape
    n = w.shape[1]
    shapes = {"x": (m, k), "w": (k, n), "b": (n,)}
    if x.device.type != "cpu":
        _require_cuda("fused_output", x)
        _check("fused_output", {"x": x, "w": w, "b": b}, shapes)
    elif (tuple(w.shape), tuple(b.shape)) != (shapes["w"], shapes["b"]):
        raise ValueError(f"fused_output: shape mismatch, x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"b {tuple(b.shape)}")
    w16 = bf16_shadow(w)
    out, x16 = torch.ops.afr.fused_output_fwd(x, w16, b)
    return out, x16, w16


@torch.library.custom_op("afr::fused_output_fwd", mutates_args=())
def _fused_output_fwd_op(x: torch.Tensor, w16: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 as an operator, as an exported graph calls it: x [M, K] float32,
    w16 W's bf16 shadow [K, padded_width(N)], b [N] float32 -> (out [M, N]
    float32, x16 [M, padded_width(K)] bfloat16, x's operand, which the
    autograd backward's K3 reads). On the card the operand pass for x and
    the GEMM with bias and clamp, counted on ``fused_output.launches``; on
    CPU tensors their plain versions. It takes the shadow, not W: the
    shadow's table keys on a tensor's identity and version, which mean
    nothing to a tracer's fake tensors."""
    m, k = x.shape
    n = b.shape[0]
    if tuple(w16.shape) != (k, padded_width(n)) or w16.dtype != torch.bfloat16:
        raise ValueError(f"fused_output: w16 must be W's bf16 shadow [{k}, {padded_width(n)}] for x "
                         f"{tuple(x.shape)} and b {tuple(b.shape)}, got {w16.dtype} {tuple(w16.shape)}")
    x16 = round_bf16(x)
    # Contiguous also where N is not a multiple of 4: K2 reads out.
    out = gemm_bf16_bias_clamp(x16, w16, b, n).contiguous()
    if x.device.type == "cuda" and m:
        fused_output.launches += 1
    return out, x16


@_fused_output_fwd_op.register_fake
def _(x, w16, b):
    m, k = x.shape
    return x.new_empty((m, b.shape[0])), x.new_empty((m, padded_width(k)), dtype=torch.bfloat16)


def bf16_shadow(w: torch.Tensor) -> torch.Tensor:
    """W's bf16 operand, ``round_bf16(w)``: [K, padded_width(N)] bfloat16,
    pad columns zero, rebuilt only when w has changed since the last call
    and kept for as long as w lives. Counts rebuilds on
    ``bf16_shadow.builds``.

    The shadow is keyed on w itself, by identity (never on its address: a
    freed W and the next one may share it), and holds w's autograd version
    counter, which every in-place PyTorch op bumps, views' included; the
    CUDA kernels that write w in place (fused_dw_adamw) bump it themselves,
    and write w's new shadow with it when the old one was current.
    It is no attribute of w, so ``torch.save`` never writes it. It is built
    outside inference mode, so a shadow made while rendering may be saved
    for a later training step's backward; an inference tensor has no version
    counter and gets a fresh shadow on every call."""
    version = None if w.is_inference() else w._version
    entry = _SHADOWS.get(w)
    if entry is not None and version is not None and entry[0] == version:
        return entry[1]
    if entry is not None:
        del _SHADOWS[w], entry  # free the stale shadow before the new one is made
    with torch.inference_mode(False), torch.no_grad():
        w16 = round_bf16(w)
    if version is not None:
        _SHADOWS[w] = (version, w16)
    bf16_shadow.builds += 1
    return w16


def _write_shadow(w: torch.Tensor, update) -> None:
    """Run ``update(w16)``, an in-place update of w that bumps w's version
    and writes the updated w's bf16, ``round_bf16(w)``, into w16: a new
    [K, padded_width(N)] bf16 buffer when w has a current shadow, and None
    (no shadow to write) otherwise. Then w16 is w's shadow at its new
    version. The old shadow is dropped first, so that the allocator can
    hand its block to w16, but never written: a caller may hold it (a
    forward saved for a later backward)."""
    entry = _SHADOWS.get(w)
    w16 = None
    if entry is not None and not w.is_inference() and entry[0] == w._version:
        shape = entry[1].shape
        del _SHADOWS[w], entry
        with torch.inference_mode(False):
            w16 = torch.empty(shape, dtype=torch.bfloat16, device=w.device)
    update(w16)
    if w16 is not None:
        _SHADOWS[w] = (w._version, w16)


def round_bf16(src: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """The operand pass of K2 and K3: bf16 (nearest even) of src where
    0 < out < 1 and 0 elsewhere (no mask when out is None), src and out
    [rows, cols] float32 -> [rows, padded_width(cols)] bfloat16, pad columns
    zero. Counts on ``round_bf16.launches``."""
    if src.device.type == "cpu":
        return round_bf16_reference(src, out)
    _require_cuda("round_bf16", src)
    if src.dim() != 2:
        raise ValueError(f"round_bf16: expected src [rows, cols], got {tuple(src.shape)}")
    rows, cols = src.shape
    tensors = {"src": src} if out is None else {"src": src, "out": out}
    dev = _check("round_bf16", tensors, {"src": (rows, cols), "out": (rows, cols)})
    dst = torch.empty((rows, padded_width(cols)), dtype=torch.bfloat16, device=dev)
    if rows and cols:
        _launch(round_bf16, "afr_round_bf16", (src, out, dst), (rows, cols, dst.shape[1]), dev)
    return dst


def gemm_bf16_tn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K2's product: a [M, L] @ b [K, L]^T in f32, a and b contiguous
    bfloat16 with L a multiple of 8 (as ``round_bf16`` pads them), in tiles
    of 128 rows by 200 columns. Counts on ``gemm_bf16_tn.launches``."""
    if a.device.type == "cpu":
        return gemm_bf16_tn_reference(a, b)
    _require_cuda("gemm_bf16_tn", a)
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.bfloat16 or t.dim() != 2 or not t.is_contiguous() or t.device != a.device:
            raise ValueError(f"gemm_bf16_tn: {name} must be a contiguous 2-D bfloat16 tensor on {a.device}")
    (m, width), k = a.shape, b.shape[0]
    if b.shape[1] != width or width % 8:
        raise ValueError(f"gemm_bf16_tn: a [M, L] and b [K, L] need one width L, a multiple of 8; "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    if not width:
        return torch.zeros((m, k), dtype=torch.float32, device=a.device)
    c = torch.empty((m, k), dtype=torch.float32, device=a.device)
    if m and k:
        _launch(gemm_bf16_tn, "afr_gemm_bf16_tn", (a, b, c), (m, k, width, width), a.device)
    return c


def gemm_bf16_mn(a: torch.Tensor, b: torch.Tensor, k: int | None = None,
                 n: int | None = None) -> torch.Tensor:
    """K3's product: a[:, :k]^T @ b[:, :n] in f32 -> [k, n], a [L, Ka] and
    b [L, Nb] contiguous bfloat16 with Ka and Nb multiples of 8 (as
    ``round_bf16`` pads them), k <= Ka and n <= Nb (default: the widths).
    Tiles of 128 x 256 on a persistent grid. The TMA stores of the result
    need rows of a multiple of 16 bytes: for n not a multiple of 4 the
    result is the [k, n] view of a [k, n rounded up to 4] tensor. Counts on
    ``gemm_bf16_mn.launches``."""
    if a.device.type == "cpu":
        return gemm_bf16_mn_reference(a, b, k, n)
    _require_cuda("gemm_bf16_mn", a)
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.bfloat16 or t.dim() != 2 or not t.is_contiguous() or t.device != a.device:
            raise ValueError(f"gemm_bf16_mn: {name} must be a contiguous 2-D bfloat16 tensor on {a.device}")
    (depth, ka), (depth_b, nb) = a.shape, b.shape
    k, n = ka if k is None else k, nb if n is None else n
    if depth_b != depth or ka % 8 or nb % 8 or not (0 <= k <= ka and 0 <= n <= nb):
        raise ValueError(f"gemm_bf16_mn: a [L, Ka] and b [L, Nb] need one depth L, widths that are "
                         f"multiples of 8 and k <= Ka, n <= Nb; got {tuple(a.shape)}, {tuple(b.shape)}, "
                         f"k={k}, n={n}")
    if not depth:
        return torch.zeros((k, n), dtype=torch.float32, device=a.device)
    ldc = -(-n // 4) * 4
    c = torch.empty((k, ldc), dtype=torch.float32, device=a.device)
    if k and n:
        _launch(gemm_bf16_mn, "afr_gemm_bf16_mn", (a, b, c), (depth, k, n, ka, nb, ldc), a.device)
    return c if ldc == n else c[:, :n]


def gemm_bf16_bias_clamp(a: torch.Tensor, w16: torch.Tensor, bias: torch.Tensor,
                         n: int | None = None) -> torch.Tensor:
    """K1's product: clamp(a[:, :K] @ w16[:, :n] + bias, 0, 1) in f32 ->
    [M, n]; a [M, Ka] and w16 [K, Nb] contiguous bfloat16 with Ka and Nb
    multiples of 8 (as ``round_bf16`` pads them), K <= Ka, n <= Nb (default
    Nb), bias [n] contiguous float32. Tiles of 128 x 256 on a persistent
    grid. The TMA stores need rows of a multiple of 16 bytes: for n not a
    multiple of 4 the result is the [M, n] view of a [M, n rounded up to 4]
    tensor. Counts on ``gemm_bf16_bias_clamp.launches``."""
    if a.device.type == "cpu":
        return gemm_bf16_bias_clamp_reference(a, w16, bias, n)
    _require_cuda("gemm_bf16_bias_clamp", a)
    for name, t in (("a", a), ("w16", w16)):
        if t.dtype != torch.bfloat16 or t.dim() != 2 or not t.is_contiguous() or t.device != a.device:
            raise ValueError(f"gemm_bf16_bias_clamp: {name} must be a contiguous 2-D bfloat16 tensor "
                             f"on {a.device}")
    (m, ka), (k, nb) = a.shape, w16.shape
    n = nb if n is None else n
    if ka % 8 or nb % 8 or not 0 < k <= ka or not 0 <= n <= nb:
        raise ValueError(f"gemm_bf16_bias_clamp: a [M, Ka] and w16 [K, Nb] need widths that are "
                         f"multiples of 8 and 0 < K <= Ka, n <= Nb; got {tuple(a.shape)}, "
                         f"{tuple(w16.shape)}, n={n}")
    if bias.dtype != torch.float32 or tuple(bias.shape) != (n,) or not bias.is_contiguous() \
            or bias.device != a.device:
        raise ValueError(f"gemm_bf16_bias_clamp: bias must be a contiguous float32 [{n}] tensor on "
                         f"{a.device}, got {bias.dtype} {tuple(bias.shape)}")
    ldc = -(-n // 4) * 4
    c = torch.empty((m, ldc), dtype=torch.float32, device=a.device)
    if m and n:
        _launch(gemm_bf16_bias_clamp, "afr_gemm_bf16_bias_clamp", (a, w16, bias, c),
                (m, k, n, ka, nb, ldc), a.device)
    return c if ldc == n else c[:, :n]


def gemm_attributes(kind: str, device="cuda") -> dict:
    """A GEMM kernel as built for the card (``kind`` "tn", K2's, "mn", K3's,
    or "k1", K1's): registers a thread, static and dynamic shared memory a
    block (bytes), threads a block, ring stages, and the tile (bm x bn)."""
    fn_name = {"tn": "afr_gemm_bf16_tn_attrs", "mn": "afr_gemm_bf16_mn_attrs",
               "k1": "afr_gemm_bf16_bias_clamp_attrs"}[kind]
    attrs = (ctypes.c_int * 7)()
    with torch.cuda.device(device):
        rc = getattr(_build.load("fused_output", _SIGNATURES), fn_name)(attrs)
    if rc != 0:
        raise RuntimeError(f"{fn_name} failed: CUDA error {rc}")
    keys = ("registers", "static_smem", "dynamic_smem", "threads", "stages", "bm", "bn")
    return dict(zip(keys, attrs))


def fused_output_dx(g: torch.Tensor, out: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K2: dX = bf16(g * mask(out)) @ bf16(w)^T in f32. g, out [M, N],
    w [K, N] -> [M, K]. On the card: the operand pass for gm16 [M, Np], w's
    bf16 shadow [K, Np] and the GEMM. ``fused_output_dx.launches`` counts K2
    calls."""
    if g.device.type == "cpu":
        return fused_output_dx_reference(g, out, w)
    return _k2(g, out, w)[0]


def _k2(g: torch.Tensor, out: torch.Tensor, w: torch.Tensor) -> tuple:
    """K2 on CUDA tensors and its masked operand: (dx, gm16), gm16 =
    round_bf16(g, out) [M, padded_width(N)] bf16; on CPU tensors the plain
    versions of both."""
    if g.device.type == "cpu":
        return fused_output_dx_reference(g, out, w), round_bf16_reference(g, out)
    _require_cuda("fused_output_dx", g)
    if g.dim() != 2 or w.dim() != 2:
        raise ValueError(f"expected g [M,N], out [M,N], w [K,N]; got {g.shape}, {out.shape}, {w.shape}")
    m, n = g.shape
    k = w.shape[0]
    dev = _check("fused_output_dx", {"g": g, "out": out, "w": w}, {"g": (m, n), "out": (m, n), "w": (k, n)})
    gm16 = round_bf16(g, out)
    if not m:
        return torch.empty((0, k), dtype=torch.float32, device=dev), gm16
    return _dx(gm16, bf16_shadow(w)), gm16


def _dx(gm16: torch.Tensor, w16: torch.Tensor) -> torch.Tensor:
    """K2 on its bf16 operands gm16 [M, Np] and w16 [K, Np]: gm16 @ w16^T;
    counts one K2 call."""
    dx = gemm_bf16_tn(gm16, w16)
    fused_output_dx.launches += 1
    return dx


def fused_output_dw(x: torch.Tensor, g: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """K3: dW = bf16(x)^T @ bf16(g * mask(out)) in f32. x [M, K], g and
    out [M, N] -> [K, N]. On the card: the operand pass twice (x16 [M, Kp],
    gm16 [M, Np]) and the MN-major GEMM once. ``fused_output_dw.launches``
    counts K3 calls."""
    if x.device.type == "cpu":
        return fused_output_dw_reference(x, g, out)
    _require_cuda("fused_output_dw", x)
    if x.dim() != 2 or g.dim() != 2:
        raise ValueError(f"expected x [M,K], g [M,N], out [M,N]; got {x.shape}, {g.shape}, {out.shape}")
    m, k = x.shape
    n = g.shape[1]
    dev = _check("fused_output_dw", {"x": x, "g": g, "out": out}, {"x": (m, k), "g": (m, n), "out": (m, n)})
    if not m:
        return torch.zeros((k, n), dtype=torch.float32, device=dev)
    return _dw(round_bf16(x), round_bf16(g, out), k, n)


def _dw(x16: torch.Tensor, gm16: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """K3 on its bf16 operands x16 [M, Kp] and gm16 [M, Np]:
    x16[:, :k]^T @ gm16[:, :n]; counts one K3 call."""
    dw = gemm_bf16_mn(x16, gm16, k, n)
    fused_output_dw.launches += 1
    return dw


class FusedOutputFunction(torch.autograd.Function):
    """clamp(bf16(x) @ bf16(w) + b, 0, 1) with the projection's own
    gradient: K1 forward; K2 for dx, K3 for dw and db = sum(g * mask) in
    PyTorch, all with the strict mask 0 < out < 1 (the JAX package's
    custom VJP, ops/fused_output.py:_bwd_rule). On the card the backward
    reads the forward's bf16 operands, x16 and w's shadow w16, and forms the
    masked cotangent gm16 once, for both K2 and K3."""

    @staticmethod
    def forward(ctx, x, w, b):
        out, x16, w16 = _k1(x, w, b)
        ctx.save_for_backward(x, w, x16, w16, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, x16, w16, out = ctx.saved_tensors
        g = g.contiguous()
        need_dx, need_dw, need_db = ctx.needs_input_grad
        dx = dw = None
        if g.device.type == "cpu" or not g.shape[0]:
            dx = fused_output_dx(g, out, w) if need_dx else None
            dw = fused_output_dw(x, g, out) if need_dw else None
        elif need_dx or need_dw:
            gm16 = round_bf16(g, out)
            dx = _dx(gm16, w16) if need_dx else None
            dw = _dw(x16, gm16, x.shape[1], g.shape[1]) if need_dw else None
        db = torch.where(clamp_mask(out), g, 0.0).sum(0) if need_db else None
        return dx, dw, db


def fused_output(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """clamp(bf16(x) @ bf16(w) + b, 0, 1) in f32, differentiable in x, w
    and b. x [M, K], w [K, N], b [N], all float32. ``fused_output.launches``
    counts K1's launches."""
    return FusedOutputFunction.apply(x, w, b)


fused_output.launches = 0
bf16_shadow.builds = 0
gemm_bf16_bias_clamp.launches = 0
fused_output_dx.launches = 0
round_bf16.launches = 0
gemm_bf16_tn.launches = 0
fused_output_dw.launches = 0
gemm_bf16_mn.launches = 0
