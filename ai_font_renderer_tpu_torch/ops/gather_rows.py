"""The backward of the embedding gathers (models/gather.py:gather_rows):
d(table)[v, :] = the sum of cot[n, :] over the tokens n whose code is v.

``gather_rows_backward`` launches the kernels of csrc/gather_rows.cu on CUDA
tensors and takes its plain version, ``gather_rows_backward_reference``,
only for CPU tensors. Both sum in one order that depends on the shapes
alone, so the card's gradient is the same bits in every run and equal to
the plain version's:

* f32 tables: f32 sums of fixed ranges of tokens, then of fixed chunks
  (``gather_rows_plan``), two kernels;
* bf16 tables: the order of the index form's backward (``index_put_``
  with accumulation on the bf16 table, which the benchmark's reference for
  a bf16 frontend computes too): each row's tokens in token order added in
  f32, the running sum rounded back to bf16 after every add where the row
  is wider than 32, once at the end where it is not; one kernel. That is
  ``index_put_``'s bits at the widths the card tests check against it,
  32 (PyTorch's small-stride kernel) and 64 (its general kernel); at width
  1 PyTorch takes a kernel that sums in another order.

The kernels replace no Pallas kernel: the JAX package leaves its gather's
VJP to XLA's scatter-add.

``gather_rows_backward.launches`` counts the calls on CUDA f32 tensors,
``gather_rows_backward.ordered_launches`` those on bf16 ones
(``utils/profiling.py``: ``gather_rows_bwd``, two kernels a call, and
``gather_rows_bwd_ordered``, one).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "afr_gather_rows_bwd": ([_PTR] * 4 + [_LL, _INT, _INT, _PTR], ctypes.c_int),
    "afr_gather_rows_bwd_ordered": ([_PTR] * 3 + [_LL, _INT, _INT, _PTR], ctypes.c_int),
    "afr_gather_rows_plan": ([_LL, _INT, _INT, _PTR], ctypes.c_int),
}

# The H100 and the kernels' limits, as csrc/gather_rows.cu has them.
SMS = 132
SMEM_PER_SM = 233_472
SMEM_PER_BLOCK = 232_448
RESERVED_PER_BLOCK = 1024
STAGE_BYTES = 2048
TABLE_BYTES = 32_768
MAX_WARPS = 8
REG_WARPS = 24  # warps an SM holds by registers (the partial pass's launch bounds)
MAX_STAGE_ROWS = 256
MAX_WIDTH = 256
MAX_SPLITS = 32
ORDERED_CHUNK = 512
ORDERED_COLS = 64
PLAN_KEYS = ("lanes", "groups", "cols", "rows", "vt", "tiles", "warps", "blocks_per_sm", "warp_tokens", "chunk",
             "chunks", "splits", "per_split", "smem_bytes")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def gather_rows_plan(n: int, num_rows: int, width: int, dtype: torch.dtype) -> dict:
    """How the kernels split n tokens of a [num_rows, width] table of
    ``dtype`` (csrc/gather_rows.cu ``make_plan``; loads no library).

    bf16: ``order`` "token", ``blocks`` of eight warps, one a (row, 64
    columns), seven filling shared memory with the row's cotangents of
    ``chunk_tokens`` tokens while the eighth adds the last fill's;
    ``round_each_add`` where width > 32.

    f32, ``order`` "fixed":

    * ``lanes`` lanes a token (a power of two up to 32, at most ``width``),
      in ``groups`` = 32 / lanes groups a warp, each owning ``cols`` columns
      of a token; ``rows`` tokens a stage in shared memory;
    * ``vt`` table rows a block holds, in ``tiles`` tiles over grid.y, so
      that a warp's tables take at most 32 KB;
    * ``warps`` a block, ``blocks_per_sm`` of them on an SM by shared
      memory and registers (the most warps an SM holds with at least 2
      blocks on it), ``smem_bytes`` a block;
    * ``warp_tokens`` consecutive tokens a warp, ``chunk`` = warps x
      warp_tokens a block, ``chunks`` blocks along the tokens: about one
      wave of the card's 132 SMs, and no block reading fewer cotangent
      bytes than its partial's;
    * ``splits`` fixed ranges of ``per_split`` chunks that the second pass
      sums first, each in one thread."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gather_rows_plan: dtype {dtype} (takes float32 and bfloat16)")
    if n < 0 or num_rows <= 0 or not 0 < width <= MAX_WIDTH:
        raise ValueError(f"gather_rows_plan: n {n}, num_rows {num_rows}, width {width} "
                         f"(takes n >= 0, num_rows > 0, 0 < width <= {MAX_WIDTH})")
    return dict(_plan(n, num_rows, width, dtype == torch.bfloat16))


@functools.lru_cache(maxsize=256)
def _plan(n: int, num_rows: int, width: int, bf16: bool) -> dict:
    """gather_rows_plan's arithmetic, once a shape: the training step asks
    for it every step."""
    if bf16:
        return {"order": "token", "blocks": num_rows * _cdiv(width, ORDERED_COLS), "chunk_tokens": ORDERED_CHUNK,
                "round_each_add": width > 32}
    lanes = 1 << (min(width, 32).bit_length() - 1)
    groups = 32 // lanes
    row_bytes = width * 4
    unit = math.lcm(groups, 16 // math.gcd(16, row_bytes))
    rows = min(unit * max(1, STAGE_BYTES // (row_bytes * unit)), MAX_STAGE_ROWS // unit * unit)
    if groups * num_rows * width * 4 <= TABLE_BYTES:
        vt, tiles = num_rows, 1
    else:
        tiles = _cdiv(num_rows, TABLE_BYTES // (groups * width * 4))
        vt = _cdiv(num_rows, tiles)

    def smem(w):
        return _cdiv(4 * w * groups * vt * width, 16) * 16 + w * (rows * row_bytes + 4 * rows)

    warps = per_sm = 0
    for min_blocks in (2, 1):
        for w in range(1, MAX_WARPS + 1):
            if smem(w) > SMEM_PER_BLOCK:
                break
            b = min(SMEM_PER_SM // (smem(w) + RESERVED_PER_BLOCK), 64 // w, REG_WARPS // w, 32)
            if b >= min_blocks and w * b >= warps * per_sm:
                warps, per_sm = w, b
        if warps:
            break
    # About one wave of blocks, each reading at least its partial's bytes.
    chunks_target = _cdiv(SMS * per_sm, tiles)
    least = _cdiv(_cdiv(vt * width * 4, row_bytes), warps)
    warp_tokens = _cdiv(max(unit, least, _cdiv(n, chunks_target * warps)), unit) * unit
    chunk = warps * warp_tokens
    chunks = _cdiv(n, chunk) if n else 1
    cap = min(MAX_SPLITS, chunks, _cdiv(SMS * 2048, num_rows * width))
    splits = 1 << (cap.bit_length() - 1)
    values = (lanes, groups, _cdiv(width, lanes), rows, vt, tiles, warps, per_sm, warp_tokens, chunk, chunks, splits,
              _cdiv(chunks, splits), smem(warps))
    return {"order": "fixed", **dict(zip(PLAN_KEYS, values))}


def gather_rows_attributes(n: int = 102_400, num_rows: int = 128, width: int = 32) -> dict:
    """The library's plan for an f32 table at this shape
    (``gather_rows_plan``'s keys) and ``occupancy``, the blocks of the
    first pass an SM holds by the runtime's occupancy calculator."""
    lib = _build.load("gather_rows", _SIGNATURES)
    vals = (ctypes.c_longlong * (len(PLAN_KEYS) + 1))()
    if lib.afr_gather_rows_plan(n, num_rows, width, vals) != 0:
        raise ValueError(f"gather_rows: the library takes no plan at n {n}, num_rows {num_rows}, width {width}")
    return {"order": "fixed", **dict(zip(PLAN_KEYS, vals[: len(PLAN_KEYS)])), "occupancy": vals[len(PLAN_KEYS)]}


def _check(codes: torch.Tensor, cot: torch.Tensor, num_rows: int, dtype: torch.dtype) -> None:
    if codes.device != cot.device:
        raise ValueError(f"gather_rows_backward: codes on {codes.device}, cot on {cot.device}")
    if codes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gather_rows_backward runs on cuda or cpu tensors, not {codes.device}")
    if codes.dtype != torch.int64:
        raise ValueError(f"gather_rows_backward: codes are {codes.dtype}, expected torch.int64")
    if dtype not in (torch.float32, torch.bfloat16) or cot.dtype != dtype:
        raise ValueError(f"gather_rows_backward: cot is {cot.dtype} for a {dtype} table "
                         f"(takes float32 or bfloat16, the table's dtype)")
    if cot.dim() != codes.dim() + 1 or cot.shape[:-1] != codes.shape:
        raise ValueError(f"gather_rows_backward: cot {tuple(cot.shape)} is not codes {tuple(codes.shape)} + (width,)")
    if not (codes.is_contiguous() and cot.is_contiguous()):
        raise ValueError("gather_rows_backward: codes and cot must be contiguous")
    gather_rows_plan(codes.numel(), num_rows, cot.shape[-1], dtype)


def _fixed_order_sum(codes: torch.Tensor, cot: torch.Tensor, num_rows: int) -> torch.Tensor:
    """The f32 kernels' order: f32 tables, one a walker (chunk, warp,
    group), each adding its tokens in order; a chunk's partial, the sum of
    its walkers' tables in walker order from zero; then each split's range
    of chunks summed in order from zero, and the splits' sums in order from
    zero."""
    n, width = cot.shape
    p = gather_rows_plan(n, num_rows, width, torch.float32)
    dev = cot.device
    t = torch.arange(n, device=dev)
    within = t % p["chunk"]
    off = within % p["warp_tokens"]
    walker = ((t // p["chunk"]) * p["warps"] + within // p["warp_tokens"]) * p["groups"] + off % p["groups"]
    step = off // p["groups"]
    per_chunk = p["warps"] * p["groups"]
    tables = torch.zeros(p["chunks"] * per_chunk, num_rows, width, device=dev)
    order = torch.argsort(step, stable=True)
    # At one step each walker adds one token: no two adds of one step meet.
    for sel in torch.split(order, torch.bincount(step).tolist() if n else []):
        wk, cd = walker[sel], codes[sel]
        tables[wk, cd] = tables[wk, cd] + cot[sel]
    tables = tables.view(p["chunks"], per_chunk, num_rows, width)
    partial = torch.zeros(p["chunks"], num_rows, width, device=dev)
    for k in range(per_chunk):
        partial += tables[:, k]
    spread = torch.zeros(p["splits"] * p["per_split"], num_rows, width, device=dev)
    spread[: p["chunks"]] = partial
    spread = spread.view(p["splits"], p["per_split"], num_rows, width)
    sub = torch.zeros(p["splits"], num_rows, width, device=dev)
    for q in range(p["per_split"]):
        sub += spread[:, q]
    out = torch.zeros(num_rows, width, device=dev)
    for s in range(p["splits"]):
        out += sub[s]
    return out


def _token_order_sum(codes: torch.Tensor, cot: torch.Tensor, num_rows: int) -> torch.Tensor:
    """The bf16 kernel's order, the index form's at widths 32 and 64: each
    row's tokens in token order added in f32 to the running sum, rounded
    back to bf16 after each add where width > 32, else once at the end."""
    n, width = cot.shape
    dev = cot.device
    each = torch.bfloat16 if width > 32 else torch.float32
    out = torch.zeros(num_rows, width, dtype=each, device=dev)
    if not n:
        return out.to(torch.bfloat16)
    by_row = torch.argsort(codes, stable=True)
    counts = torch.bincount(codes, minlength=num_rows)
    rank = torch.empty(n, dtype=torch.long, device=dev)
    rank[by_row] = torch.arange(n, device=dev) - (torch.cumsum(counts, 0) - counts)[codes[by_row]]
    order = torch.argsort(rank, stable=True)
    # At one rank each row adds one token: no two adds of one step meet.
    for sel in torch.split(order, torch.bincount(rank).tolist()):
        rows = codes[sel]
        out[rows] = (out[rows].float() + cot[sel].float()).to(each)
    return out.to(torch.bfloat16)


def gather_rows_backward_reference(codes: torch.Tensor, cot: torch.Tensor, num_rows: int,
                                   dtype: torch.dtype) -> torch.Tensor:
    """The kernels' plain version, in their order of sums (the module's
    docstring): codes [*] int64 in [0, num_rows), cot [*, width] of
    ``dtype`` -> [num_rows, width] of ``dtype``. Runs on either device
    (the card's tests hold the kernels to it)."""
    _check(codes, cot, num_rows, dtype)
    n, width = codes.numel(), cot.shape[-1]
    if n and (int(codes.min()) < 0 or int(codes.max()) >= num_rows):
        raise ValueError(f"gather_rows_backward: codes outside [0, {num_rows})")
    codes, cot = codes.reshape(-1), cot.reshape(n, width)
    if dtype == torch.bfloat16:
        return _token_order_sum(codes, cot, num_rows)
    return _fixed_order_sum(codes, cot, num_rows)


def gather_rows_backward(codes: torch.Tensor, cot: torch.Tensor, num_rows: int, dtype: torch.dtype) -> torch.Tensor:
    """d(table) [num_rows, width] of ``dtype`` for the gather table[codes]:
    codes [*] int64, cot [*, width] of ``dtype`` (float32 or bfloat16, the
    table's), both contiguous, width <= 256. On CUDA tensors the kernels of
    csrc/gather_rows.cu, counted on ``gather_rows_backward.launches`` for
    f32 and on ``.ordered_launches`` for bf16; on CPU tensors the plain
    version. A
    code outside [0, num_rows) raises on the CPU at the call, and on the
    card stops the kernel: a CUDA error at the next synchronisation, so
    that no step waits on a check."""
    if codes.device.type == "cpu" and cot.device.type == "cpu":
        return gather_rows_backward_reference(codes, cot, num_rows, dtype)
    _check(codes, cot, num_rows, dtype)
    n, width = codes.numel(), cot.shape[-1]
    dev = cot.device
    if cot.data_ptr() % 16:
        cot = cot.clone()  # the f32 kernel reads 16-byte vectors, the bf16 one 4-byte pairs
    out = torch.empty((num_rows, width), dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        lib = _build.load("gather_rows", _SIGNATURES)
        stream = _build.stream_handle(dev)
        if dtype == torch.bfloat16:
            rc = lib.afr_gather_rows_bwd_ordered(cot.data_ptr(), codes.data_ptr(), out.data_ptr(), n, num_rows, width,
                                                 stream)
        else:
            chunks = gather_rows_plan(n, num_rows, width, dtype)["chunks"]
            partial = torch.empty(chunks * num_rows * width, dtype=torch.float32, device=dev)
            rc = lib.afr_gather_rows_bwd(cot.data_ptr(), codes.data_ptr(), partial.data_ptr(), out.data_ptr(), n,
                                         num_rows, width, stream)
    if rc != 0:
        raise RuntimeError(f"gather_rows_bwd kernel launch failed: CUDA error {rc}")
    if dtype == torch.bfloat16:
        gather_rows_backward.ordered_launches += 1
    else:
        gather_rows_backward.launches += 1
    return out


gather_rows_backward.launches = 0
gather_rows_backward.ordered_launches = 0
