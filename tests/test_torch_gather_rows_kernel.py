"""The embedding gathers' backward of the card (ops/gather_rows.py), on the
CPU through its plain version, which sums in the kernels' order: its f32
values against an f64 sum, its order against a literal walk of the
kernels' loops (f32) and of the index form's (bf16), its plan, the
wrapper's checks, and the autograd function that models/gather.py takes on
the card. The kernels themselves run in tests/test_torch_cuda.py
(``-k gather_rows``)."""

import numpy as np
import pytest
import torch

from ai_font_renderer_tpu_torch.fontgen.layout import encode_codes
from ai_font_renderer_tpu_torch.fontgen.textgen import generate_corpus
from ai_font_renderer_tpu_torch.models.gather import _GatherRowsFunction
from ai_font_renderer_tpu_torch.ops import gather_rows_backward, gather_rows_backward_reference, gather_rows_plan
from ai_font_renderer_tpu_torch.ops import gather_rows as gr

B, S, V = 1024, 100, 128
U32 = 2.0**-24  # the unit roundoff of f32


@pytest.fixture(scope="module")
def corpus_codes():
    """The codes of 1024 corpus strings (10-100 characters, padded with 0):
    about half of them the padding row."""
    return torch.from_numpy(encode_codes(generate_corpus(B, base_seed=15), S)).long()


def _case(name, corpus_codes):
    """(codes, cot, num_rows, dtype) of a named shape."""
    g = torch.Generator().manual_seed(23)
    if name == "flagship E32 f32":
        return corpus_codes, torch.randn(B, S, 32, generator=g), V, torch.float32
    if name == "hc307m E64 bf16":
        return corpus_codes, torch.randn(B, S, 64, generator=g).to(torch.bfloat16), V, torch.bfloat16
    if name == "place_adv 1-D V128":
        return corpus_codes, torch.randn(B, S, 1, generator=g), V, torch.float32
    if name == "place_kern 1-D V16384":
        pairs = corpus_codes[:, :-1] * V + corpus_codes[:, 1:]
        return pairs, torch.randn(B, S - 1, 1, generator=g), V * V, torch.float32
    if name == "one row E32 f32":  # the worst skew: every code one row
        return torch.full((B, S), 7), torch.randn(B, S, 32, generator=g), V, torch.float32
    raise KeyError(name)


CASES = ["flagship E32 f32", "hc307m E64 bf16", "place_adv 1-D V128", "place_kern 1-D V16384", "one row E32 f32"]
F32_CASES = [c for c in CASES if "f32" in c or "1-D" in c]


def _depth(p: dict) -> int:
    """The most f32 adds on any path into one output: a walker's tokens, the
    block's walkers, a split's chunks, the splits."""
    return -(-p["warp_tokens"] // p["groups"]) + p["warps"] * p["groups"] + p["per_split"] + p["splits"]


@pytest.mark.parametrize("name", F32_CASES)
def test_plain_version_equals_the_f64_sum(name, corpus_codes):
    """f32 tables, within the rounding of the f32 sums: each output is off
    the exact sum by at most depth x u32 x the sum of its terms' magnitudes
    (depth: the most adds on a path into it)."""
    codes, cot, num_rows, dtype = _case(name, corpus_codes)
    width = cot.shape[-1]
    got = gather_rows_backward(codes, cot, num_rows, dtype)
    assert got.shape == (num_rows, width) and got.dtype == dtype
    flat_codes, flat_cot = codes.reshape(-1), cot.reshape(-1, width).double()
    exact = torch.zeros(num_rows, width, dtype=torch.float64).index_add_(0, flat_codes, flat_cot)
    magnitude = torch.zeros(num_rows, width, dtype=torch.float64).index_add_(0, flat_codes, flat_cot.abs())
    bound = 1.01 * _depth(gather_rows_plan(codes.numel(), num_rows, width, dtype)) * U32 * magnitude
    err = (got.double() - exact).abs()
    assert bool((err <= bound).all()), f"worst excess {float((err - bound).max())}"


def _bf16_round(x: np.ndarray) -> np.ndarray:
    """float32 -> the nearest bf16 (ties to even), as float32 (finite x)."""
    bits = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


def test_bf16_plain_version_is_the_index_form_s_walk(corpus_codes):
    """hc307m's bf16 table at B 1024 x S 100 (corpus codes): bit for bit a
    literal walk of the tokens in order, each row's running sum added to in
    f32 and rounded to bf16 (index_put_ with accumulation on the bf16
    table); far from the exact sum on the padding row, whose running sum
    stops taking small terms."""
    codes, cot, num_rows, dtype = _case("hc307m E64 bf16", corpus_codes)
    flat_codes, flat_cot = codes.reshape(-1).numpy(), cot.reshape(-1, 64).float().numpy()
    want = np.zeros((num_rows, 64), np.float32)
    for t, v in enumerate(flat_codes):
        want[v] = _bf16_round(want[v] + flat_cot[t])
    got = gather_rows_backward(codes, cot, num_rows, dtype)
    assert got.dtype == torch.bfloat16 and torch.equal(got.float(), torch.from_numpy(want))
    exact = np.zeros((num_rows, 64))
    np.add.at(exact, flat_codes, flat_cot.astype(np.float64))
    assert np.abs(want[0] - exact[0]).max() > 10.0


@pytest.mark.parametrize("name", CASES)
def test_plain_version_gives_the_same_bits_twice(name, corpus_codes):
    codes, cot, num_rows, dtype = _case(name, corpus_codes)
    first = gather_rows_backward(codes, cot, num_rows, dtype)
    assert torch.equal(first, gather_rows_backward(codes.clone(), cot.clone(), num_rows, dtype))


def _walk_of_the_kernels(codes: np.ndarray, cot: np.ndarray, num_rows: int, dtype: torch.dtype) -> np.ndarray:
    """csrc/gather_rows.cu's loops, written out one float32 add at a time:
    a block a (chunk, tile), a table a (warp, group), a run of one code
    summed in a register; the walkers' tables in order into the chunk's
    partial; the splits' chunks in order, then the splits in order."""
    f32 = np.float32
    n, width = cot.shape
    p = gather_rows_plan(n, num_rows, width, dtype)
    partial = np.zeros((p["chunks"], num_rows, width), f32)
    for chunk in range(p["chunks"]):
        for tile in range(p["tiles"]):
            v0 = tile * p["vt"]
            vt = min(p["vt"], num_rows - v0)
            tables = np.zeros((p["warps"], p["groups"], vt, width), f32)
            for warp in range(p["warps"]):
                start = chunk * p["chunk"] + warp * p["warp_tokens"]
                end = min(start + p["warp_tokens"], n)
                for group in range(p["groups"]):
                    cur, acc = -1, None
                    for t in range(start + group, end, p["groups"]):
                        v = int(codes[t]) - v0
                        if not 0 <= v < vt:
                            continue
                        if v != cur:
                            if cur >= 0:
                                tables[warp, group, cur] = acc
                            cur, acc = v, tables[warp, group, v].copy()
                        acc = (acc + cot[t].astype(f32)).astype(f32)
                    if cur >= 0:
                        tables[warp, group, cur] = acc
            s = np.zeros((vt, width), f32)
            for warp in range(p["warps"]):
                for group in range(p["groups"]):
                    s = (s + tables[warp, group]).astype(f32)
            partial[chunk, v0 : v0 + vt] = s
    out = np.zeros((num_rows, width), f32)
    for split in range(p["splits"]):
        acc = np.zeros((num_rows, width), f32)
        for c in range(split * p["per_split"], min((split + 1) * p["per_split"], p["chunks"])):
            acc = (acc + partial[c]).astype(f32)
        out = (out + acc).astype(f32)
    return out


@pytest.mark.parametrize("n, num_rows, width, dtype", [
    (3001, 11, 3, torch.float32),     # 16 groups of 2 lanes, a ragged end
    (2500, 300, 1, torch.float32),    # 32 groups of one lane, the table in 2 tiles
    (777, 5, 48, torch.float32),      # 2 columns a lane, some lanes with one
    (1000, 1200, 64, torch.float32),  # a tiled E 64 table
], ids=["E3", "E1-tiled", "E48", "E64-tiled"])
def test_plain_version_sums_in_the_kernels_order(n, num_rows, width, dtype):
    """f32 tables: bit for bit the literal walk of the kernels' loops, at
    small shapes that take groups of lanes, tiles of the table and a ragged
    end; the codes skewed, in runs, as the corpus's padding."""
    rng = np.random.default_rng(5)
    codes = rng.integers(0, num_rows, n)
    codes[rng.random(n) < 0.4] = num_rows // 2
    codes[n // 3 : n // 3 + 90] = 0
    cot = torch.from_numpy(rng.standard_normal((n, width)).astype(np.float32)).to(dtype)
    want = _walk_of_the_kernels(codes, cot.float().numpy(), num_rows, dtype)
    got = gather_rows_backward(torch.from_numpy(codes), cot, num_rows, dtype)
    assert torch.equal(got, torch.from_numpy(want).to(dtype))


def test_the_plan_keeps_two_blocks_an_sm_at_the_cells_shapes():
    """At the flagship's shape (B 1024 x S 100, 128 rows, E 32 f32) and the
    E 64 f32 placement table: at least 2 blocks an SM by shared memory, a
    grid of one wave (no second) that gives all but a few of the 132 SMs
    two blocks (the chunks' lengths are multiples of the warps), and the
    table whole in every block. hc307m's bf16 table takes the token-order
    kernel: a one-warp block a row."""
    assert gather_rows_plan(B * S, V, 64, torch.bfloat16) == {"order": "token", "blocks": V, "chunk_tokens": 512,
                                                              "round_each_add": True}
    for width, dtype in ((32, torch.float32), (64, torch.float32)):
        p = gather_rows_plan(B * S, V, width, dtype)
        assert p["blocks_per_sm"] >= 2
        assert p["blocks_per_sm"] * p["smem_bytes"] <= gr.SMEM_PER_SM
        assert 0.97 * 2 * gr.SMS <= p["chunks"] * p["tiles"] <= p["blocks_per_sm"] * gr.SMS
        assert p["tiles"] == 1 and p["vt"] == V
        assert p["chunks"] * p["chunk"] >= B * S > (p["chunks"] - 1) * p["chunk"]


def test_the_plan_tiles_the_table_where_it_does_not_fit():
    """A warp's tables take at most 32 KB: the 1-D pair table (16,384 rows,
    32 one-lane groups) and a 4,000-row E 256 table go in tiles over
    grid.y, each block within the per-block limit."""
    for n, rows, width, dtype in ((B * (S - 1), V * V, 1, torch.float32), (4096, 4000, 256, torch.float32)):
        p = gather_rows_plan(n, rows, width, dtype)
        assert p["tiles"] > 1 and p["tiles"] * p["vt"] >= rows > (p["tiles"] - 1) * p["vt"]
        assert p["groups"] * p["vt"] * width * 4 <= gr.TABLE_BYTES
        assert p["smem_bytes"] <= gr.SMEM_PER_BLOCK
    p = gather_rows_plan(B * S, V, 1, torch.float32)
    assert (p["tiles"], p["groups"], p["lanes"]) == (1, 32, 1)


@pytest.mark.parametrize("case", ["code -1", "code V", "int32 codes", "f16 cot", "cot dtype not the table's",
                                  "strided cot", "strided codes", "wrong width axis", "width 257"])
def test_the_wrapper_raises_on_bad_codes_dtypes_and_layouts(case):
    codes = torch.randint(0, V, (4, 6))
    cot = torch.randn(4, 6, 8)
    dtype = torch.float32
    if case == "code -1":
        codes[1, 2] = -1
    elif case == "code V":
        codes[3, 5] = V
    elif case == "int32 codes":
        codes = codes.int()
    elif case == "f16 cot":
        cot, dtype = cot.half(), torch.float16
    elif case == "cot dtype not the table's":
        dtype = torch.bfloat16
    elif case == "strided cot":
        cot = torch.randn(4, 6, 16)[..., ::2]
    elif case == "strided codes":
        codes = torch.randint(0, V, (4, 12))[:, ::2]
    elif case == "wrong width axis":
        cot = torch.randn(4, 8, 6)
    elif case == "width 257":
        cot = torch.randn(4, 6, 257)
    with pytest.raises(ValueError):
        gather_rows_backward(codes, cot, V, dtype)


def test_an_empty_batch_gives_zeros():
    got = gather_rows_backward(torch.zeros(0, 100, dtype=torch.long), torch.zeros(0, 100, 32), V, torch.float32)
    assert torch.equal(got, torch.zeros(V, 32))


@pytest.mark.parametrize("shape", [(V, 64), (V,)], ids=["rows", "1-D"])
def test_the_card_s_autograd_function_gathers_and_takes_the_plain_order(shape, corpus_codes):
    """models/gather.py's function (the card's route, here on CPU tensors,
    where its backward is the plain version): the forward is table[codes],
    the gradient gather_rows_backward's, 1-D tables as [V, 1]."""
    g = torch.Generator().manual_seed(4)
    table = torch.randn(shape, generator=g, requires_grad=True)
    cot = torch.randn(corpus_codes.shape + shape[1:], generator=g)
    if len(shape) == 1:
        out = _GatherRowsFunction.apply(table[:, None], corpus_codes)[..., 0]
    else:
        out = _GatherRowsFunction.apply(table, corpus_codes)
    assert torch.equal(out, table.detach()[corpus_codes])
    out.backward(cot)
    want = gather_rows_backward_reference(corpus_codes, cot.reshape(corpus_codes.shape + (-1,)), V, torch.float32)
    assert torch.equal(table.grad, want.reshape(shape))
