"""Each traffic mix repeats from its seed, and two seeds do the same work in
another order."""

import numpy as np
import pytest
import torch

from perfbench import harness, traffic


def _mixes():
    spec = harness.load_spec()
    return sorted({w["traffic"] for w in spec["workloads"]})


@pytest.mark.parametrize("mix_name", _mixes())
def test_mix_repeats_from_its_seed(mix_name):
    mix = traffic.load(mix_name)
    assert mix["kind"] == "train"
    rows = traffic.train_split(200, 0.2, 2**31 + 5)
    assert np.array_equal(rows, traffic.train_split(200, 0.2, 2**31 + 5))
    a, b = (traffic.BatchStream(rows, 16, 2**31 + 5, "cpu") for _ in range(2))
    for _ in range(25):
        assert torch.equal(a.take(3), b.take(3))
    other = traffic.train_split(200, 0.2, 2**31 + 6)
    assert not np.array_equal(rows, other) and len(other) == len(rows)


def test_an_epoch_covers_the_same_rows_whatever_the_seed():
    rows = np.arange(160, dtype=np.int64)
    seen = []
    for seed in (3, 2**33 + 1):
        s = traffic.BatchStream(rows, 16, seed, "cpu")
        seen.append(np.sort(s.take(100).reshape(-1).numpy()))
    assert np.array_equal(seen[0], seen[1]) and np.array_equal(seen[0], rows)


def test_a_call_stops_at_the_end_of_its_epoch():
    s = traffic.BatchStream(np.arange(50, dtype=np.int64), 16, 1, "cpu")
    assert [s.take(2).shape[0] for _ in range(4)] == [2, 1, 2, 1]


def test_corpus_is_the_programs_own():
    """The corpus comes from the program's builders: its first strings are
    the program's, and lengths those builders do not make are refused."""
    import dataclasses

    from ai_font_renderer_tpu_torch.config import FIRACODE_PATH, SheetSpec
    from ai_font_renderer_tpu_torch.fontgen.layout import encode_codes
    from ai_font_renderer_tpu_torch.fontgen.textgen import generate_corpus

    mix = traffic.load("train_corpus")
    spec = dataclasses.replace(SheetSpec(), max_chars=100)
    ds = traffic.build_dataset(FIRACODE_PATH, 8, mix, spec, "cpu")
    want = encode_codes(generate_corpus(8, base_seed=mix["corpus_seed"]), 100)
    assert np.array_equal(ds.codes.numpy(), want) and ds.targets_u8.dtype == torch.uint8
    with pytest.raises(ValueError, match="10-100"):
        traffic.build_dataset(FIRACODE_PATH, 8, {**mix, "min_length": 100}, spec, "cpu")
