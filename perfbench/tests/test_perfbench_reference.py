"""The reference agrees with the program at tiny widths on the CPU: a whole
run of each cell (set-up, checked steps and call, window, reference)
through the harness, with the program's plain versions of its kernels."""

import pytest
import torch

from perfbench import harness
from perfbench.reference import check

from .tiny import ALL, cell

# CPU readings at the tiny size (8-wide embedding, batch 16): the program's
# plain kernels against the reference differ by f32 and bf16 rounding only.
TINY_LIMITS = {"loss_gap": 1e-3, "grad_gap": 1e-2, "change_gap": 1e-2,
               "call_loss_gap": 1e-3, "call_grad_gap": 1e-2, "call_change_gap": 1e-2}


@pytest.mark.parametrize("name", ALL)
def test_program_matches_reference_at_tiny_width(name):
    c = cell(name)
    result = harness.run_cell(c)
    assert result["failed"] == 0 and result["attempted"] > 0
    numbers = result["numbers"]
    assert set(numbers) == set(c.limits)
    for k, v in numbers.items():
        assert v <= TINY_LIMITS[k], (k, v)
    # The first loss is drawn with the same masks.
    assert result["readings"]["program"]["losses"][0] == pytest.approx(
        result["readings"]["reference"]["losses"][0], rel=1e-5)


def test_grad_norms_from_second_moment_sums():
    """nu after k steps = b2^k nu before + (1 - b2) sum_i b2^(k-i) g_i^2: the
    norms read back the weighted gradients."""
    b2, g = 0.99, [torch.tensor([3.0, 4.0]), torch.tensor([1.0, 0.0]), torch.tensor([0.0, 2.0])]
    nu = torch.zeros(2, dtype=torch.float64)
    for gi in g[:1]:
        nu = b2 * nu + (1 - b2) * gi.double() ** 2
    before = check.nu_sums({"w": nu})
    assert check.grad_norms(before, None, b2, 1)["w"] == pytest.approx(5.0)
    for gi in g[1:]:
        nu = b2 * nu + (1 - b2) * gi.double() ** 2
    got = check.grad_norms(check.nu_sums({"w": nu}), before, b2, 2)["w"]
    assert got == pytest.approx((b2 * 1.0 + 4.0) ** 0.5)


def test_change_norms_against_a_host_copy():
    p = {"w": torch.arange(6.0).reshape(2, 3)}
    before = check.host_copy(p)
    p["w"] += torch.tensor([[3.0, 0, 0], [0, 4.0, 0]])
    assert check.change_norms(p, before) == {"w": pytest.approx(5.0)}
