"""The check fails a broken timed path. Each test drives the rest of a run
(the harness's look for a card skipped, on the CPU at a tiny size) with a
fault of perfbench/faults.py planted in the program underneath, and sees
``correct`` come out false. The control, the program one precision lower
or the reference in its place, reads far above the program."""

import json

import pytest

from perfbench import faults, harness
from perfbench.reference import check

from .tiny import cell

TRAIN = [w["name"] for w in harness.load_spec()["workloads"]]


def _correct(c) -> bool:
    result = harness.run_cell(c)
    return check.passes(result["numbers"], c.limits) and result["failed"] == 0


@pytest.mark.parametrize("name", TRAIN)
def test_sound_run_is_correct(name):
    assert _correct(cell(name))


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("late", [False, True])
def test_training_fault_is_not_correct(name, fault, late):
    with faults.planted(fault, late):
        assert not _correct(cell(name))


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_late_fault_shows_only_in_the_checked_call(fault):
    """A fault in calls of the window's shape alone leaves the first steps
    sound: only the checked call's numbers can catch it."""
    c = cell("flagship.train_corpus")
    with faults.planted(fault, late=True):
        numbers = harness.run_cell(c)["numbers"]
    first = {k: v for k, v in numbers.items() if not k.startswith("call_")}
    call = {k: v for k, v in numbers.items() if k.startswith("call_")}
    assert check.passes(first, {k: c.limits[k] for k in first})
    assert not check.passes(call, {k: c.limits[k] for k in call})


@pytest.mark.parametrize("name", TRAIN)
def test_control_reads_far_above_the_program(name):
    """The control named in the cell's limits file, as ``readings.py`` runs
    it: ``{"program": {field: value}}`` or ``{"reference": precision}``."""
    control = json.loads((harness.HERE / "limits" / f"{name}.json").read_text())["control"]
    sound = harness.run_cell(cell(name))["numbers"]
    low = harness.run_cell(cell(name, program_changes=control.get("program"),
                                reference_as_program=control.get("reference")))["numbers"]
    assert any(low[k] >= 3 * sound[k] and low[k] > 0 for k in sound), (sound, low)
