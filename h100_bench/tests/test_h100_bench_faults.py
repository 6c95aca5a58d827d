"""``correct`` comes out false when the timed path is broken underneath
(the harness driven on the CPU at small sizes, its look for a card
skipped), once for each fault a cell can have, and the control, the
reference in fp8 in the program's place, reads above the limits that sound
runs keep."""

from __future__ import annotations

import time

import pytest

from conftest import TINY_CELLS
from h100_bench import faults, harness

CASES = [(c, f) for c in TINY_CELLS
         for f in faults.applicable("eval" if "eval" in c else "train",
                                    "proj" if "proj" in c else "free")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_planted_fault_is_not_correct(tiny_root, cell, fault):
    c = harness.load_cell(cell, tiny_root)
    res = harness.run_cell(c, 2**31 + 77, 0.3, False, "cpu", time.perf_counter(),
                           fault=faults.FAULTS[fault])
    assert not res["correct"], res["checks"]
    assert res["failed"] > 0


@pytest.mark.parametrize("cell", TINY_CELLS)
def test_sound_runs_are_correct_and_the_fp8_control_is_not(tiny_root, cell):
    c = harness.load_cell(cell, tiny_root)
    res = harness.run_cell(c, 2**31 + 78, 0.3, False, "cpu", time.perf_counter(),
                           control="fp8")
    assert res["correct"], res["checks"]
    control = res["_readings"]["control"]
    ok, _ = harness.judge(control, c.limits)
    assert not ok, control
