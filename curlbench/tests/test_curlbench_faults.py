"""A run rehearsed on the CPU at a tiny size, the harness's look for a card
skipped, with the timed path broken underneath: `correct` comes out false
for each fault the cell can have, and true without one."""

from __future__ import annotations

import io

import pytest

from curlbench import faults, harness
from curlbench.tests import tiny

CELLS = [(w["name"], harness.load_json(harness.HERE / "workloads" / f"{w['name']}.json")["driver"])
         for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]
# A cell has each fault its traffic can have: serving cannot leave its state
# unchanged, and no cell is on more than one chip.
CASES = [(name, driver, fault) for name, driver in CELLS
         for fault in (None, "answer_altered", "half_batch", "state_unchanged")
         if not (fault == "state_unchanged" and driver != "train")
         and not (fault == "answer_altered" and driver == "train")]


@pytest.mark.parametrize("name,driver,fault", CASES)
def test_correct_only_without_a_fault(name, driver, fault):
    plant = faults.FAULTS[fault]() if fault else harness_null()
    with plant:
        out = harness.run(name, 2 ** 31 + 3, 0.3, False, device="cpu",
                          overrides=tiny.overrides(driver), log=io.StringIO())
    assert out["correct"] is (fault is None), out["compared"]
    assert out["attempted"] > 0
    assert list(out)[-1] == "compared"


def harness_null():
    import contextlib

    return contextlib.nullcontext()
