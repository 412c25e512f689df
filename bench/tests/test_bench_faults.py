"""A whole run on the CPU, with the harness's look for a card skipped:
`correct` holds for the program as it is and fails with each fault of
`bench/faults.py` planted under the timed path."""

import dataclasses

import pytest

from bench import faults, harness

from _small import small_cell


def test_sound_run_is_correct():
    out = harness.run_cell(small_cell(), 2 ** 31 + 3, 0.0, False,
                           device="cpu")
    assert out["correct"] and out["failed"] == 0
    assert list(out["checks"]) == ["loss_rel_gap", "sim_gap_ms"]
    every = dataclasses.replace(
        small_cell(), limits={"first_loss_gap": 1e-6,
                              "second_loss_gap": 1e-6,
                              "loss_rel_gap": 1e-5, "sim_gap_ms": 0.0})
    out = harness.run_cell(every, 2 ** 31 + 3, 0.0, False, device="cpu")
    assert out["correct"]
    assert list(out["checks"]) == ["first_loss_gap", "second_loss_gap",
                                   "loss_rel_gap", "sim_gap_ms"]
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"round_ms", "setup_s"}


@pytest.mark.parametrize("fault", faults.NAMES)
def test_fault_is_not_correct(fault):
    with faults.planted(fault):
        out = harness.run_cell(small_cell(), 2 ** 31 + 3, 0.0, False,
                               device="cpu")
    assert not out["correct"], out["checks"]
