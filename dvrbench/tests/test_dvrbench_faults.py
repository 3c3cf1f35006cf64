"""A whole run on the CPU at a small size, the chip's look skipped: sound,
the check passes; with each fault a cell can have planted in the program
underneath the harness, ``correct`` comes out false."""
import pytest

from dvrbench import harness, run

CASES = [(w["name"], f)
         for w in harness.benchmark()["workloads"]
         for f in [None] + sorted(harness.faults(harness.job_of(w["name"])))]


@pytest.mark.parametrize("cell,fault", CASES)
def test_faults_come_out_not_correct(cell, fault):
    job = harness.job_of(cell)
    seed = 2 ** 32 + 17

    def go():
        return run.run_cell(cell, seed, 0.3, False, "cpu",
                            overrides=harness.small(job))
    if fault is None:
        assert go()["correct"] is True
        return
    with harness.faults(job)[fault]():
        r = go()
    assert r["correct"] is False, r["checks"]
