"""The control: the reference with the volumes and the TF held in
bfloat16, in the program's place, comes out not correct against the
cell's limits.  At a small size on the CPU here; at the cell's own size
on the chip (``card``)."""
import pytest

from dvrbench import calibrate, harness

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


def _control_fails(cell, seed, overrides=None, device="cpu",
                   seconds=0.3):
    w = harness.cell(cell)
    cfg = dict(harness.config(w["config"]), **(overrides or {}))
    job = harness.job(cfg["job"]).Job(cfg, harness.traffic(w["traffic"]),
                                      seed, device)
    job.setup()
    job.window(seconds)
    job.release()
    got = job.compare(job.reference(calibrate.bf16), job.reference())
    limits = harness.limits(cell)
    return any(got[k] > lim for k, lim in limits.items()), got


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_small(cell):
    failed, got = _control_fails(cell, 2 ** 31 + 3,
                                 harness.small(harness.job_of(cell)))
    assert failed, got


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_at_cell_size(card, cell):
    for seed in (2 ** 32 + 1, 2 ** 32 + 2, 2 ** 32 + 3):
        failed, got = _control_fails(cell, seed, device="cuda", seconds=1.5)
        assert failed, got
