"""A job is found by its module alone: its faults and its size on the CPU
are its own tables.  A kernel's roofline reads its time by the traced unit
that launched it, so the same work reads the same share however many
launches carry it.  On hand-made Chrome traces, on the CPU."""
import sys
import types

import pytest

from dvrbench import harness, tracing

K2 = "void march_diff_bwd_kernel<false, false, false, false, true>(MarchArgs)"
VIEWS, UNITS, UNIT_US = 8, 3, 1000.0


def _x(name, ts, dur, cat, **args):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 1, "tid": 1}
    if args:
        e["args"] = args
    return e


def _trace(launches_a_unit, stray=False):
    """``UNITS`` units of ``UNIT_US`` us, each launching K2 in
    ``launches_a_unit`` launches that together run 800 us on the device;
    each kernel runs after its unit's host range has closed, on the stream.
    The profiler repeats each unit's range on the device's timeline
    (``gpu_user_annotation``), which is no unit.  ``stray``: one more K2
    launched between two units."""
    events = [_x(tracing.WINDOW, 0.0, UNITS * UNIT_US + 5000.0,
                 "user_annotation")]
    corr = 0
    dev = UNITS * UNIT_US + 10.0        # the device runs behind the host
    for u in range(UNITS):
        t0 = u * UNIT_US
        events.append(_x(tracing.UNIT, t0 + 1.0, UNIT_US - 2.0,
                         "user_annotation"))
        events.append(_x(tracing.UNIT, t0 + 0.5, 0.2, "gpu_user_annotation"))
        for k in range(launches_a_unit):
            corr += 1
            dur = 800.0 / launches_a_unit
            events.append(_x("cudaLaunchKernel", t0 + 10.0 + k, 0.5,
                             "cuda_runtime", correlation=corr))
            events.append(_x(K2, dev, dur, "kernel", correlation=corr))
            dev += dur
    if stray:
        corr += 1
        events.append(_x("cuLaunchKernel", UNIT_US - 0.5, 0.2,
                         "cuda_driver", correlation=corr))
        events.append(_x(K2, dev, 5000.0, "kernel", correlation=corr))
    tr = tracing.Trace(events, UNITS)
    tr.work["k2"] = {"steps": [0, 2], "least_s": 1e-5}
    return tr


def _first_launches_reader(trace):
    """The reader before kernels were counted by unit: K2's time in the
    first ``views x steps`` launches of the trace."""
    w = trace.work["k2"]
    count = VIEWS * len(w["steps"])
    sel = [k for k in trace.kernels
           if tracing.kernel_matches(k[2], ("march_diff_bwd_kernel",))]
    times = [(b - a) * 1e-6 for a, b, _, _ in sel[:count]]
    if len(times) < count or sum(times) <= 0:
        return None
    return 100.0 * w["least_s"] / sum(times)


def test_one_launch_a_step_reads_the_roofline_of_eight():
    read = harness.reader("k2_roofline.train")
    eight, one = read(_trace(VIEWS)), read(_trace(1))
    # 1e-5 s of work over 2 counted units of 800 us.
    assert eight == pytest.approx(100.0 * 1e-5 / 1.6e-3, rel=1e-12)
    assert one == pytest.approx(eight, rel=1e-12)


def test_the_first_launches_reader_reads_nothing_on_one_launch_a_step():
    assert _first_launches_reader(_trace(VIEWS)) == pytest.approx(
        harness.reader("k2_roofline.train")(_trace(VIEWS)), rel=1e-12)
    assert _first_launches_reader(_trace(1)) is None


@pytest.mark.parametrize("launches", [1, VIEWS])
def test_a_launch_outside_every_unit_is_not_counted(launches):
    read = harness.reader("k2_roofline.train")
    stray = _trace(launches, stray=True)
    assert read(stray) == pytest.approx(read(_trace(launches)), rel=1e-12)
    per = stray.kernel_s_per_unit(("march_diff_bwd_kernel",))
    assert per == pytest.approx([8e-4] * UNITS, rel=1e-12)


def test_a_counted_unit_without_the_kernel_reads_nothing():
    tr = _trace(1)
    tr.work["k3"] = {"steps": [0], "least_s": 1e-5}
    assert harness.reader("k3_roofline.viewer")(tr) is None
    tr.work["k2"]["steps"] = [0, UNITS]
    assert harness.reader("k2_roofline.train")(tr) is None


@pytest.mark.parametrize("job", sorted({harness.job_of(w["name"]) for w in
                                        harness.benchmark()["workloads"]}))
def test_every_job_has_faults_and_a_cpu_size(job):
    faults = harness.faults(job)
    assert faults and all(callable(f) for f in faults.values())
    assert isinstance(harness.small(job), dict) and harness.small(job)


def test_a_job_is_found_by_its_module_alone(monkeypatch):
    def plant():
        raise AssertionError("not planted here")
    mod = types.ModuleType("dvrbench.jobs._throwaway")
    mod.FAULTS = {"plant": plant}
    mod.SMALL = {"volume": [8, 8, 8]}
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    assert harness.faults("_throwaway") == {"plant": plant}
    assert harness.small("_throwaway") == {"volume": [8, 8, 8]}
