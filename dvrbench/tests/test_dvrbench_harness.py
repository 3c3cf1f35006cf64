"""The harness finds every piece by its name, ``BENCHMARK.json`` keeps to
the benchmark's contract, and a run's last line has the agreed keys."""
import json
import os
import re

import pytest

from conftest import ROOT
from dvrbench import harness, run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["dvrbench"]
    assert BENCH["command"] == ["python3", "-m", "dvrbench.run"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_entry_keys():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("dvrbench/")
        names.add(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1
        assert len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))
    every = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(every) == len(set(every))
    for n in every + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_pieces(cell):
    w = harness.cell(cell)
    cfg = harness.config(w["config"])
    assert harness.job(cfg["job"]).Job
    assert harness.traffic(w["traffic"])["layers"]
    assert harness.limits(cell)
    e2e = [m["name"] for m in harness.metrics_for(cell, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert set(e2e) - {"setup_s"} <= set(harness.job(cfg["job"]).END_TO_END)
    layers = harness.metrics_for(cell, "per_layer")
    assert layers
    for m in layers:
        assert callable(harness.reader(m["name"]))


def test_every_file_under_paths_has_a_legal_name():
    for base, _, files in os.walk(os.path.join(ROOT, "dvrbench")):
        if "__pycache__" in base:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(base, f), ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel


def test_configs_state_the_renderer_and_what_was_assumed():
    for c in BENCH["configs"]:
        cfg = harness.config(c["name"])
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["assumed"] and cfg["source"] == c["source"]


@pytest.mark.parametrize("cell,trace", [("volfit.ct_head", False),
                                        ("viewer.ct_head", True)])
def test_result_line_keys(cell, trace):
    r = run.run_cell(cell, 2 ** 33 + 5, 0.3, trace, "cpu",
                     overrides=harness.small(harness.job_of(cell)))
    want = ["correct", "attempted", "failed", "metrics", "device"]
    want += ["breakdown"] if trace else []
    assert list(r) == want + ["checks"]
    assert r["correct"] is True
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    kind = "per_layer" if trace else "end_to_end"
    assert set(r["metrics"]) <= {m["name"]
                                 for m in harness.metrics_for(cell, kind)}
    if not trace:
        assert set(r["metrics"]) == {
            m["name"] for m in harness.metrics_for(cell, kind)}
    assert set(r["checks"]) == set(harness.limits(cell))
