"""Finds each piece of a cell by its name: the cell in ``BENCHMARK.json``,
its configuration in ``configs/<name>.json``, its traffic in
``traffic/<name>.json``, its limits in ``limits/<cell>.json``, the job that
runs its configuration in ``jobs/<job>.py`` (with the faults its cells can
have and the size that runs them on the CPU) and each per-layer metric's
reader in ``metrics/<metric>.py``.  A new cell, configuration, traffic mix,
job or metric is new files and entries, never an edit."""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell(name: str, bench: dict = None) -> dict:
    bench = bench or benchmark()
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, bench: dict = None) -> dict:
    """A configuration's file, as ``BENCHMARK.json`` names it."""
    bench = bench or benchmark()
    for c in bench["configs"]:
        if c["name"] == name:
            return _load_json(os.path.join(ROOT, c["file"]))
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return _load_json(os.path.join(HERE, "traffic", name + ".json"))


def limits(cell_name: str) -> Dict[str, float]:
    return _load_json(os.path.join(HERE, "limits", cell_name + ".json"))[
        "limits"]


def job(name: str):
    """The module that runs a configuration's job (``jobs/<name>.py``)."""
    return importlib.import_module(f"dvrbench.jobs.{name}")


def job_of(cell_name: str, bench: dict = None) -> str:
    """The name of the job that runs a cell: its configuration's ``job``."""
    bench = bench or benchmark()
    return config(cell(cell_name, bench)["config"], bench)["job"]


def faults(name: str) -> Dict[str, Callable]:
    """The faults a job's cells can have, each name with the factory of
    the context manager that plants it (``FAULTS`` of ``jobs/<name>.py``,
    the factories in :mod:`dvrbench.faults`)."""
    return dict(job(name).FAULTS)


def small(name: str) -> dict:
    """The configuration's keys that a job's cells replace to run on the
    CPU in seconds (``SMALL`` of ``jobs/<name>.py``)."""
    return dict(job(name).SMALL)


def metrics_for(cell_name: str, kind: str, bench: dict = None) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that a cell reports:
    those that list it, and those that list no cells."""
    bench = bench or benchmark()
    return [m for m in bench[kind]
            if "workloads" not in m or cell_name in m["workloads"]]


def reader(metric: str) -> Callable:
    """The ``read(trace)`` function of ``metrics/<metric>.py``."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "dvrbench.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
