"""Runs one cell of the benchmark once and prints its result line.

    python3 -m dvrbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the repository's root, on a machine with the CUDA cards the cell asks
for.  The run makes its inputs on the device from the seed, builds the
program's kernels (or loads them from ``build/torch_kernels/``), runs the
cell's set-up and warm-up, measures for ``--seconds`` (``--trace 0``: the
cell's end-to-end metrics) or traces a fixed number of steps or frames
(``--trace 1``: its per-layer metrics), then frees the program's state and
holds what the timed path produced against the plain reference.  The last
line of standard output is one JSON object; the numbers compared, each
beside its limit, are also the last lines of standard error.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys
import time

_IMPORTED_AT = time.time()

from . import harness  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "differender_tpu")
TRACE_PATH = os.path.join(harness.ROOT, "build", "dvrbench", "trace.json")


def process_start() -> float:
    """The wall-clock time this process started (its import of this module
    where ``/proc`` does not say)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return _IMPORTED_AT


def forbidden_modules(names=None):
    """The top-level names of JAX and the JAX package among loaded modules
    (or ``names``), compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", started: float = None,
             overrides: dict = None) -> dict:
    """One run of a cell; returns the result object.  ``overrides`` replace
    keys of the configuration (the tests run a cell on the CPU at a few
    voxels and pixels)."""
    import torch
    started = _IMPORTED_AT if started is None else started
    bench = harness.benchmark()
    cell = harness.cell(workload, bench)
    cfg = dict(harness.config(cell["config"], bench), **(overrides or {}))
    job_mod = harness.job(cfg["job"])
    job = job_mod.Job(cfg, harness.traffic(cell["traffic"]), seed, device)
    job.setup()
    metrics, device_info, breakdown = {}, {}, None
    # No garbage collection inside the measured or traced window.
    gc.collect()
    gc.disable()
    try:
        if trace:
            tr = job.traced(TRACE_PATH)
        else:
            setup_s = time.time() - started
            measured = job.window(seconds)
            measured["setup_s"] = setup_s
    finally:
        gc.enable()
    cuda = torch.device(device).type == "cuda"
    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name() if cuda else "cpu",
        "count": cell["chips"],
        "memory_peak_bytes": int(torch.cuda.max_memory_allocated())
        if cuda else 0}
    t_window = time.time()
    job.release()
    limits = harness.limits(workload)
    numbers = job.compare(job.program, job.reference())
    t_check = time.time()
    checks = {k: {"value": numbers[k], "limit": lim}
              for k, lim in limits.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values()) and job.failed == 0
    if trace:
        job.count_work()
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = tr.window_s
        for m in harness.metrics_for(workload, "per_layer", bench):
            value = harness.reader(m["name"])(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = {"device_ops": tr.top_device_ops(),
                     "idle_gaps": tr.idle_gaps()}
    else:
        for m in harness.metrics_for(workload, "end_to_end", bench):
            metrics[m["name"]] = {"value": measured[m["name"]],
                                  "unit": m["unit"]}
    print(f"dvrbench: {workload} seed {seed}: set-up and window "
          f"{t_window - started:.1f} s, check {t_check - t_window:.1f} s, "
          f"work count {time.time() - t_check:.1f} s", file=sys.stderr)
    result = {"correct": bool(correct), "attempted": job.attempted,
              "failed": job.failed, "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m dvrbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    started = process_start()
    # The CUDA driver's cache of JIT-compiled code stays in the checkout;
    # one host thread for PyTorch's CPU work, so the run is one steady load.
    os.environ["CUDA_CACHE_PATH"] = os.path.join(harness.ROOT, "build",
                                                 "cuda_cache")
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch
    torch.set_num_threads(1)
    chips = harness.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"dvrbench: {args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", started)
    found = forbidden_modules()
    if found:
        print(f"dvrbench: the run loaded {', '.join(found)}; nothing it "
              f"runs may import JAX or the JAX package", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
