"""The readings that a cell's correctness limits are set from, on the chip:

    python3 -m dvrbench.calibrate --workload <cell> --seed <first> \\
        --seeds 12 [--control 3] [--faults 3] [--seconds 1.5] [--out PATH]

For each of ``--seeds`` seeds from ``--seed`` on, the cell's set-up and a
short window at its own load through the program, then the plain
reference: the program's numbers (the lower readings).  For the first
``--control`` seeds also the control: the reference with the volumes and
the TF held in bfloat16, in the program's place (the upper readings).  For
the first ``--faults`` seeds, each fault of the cell's job (its
``FAULTS``) planted in the program, held to the sound run's reference where
the job sets ``FAULTS_SHARE_REFERENCE`` and to its own otherwise; a job
with a ``details(ref)`` method adds what lies under its numbers.  One
process for all, so the kernels load once.  Writes a JSON summary to
``--out`` and prints it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from . import harness


def bf16(x: torch.Tensor) -> torch.Tensor:
    """Rounds to bfloat16 and back: a tensor held in bfloat16."""
    return x.to(torch.bfloat16).to(torch.float32)


def _program_numbers(cfg, traffic, seed, seconds, want=None):
    job = harness.job(cfg["job"]).Job(cfg, traffic, seed, "cuda")
    job.setup()
    job.window(seconds)
    job.release()
    t = time.perf_counter()
    ref = job.reference() if want is None else want
    ref_s = time.perf_counter() - t
    return job, ref, job.compare(job.program, ref), ref_s


def calibrate(workload: str, seeds, control: int, fault_seeds: int,
              seconds: float) -> dict:
    bench = harness.benchmark()
    cell = harness.cell(workload, bench)
    cfg = harness.config(cell["config"], bench)
    traffic = harness.traffic(cell["traffic"])
    share = getattr(harness.job(cfg["job"]), "FAULTS_SHARE_REFERENCE", False)
    out = {"workload": workload, "device": torch.cuda.get_device_name(),
           "program": {}, "control": {}, "faults": {}, "reference_s": []}
    for i, seed in enumerate(seeds):
        job, ref, numbers, ref_s = _program_numbers(cfg, traffic, seed,
                                                    seconds)
        out["program"][str(seed)] = numbers
        out["reference_s"].append(ref_s)
        if hasattr(job, "details"):
            out.setdefault("details", {})[str(seed)] = job.details(ref)
        if i < control:
            out["control"][str(seed)] = job.compare(job.reference(bf16), ref)
        if i < fault_seeds:
            for name, plant in harness.faults(cfg["job"]).items():
                with plant():
                    _, _, got, _ = _program_numbers(
                        cfg, traffic, seed, seconds,
                        want=ref if share else None)
                out["faults"].setdefault(name, {})[str(seed)] = got
        del job, ref
        torch.cuda.empty_cache()
        print(json.dumps({"seed": seed, "program": numbers,
                          "control": out["control"].get(str(seed))}),
              file=sys.stderr, flush=True)
    keys = next(iter(out["program"].values())).keys()
    out["summary"] = {
        k: {"program_max": max(v[k] for v in out["program"].values()),
            "control_min": min((v[k] for v in out["control"].values()),
                               default=None),
            "faults_min": {f: min(v[k] for v in per.values())
                           for f, per in out["faults"].items()}}
        for k in keys}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m dvrbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=1.5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dvrbench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    out = calibrate(args.workload,
                    [args.seed + i for i in range(args.seeds)],
                    args.control, args.faults, args.seconds)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out["summary"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
