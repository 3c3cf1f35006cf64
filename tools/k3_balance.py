#!/usr/bin/env python3
"""How evenly K3's ground-truth work spreads over the H100's SMs.

Usage, from the repository root, on a machine with a CUDA card::

    python3 tools/k3_balance.py [--seed N] [--scene ct_head|dense_sim]

Builds one step of the benchmark's volume fit (``dvrbench`` configuration
``volfit_256``: 256^3, 8 views of 256^2 at sampling rate 8, the occupancy
grid on) and marches each view's rays through K3 with its per-ray counts
(``march_nondiff(..., counts=)``).  A ray's work is its visited plus its
composited samples; a warp's work is its busiest lane's (32 lanes of a
16x8 block, two rows of 16 each); a block's is the sum of its 4 warps'.

Two models of a launch on 132 SMs of 4 resident blocks each (528 slots):

- *dispatch*: each view's blocks in dispatch order (x fastest, then y),
  block ``b`` on SM ``b mod 132``; the busiest SM's load over the mean
  SM's load, per view;
- *slots*: blocks list-scheduled on 528 slots, each to the slot free
  first; the makespan of one launch per view (summed) and of one launch of
  all views (view slowest), each over the even spread (total work / 528).

Each view's K3 is also timed by CUDA events (median of 5 calls, rays and
grid prebuilt), beside the model's busiest SM, and the card's name and
power limit are printed.  One JSON line per view, then a summary line.
"""
from __future__ import annotations

import argparse
import heapq
import json
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SMS, SLOTS_PER_SM = 132, 4
BLOCK_W, BLOCK_H = 16, 8


def block_work(work: torch.Tensor) -> torch.Tensor:
    """Per block (in dispatch order) the sum of its warps' busiest lanes;
    ``work`` is (H, W) and padded with zero-work lanes to whole blocks."""
    H, W = work.shape
    gy, gx = -(-H // BLOCK_H), -(-W // BLOCK_W)
    pad = torch.zeros((gy * BLOCK_H, gx * BLOCK_W), dtype=torch.float64)
    pad[:H, :W] = work.double().cpu()
    # (gy, 4 warps, 2 rows, gx, 16 lanes): a warp is two rows of a block.
    w = pad.reshape(gy, BLOCK_H // 2, 2, gx, BLOCK_W)
    warp_max = w.amax(dim=(2, 4))                      # (gy, 4, gx)
    return warp_max.sum(dim=1).reshape(-1)             # (gy * gx,)


def busiest_sm_ratio(blocks: torch.Tensor) -> float:
    load = torch.zeros(SMS, dtype=torch.float64)
    idx = torch.arange(blocks.numel()) % SMS
    load.index_add_(0, idx, blocks)
    return float(load.max() / load.mean())


def makespan(blocks) -> float:
    """List scheduling of ``blocks`` (in order) on 528 slots."""
    slots = [0.0] * (SMS * SLOTS_PER_SM)
    heapq.heapify(slots)
    for b in blocks:
        heapq.heappush(slots, heapq.heappop(slots) + float(b))
    return max(slots)


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scene", default="ct_head")
    args = ap.parse_args()

    import differender_tpu_torch as P
    from dvrbench import harness
    from dvrbench.jobs import volfit

    cfg = harness.config("volfit_256")
    traffic = harness.traffic(args.scene)
    job = volfit.Job(cfg, traffic, args.seed, "cuda")
    lfs, _ = job.feed()
    rc = job.rc
    config = rc.config
    sr = float(cfg["gt_sampling_rate"])
    vol = P.volume_to_internal(job.vol_gt[0]).contiguous()
    tf = P.tf_to_internal(job.tf).contiguous()
    grid = P.build_occupancy(vol, tf, config)
    H, W = config.image_shape

    per_view, all_blocks, looped = [], [], 0.0
    for v in range(lfs.shape[0]):
        rays = P.make_rays(lfs[v], config, sr)
        counts = torch.empty((H, W, 3), dtype=torch.int32, device="cuda")
        _, visited, composited = P.march_nondiff(vol, tf, rays, config, sr,
                                                 grid, counts=counts)
        work = (visited + composited).double()
        blocks = block_work(work)
        all_blocks.append(blocks)
        times = []
        for _ in range(5):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            P.march_nondiff(vol, tf, rays, config, sr, grid)
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        span = makespan(blocks)
        looped += span
        lane = work.cpu()
        rec = {"view": v, "look_from": [round(float(x), 4) for x in lfs[v]],
               "k3_ms": statistics.median(times),
               "rays_hit": int((rays.n_samples > 0).sum()),
               "work_mean": float(lane.mean()), "work_max": float(lane.max()),
               "cell_loads": int(counts[..., 0].sum()),
               "grid_reads": int(counts[..., 2].sum()),
               "warp_max_over_mean": float(
                   blocks.sum() / (lane.sum() / 32.0)) if lane.sum() else 0.0,
               "busiest_sm_over_mean": busiest_sm_ratio(blocks),
               "makespan_over_even": span / (float(blocks.sum())
                                             / (SMS * SLOTS_PER_SM))}
        per_view.append(rec)
        print(json.dumps(rec), flush=True)
    batch = torch.cat(all_blocks)
    even = float(batch.sum()) / (SMS * SLOTS_PER_SM)
    ratios = [r["busiest_sm_over_mean"] for r in per_view]
    print(json.dumps({
        "scene": args.scene, "seed": args.seed, "views": len(per_view),
        "busiest_sm_over_mean": [min(ratios), statistics.median(ratios),
                                 max(ratios)],
        "k3_ms_looped": sum(r["k3_ms"] for r in per_view),
        "slots_looped_over_even": looped / even,
        "slots_one_launch_over_even": makespan(batch) / even,
        "card": card()}), flush=True)


if __name__ == "__main__":
    main()
