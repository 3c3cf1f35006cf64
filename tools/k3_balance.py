#!/usr/bin/env python3
"""How evenly a march kernel's work in one volume-fitting step spreads over
the H100's SMs: K3 (the ground truth), K1 or K2 (the fitted views).

Usage, from the repository root, on a machine with a CUDA card::

    python3 tools/k3_balance.py [--kernel k3|k1|k2] [--seed N]
                                [--scene ct_head|dense_sim]

Builds one step of the benchmark's volume fit (``dvrbench`` configuration
``volfit_256``: 256^3, 8 views of 256^2) and reads each view's per-ray
work from the kernel's own counts:

- ``k3``: the ground truth at sampling rate 8 with the occupancy grid,
  K3's ``march_nondiff(..., counts=)``; a ray's work is its visited plus
  its composited samples;
- ``k1``: the fitted volume's views at sampling rate 1 with the step's
  jitter, K1's ``march_diff_fwd(..., counts=)``; a ray's work is the
  samples it marched before its stop (``valid_steps - 1``), of which the
  zero-opacity samples K1 skips are printed;
- ``k2``: the same views, K2's ``march_diff_bwd(..., counts=)`` for the
  step's own image cotangent (the gradient of ``dssim_mse_loss`` against
  the ground truth); a ray's work is the samples K2 recomputes plus those
  that scatter into ``d_volume`` (its quiet samples and atomics are
  printed).

A warp's work is its busiest lane's (32 lanes of a 16x8 block, two rows of
16 each); a block's is the sum of its 4 warps'.  Two models of a launch on
132 SMs of ``SLOTS`` resident blocks each (K1 5, K2 and K3 4):

- *dispatch*: each view's blocks in dispatch order (x fastest, then y),
  block ``b`` on SM ``b mod 132``; the busiest SM's load over the mean
  SM's load, per view;
- *slots*: blocks list-scheduled on the slots, each to the slot free
  first; the makespan of one launch per view (summed) and of one launch of
  all views (view slowest), each over the even spread (total work /
  slots).

Each view's launch is also timed by CUDA events (median of 5 calls, its
operands prebuilt), and for K3 and K1 one launch of all the views, whose
launch grid holds the view in ``blockIdx.z``; the card's name and power
limit are printed.  One JSON line per view, then a summary line.
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

SMS = 132
SLOTS = {"k3": 4, "k1": 5, "k2": 4}     # each kernel's __launch_bounds__
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


def makespan(blocks, slots_per_sm: int) -> float:
    """List scheduling of ``blocks`` (in order) on the card's slots."""
    slots = [0.0] * (SMS * slots_per_sm)
    heapq.heapify(slots)
    for b in blocks:
        heapq.heappush(slots, heapq.heappop(slots) + float(b))
    return max(slots)


def median_ms(fn, reps: int = 5) -> float:
    """Median device time of ``fn`` by CUDA events, after one warm call."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _stack(P, per_view):
    """One bundle of views from each view's rays, view-major."""
    return P.RayBundle(*(torch.stack(f) for f in zip(*per_view)))


def k3_views(P, job, lfs, u):
    """Per view of the ground truth: (rays, work, fields, launch); then
    the launch of all the views."""
    config = job.rc.config
    sr = float(job.cfg["gt_sampling_rate"])
    vol = P.volume_to_internal(job.vol_gt[0]).contiguous()
    tf = P.tf_to_internal(job.tf).contiguous()
    grid = P.build_occupancy(vol, tf, config)
    H, W = config.image_shape
    per_view = [P.make_rays(lf, config, sr) for lf in lfs]
    for rays in per_view:
        counts = torch.empty((H, W, 3), dtype=torch.int32, device="cuda")
        _, visited, composited = P.march_nondiff(vol, tf, rays, config, sr,
                                                 grid, counts=counts)
        yield (rays, (visited + composited).double(),
               {"cell_loads": int(counts[..., 0].sum()),
                "grid_reads": int(counts[..., 2].sum())},
               lambda r=rays: P.march_nondiff(vol, tf, r, config, sr, grid))
    batch = _stack(P, per_view)
    yield lambda: P.march_nondiff(vol, tf, batch, config, sr, grid)


def _fit_operands(P, job, lfs, u):
    config = job.rc.config
    sr = float(job.cfg["sampling_rate"])
    vol = P.volume_to_internal(job.vol.detach()[0]).contiguous()
    tf = P.tf_to_internal(job.tf).contiguous()
    per_view = [P.make_rays(lf, config, sr, u=None if u is None else u[v])
                for v, lf in enumerate(lfs)]
    return config, sr, vol, tf, per_view


def k1_views(P, job, lfs, u):
    """Per fitted view: (rays, work, fields, launch); then the launch of
    all the views."""
    config, sr, vol, tf, per_view = _fit_operands(P, job, lfs, u)
    H, W = config.image_shape
    for rays in per_view:
        counts = torch.empty((H, W, 2), dtype=torch.int32, device="cuda")
        _, steps = P.march_diff_fwd(vol, tf, rays, config, sr, counts=counts)
        yield (rays, (steps - 1).double(),
               {"zero_skipped": int(counts[..., 0].sum()),
                "general": int(counts[..., 1].sum())},
               lambda r=rays: P.march_diff_fwd(vol, tf, r, config, sr))
    batch = _stack(P, per_view)
    yield lambda: P.march_diff_fwd(vol, tf, batch, config, sr)


def k2_views(P, job, lfs, u):
    """Per fitted view, for the step's own image cotangent: (rays, work,
    fields, launch); then None (K2 launches a view at a time)."""
    config, sr, vol, tf, per_view = _fit_operands(P, job, lfs, u)
    H, W = config.image_shape
    with torch.no_grad():
        gts = job.rc.raycast_nondiff(job.vol_gt, job.tf, lfs,
                                     float(job.cfg["gt_sampling_rate"]))
    imgs = job.rc(job.vol, job.tf, lfs, u=u)
    [g] = torch.autograd.grad(P.dssim_mse_loss(imgs, gts), [imgs])
    g = g.permute(0, 2, 3, 1).contiguous()
    for v, rays in enumerate(per_view):
        image, _ = P.march_diff_fwd(vol, tf, rays, config, sr)
        counts = torch.empty((H, W, 4), dtype=torch.int32, device="cuda")
        _, _, steps = P.march_diff_bwd(vol, tf, rays, config, sr, image,
                                       g[v], counts=counts)
        yield (rays, (steps - 1 + counts[..., 0]).double(),
               {"scattered": int(counts[..., 0].sum()),
                "quiet_light": int(counts[..., 1].sum()),
                "atomics": int(counts[..., 2].sum())},
               lambda r=rays, i=image, gv=g[v]: P.march_diff_bwd(
                   vol, tf, r, config, sr, i, gv))
    yield None


VIEWS = {"k3": k3_views, "k1": k1_views, "k2": k2_views}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=sorted(VIEWS), default="k3")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scene", default="ct_head")
    args = ap.parse_args()

    import differender_tpu_torch as P
    from dvrbench import harness
    from dvrbench.jobs import volfit

    slots = SLOTS[args.kernel]
    cfg = harness.config("volfit_256")
    job = volfit.Job(cfg, harness.traffic(args.scene), args.seed, "cuda")
    lfs, u = job.feed()

    per_view, all_blocks, looped = [], [], 0.0
    views = VIEWS[args.kernel](P, job, lfs, u)
    for v in range(lfs.shape[0]):
        rays, work, fields, launch = next(views)
        blocks = block_work(work)
        all_blocks.append(blocks)
        span = makespan(blocks, slots)
        looped += span
        lane = work.cpu()
        rec = {"view": v, "look_from": [round(float(x), 4) for x in lfs[v]],
               "ms": median_ms(launch),
               "rays_hit": int((rays.n_samples > 0).sum()),
               "work_mean": float(lane.mean()), "work_max": float(lane.max()),
               **fields,
               "warp_max_over_mean": float(
                   blocks.sum() / (lane.sum() / 32.0)) if lane.sum() else 0.0,
               "busiest_sm_over_mean": busiest_sm_ratio(blocks),
               "makespan_over_even": span / (float(blocks.sum())
                                             / (SMS * slots))}
        per_view.append(rec)
        print(json.dumps(rec), flush=True)
    batched = next(views)
    batch = torch.cat(all_blocks)
    even = float(batch.sum()) / (SMS * slots)
    ratios = [r["busiest_sm_over_mean"] for r in per_view]
    print(json.dumps({
        "kernel": args.kernel, "scene": args.scene, "seed": args.seed,
        "views": len(per_view), "slots_per_sm": slots,
        "busiest_sm_over_mean": [min(ratios), statistics.median(ratios),
                                 max(ratios)],
        "ms_looped": sum(r["ms"] for r in per_view),
        "ms_one_launch": None if batched is None else median_ms(batched),
        "slots_looped_over_even": looped / even,
        "slots_one_launch_over_even": makespan(batch, slots) / even,
        "card": card()}), flush=True)


if __name__ == "__main__":
    main()
