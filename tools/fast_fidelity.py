"""The fidelity of the shear-warp viewer cell: SSIM of its sampled frames
against the exact viewer's plain reference (the ray march at the
``viewer_800`` sampling rate), on the card:

    python3 tools/fast_fidelity.py [--seed N] [--cell viewer_fast.ct_head]

Runs the cell's set-up and a short window, then renders the sampled
frames' cameras through ``dvrbench.reference.dvr.render_views``; prints one
JSON line with the SSIM of each frame (``differender_tpu_torch.losses.
ssim``, over RGBA) and the largest pixel gap.  A reading, not a limit.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    from differender_tpu_torch.losses import ssim
    from dvrbench import harness
    from dvrbench.reference import dvr
    ap = argparse.ArgumentParser(prog="python3 tools/fast_fidelity.py")
    ap.add_argument("--cell", default="viewer_fast.ct_head")
    ap.add_argument("--seed", type=int, default=2 ** 32 + 2301)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    w = harness.cell(args.cell)
    cfg = harness.config(w["config"])
    exact = harness.config("viewer_800")
    job = harness.job(cfg["job"]).Job(cfg, harness.traffic(w["traffic"]),
                                      args.seed, "cuda")
    job.setup()
    job.window(args.seconds)
    job.release()
    fast = job.program["frames"]
    cams = torch.stack([job.camera(k) for k in job.frame_ids])
    H, W = cfg["image"]
    want = dvr.render_views(job.vol[0], job.tf, cams, H, W,
                            exact["sampling_rate"],
                            dvr.Optics.from_config(exact), diff=False)
    print(json.dumps({
        "cell": args.cell, "seed": args.seed, "frames": job.frame_ids,
        "ssim": [float(ssim(a, b)) for a, b in zip(fast, want)],
        "max_gap": float((fast - want).abs().max()),
        "device": torch.cuda.get_device_name()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
