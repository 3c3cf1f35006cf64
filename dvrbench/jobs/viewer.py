"""The viewer job: frames of one volume from a camera that orbits it, each
through ``Raycaster.raycast_nondiff`` (the occupancy grid built in the
call, then the inference march), in a closed loop: a frame is issued when
the one before it is on the host.

The window keeps a sample of its frames, drawn from the seed as it runs
(reservoir sampling), which the reference renders again after it.
"""
from __future__ import annotations

import math
import random
import statistics
import time

import torch

from .. import faults, inputs, work
from ..reference import dvr

END_TO_END = ("frame_ms", "frame_p95_ms")
# The faults a viewer cell can have.
FAULTS = {"stale_frame": faults.stale_frame, "half_rays": faults.half_rays,
          "altered_answer": faults.altered_answer}
# The cells on the CPU in seconds: 16^3 at 16^2.
SMALL = {"volume": [16, 16, 16], "image": [16, 16], "sampling_rate": 2.0}
WARM = 3             # frames before the window
SAMPLED = 2          # frames of the window the check compares
TRACED = 24          # frames under the profiler
WORK_FRAMES = 2      # of which K3's roofline reads the first


class Job:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        import differender_tpu_torch as P
        self.P, self.cfg, self.dev = P, cfg, torch.device(device)
        self.sync = inputs.syncer(self.dev)
        D = cfg["volume"][0]
        gen = inputs.generator(seed, 0, self.dev)
        self.vol = inputs.volume(traffic, D, gen)[None]
        self.tf = inputs.transfer_function(cfg["tf"], cfg["tf_resolution"],
                                           self.dev)
        self.phase = inputs.start_angle(inputs.generator(seed, 1, self.dev))
        self.pick = random.Random(seed)
        H, W = cfg["image"]
        self.rc = P.Raycaster(
            tuple(cfg["volume"]), (W, H), cfg["tf_resolution"],
            jitter=cfg["jitter"], max_samples=cfg["max_samples"],
            fov=cfg["fov"],
            near=cfg["near"], device=self.dev,
            **{k: cfg[k] for k in ("ambient", "diffuse", "specular",
                                   "shininess", "ert_threshold",
                                   "alpha_skip", "normal_delta")})
        self.k = 0

    def camera(self, k: int) -> torch.Tensor:
        c = self.cfg
        return inputs.orbit(self.phase + math.radians(c["orbit_deg"]) * k,
                            c["orbit_y"], c["orbit_dist"], self.dev)

    def frame(self) -> torch.Tensor:
        img = self.rc.raycast_nondiff(self.vol, self.tf, self.camera(self.k),
                                      self.cfg["sampling_rate"])
        self.k += 1
        return img

    def setup(self):
        for _ in range(WARM):
            self.frame()
        self.sync()

    def window(self, seconds: float) -> dict:
        lat, kept = [], []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            t = time.perf_counter()
            k = self.k
            img = self.frame()
            self.sync()
            lat.append(time.perf_counter() - t)
            self._keep(kept, len(lat) - 1, k, img)
        total = time.perf_counter() - t0
        self.sampled = kept
        self.attempted, self.failed = len(lat), 0
        p95 = statistics.quantiles(lat, n=20)[18] if len(lat) > 1 \
            else lat[0]
        return {"frame_ms": total / len(lat) * 1e3,
                "frame_p95_ms": p95 * 1e3}

    def _keep(self, kept, i, k, img):
        """Reservoir sampling of ``SAMPLED`` frames among those so far."""
        if len(kept) < SAMPLED:
            kept.append((k, img.clone()))
        else:
            j = self.pick.randrange(i + 1)
            if j < SAMPLED:
                kept[j] = (k, img.clone())

    def traced(self, trace_path: str):
        from .. import tracing
        kept = []
        self.work_frames = []

        def unit(i):
            if i < WORK_FRAMES:
                self.work_frames.append((i, self.k))
            k = self.k
            img = self.frame()
            self._keep(kept, i, k, img)
        tr = tracing.profile_units(unit, TRACED, self.sync, trace_path)
        self.sampled = kept
        self.attempted, self.failed = TRACED, 0
        self.trace = tr
        return tr

    def count_work(self):
        """K3's work in the traced window's first frames."""
        least = sum(work.least_seconds(*work.k3_launch_work(
            self.vol[0], self.tf, self.camera(k), self.cfg))
            for _, k in self.work_frames)
        self.trace.work["k3"] = {"steps": [i for i, _ in self.work_frames],
                                 "least_s": least}

    # -- correctness ---------------------------------------------------------

    def release(self):
        self.frame_ids = [k for k, _ in self.sampled]
        self.program = {"frames": torch.stack([img for _, img in
                                               self.sampled])}
        del self.rc, self.sampled
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, store=None) -> dict:
        store = store or (lambda x: x)
        cams = torch.stack([self.camera(k) for k in self.frame_ids])
        H, W = self.cfg["image"]
        return {"frames": dvr.render_views(
            store(self.vol[0]), store(self.tf), cams, H, W,
            self.cfg["sampling_rate"], dvr.Optics.from_config(self.cfg),
            diff=False)}

    def compare(self, got: dict, want: dict) -> dict:
        """Over the sampled frames, the widest gap of a pixel channel, and
        the mean gap of the worst frame."""
        gap = (got["frames"] - want["frames"]).abs().flatten(1)
        return {"max_gap": float(gap.max()),
                "mean_gap": float(gap.mean(1).max())}
