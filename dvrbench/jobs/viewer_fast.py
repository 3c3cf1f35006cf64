"""The viewer job through the shear-warp fast path: frames of one volume
from a camera that orbits it, each through ``Raycaster.raycast_fast`` at
the configuration's ``intermediate`` and ``planes_per_voxel`` (the slab
frame, one K8 launch, the warp), in the viewer's closed loop: a frame is
issued when the one before it is on the host.

The loop, the window, the reservoir of sampled frames, the traced frames
and the check's numbers are the viewer job's (:mod:`dvrbench.jobs.viewer`);
the reference is the shear-warp's own (:mod:`dvrbench.reference.
shearwarp`), since the slab quadrature is not the ray march's.
"""
from __future__ import annotations

import random

import torch

from .. import faults, inputs, work, work_fast
from ..reference import dvr, shearwarp
from . import viewer

END_TO_END = viewer.END_TO_END


def _frames_edited(edit):
    """Patches ``Raycaster.raycast_fast`` so that each frame it returns
    passes through ``edit``."""
    import differender_tpu_torch as P

    def make(orig):
        def render(self, *a, **k):
            return edit(orig(self, *a, **k))
        return render
    return faults._patched(P.Raycaster, "raycast_fast", make)


def stale_frame():
    """Each frame shows the view of the frame before it."""
    last = {}

    def edit(img):
        prev = last.get("img", img)
        last["img"] = img
        return prev
    return _frames_edited(edit)


def half_rays():
    """The bottom half of each frame's rows is never rendered."""
    def edit(img):
        img = img.clone()
        img[..., img.shape[-2] // 2:, :] = 0.0
        return img
    return _frames_edited(edit)


def altered_answer():
    """An 8 x 8 block of each frame is off by 0.05."""
    def edit(img):
        img = img.clone()
        img[..., :8, :8] += 0.05
        return img
    return _frames_edited(edit)


def half_planes():
    """Each frame marches half the planes the configuration asks for: the
    cut of the quadrature that a faster frame could make."""
    import differender_tpu_torch as P

    def make(orig):
        def render(self, volume, tf, look_from, intermediate=None,
                   planes_per_voxel=2.0):
            return orig(self, volume, tf, look_from, intermediate,
                        planes_per_voxel / 2)
        return render
    return faults._patched(P.Raycaster, "raycast_fast", make)


# The faults a fast viewer cell can have.
FAULTS = {"stale_frame": stale_frame, "half_rays": half_rays,
          "altered_answer": altered_answer, "half_planes": half_planes}
# The cells on the CPU in seconds: 16^3 at 16^2 from a 24^2 intermediate.
SMALL = {"volume": [16, 16, 16], "image": [16, 16], "intermediate": 24}


class Job(viewer.Job):
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
            jitter=False, fov=cfg["fov"], near=cfg["near"], device=self.dev,
            **{k: cfg[k] for k in ("ambient", "diffuse", "specular",
                                   "shininess", "ert_threshold")})
        self.k = 0

    def frame(self) -> torch.Tensor:
        img = self.rc.raycast_fast(self.vol, self.tf, self.camera(self.k),
                                   self.cfg["intermediate"],
                                   self.cfg["planes_per_voxel"])
        self.k += 1
        return img

    def count_work(self):
        """K8's work in the traced window's first frames."""
        least = sum(work.least_seconds(*work_fast.k8_launch_work(
            self.vol[0], self.tf, self.camera(k), self.cfg))
            for _, k in self.work_frames)
        self.trace.work["k8"] = {"steps": [i for i, _ in self.work_frames],
                                 "least_s": least}

    def reference(self, store=None) -> dict:
        store = store or (lambda x: x)
        cams = torch.stack([self.camera(k) for k in self.frame_ids])
        H, W = self.cfg["image"]
        return {"frames": shearwarp.render_views(
            store(self.vol[0]), store(self.tf), cams, H, W,
            self.cfg["intermediate"], self.cfg["planes_per_voxel"],
            dvr.Optics.from_config(self.cfg))}
