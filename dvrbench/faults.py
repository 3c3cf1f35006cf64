"""Faults planted in the program underneath the harness, to show that the
check sees them: each is a context manager that patches the port's entry
points for the length of a run.  Neither the benchmark's runs nor the
program use this module; the calibration and the tests do.

* ``state_unchanged``: the optimizer's step leaves the volume as it was.
* ``half_batch``: the loss takes the first half of the views and means
  over them, leaving the rest out.
* ``stale_frame``: each frame shows the view of the frame before it.
* ``half_rays``: the bottom half of each frame's rows is never rendered.
* ``altered_answer``: an 8 x 8 block of each frame is off by 0.05.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(obj, name, make):
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def state_unchanged():
    return _patched(torch.optim.AdamW, "step",
                    lambda orig: lambda self, closure=None: None)


def half_batch():
    import differender_tpu_torch as P

    def make(orig):
        def loss(pred, target, *a, **k):
            h = max(1, pred.shape[0] // 2)
            return orig(pred[:h], target[:h], *a, **k)
        return loss
    return _patched(P, "dssim_mse_loss", make)


def stale_frame():
    import differender_tpu_torch as P
    last = {}

    def make(orig):
        def render(self, *a, **k):
            img = orig(self, *a, **k)
            prev = last.get("img", img)
            last["img"] = img
            return prev
        return render
    return _patched(P.Raycaster, "raycast_nondiff", make)


def half_rays():
    import differender_tpu_torch as P

    def make(orig):
        def render(self, *a, **k):
            img = orig(self, *a, **k).clone()
            img[..., img.shape[-2] // 2:, :] = 0.0
            return img
        return render
    return _patched(P.Raycaster, "raycast_nondiff", make)


def altered_answer():
    import differender_tpu_torch as P

    def make(orig):
        def render(self, *a, **k):
            img = orig(self, *a, **k).clone()
            img[..., :8, :8] += 0.05
            return img
        return render
    return _patched(P.Raycaster, "raycast_nondiff", make)


# The faults that each job's cells can have.
FAULTS = {
    "volfit": {"state_unchanged": state_unchanged, "half_batch": half_batch},
    "viewer": {"stale_frame": stale_frame, "half_rays": half_rays,
               "altered_answer": altered_answer},
}
