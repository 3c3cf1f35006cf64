"""Faults planted in the program underneath the harness, to show that the
check sees them: each factory returns a context manager that patches the
port's entry points for the length of a run.  Each job names the faults
its cells can have in its own ``FAULTS`` table (``jobs/<job>.py``), which
:func:`dvrbench.harness.faults` reads.  A benchmark run loads this module
with its job and plants nothing; the calibration and the tests plant.

* ``state_unchanged``: AdamW's step leaves the volume as it was.
* ``half_batch``: the loss takes the first half of the views and means
  over them, leaving the rest out.
* ``stale_frame``: each frame shows the view of the frame before it.
* ``half_rays``: the bottom half of each frame's rows is never rendered.
* ``altered_answer``: an 8 x 8 block of each frame is off by 0.05.
* ``tf_state_unchanged``: ``TFMomentum.step`` leaves the TF as it was.
* ``top_half_loss``: the loss takes the top half of the image's rows only.
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


def tf_state_unchanged():
    from differender_tpu_torch.optim import TFMomentum
    return _patched(TFMomentum, "step",
                    lambda orig: lambda self, closure=None: None)


def top_half_loss():
    import differender_tpu_torch as P

    def make(orig):
        def loss(pred, target):
            h = pred.shape[0] // 2
            return orig(pred[:h], target[:h])
        return loss
    return _patched(P, "mse_loss", make)
