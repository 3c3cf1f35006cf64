"""The TF fit's faults, planted in the program underneath the harness as
those of :mod:`dvrbench.faults` are, and the size at which the tests run
its cells on the CPU.  Neither the benchmark's runs nor the program use
this module; the tests do (``dvrbench/conftest.py`` adds both tables to
the harness tests' own).

* ``state_unchanged``: ``TFMomentum.step`` leaves the TF as it was.
* ``top_half_loss``: the loss takes the top half of the image's rows only.
"""
from __future__ import annotations

from .faults import _patched


def state_unchanged():
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


FAULTS = {"tffit": {"state_unchanged": state_unchanged,
                    "top_half_loss": top_half_loss}}

# The job's cells on the CPU in seconds: 16^3, 12^2, 16 texels, fits of 4
# steps.
SMALL = {"tffit": {"volume": [16, 16, 16], "image": [12, 12],
                   "tf_resolution": 16, "iterations": 4}}
