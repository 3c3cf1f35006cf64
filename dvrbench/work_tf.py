"""The work K2 needs for a TF gradient alone (the transfer-function fit's
backward: the volume and the camera need no gradient), counted from the
inputs by :mod:`work`'s own pass and from its constants.

Against :func:`work.k2_launch_work` (the volume fit's full backward): a
sample of opacity above 0 costs no scatter into the volume and no
cotangent of its gradient, and no ``d_volume`` is read or written.  The
gradient points stay, since they feed the light and so the TF colour's
cotangent.  So the count reads the same whatever K2 does; a K2 that also
computes the volume's gradient reads lower against it.
"""
from __future__ import annotations

import torch

from . import work
from .reference import dvr

# The shading's backward as far as the TF colour: d of the TF colour and of
# light * alpha (14), and of alpha through the opacity correction (8).  The
# rest of work.SHADE_BWD_OPS (the light clamp, the specular power, r.v, the
# reflection, n.l, the normal and the unit normal's VJP) reaches only the
# gradient, so only the volume.
SHADE_BWD_TF_OPS = 14 + 8
# A sample of opacity above 0: the forward again, the composite's backward,
# the shading's to the TF colour and the TF lerp's; no scatter.
TF_BWD_SAMPLE_OPS = (work.DIFF_SAMPLE_OPS + work.COMPOSITE_BWD_OPS
                     + SHADE_BWD_TF_OPS + work.TF_LERP_BWD_OPS - 7)


def k2_tf_launch_work(volume_user, tf_user, look_from, sampling_rate,
                      cfg: dict):
    """The operations and bytes of one TF-only K2 launch for one view:
    every sample before the ray's stop, those of opacity above 0 at
    ``TF_BWD_SAMPLE_OPS``, the others at a quiet sample's; the volume, the
    TF and its gradient, and the per-pixel state (rays, image, cotangent,
    counts), each once."""
    optics = dvr.Optics.from_config(cfg)
    H, W = cfg["image"]
    rays = dvr.camera_rays(look_from, H, W, tuple(volume_user.shape),
                           sampling_rate, optics)
    limit = torch.clamp(rays.n, max=cfg["max_samples"])
    above, below = work._alpha_pass(volume_user, tf_user, rays,
                                    sampling_rate, optics, limit, 0.0)
    ops = (int(above.sum()) * TF_BWD_SAMPLE_OPS
           + int(below.sum()) * work.QUIET_SAMPLE_OPS)
    R = tf_user.shape[1]
    nbytes = (volume_user.numel() * 4 + R * 32 + H * W * (5 * 4 + 4)
              + H * W * 36)
    return ops, nbytes
