"""The work K8 (the shear-warp slab march) needs for one frame, counted by
the shear-warp reference's own pass (:mod:`reference.shearwarp`) and from
the constants below, never from a kernel's counter: so it reads the same
whatever implements the march.

Operations: each in-footprint sample before its intermediate pixel's stop
(the gate on T) at ``SAMPLE_OPS``, and the z-lerp of each slab texel that
those samples' taps read with a weight that is not 0, at ``ZLERP_OPS``.
Bytes: the voxel-layer texels those slab texels are lerped from, each read
once at 16 bytes (intensity and gradient), the per-pixel exponent, the TF
and the ``O x O`` RGBA image.
"""
from __future__ import annotations

import torch

from . import work
from .reference import dvr, shearwarp

# The per-sample operations of the slab march (f32 operations a sample
# needs, transcendentals count as one): the plane's position, the ray's
# crossing and the two source coordinates (11); each axis's taps (floor,
# frac, the inside test, the clamps, 1 - frac, two selects: 13 each);
# three 4-channel lerps and the coverage (39); the TF lerp; the shading
# (the unit normal 12, the light direction 14, n.l 5, diffuse 3, the
# reflection 7, the view direction 14, r.v 6, the specular power 4, the
# light and its clamp 3: 68); the opacity correction and the premultiplied
# colour (11); the composite and the gate (9).
SHADE_OPS = 68
SAMPLE_OPS = 11 + 2 * 13 + 39 + work.TF_LERP_OPS + SHADE_OPS + 11 + 9
# A slab texel's z-lerp from its two voxel layers: 4 channels, two
# products and a sum each.
ZLERP_OPS = 12


def _reads(t: shearwarp.Taps, size: int) -> torch.Tensor:
    """``(n, size)`` float64, 1 where position ``i`` reads texel ``j`` with
    a weight that is not 0."""
    m = torch.zeros((t.lo.shape[0], size), dtype=torch.float64,
                    device=t.lo.device)
    m.scatter_add_(1, t.lo[:, None], (t.w_lo != 0).double()[:, None])
    m.scatter_add_(1, t.hi[:, None], (t.w_hi != 0).double()[:, None])
    return (m > 0).double()


@torch.no_grad()
def k8_launch_work(volume_user, tf_user, look_from, cfg: dict):
    """The operations and bytes of one K8 launch for one frame."""
    optics = dvr.Optics.from_config(cfg)
    vol = dvr.internal(volume_user.to(torch.float32))
    tf = tf_user.to(torch.float32).t().contiguous()
    frame = shearwarp.slab_frame(vol, look_from)
    g = shearwarp.grid(frame, cfg["intermediate"], cfg["planes_per_voxel"])
    _, X, Y, Z = frame.channels.shape
    zlo, zhi, fz = g.zlo.tolist(), g.zhi.tolist(), g.fz.tolist()
    layers = torch.zeros((Z, X, Y), dtype=torch.bool, device=vol.device)
    count = {"samples": 0, "slab_texels": 0}     # summed on the device

    def visit(s, tx, ty, alive):
        live = alive & tx.inside[:, None] & ty.inside[None, :]
        count["samples"] += live.sum()
        cols = (live.double() @ _reads(ty, Y)) > 0         # (O, Y)
        need = (_reads(tx, X).t() @ cols.double()) > 0     # (X, Y)
        count["slab_texels"] += need.sum()
        layers[zlo[s]] |= need
        if fz[s] != 0.0:
            layers[zhi[s]] |= need

    shearwarp.intermediate(frame, tf, g, optics, visit)
    O = cfg["intermediate"]
    ops = (int(count["samples"]) * SAMPLE_OPS
           + int(count["slab_texels"]) * ZLERP_OPS)
    nbytes = int(layers.sum()) * 16 + O * O * (4 + 16) + tf.shape[0] * 16
    return ops, nbytes
