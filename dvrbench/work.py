"""The work a march needs, counted from the inputs by the benchmark's own
plain pass, and the least time the H100 could do it in.

The per-sample operation constants are those of the kernels' bounds in the
repository's chip check (f32 operations a sample needs, transcendentals
count as one).  The counts never come from a kernel's counter, so they read
the same whatever implements the march.
"""
from __future__ import annotations

import torch

from .reference import dvr

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12        # f32 outside the tensor cores

AXIS_OPS = 7 + 1                   # clamp, scale, floor, frac; 1 - frac
PAIR_OPS = 4                       # one axis pair's 4 weight products
POINT_OPS = 8 + 15                 # 8 corner weights, weighted sum
CENTRE_OPS = 3 * AXIS_OPS + PAIR_OPS + POINT_OPS
GRADIENT_POINTS_OPS = 2 * PAIR_OPS + 6 * (AXIS_OPS + POINT_OPS)
POSITION_OPS = 8                   # t = t0 + s*dt, p = o + t*d
STENCIL_OPS = 6 + 3                # +-delta offsets, gradient differences
TF_LERP_OPS = 18
OPACITY_OPS = 4
SHADE_OPS = 59                     # normal, light, diffuse, reflection,
                                   # specular, light sum and clamp, rgb
COMPOSITE_OPS = 9                  # rgb += T*c, T *= 1-a, the ERT gate
DIFF_SAMPLE_OPS = (POSITION_OPS + CENTRE_OPS + GRADIENT_POINTS_OPS
                   + STENCIL_OPS + TF_LERP_OPS + OPACITY_OPS + SHADE_OPS
                   + COMPOSITE_OPS)
NONDIFF_VISIT_OPS = POSITION_OPS + CENTRE_OPS + TF_LERP_OPS + 2
NONDIFF_SHADE_OPS = (GRADIENT_POINTS_OPS + STENCIL_OPS + OPACITY_OPS
                     + SHADE_OPS - 1 + COMPOSITE_OPS - 1)
TF_LERP_BWD_OPS = 7 + 16 + 11 + 1 + 3
COMPOSITE_BWD_OPS = 13
SHADE_BWD_OPS = 14 + 8 + 2 + 3 + 3 + 3 + 9 + 12 + 17
SCATTER_OPS = 7 * 8 * 2 + 3
# The backward of a sample of non-zero opacity: the forward again, the
# composite's, the shading's and the TF lerp's backward, the scatter.
BWD_SAMPLE_OPS = (DIFF_SAMPLE_OPS + COMPOSITE_BWD_OPS + SHADE_BWD_OPS
                  + TF_LERP_BWD_OPS - 7 + SCATTER_OPS)
# A sample of opacity 0: its value, TF colour, opacity and composite, their
# backward to the TF; no scatter into the volume.
QUIET_SAMPLE_OPS = (POSITION_OPS + CENTRE_OPS + TF_LERP_OPS + OPACITY_OPS
                    + COMPOSITE_OPS + COMPOSITE_BWD_OPS + 8
                    + TF_LERP_BWD_OPS - 7)


def least_seconds(nops: float, nbytes: float) -> float:
    """The least time of a launch: the larger of its operations at the f32
    peak and its bytes at the HBM bandwidth."""
    return max(nbytes / HBM_BYTES_PER_S, nops / F32_FLOPS_PER_S)


@torch.no_grad()
def _alpha_pass(volume_user, tf_user, rays: dvr.Rays, sampling_rate,
                optics: dvr.Optics, limit, skip: float,
                chunk_samples: int = 1 << 24):
    """Per ray, the samples before its stop (the ERT gate on the opacity
    alone, or its limit) whose TF alpha is above ``skip`` and those at or
    below it."""
    vol = dvr.internal(volume_user)
    tf = tf_user.t().contiguous()
    dev = vol.device
    thr = float(torch.tensor(1.0 - optics.ert_threshold,
                             dtype=torch.float32))
    inv_sr = float(torch.tensor(1.0 / sampling_rate, dtype=torch.float32))
    N = rays.n.shape[0]
    T = torch.ones(N, dtype=torch.float32, device=dev)
    above = torch.zeros(N, dtype=torch.int64, device=dev)
    below = torch.zeros(N, dtype=torch.int64, device=dev)
    # A sample in a brick whose alpha cannot pass ``skip`` is below it.
    empty = dvr.transparent_bricks(vol, tf, skip)
    act = torch.nonzero(limit > 0).reshape(-1)
    base = 0
    while act.numel():
        k = int(max(4, min(1024, chunk_samples // act.numel())))
        s = base + torch.arange(k, device=dev, dtype=torch.float32)
        lim = limit[act]
        valid = s[None, :] < lim[:, None].to(torch.float32)
        t = rays.t0[act][:, None] + s[None, :] * rays.dt[act][:, None]
        pos = rays.origin[act][:, None, :] + t[..., None] \
            * rays.dirs[act][:, None, :]
        flat = pos.reshape(-1, 3)
        cand = torch.nonzero(~empty.reshape(-1)[
            dvr.brick_of(flat, vol.shape)]).reshape(-1)
        a_tf = torch.zeros(flat.shape[0], dtype=torch.float32, device=dev)
        a_tf[cand] = dvr.tf_lookup(tf, dvr.trilinear(vol, flat[cand]))[:, 3]
        a_tf = a_tf.reshape(-1, k)
        a = 1.0 - torch.pow(torch.clamp(1.0 - a_tf, min=0.0), inv_sr)
        a = torch.where(valid & (a_tf > skip), a, torch.zeros_like(a))
        trans = torch.cumprod(1.0 - a, dim=1)
        T_before = T[act][:, None] * torch.cat(
            [torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=1)
        taken = valid & (T_before > thr)
        up = taken & (a_tf > skip)
        above.index_add_(0, act, up.sum(1))
        below.index_add_(0, act, (taken & ~up).sum(1))
        T_new = T[act] * torch.prod(torch.where(taken, 1.0 - a,
                                                torch.ones_like(a)), dim=1)
        T.index_copy_(0, act, T_new)
        base += k
        act = act[(T_new > thr) & (lim > base)]
    return above, below


def k2_launch_work(volume_user, tf_user, look_from, u, cfg: dict):
    """The operations and bytes K2 needs for one view of the fitting step:
    every sample before the ray's stop, those of opacity above 0 at the
    backward's full cost, the others at a quiet sample's."""
    optics = dvr.Optics.from_config(cfg)
    H, W = cfg["image"]
    rays = dvr.camera_rays(look_from, H, W, tuple(volume_user.shape),
                           cfg["sampling_rate"], optics, u)
    limit = torch.clamp(rays.n, max=cfg["max_samples"])
    above, below = _alpha_pass(volume_user, tf_user, rays,
                               cfg["sampling_rate"], optics, limit, 0.0)
    n_above, n_below = int(above.sum()), int(below.sum())
    ops = n_above * BWD_SAMPLE_OPS + n_below * QUIET_SAMPLE_OPS
    vol_bytes = volume_user.numel() * 4
    R = tf_user.shape[1]
    nbytes = 3 * vol_bytes + R * 32 + H * W * (5 * 4 + 4) + H * W * 36
    return ops, nbytes


def k3_launch_work(volume_user, tf_user, look_from, cfg: dict):
    """The operations and bytes K3 needs for one frame: only the samples it
    composites (TF alpha above the skip, before the ray's stop), each
    visited and shaded; a sample the march can skip costs nothing here."""
    optics = dvr.Optics.from_config(cfg)
    H, W = cfg["image"]
    rays = dvr.camera_rays(look_from, H, W, tuple(volume_user.shape),
                           cfg["sampling_rate"], optics)
    above, _ = _alpha_pass(volume_user, tf_user, rays, cfg["sampling_rate"],
                           optics, rays.n, optics.alpha_skip)
    ops = int(above.sum()) * (NONDIFF_VISIT_OPS + NONDIFF_SHADE_OPS)
    R = tf_user.shape[1]
    nbytes = (volume_user.numel() * 4 + R * 16 + H * W * (5 * 4 + 4)
              + H * W * 24)
    return ops, nbytes
