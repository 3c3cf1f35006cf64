"""The ray-march renderer (counterpart of ``differender_tpu/render.py``).

``march_diff`` is a ``torch.autograd.Function``: on CUDA tensors its forward
is kernel K1 (``march_diff_fwd``, ``csrc/march.cu``) and its backward kernel
K2 (``march_diff_bwd``, ``csrc/march_bwd.cu``), which recomputes the march
and scatters ``d_volume`` and ``d_tf``.  ``march_nondiff`` is kernel K3
(``csrc/march.cu``), which jumps over empty space through an occupancy grid
(:mod:`~differender_tpu_torch.occupancy`) when it is given one.  On CPU
tensors each takes its plain sequential version
beside it, which the tests hold against the JAX package and
``chip_smoke.py`` holds the kernels against on the card; the plain
differentiable march is differentiated by autograd.  Every version marches
each ray front to back and carries the transmittance ``T``
multiplicatively: a step composites while ``T > f32(1 - ert_threshold)``,
and the image alpha is ``1 - T``.  ``config.analytic_normals`` selects the
gradient of every march: the 7-point central-difference stencil, or the
analytic in-cell gradient of the centre's 8 corners.  Gradients flow to the
volume and the TF, and to the camera where ``look_from`` requires grad (as
JAX's functional AD gives them): on CUDA through K2's per-ray position sums
(its camera instantiation) and autograd of the ray setup, on the CPU
through autograd of the plain march.  ``march_diff`` also takes a bundle of
V views of one volume and TF (:func:`render_batch`): one K1 launch with the
view in its launch grid's z axis, and a K2 launch a view adding into one
``d_volume`` and one ``d_tf``.

K1 and K2 also march one X-slab of a sharded volume in their segment
instantiations (a :class:`Segment` in ``MarchArgs``), which
``parallel.volume_sharding`` launches.

The JAX package's large-scale entry points run on the same kernels: row
strips (:func:`render_strips`, :func:`render_nondiff_strips`) and rays
sorted by predicted depth into chunks (:func:`render_depth_sorted`) are
one launch per strip or chunk, each ray marching as it would in one launch;
:func:`choose_diff_renderer` is the JAX package's scene policy over them,
and :func:`value_and_grad_blockwise` its refusals over
:func:`value_and_grad_render`.
"""
from __future__ import annotations

import contextlib
import ctypes
import math
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _build
from .config import RenderConfig
from .geometry import RayBundle, make_rays, march_params
from .occupancy import build_occupancy, cell_index, jump_steps
from .ops.bricks import grid_shape
from .profiling import span
from .sampling import (apply_tf, march_tf, sample_with_gradient,
                       sample_with_gradient_analytic, trilinear, voxel_coords,
                       voxel_scale)
from .shading import shade


class RenderOutput(NamedTuple):
    image: torch.Tensor        # (H, W, 4) RGBA, row 0 = image top
    valid_steps: torch.Tensor  # (H, W) int32: 1 + composited samples
    n_samples: torch.Tensor    # (H, W) int32 per-ray sample count

    @property
    def max_valid_steps(self) -> torch.Tensor:
        return torch.max(self.valid_steps - 1)


def _ert_threshold(config: RenderConfig) -> float:
    """The transmittance gate ``f32(1 - ert_threshold)``."""
    return float(np.float32(1.0 - config.ert_threshold))


class RaySoA(NamedTuple):
    """Flat ray state of a march: sample ``s`` of ray ``i`` sits at
    ``origin + (t0[i] + s * dt[i]) * dirs[i]``.  Differentiable in
    ``origin``, ``dirs``, ``t0`` and ``dt`` where the bundle was."""
    origin: torch.Tensor   # (3,)
    dirs: torch.Tensor     # (H*W, 3)
    t0: torch.Tensor       # (H*W,)
    dt: torch.Tensor       # (H*W,)
    n: torch.Tensor        # (H*W,) int32 sample count


def _ray_soa(rays: RayBundle) -> RaySoA:
    with span("dr.rays.soa"):
        params = march_params(rays)
        n = rays.n_samples.numel()
        return RaySoA(rays.origin.to(torch.float32), rays.dirs.reshape(n, 3),
                      params.t0.reshape(n), params.dt.reshape(n),
                      rays.n_samples.reshape(n))


def _sampler(config: RenderConfig):
    """The value-and-gradient sampler of the config's normal mode."""
    return (sample_with_gradient_analytic if config.analytic_normals
            else sample_with_gradient)


def _check_grid(occupancy, config) -> None:
    """Raises unless ``occupancy`` (if any) is the macrocell grid of the
    config's volume."""
    if occupancy is not None and (
            occupancy.cell < 1 or tuple(occupancy.shape)
            != grid_shape(config.volume_shape, occupancy.cell)):
        raise ValueError(f"occupancy grid {tuple(occupancy.shape)} at cell "
                         f"{occupancy.cell} does not fit a volume of "
                         f"{tuple(config.volume_shape)}")


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _plain_march(volume, tf, rays, config, sampling_rate, limit, ert,
                 nondiff, occupancy=None, taps=None):
    """Sequential march over the rays still alive; returns the flat
    composite ``(rgb, T)`` and per-ray counts ``(visited, composited)``.
    Each ray carries its own step index ``s``.  With an ``occupancy`` grid
    (inference march only) a ray jumps at its head as kernel K3 does: at
    every ``occupancy_jump_every``-th iteration, unless its last sample
    composited.  Out of place, so autograd differentiates it when the volume
    or the TF requires grad (the differentiable path's TF is
    :func:`march_tf`).  For the inference march it also counts, per ray, the
    visited samples whose centre cell's low voxel indices differ from the
    previous visited sample's, the first included: kernel K3's cell loads
    (else that count is None).

    ``taps`` (differentiable march only), a list, receives per iteration
    ``(rays, s, pos, z)``: the rays stepped, their step indices and
    positions, and five zero tensors that the march adds to the sample's
    position, value, gradient, the position in its light direction and its
    view direction; their gradients are those quantities' cotangents
    (:func:`march_diff_cotangents_plain`).  Adding zeros changes no
    value."""
    origin, dirs, t0, dt, _ = _ray_soa(rays)
    sample = _sampler(config)
    N = dirs.shape[0]
    dev = volume.device
    thr = _ert_threshold(config)
    skip = float(np.float32(config.alpha_skip))
    every = max(1, config.occupancy_jump_every)
    T = torch.ones(N, dtype=torch.float32, device=dev)
    rgb = torch.zeros(N, 3, dtype=torch.float32, device=dev)
    visited = torch.zeros(N, dtype=torch.int32, device=dev)
    composited = torch.zeros(N, dtype=torch.int32, device=dev)
    s = torch.zeros(N, dtype=torch.int32, device=dev)
    look = torch.full((N,), occupancy is not None, device=dev)
    if nondiff:
        cell_loads = torch.zeros(N, dtype=torch.int32, device=dev)
        cell_key = torch.full((N, 3), -1, dtype=torch.int64, device=dev)
    idx = torch.arange(N, device=dev)
    it = 0
    while True:
        alive = limit[idx] > s[idx]
        if ert:
            alive &= T.detach()[idx] > thr
        idx = idx[alive]
        if occupancy is not None and it % every == 0 and idx.numel():
            j = idx[look[idx]]
            tj = t0[j] + s[j].to(torch.float32) * dt[j]
            pj = origin + tj[:, None] * dirs[j]
            adv = jump_steps(occupancy, config.volume_shape, pj[:, 0],
                             pj[:, 1], pj[:, 2], dt[j])
            s[j] += torch.minimum(adv, limit[j] - s[j])
            idx = idx[limit[idx] > s[idx]]
        if idx.numel() == 0:
            break
        visited[idx] += 1
        t = t0[idx] + s[idx].to(torch.float32) * dt[idx]
        pos = origin + t[:, None] * dirs[idx]
        if nondiff:
            low = torch.floor(voxel_coords(pos, config.volume_shape)).long()
            cell_loads[idx] += (low != cell_key[idx]).any(-1).to(torch.int32)
            cell_key[idx] = low
            rgba = apply_tf(tf, trilinear(volume, pos))
            keep = rgba[:, 3] > skip
            if occupancy is not None:
                look[idx] = ~keep
            rgba, pos, on = rgba[keep], pos[keep], idx[keep]
            _, grad = sample(volume, pos, config.normal_delta)
            light_pos, view = pos, dirs[on]
        else:
            on, view = idx, dirs[idx]
            if taps is not None:
                pos, view, z = _tap(taps, idx, s[idx], pos, view)
            intensity, grad = sample(volume, pos, config.normal_delta)
            light_pos = pos
            if taps is not None:
                intensity, grad, light_pos = (intensity + z[0], grad + z[1],
                                              pos + z[2])
            rgba = march_tf(tf, intensity)
        shaded = shade(light_pos, grad, rgba, view, origin, sampling_rate,
                       config, clamp_light=not nondiff)
        Ti = T[on]
        rgb = rgb.index_add(0, on, Ti[:, None] * shaded[:, :3])
        T = T.index_copy(0, on, Ti * (1.0 - shaded[:, 3]))
        composited[on] += 1
        s[idx] += 1
        it += 1
    return rgb, T, visited, composited, cell_loads if nondiff else None


def march_diff_plain(volume: torch.Tensor, tf: torch.Tensor,
                     rays: RayBundle, config: RenderConfig, sampling_rate,
                     ert: bool = True):
    """Plain torch differentiable-path march.  Marches samples
    ``s < min(n, max_samples)`` with the headlight clamped; returns
    ``(image (H, W, 4), valid_steps (H, W) int32)``.  Autograd
    differentiates it through the shading and TF rules of
    :mod:`~differender_tpu_torch.shading` and
    :mod:`~differender_tpu_torch.sampling`: it is K2's oracle, not a
    hand-derived backward."""
    H, W = config.image_shape
    limit = torch.clamp(rays.n_samples.reshape(-1), max=config.max_samples)
    rgb, T, _, comp, _ = _plain_march(volume, tf, rays, config,
                                      sampling_rate, limit, ert,
                                      nondiff=False)
    image = torch.cat([rgb, (1.0 - T)[:, None]], dim=-1).reshape(H, W, 4)
    return image, (comp + 1).reshape(H, W)


def _plain_views(plain, tally, volume, tf, rays, views, *args):
    """``plain(volume, tf, rays, *args)``, a plain march, of one view's
    bundle (``views`` None), or of each of a bundle's ``views`` views in
    turn over the one volume and TF with the outputs stacked and the views
    counted in the tally ``tally``."""
    if views is None:
        return plain(volume, tf, rays, *args)
    outs = [plain(volume, tf, _view_rays(rays, v), *args)
            for v in range(views)]
    _build.count(tally, views)
    return tuple(torch.stack(o) for o in zip(*outs))


class SampleCotangents(NamedTuple):
    """Per sample of a differentiable march (M samples), the cotangents
    that K2's camera instantiation sums per ray."""
    ray: torch.Tensor       # (M,) int64 flat ray index
    s: torch.Tensor         # (M,) int32 step index
    pos: torch.Tensor       # (M, 3) position o + (t0 + s*dt) d
    d_pos: torch.Tensor     # (M, 3) the position's whole cotangent
    d_value: torch.Tensor   # (M,) the sampled value's
    d_grad: torch.Tensor    # (M, 3) the sampled gradient's
    d_light: torch.Tensor   # (M, 3) the position's in the light direction
                            # p - (o + (0, 1, 0)) alone
    d_view: torch.Tensor    # (M, 3) the view direction's (the ray's dirs)


def march_diff_cotangents_plain(volume: torch.Tensor, tf: torch.Tensor,
                                rays: RayBundle, config: RenderConfig,
                                sampling_rate, grad: torch.Tensor,
                                ert: bool = True) -> SampleCotangents:
    """Autograd of :func:`march_diff_plain` for the image cotangent
    ``grad`` (H, W, 4), taken at each sample (the ``taps`` of the plain
    march): the plain version of K2's per-ray position sums
    (:func:`ray_sums`).  Neither is exported: they are the oracle that the
    tests and ``chip_smoke.py`` hold K2's camera sums to, ray by ray."""
    limit = torch.clamp(rays.n_samples.reshape(-1), max=config.max_samples)
    taps = []
    with torch.enable_grad():
        rgb, T, _, _, _ = _plain_march(volume, tf, rays, config,
                                       sampling_rate, limit, ert,
                                       nondiff=False, taps=taps)
        image = torch.cat([rgb, (1.0 - T)[:, None]], dim=-1)
        return tap_cotangents(image, taps, grad)


def tap_cotangents(image: torch.Tensor, taps, grad: torch.Tensor
                   ) -> SampleCotangents:
    """The :class:`SampleCotangents` of a plain march's ``taps`` for the
    cotangent ``grad`` of its flat composite ``image`` (N, 4)."""
    if not taps:          # no ray meets the volume
        e = image.new_zeros((0, 3))
        return SampleCotangents(e[:, 0].long(), e[:, 0].int(), e, e,
                                e[:, 0], e, e, e)
    leaves = [z for tap in taps for z in tap[3]]
    got = torch.autograd.grad(image, leaves, grad.reshape(-1, 4),
                              allow_unused=True)
    cots = [torch.cat([torch.zeros_like(z) if g is None else g
                       for z, g in zip(leaves[k::5], got[k::5])])
            for k in range(5)]
    ray, s, pos = (torch.cat([tap[i] for tap in taps]) for i in range(3))
    return SampleCotangents(ray, s, pos, *cots)


def _tap(taps, idx, s, pos, view):
    """Records one step of a plain march in ``taps`` (see
    :func:`_plain_march`) and returns its position and view direction with
    their zero leaves added, and the leaves of the value, the gradient and
    the light position."""
    m = idx.numel()
    z = [torch.zeros(shape, dtype=torch.float32, device=pos.device,
                     requires_grad=True)
         for shape in ((m, 3), (m,), (m, 3), (m, 3), (m, 3))]
    taps.append((idx, s.clone(), pos.detach(), z))
    return pos + z[0], view + z[4], z[1:4]


def ray_sums(cot: SampleCotangents, image_shape) -> torch.Tensor:
    """K2's 12 per-ray sums from per-sample cotangents, (H, W, 12):
    ``P = sum d_pos``, ``S = sum s * d_pos``, ``L = sum d_light`` and
    ``V = sum d_view``."""
    H, W = image_shape
    out = torch.zeros((H * W, 12), dtype=torch.float32,
                      device=cot.d_pos.device)
    s = cot.s.to(torch.float32)[:, None]
    terms = torch.cat([cot.d_pos, s * cot.d_pos, cot.d_light, cot.d_view],
                      -1)
    return out.index_add_(0, cot.ray, terms).reshape(H, W, 12)


def ray_cotangents(sums: torch.Tensor, dirs: torch.Tensor, t0: torch.Tensor,
                   dt: torch.Tensor, views: Optional[int] = None):
    """The cotangents of a march's ray tensors from K2's per-ray sums
    ``sums`` (N, 12) (:func:`ray_sums`): sample ``s`` sits at ``o + (t0 +
    s*dt) d``, its light at ``o + (0, 1, 0)``, and shading's view direction
    is ``d``.  Returns ``(d_origin (3,), d_dirs (N, 3), d_t0 (N,),
    d_dt (N,))``: ``sum (P - L)``, ``t0 P + dt S + V``, ``d.P`` and
    ``d.S``.  For the rays of ``views`` views (view-major), ``d_origin``
    is (views, 3): each view's sum over its own rays."""
    P, S, L, V = sums.reshape(-1, 12).split(3, dim=-1)
    d_origin = ((P - L).sum(0) if views is None
                else (P - L).reshape(views, -1, 3).sum(1))
    d_dirs = t0[:, None] * P + dt[:, None] * S + V
    return (d_origin, d_dirs, (dirs * P).sum(-1), (dirs * S).sum(-1))


@torch.no_grad()
def march_nondiff_plain(volume: torch.Tensor, tf: torch.Tensor,
                        rays: RayBundle, config: RenderConfig,
                        sampling_rate, occupancy=None, *,
                        cell_loads: Optional[torch.Tensor] = None):
    """Plain torch inference march.  No ``max_samples`` cap; a sample
    composites only if its TF alpha is ``> alpha_skip``; no light clamp;
    the image ends with ``min(1, .)``.  With an ``occupancy`` grid
    (:class:`~differender_tpu_torch.occupancy.OccupancyGrid` of this volume
    and TF) each ray jumps over samples that provably classify at or below
    ``alpha_skip``, as K3 does; the image does not change.  Returns
    ``(image (H, W, 4), visited (H, W), composited (H, W))``: the samples
    each ray evaluated and the samples it composited.  ``cell_loads``, an
    (H, W) int32 tensor beside the volume, receives per ray the visited
    samples whose centre cell differs from the previous visited sample's
    (the first included): the cell loads K3 counts."""
    H, W = config.image_shape
    _check_grid(occupancy, config)
    limit = rays.n_samples.reshape(-1)
    rgb, T, vis, comp, loads = _plain_march(
        volume, tf, rays, config, sampling_rate, limit, ert=True,
        nondiff=True, occupancy=occupancy)
    if cell_loads is not None:
        _build.output("cell_loads", cell_loads, volume.device,
                      config.image_shape).copy_(loads.reshape(H, W))
    image = torch.cat([rgb, (1.0 - T)[:, None]], dim=-1)
    image = torch.clamp(image, max=1.0).reshape(H, W, 4)
    return image, vis.reshape(H, W), comp.reshape(H, W)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

class _MarchArgs(ctypes.Structure):
    """Mirror of ``struct MarchArgs`` in ``csrc/march_common.cuh``."""
    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "dx", "dy", "dz", "t0", "dt", "n", "volume", "tf", "origin",
        "image", "steps", "shaded", "occ", "occ_far", "counts")]
        + [(f, ctypes.c_int) for f in (
            "H", "W", "X", "Y", "Z", "R", "max_steps", "ert",
            "nx", "ny", "nz", "cell", "jump_every")]
        + [(f, ctypes.c_float) for f in (
            "scale_x", "scale_y", "scale_z", "delta", "inv_sr", "thr",
            "ambient", "diffuse", "specular", "shininess",
            "lc_r", "lc_g", "lc_b", "alpha_skip", "cell_world",
            "sc_x", "sc_y", "sc_z")]
        + [("analytic", ctypes.c_int), ("s_lo", ctypes.c_void_p)]
        + [(f, ctypes.c_int) for f in ("length", "x_start", "Xp")]
        + [(f, ctypes.c_float) for f in ("x_lo", "x_hi")])


class Segment(NamedTuple):
    """The march over one X-slab of a volume sharded along X, the operands
    of K1's and K2's segment instantiations (``MarchArgs.s_lo`` and after):
    the volume is the shard's padded block, global x planes ``[x_start,
    x_start + Xp)``; ray ``i`` marches the steps ``s_lo[i] + j`` for
    ``j < length`` and composites those whose voxel coordinate ``c_x`` lies
    in ``[x_lo, x_hi)`` (``parallel.volume_sharding``)."""
    s_lo: torch.Tensor    # (H*W,) int32
    length: int
    x_start: int
    x_lo: float
    x_hi: float


class _MarchBwdArgs(ctypes.Structure):
    """Mirror of ``struct MarchBwdArgs`` in ``csrc/march_bwd.cu``."""
    _fields_ = [("f", _MarchArgs)] + [(f, ctypes.c_void_p) for f in (
        "grad", "d_volume", "d_tf", "ray_sums")]


def _occupancy_args(occupancy, config, dev):
    """The grid's fields of ``MarchArgs`` (a null grid: no skip): its
    distance field, the field's largest value (on the device: K3 reads it),
    the ints and ``cell_world``."""
    if occupancy is None:
        return None, None, (0, 0, 0, 1, 1), 0.0
    nx, ny, nz = occupancy.shape
    dist = _build.operand("occupancy.dist", occupancy.dist, dev,
                          (nx * ny * nz,), torch.int32)
    ints = (nx, ny, nz, occupancy.cell, max(1, config.occupancy_jump_every))
    far = _build.operand("occupancy.far", occupancy.far, dev, (1,),
                         torch.int32)
    return dist, far, ints, float(np.float32(occupancy.cell_world))


def _march_args(volume, tf, soa, config, sampling_rate, ert, max_steps,
                image, steps, shaded=None, occupancy=None, counts=None,
                segment=None, views=None):
    """Validate the operands and fill ``MarchArgs`` for the rays ``soa``
    (:class:`RaySoA`); with a :class:`Segment`, those of the segment
    instantiations (``volume`` the shard's padded block; parity, no ERT);
    with ``views``, K1's or K3's rays of that many views, view-major
    (``origin`` (views, 3), ``image`` (views, H, W, 4)).  Returns the
    struct and the tensors it points into, which the caller keeps
    referenced until the launch is enqueued (the caching allocator keeps
    their memory for the stream after that)."""
    dev = volume.device
    H, W = config.image_shape
    lead = () if views is None else (views,)
    N = H * W * (views or 1)
    X, Y, Z = config.volume_shape
    if segment is None:
        volume = _build.operand("volume", volume, dev, config.volume_shape)
        s_lo, seg = None, (0, 0, 0, 0.0, 0.0)
    else:
        Xp = volume.shape[0]
        volume = _build.operand("padded volume", volume, dev, (Xp, Y, Z))
        s_lo = _build.operand("s_lo", segment.s_lo, dev, (H * W,),
                              torch.int32)
        seg = (segment.length, segment.x_start, Xp, segment.x_lo,
               segment.x_hi)
        ert = False
    if tf.ndim != 2 or tf.shape[1] != 4 or tf.shape[0] < 1:
        raise ValueError(f"tf must be (R, 4); got {tuple(tf.shape)}")
    tf = _build.operand("tf", tf, dev)
    origin = _build.operand("look_from", soa.origin, dev, lead + (3,))
    dirs = _build.operand("ray dirs", soa.dirs, dev, (N, 3))
    dx, dy, dz = (dirs[:, i].contiguous() for i in range(3))
    t0 = _build.operand("t0", soa.t0, dev, (N,))
    dt = _build.operand("dt", soa.dt, dev, (N,))
    n = _build.operand("n_samples", soa.n, dev, (N,), torch.int32)
    image = _build.operand("image", image, dev, lead + (H, W, 4))
    scale = voxel_scale(config.volume_shape)
    sc = np.float32(config.normal_delta) * scale
    lc = config.light_color
    dist, far, occ_ints, cell_world = _occupancy_args(occupancy, config,
                                                      dev)
    args = _MarchArgs(
        dx.data_ptr(), dy.data_ptr(), dz.data_ptr(), t0.data_ptr(),
        dt.data_ptr(), n.data_ptr(), volume.data_ptr(), tf.data_ptr(),
        origin.data_ptr(), image.data_ptr(), steps.data_ptr(),
        shaded.data_ptr() if shaded is not None else None,
        dist.data_ptr() if dist is not None else None,
        far.data_ptr() if far is not None else None,
        counts.data_ptr() if counts is not None else None,
        H, W, X, Y, Z, tf.shape[0], max_steps, int(ert), *occ_ints,
        float(scale[0]), float(scale[1]), float(scale[2]),
        float(np.float32(config.normal_delta)),
        float(np.float32(1.0) / np.float32(sampling_rate)),
        _ert_threshold(config), config.ambient, config.diffuse,
        config.specular, config.shininess, lc[0], lc[1], lc[2],
        config.alpha_skip, cell_world, float(sc[0]), float(sc[1]),
        float(sc[2]), int(config.analytic_normals and segment is None),
        s_lo.data_ptr() if s_lo is not None else None, *seg)
    return args, (volume, tf, origin, dx, dy, dz, t0, dt, n, image, dist,
                  far, s_lo)


def _launch_march(volume, tf, soa, config, sampling_rate, ert,
                  counts=None, segment=None, views=None):
    """Allocate the outputs and call K1 (its segment instantiation with a
    :class:`Segment`) inside the caller's ``_build.launch`` block, on the
    rays of ``views`` views (view-major; each output gains a leading
    ``views``) where given; ``counts`` (if given) receives its per-ray
    counts."""
    shape = ((views,) if views else ()) + tuple(config.image_shape)
    dev = volume.device
    image = torch.empty(shape + (4,), dtype=torch.float32, device=dev)
    steps = torch.empty(shape, dtype=torch.int32, device=dev)
    args, keep = _march_args(volume, tf, soa, config, sampling_rate, ert,
                             config.max_samples, image, steps, counts,
                             segment=segment, views=views)
    _build.call("dr_march_diff_fwd", ctypes.byref(args), views or 1,
                like=keep[0])
    return image, steps


def march_diff_fwd(volume: torch.Tensor, tf: torch.Tensor, rays: RayBundle,
                   config: RenderConfig, sampling_rate, ert: bool = True, *,
                   counts: Optional[torch.Tensor] = None):
    """Kernel K1 on CUDA tensors (one launch), :func:`march_diff_plain` on
    CPU tensors.  Returns ``(image (H, W, 4), valid_steps (H, W))``; no
    autograd.
    ``counts``, an (H, W, 2) int32 tensor beside the volume, receives two
    counts per ray: the samples of opacity exactly 0, which K1 composites
    without their gradient and shading, and the samples of the stencil's
    general branch (0 with ``analytic_normals``; K1 only: ``chip_smoke.py``
    reads them).

    ``rays`` may hold V views of this volume and TF, as
    :func:`march_nondiff` takes them: then one K1 launch marches them all
    (the plain march each view in turn on the CPU), the outputs and
    ``counts`` gain the leading V, each ray's results are those of its view
    marched alone, and the tally ``march_diff_fwd.views`` counts the V
    views."""
    views = _views(rays, config)
    if _build.uses_plain(volume):
        if counts is not None:
            raise ValueError("counts are counted by kernel K1 only; the "
                             "volume is on the CPU")
        with torch.no_grad():
            return _plain_views(march_diff_plain, "march_diff_fwd.views",
                                volume, tf, rays, views, config,
                                sampling_rate, ert)
    soa = _ray_soa(rays)
    with _build.launch("march_diff_fwd", views=views or 0):
        shape = ((views,) if views else ()) + tuple(config.image_shape)
        counts = _build.output("counts", counts, volume.device, shape + (2,))
        return _launch_march(volume, tf, soa, config, sampling_rate, ert,
                             counts, views=views)


def march_diff_bwd_plain(volume: torch.Tensor, tf: torch.Tensor,
                         rays: RayBundle, config: RenderConfig,
                         sampling_rate, grad: torch.Tensor,
                         ert: bool = True):
    """Plain version of K2: autograd of :func:`march_diff_plain` for the
    image cotangent ``grad`` (H, W, 4).  Returns ``(d_volume, d_tf,
    valid_steps)``."""
    with torch.enable_grad():
        v = volume.detach().requires_grad_(True)
        t = tf.detach().requires_grad_(True)
        image, steps = march_diff_plain(v, t, rays, config, sampling_rate,
                                        ert)
        d_v, d_t = torch.autograd.grad(image, (v, t), grad,
                                       allow_unused=True)
    d_v = torch.zeros_like(volume) if d_v is None else d_v
    d_t = torch.zeros_like(tf) if d_t is None else d_t
    return d_v, d_t, steps


def _launch_k2(volume, tf, soa, config, sampling_rate, image, grad, ert,
               counts=None, sums=None, segment=None, volume_grad=True,
               into=None):
    """Call K2 inside the caller's ``_build.launch`` block: its camera
    instantiation where ``sums`` (an (H, W, 12) f32 tensor) is given to
    receive the per-ray sums, its segment instantiation with a
    :class:`Segment` (``d_volume`` then has the padded block's shape).
    Without ``volume_grad``, its TF-only instantiation (neither ``sums`` nor
    a segment: the C entry refuses them): no ``d_volume`` is allocated or
    computed, and ``None`` is returned in its place.  ``into``, the
    ``(d_volume, d_tf)`` that an earlier call returned, has K2 add into
    those buffers in place of new zeroed ones."""
    H, W = config.image_shape
    dev = volume.device
    steps = torch.empty((H, W), dtype=torch.int32, device=dev)
    fwd, keep = _march_args(volume, tf, soa, config, sampling_rate, ert,
                            config.max_samples, image, steps, counts,
                            segment=segment)
    grad = _build.operand("image cotangent", grad, dev, (H, W, 4))
    if into is not None:
        d_volume, d_tf = into
    else:
        d_volume = (torch.zeros(keep[0].shape, dtype=torch.float32,
                                device=dev) if volume_grad else None)
        d_tf = torch.zeros(keep[1].shape, dtype=torch.float32, device=dev)
    args = _MarchBwdArgs(fwd, grad.data_ptr(),
                         d_volume.data_ptr() if volume_grad else None,
                         d_tf.data_ptr(),
                         sums.data_ptr() if sums is not None else None)
    _build.call("dr_march_diff_bwd", ctypes.byref(args), like=keep[0])
    return d_volume, d_tf, steps


def march_diff_bwd(volume: torch.Tensor, tf: torch.Tensor, rays: RayBundle,
                   config: RenderConfig, sampling_rate, image: torch.Tensor,
                   grad: torch.Tensor, ert: bool = True, *,
                   counts: Optional[torch.Tensor] = None,
                   sums: Optional[torch.Tensor] = None,
                   volume_grad: bool = True):
    """Backward of the differentiable march for the image cotangent
    ``grad`` (H, W, 4): kernel K2 on CUDA tensors (one launch),
    :func:`march_diff_bwd_plain` on CPU.

    ``image`` is K1's output for the same inputs: K2 recomputes the march
    front to back, bitwise as K1 marched it, and needs the finished
    composite to know each sample's share of what lies behind it.  Returns
    ``(d_volume (X, Y, Z), d_tf (R, 4), valid_steps (H, W))``, the last
    counted by K2 itself.  ``d_volume`` and ``d_tf`` are summed with f32
    atomics, so their last bits vary from run to run.  ``counts``, an
    (H, W, 4) int32 tensor beside the volume, receives four counts per ray:
    the samples that add anything to ``d_volume``, the samples that add
    nothing but whose ``d_tf`` needs the light (so the gradient points), the
    atomics K2 added to ``d_volume``, and the samples of the stencil's
    general branch (K2 only: ``chip_smoke.py`` reads them for K2's bound).
    ``sums``, an (H, W, 12) f32 tensor beside the volume, receives K2's
    per-ray position sums (:func:`ray_sums`; K2's camera instantiation,
    tallied as ``march_diff_bwd.camera``), the plain version
    of which is :func:`march_diff_cotangents_plain`.  Without
    ``volume_grad``, ``d_volume`` is ``None``: K2's TF-only instantiation
    (tallied as ``march_diff_bwd.tf_only``) computes ``d_tf``
    alone, and takes no ``sums``."""
    if not volume_grad and sums is not None:
        raise ValueError("sums are taken by K2's camera instantiation, "
                         "which computes the volume gradient too")
    if _build.uses_plain(volume):
        if counts is not None or sums is not None:
            raise ValueError("counts and sums are taken by kernel K2 only; "
                             "the volume is on the CPU")
        d_v, d_t, steps = march_diff_bwd_plain(volume, tf, rays, config,
                                               sampling_rate, grad, ert)
        return (d_v if volume_grad else None), d_t, steps
    H, W = config.image_shape
    soa = _ray_soa(rays)
    with _build.launch("march_diff_bwd", camera=sums is not None,
                       tf_only=not volume_grad):
        counts = _build.output("counts", counts, volume.device, (H, W, 4))
        sums = _build.output("sums", sums, volume.device, (H, W, 12),
                             torch.float32)
        return _launch_k2(volume, tf, soa, config, sampling_rate, image,
                          grad, ert, counts, sums, volume_grad=volume_grad)


class _MarchDiff(torch.autograd.Function):
    """K1 forward, K2 backward, differentiable in the volume, the TF and
    the ray tensors of :class:`RaySoA`.  Saves the inputs and the image
    (O(H*W) state beside the volume); ``valid_steps`` is not
    differentiable.  Where a ray tensor needs a gradient, K2's camera
    instantiation also sums the position cotangents per ray, and
    :func:`ray_cotangents` maps them onto the ray tensors.  Where only the
    TF needs one, K2's TF-only instantiation computes ``d_tf`` alone
    (tallied as ``march_diff_bwd.tf_only``, inside the span
    ``dr.backward.tf_only``).

    With ``views`` (an ``origin`` of (V, 3) and the rays of V views,
    view-major), the forward is one K1 launch over the V views, and the
    backward one K2 launch a view on that view's rays, image and
    cotangent, each adding into one ``d_volume`` and one ``d_tf`` (zeroed
    once)."""

    @staticmethod
    def forward(ctx, volume, tf, origin, dirs, t0, dt, n, config,
                sampling_rate, ert, views=None):
        soa = RaySoA(origin, dirs, t0, dt, n)
        with _build.launch("march_diff_fwd", views=views or 0):
            image, steps = _launch_march(volume, tf, soa, config,
                                         sampling_rate, ert, views=views)
        ctx.save_for_backward(volume, tf, origin, dirs, t0, dt, n, image)
        ctx.march = (config, sampling_rate, ert, views)
        ctx.mark_non_differentiable(steps)
        return image, steps

    @staticmethod
    def backward(ctx, g_image, _g_steps):
        volume, tf, origin, dirs, t0, dt, n, image = ctx.saved_tensors
        config, sampling_rate, ert, views = ctx.march
        need = ctx.needs_input_grad
        camera = any(need[2:6])
        tf_only = need[1] and not need[0] and not camera
        with span("dr.backward"), (span("dr.backward.tf_only") if tf_only
                                   else contextlib.nullcontext()):
            lead = (views,) if views else ()
            sums = (torch.empty(lead + config.image_shape + (12,),
                                dtype=torch.float32, device=volume.device)
                    if camera else None)
            grads = None
            for soa, image_v, g_v, sums_v in _view_slices(
                    RaySoA(origin, dirs, t0, dt, n), image, g_image, sums,
                    views):
                with _build.launch("march_diff_bwd", camera=camera,
                                   tf_only=tf_only):
                    grads = _launch_k2(volume, tf, soa, config,
                                       sampling_rate, image_v, g_v, ert,
                                       sums=sums_v, volume_grad=not tf_only,
                                       into=None if grads is None
                                       else grads[:2])
            d_rays = (ray_cotangents(sums, dirs, t0, dt, views) if camera
                      else (None,) * 4)
        grads = grads[:2] + d_rays
        return tuple(g if k else None for g, k in zip(grads, need[:6])) + \
            (None,) * 5


def _view_slices(soa: RaySoA, image, grad, sums, views):
    """Per view of a march's rays, its :class:`RaySoA`, image, image
    cotangent and sums (None where ``sums`` is): the whole of each for one
    view's rays (``views`` None), else view ``v``'s rows."""
    if views is None:
        yield soa, image, grad, sums
        return
    hw = soa.dirs.shape[0] // views
    for v in range(views):
        rows = slice(v * hw, (v + 1) * hw)
        yield (RaySoA(soa.origin[v], soa.dirs[rows], soa.t0[rows],
                      soa.dt[rows], soa.n[rows]),
               image[v], grad[v], None if sums is None else sums[v])


def march_diff(volume: torch.Tensor, tf: torch.Tensor, rays: RayBundle,
               config: RenderConfig, sampling_rate, ert: bool = True):
    """Differentiable-path march, differentiable in ``volume``, ``tf`` and
    the ray bundle (so in the camera that built it): K1 forward and K2
    backward on CUDA tensors, :func:`march_diff_plain` (differentiated by
    autograd) on CPU tensors.  Returns ``(image (H, W, 4), valid_steps
    (H, W))``.

    ``rays`` may hold V views of this volume and TF, as
    :func:`march_nondiff` takes them (:func:`render_batch` stacks them):
    then the outputs gain a leading V, one K1 launch marches them all and
    the backward launches K2 once a view, adding into one ``d_volume`` and
    one ``d_tf``; on the CPU the plain march runs each view in turn over
    the one volume.  The tally ``march_diff_fwd.views`` counts the V
    views."""
    views = _views(rays, config)
    if _build.uses_plain(volume):
        return _plain_views(march_diff_plain, "march_diff_fwd.views",
                            volume, tf, rays, views, config, sampling_rate,
                            ert)
    return _MarchDiff.apply(volume, tf, *_ray_soa(rays), config,
                            sampling_rate, ert, views)


# K1's and K3's launch grids hold the view in blockIdx.z, at most 65535.
_MAX_VIEWS = 65535


def _views(rays: RayBundle, config: RenderConfig) -> Optional[int]:
    """The view count V of a bundle of views (``origin`` (V, 3), the other
    fields (V, H, W[, 3])), None for one view's bundle (``origin`` (3,));
    raises unless every field has the batch's shape."""
    if rays.origin.ndim == 1:
        return None
    if rays.origin.ndim != 2 or rays.origin.shape[1] != 3:
        raise ValueError(f"look_from must be (3,) or (V, 3); got "
                         f"{tuple(rays.origin.shape)}")
    V = rays.origin.shape[0]
    if not 1 <= V <= _MAX_VIEWS:
        raise ValueError(f"a batch holds 1 to {_MAX_VIEWS} views; got {V}")
    shape = (V,) + tuple(config.image_shape)
    for name, t, want in (("dirs", rays.dirs, shape + (3,)),
                          ("entry", rays.entry, shape),
                          ("exit", rays.exit, shape),
                          ("n_samples", rays.n_samples, shape)):
        if tuple(t.shape) != want:
            raise ValueError(f"ray {name} of {V} views must have shape "
                             f"{want}; got {tuple(t.shape)}")
    return V


def _view_rays(rays: RayBundle, v: int) -> RayBundle:
    return RayBundle(*(f[v] for f in rays))


def march_nondiff(volume: torch.Tensor, tf: torch.Tensor, rays: RayBundle,
                  config: RenderConfig, sampling_rate, occupancy=None, *,
                  counts: Optional[torch.Tensor] = None):
    """Inference march: kernel K3 on CUDA tensors (one launch),
    :func:`march_nondiff_plain` on CPU tensors.  With an ``occupancy`` grid
    each ray jumps over empty space.  Returns ``(image, visited,
    composited)`` as the plain version does.
    ``counts``, an (H, W, 3) int32 tensor beside the volume, receives three
    counts per ray: K3's loads of the centre's 2x2x2 cell (it keeps the
    cell across samples and loads it when the centre's low voxel indices
    change), the voxels its composited samples loaded beyond that cell for
    their gradient (0 with ``analytic_normals``: the gradient comes from the
    cell), and its reads of the occupancy grid (K3 only: ``chip_smoke.py``
    reads them).

    ``rays`` may hold V views of this volume and TF (``origin`` (V, 3),
    the other fields with a leading V, as :func:`render_nondiff_batch`
    stacks them): then one K3 launch marches them all (the plain march
    each view in turn on the CPU), the outputs and ``counts`` gain the
    leading V, each ray's results are those of its view marched alone, and
    the tally ``march_nondiff.views`` counts the V views."""
    views = _views(rays, config)
    if _build.uses_plain(volume):
        if counts is not None:
            raise ValueError("counts are counted by kernel K3 only; the "
                             "volume is on the CPU")
        return _plain_views(march_nondiff_plain, "march_nondiff.views",
                            volume, tf, rays, views, config, sampling_rate,
                            occupancy)
    soa = _ray_soa(rays)
    dev = volume.device
    with _build.launch("march_nondiff", views=views or 0):
        _check_grid(occupancy, config)
        shape = ((views,) if views else ()) + tuple(config.image_shape)
        counts = _build.output("counts", counts, dev, shape + (3,))
        image = torch.empty(shape + (4,), dtype=torch.float32, device=dev)
        visited = torch.empty(shape, dtype=torch.int32, device=dev)
        composited = torch.empty(shape, dtype=torch.int32, device=dev)
        args, keep = _march_args(volume, tf, soa, config, sampling_rate,
                                 True, np.iinfo(np.int32).max, image,
                                 visited, composited, occupancy, counts,
                                 views=views)
        _build.call("dr_march_nondiff", ctypes.byref(args), views or 1,
                    like=keep[0])
    return image, visited, composited


# ---------------------------------------------------------------------------
# Public functional API
# ---------------------------------------------------------------------------

def _inputs(volume, tf, look_from):
    """f32 views of the inputs on the volume's device; a camera that
    requires grad keeps its graph."""
    look_from = torch.as_tensor(look_from, dtype=torch.float32,
                                device=volume.device)
    return volume.to(torch.float32), tf.to(torch.float32), look_from


def render(volume: torch.Tensor, tf: torch.Tensor, look_from,
           config: RenderConfig, sampling_rate: Optional[float] = None,
           u: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None,
           ert: bool = True) -> RenderOutput:
    """Differentiable-path render of one view.

    Args:
        volume: (X, Y, Z) f32 volume, internal axis order.
        tf: (R, 4) RGBA transfer function.
        look_from: (3,) camera position; the camera looks at the origin.
        config: static :class:`RenderConfig`.
        sampling_rate: Nyquist multiplier; defaults to the config's.
        u: optional (H, W) uniform draw that jitters ray starts.
        generator: optional ``torch.Generator`` on the volume's device to
            draw ``u`` from when ``u`` is not given.  With neither there is
            no jitter.
        ert: early ray termination.
    Runs where ``volume`` lives: kernels K1 (forward) and K2 (backward) on
    CUDA, the plain march on CPU.  The image is differentiable with respect
    to ``volume`` and ``tf``, and to ``look_from`` where it requires grad
    (as JAX's functional AD differentiates it; on CUDA K2's camera
    instantiation then runs in place of its default one).
    """
    sr = config.sampling_rate if sampling_rate is None else sampling_rate
    with span("dr.view"):
        volume, tf, look_from = _inputs(volume, tf, look_from)
        if u is None and generator is not None:
            u = torch.rand(config.image_shape, generator=generator,
                           dtype=torch.float32, device=volume.device)
        rays = make_rays(look_from, config, sr, u=u)
        image, steps = march_diff(volume, tf, rays, config, sr, ert=ert)
    return RenderOutput(image=image, valid_steps=steps,
                        n_samples=rays.n_samples)


def _batch_rays(look_from: torch.Tensor, config: RenderConfig,
                sampling_rate, u: Optional[torch.Tensor] = None
                ) -> RayBundle:
    """The rays of V views (``look_from`` (V, 3)): each view's
    :func:`make_rays`, with its own row of ``u`` (V, H, W) where given,
    stacked view-major."""
    if look_from.ndim != 2 or look_from.shape[1] != 3:
        raise ValueError(f"look_from must be (V, 3); got "
                         f"{tuple(look_from.shape)}")
    want_u = (look_from.shape[0],) + tuple(config.image_shape)
    if u is not None and tuple(u.shape) != want_u:
        raise ValueError(f"u must have shape {want_u}; got "
                         f"{tuple(u.shape)}")
    per_view = [make_rays(lf, config, sampling_rate,
                          u=None if u is None else u[v])
                for v, lf in enumerate(look_from)]
    return RayBundle(*(torch.stack(f) for f in zip(*per_view)))


def render_batch(volume: torch.Tensor, tf: torch.Tensor, look_from,
                 config: RenderConfig, sampling_rate: Optional[float] = None,
                 u: Optional[torch.Tensor] = None,
                 ert: bool = True) -> RenderOutput:
    """:func:`render` of V views (``look_from`` (V, 3), ``u`` (V, H, W) if
    given) of one volume and one TF: each view's rays from
    :func:`make_rays` stacked view-major, and one :func:`march_diff` of
    them all.  On CUDA that is one K1 launch forward and, backward, a K2
    launch a view, each adding into one ``d_volume`` and one ``d_tf``; on
    the CPU the plain march of each view in turn over the one volume,
    differentiated by autograd.  Every ray's K1 thread does the work it
    does in its own view's launch, so the images and ``valid_steps`` are
    :func:`render`'s bit for bit.  Differentiable as :func:`render` is, in
    ``look_from`` too where it requires grad.  Returns images
    (V, H, W, 4), ``valid_steps`` and ``n_samples`` (V, H, W)."""
    sr = config.sampling_rate if sampling_rate is None else sampling_rate
    with span("dr.view.batch"):
        volume, tf, look_from = _inputs(volume, tf, look_from)
        rays = _batch_rays(look_from, config, sr, u)
        image, steps = march_diff(volume, tf, rays, config, sr, ert=ert)
    return RenderOutput(image=image, valid_steps=steps,
                        n_samples=rays.n_samples)


def render_nondiff(volume: torch.Tensor, tf: torch.Tensor, look_from,
                   config: RenderConfig,
                   sampling_rate: Optional[float] = None,
                   u: Optional[torch.Tensor] = None,
                   occupancy=None) -> RenderOutput:
    """Inference render of one view; the default sampling rate is
    ``4 * config.sampling_rate`` and there is no jitter unless ``u`` is
    given.  With ``config.occupancy_skip`` (the default) the march jumps over
    empty space through an occupancy grid, built here (kernels K6 and K7, two
    C calls, on CUDA) unless a prebuilt ``occupancy`` grid of this volume
    and TF is passed; the image does not change.  ``valid_steps`` is all
    ones, as in the JAX package."""
    sr = 4.0 * config.sampling_rate if sampling_rate is None else sampling_rate
    with span("dr.view"):
        volume, tf, look_from = _inputs(volume, tf, look_from)
        if occupancy is None and config.occupancy_skip:
            occupancy = build_occupancy(volume, tf, config)
        rays = make_rays(look_from, config, sr, u=u)
        image, _, _ = march_nondiff(volume, tf, rays, config, sr, occupancy)
        ones = torch.ones(config.image_shape, dtype=torch.int32,
                          device=volume.device)
    return RenderOutput(image=image, valid_steps=ones,
                        n_samples=rays.n_samples)


def render_nondiff_batch(volume: torch.Tensor, tf: torch.Tensor, look_from,
                         config: RenderConfig,
                         sampling_rate: Optional[float] = None
                         ) -> RenderOutput:
    """:func:`render_nondiff` of V views (``look_from`` (V, 3)) of one
    volume and one TF: one occupancy grid (with ``config.occupancy_skip``),
    each view's rays from :func:`make_rays` stacked view-major, and one
    :func:`march_nondiff` of them all: one K3 launch on CUDA, the plain
    march of each view in turn on the CPU.  Every ray's K3 thread does the
    work it does in its own view's launch, so the images are
    :func:`render_nondiff`'s bit for bit.  Returns images (V, H, W, 4),
    ``valid_steps`` all ones and ``n_samples`` (V, H, W)."""
    sr = 4.0 * config.sampling_rate if sampling_rate is None else sampling_rate
    with span("dr.view.batch"):
        volume, tf, look_from = _inputs(volume, tf, look_from)
        occupancy = (build_occupancy(volume, tf, config)
                     if config.occupancy_skip else None)
        rays = _batch_rays(look_from, config, sr)
        image, _, _ = march_nondiff(volume, tf, rays, config, sr, occupancy)
        ones = torch.ones(rays.n_samples.shape, dtype=torch.int32,
                          device=volume.device)
    return RenderOutput(image=image, valid_steps=ones,
                        n_samples=rays.n_samples)


# ---------------------------------------------------------------------------
# Large-scale entry points: strips, depth-sorted chunks, the scene policy
# ---------------------------------------------------------------------------

def _strip_height(config: RenderConfig, n_strips: int) -> int:
    H = config.height
    if H % n_strips:
        raise ValueError(
            f"n_strips={n_strips} must divide the image height {H}")
    return H // n_strips


def _ray_rows(rays: RayBundle, sl: slice) -> RayBundle:
    return RayBundle(origin=rays.origin, dirs=rays.dirs[sl],
                     entry=rays.entry[sl], exit=rays.exit[sl],
                     n_samples=rays.n_samples[sl])


def render_nondiff_strips(volume: torch.Tensor, tf: torch.Tensor, look_from,
                          config: RenderConfig,
                          sampling_rate: Optional[float] = None,
                          u: Optional[torch.Tensor] = None,
                          n_strips: int = 4,
                          occupancy=None) -> RenderOutput:
    """:func:`render_nondiff` marched as ``n_strips`` row strips, one K3
    launch each (the JAX package bounds its program size this way).  The
    occupancy grid and the rays are built once and shared; every ray's K3
    thread does the same work as in one launch, so the image is
    :func:`render_nondiff`'s bit for bit.  ``n_strips`` must divide the
    image height."""
    sr = 4.0 * config.sampling_rate if sampling_rate is None else sampling_rate
    h = _strip_height(config, n_strips)
    with span("dr.view"):
        volume, tf, look_from = _inputs(volume, tf, look_from)
        if occupancy is None and config.occupancy_skip:
            occupancy = build_occupancy(volume, tf, config)
        rays = make_rays(look_from, config, sr, u=u)
        strip_cfg = config.replace(image_shape=(h, config.width))
        image = torch.cat([
            march_nondiff(volume, tf,
                          _ray_rows(rays, slice(s * h, (s + 1) * h)),
                          strip_cfg, sr, occupancy)[0]
            for s in range(n_strips)])
        ones = torch.ones(config.image_shape, dtype=torch.int32,
                          device=volume.device)
    return RenderOutput(image=image, valid_steps=ones,
                        n_samples=rays.n_samples)


def render_strips(volume: torch.Tensor, tf: torch.Tensor, look_from,
                  config: RenderConfig, sampling_rate: Optional[float] = None,
                  u: Optional[torch.Tensor] = None, n_strips: int = 4,
                  ert: bool = True) -> RenderOutput:
    """:func:`render` marched as ``n_strips`` row strips: one K1 launch each
    forward, one K2 launch each backward, and autograd sums the strips'
    ``d_volume``/``d_tf``.  The image and ``valid_steps`` are
    :func:`render`'s; the gradients differ only in the order of K2's atomic
    adds.  Differentiable in ``look_from`` where it requires grad, as
    :func:`render` is.  ``n_strips`` must divide the image height."""
    sr = config.sampling_rate if sampling_rate is None else sampling_rate
    h = _strip_height(config, n_strips)
    with span("dr.view"):
        volume, tf, look_from = _inputs(volume, tf, look_from)
        rays = make_rays(look_from, config, sr, u=u)
        strip_cfg = config.replace(image_shape=(h, config.width))
        outs = [march_diff(volume, tf,
                           _ray_rows(rays, slice(s * h, (s + 1) * h)),
                           strip_cfg, sr, ert=ert) for s in range(n_strips)]
        return RenderOutput(image=torch.cat([o[0] for o in outs]),
                            valid_steps=torch.cat([o[1] for o in outs]),
                            n_samples=rays.n_samples)


@torch.no_grad()
def _predict_march_depth(volume, tf, rays: RayBundle, config: RenderConfig,
                         coarse: int = 32) -> torch.Tensor:
    """Per-ray upper estimate of the useful march depth, in samples (N,):
    the occupancy distance field (:func:`build_occupancy`) at ``coarse``
    points along each ray, the last occupied coarse interval plus one of
    slack, mapped to a sample index.  A sort key for
    :func:`render_depth_sorted`; its errors cost scheduling, never
    correctness."""
    grid = build_occupancy(volume, tf, config)
    soa = _ray_soa(rays)
    dev = soa.t0.device
    n_f = soa.n.to(torch.float32)
    frac = (torch.arange(coarse, dtype=torch.float32, device=dev)
            + 0.5) / coarse
    t = soa.t0[None] + frac[:, None] * (
        torch.clamp(n_f - 1.0, min=0.0) * soa.dt)[None]       # (C, N)
    p = [soa.origin[i] + t * soa.dirs[:, i][None] for i in range(3)]
    occ = grid.dist[cell_index(grid, config.volume_shape, *p)] == 0
    idx = torch.arange(1, coarse + 1, dtype=torch.float32,
                       device=dev)[:, None]
    last = torch.amax(torch.where(occ, idx, idx.new_zeros(())), dim=0)
    return torch.clamp((last + 1.0) / coarse, max=1.0) * n_f


def render_depth_sorted(volume: torch.Tensor, tf: torch.Tensor, look_from,
                        config: RenderConfig,
                        sampling_rate: Optional[float] = None,
                        u: Optional[torch.Tensor] = None,
                        chunks: int = 4) -> RenderOutput:
    """:func:`render` with the rays sorted by predicted march depth
    (:func:`_predict_march_depth`, a stable sort, as ``jnp.argsort``) into
    ``chunks`` equal groups, each marched by its own K1 launch (and K2
    launch backward); the image and ``valid_steps`` are scattered back to
    pixel order.  Every ray marches its own samples with its own ERT, so the
    result is :func:`render`'s (gradients up to K2's atomic order).

    The JAX package sorts so that its global per-block ERT skip fires per
    chunk; the card terminates each ray on its own thread, so what sorting
    can buy here is less divergence within a warp, at the cost of spatial
    locality.  A chunk of M rays is marched as an image of ``(M // w, w)``
    with ``w = gcd(M, W)`` (``W`` when ``chunks`` divides the height): the
    kernels launch 16x8 thread blocks over the image and index rays as
    ``h*W + w``, so a chunk one ray wide would idle 15 of 16 lanes.
    ``chunks`` must divide H*W."""
    sr = config.sampling_rate if sampling_rate is None else sampling_rate
    volume, tf, look_from = _inputs(volume, tf, look_from)
    H, W = config.image_shape
    N = H * W
    if N % chunks:
        raise ValueError(f"chunks={chunks} must divide H*W={N}")
    M = N // chunks
    with span("dr.view"):
        rays = make_rays(look_from, config, sr, u=u)
        depth = _predict_march_depth(volume, tf, rays, config)
        order = torch.argsort(depth, stable=True)
        inv = torch.empty_like(order)
        inv[order] = torch.arange(N, device=order.device)
        w = math.gcd(M, W)
        shape = (M // w, w)
        chunk_cfg = config.replace(image_shape=shape)
        fields = [rays.dirs.reshape(N, 3)[order],
                  rays.entry.reshape(N)[order], rays.exit.reshape(N)[order],
                  rays.n_samples.reshape(N)[order]]
        images, steps = [], []
        for c in range(chunks):
            d, e, x, n = (f[c * M:(c + 1) * M] for f in fields)
            rb = RayBundle(origin=rays.origin, dirs=d.reshape(shape + (3,)),
                           entry=e.reshape(shape), exit=x.reshape(shape),
                           n_samples=n.reshape(shape))
            image, vs = march_diff(volume, tf, rb, chunk_cfg, sr, ert=True)
            images.append(image.reshape(M, 4))
            steps.append(vs.reshape(M))
        return RenderOutput(image=torch.cat(images)[inv].reshape(H, W, 4),
                            valid_steps=torch.cat(steps)[inv].reshape(H, W),
                            n_samples=rays.n_samples)


@torch.no_grad()
def _depth_spread(volume, tf, look_from, config: RenderConfig,
                  sampling_rate: float) -> float:
    """The share of the rays that meet the volume whose predicted useful
    depth is under half their sample count: the scene statistic behind
    :func:`choose_diff_renderer` (high on bounded objects in empty space,
    0 on a fully occupied scene)."""
    volume, tf, look_from = _inputs(volume, tf, look_from)
    rays = make_rays(look_from, config, sampling_rate)
    d = _predict_march_depth(volume, tf, rays, config)
    nf = rays.n_samples.reshape(-1).to(torch.float32)
    hit = nf > 0.0
    rho = d / torch.clamp(nf, min=1.0)
    n_hit = torch.clamp(torch.sum(hit.to(torch.float32)), min=1.0)
    spread = torch.sum(((rho < 0.5) & hit).to(torch.float32)) / n_hit
    with span("dr.sync"):
        return float(spread)


@torch.no_grad()
def _alive_fraction(volume, tf, look_from, config: RenderConfig,
                    sampling_rate: float, s_split: int) -> float:
    """The share of rays still marching after ``s_split`` steps, from one
    forward render at ``config`` (``valid_steps > s_split``)."""
    out = render(volume.detach(), tf.detach(), look_from, config,
                 sampling_rate)
    alive = torch.mean((out.valid_steps.reshape(-1) > s_split)
                       .to(torch.float32))
    with span("dr.sync"):
        return float(alive)


def _compacted(compact_after: int, compact_prefix: float):
    """The JAX package's "compacted" candidate: :func:`render` with
    ``compact_after``/``compact_prefix`` set.  The port accepts and ignores
    those knobs (each ray terminates on its own thread), so it renders as
    :func:`render` does."""
    def fn(volume, tf, look_from, config, sampling_rate=None, u=None):
        return render(volume, tf, look_from,
                      config.replace(compact_after=compact_after,
                                     compact_prefix=compact_prefix),
                      sampling_rate=sampling_rate, u=u)
    return fn


def _depth_sorted(chunks: int):
    def fn(volume, tf, look_from, config, sampling_rate=None, u=None):
        return render_depth_sorted(volume, tf, look_from, config,
                                   sampling_rate=sampling_rate, u=u,
                                   chunks=chunks)
    return fn


def _compact_prefix(alive: float) -> float:
    """The prefix bucket of the JAX package's compaction: the power-of-two
    fraction 2^-k, k in [2, 5], with ~1.5x slack over ``alive``."""
    return 2.0 ** -min(5, max(2, int(-math.log2(max(alive, 1e-6) * 1.5))))


def choose_diff_renderer(volume, tf, look_from, config: RenderConfig,
                         sampling_rate: Optional[float] = None,
                         chunks: int = 4, threshold: float = 0.25,
                         alive_threshold: float = 0.125,
                         compact_after: int = 2, probe: str = "heuristic"):
    """The JAX package's scene-adaptive choice of the differentiable
    renderer; returns ``(render_fn, name)`` with ``name`` one of
    ``"compacted"``, ``"depth_sorted"`` and ``"plain"`` (then ``render_fn``
    is :func:`render` itself), and ``render_fn`` taking :func:`render`'s
    ``(volume, tf, look_from, config, sampling_rate=None, u=None)``.

    ``probe="heuristic"`` decides as the JAX package does, with its
    thresholds: a 128^2 probe render without jitter gives the share of rays
    alive after ``compact_after`` march blocks (``config.block_size``
    samples each; at most ``alive_threshold`` picks "compacted"), else the
    depth-spread statistic (above ``threshold`` picks "depth_sorted"), else
    "plain".  ``probe="timed"`` times one forward and backward step of
    "plain" and "depth_sorted" at the full config and returns the faster.
    On the card "compacted" renders as :func:`render` does (the port ignores
    the compaction knobs) and "depth_sorted" changes only the rays' order,
    so every choice gives :func:`render`'s image."""
    if probe not in ("heuristic", "timed"):
        raise ValueError(f"probe must be 'heuristic' or 'timed'; "
                         f"got {probe!r}")
    if probe == "timed":
        return _choose_diff_renderer_timed(volume, tf, look_from, config,
                                           sampling_rate, chunks)
    sr = config.sampling_rate if sampling_rate is None else sampling_rate
    volume, tf, look_from = _inputs(volume, tf, look_from)
    n_blocks = -(-config.diff_march_steps(float(sr)) // config.block_size)
    if 0 < compact_after < n_blocks:
        probe_cfg = config.replace(image_shape=(128, 128), compact_after=0)
        alive = _alive_fraction(volume, tf, look_from, probe_cfg, float(sr),
                                compact_after * config.block_size)
        if alive <= alive_threshold:
            return _compacted(compact_after, _compact_prefix(alive)), \
                "compacted"
    if _depth_spread(volume, tf, look_from, config, float(sr)) > threshold:
        return _depth_sorted(chunks), "depth_sorted"
    return render, "plain"


def _choose_diff_renderer_timed(volume, tf, look_from, config, sampling_rate,
                                chunks):
    """``choose_diff_renderer(probe="timed")``: one warm-up and one timed
    forward and backward step (``mean(image^2)``) of each distinct renderer,
    "plain" and "depth_sorted", the camera moved by 1e-6 between them; the
    faster wins, ties to "plain".  "compacted" is not timed: here it is
    :func:`render` with ignored knobs, so it would only time "plain" twice.
    Timed by the host clock after ``torch.cuda.synchronize()`` on the
    card."""
    sr = config.sampling_rate if sampling_rate is None else sampling_rate
    volume, tf, look_from = _inputs(volume, tf, look_from)
    dev = volume.device
    candidates = [("plain", render), ("depth_sorted", _depth_sorted(chunks))]

    def sync():
        if dev.type == "cuda":
            with span("dr.sync"):
                torch.cuda.synchronize(dev)

    best = None
    for name, fn in candidates:
        def step(c, _fn=fn):
            v = volume.detach().requires_grad_(True)
            t = tf.detach().requires_grad_(True)
            with torch.enable_grad():
                img = _fn(v, t, look_from.detach() + c * 1e-6, config,
                          sampling_rate=sr).image
                torch.autograd.grad(torch.mean(img ** 2), (v, t),
                                    allow_unused=True)
        step(0.0)
        sync()
        t0 = time.perf_counter()
        step(1.0)
        sync()
        dt = time.perf_counter() - t0
        if best is None or dt < best[2]:
            best = (name, fn, dt)
    name, fn, _ = best
    return (fn, name) if name != "plain" else (render, "plain")


def value_and_grad_render(volume: torch.Tensor, tf: torch.Tensor, look_from,
                          config: RenderConfig, loss_fn,
                          sampling_rate: Optional[float] = None,
                          u: Optional[torch.Tensor] = None, ert: bool = True,
                          loss_args: tuple = ()):
    """Loss and ``(d_volume, d_tf)`` of ``loss_fn(render(...), *loss_args)``.

    The counterpart of ``differender_tpu/render.py::value_and_grad_render``.
    K2 holds only O(H*W) state beside the volume, so one strategy serves
    every size: ``config.use_blockwise_grad()`` changes nothing here.
    ``u`` takes the place of the JAX package's jitter key.  Returns
    ``(loss, (d_volume, d_tf))``, all detached; the camera is held fixed
    (:func:`render` gives its gradient where ``look_from`` requires grad)."""
    v = volume.detach().to(torch.float32).requires_grad_(True)
    t = tf.detach().to(torch.float32).requires_grad_(True)
    look_from = torch.as_tensor(look_from).detach()
    with torch.enable_grad():
        out = render(v, t, look_from, config, sampling_rate, u=u, ert=ert)
        loss = loss_fn(out, *loss_args)
        d_v, d_t = torch.autograd.grad(loss, (v, t), allow_unused=True)
    d_v = torch.zeros_like(v) if d_v is None else d_v
    d_t = torch.zeros_like(t) if d_t is None else d_t
    return loss.detach(), (d_v, d_t)


def value_and_grad_blockwise(volume: torch.Tensor, tf: torch.Tensor,
                             look_from, config: RenderConfig, loss_fn,
                             sampling_rate: Optional[float] = None,
                             u: Optional[torch.Tensor] = None,
                             ert: bool = True, loss_args: tuple = ()):
    """Loss and ``(d_volume, d_tf)`` of ``loss_fn(render(...), *loss_args)``
    (counterpart of ``differender_tpu/render.py::value_and_grad_blockwise``).

    The JAX package splits its 512^3-class backward into host-level march
    blocks because one program of it exceeds the TPU compiler's limits.
    Here the march is one K1 launch, the loss head, and one K2 launch that
    recomputes the march and keeps only O(H*W) state beside the volume, so
    no block loop is needed: this is :func:`value_and_grad_render`.  It
    refuses what the JAX package refuses, with the same ``ValueError``:
    ``march_vjp="tiled"``, ``camera_grads``, and ``march_vjp="sorted"``
    with a march table other than ``super64``/``super64s2``
    (:meth:`RenderConfig.resolved_march_table`); the other TPU knobs,
    ``block_size`` and ``compact_after`` among them, are ignored."""
    if config.march_vjp == "tiled":
        raise ValueError("value_and_grad_blockwise supports march_vjp "
                         "'ad' and 'sorted', not 'tiled'")
    if config.camera_grads:
        raise ValueError(
            "camera_grads=True is unsupported on the blockwise backward; "
            "use render()/value_and_grad over it (march_vjp='ad' or "
            "'sorted') for camera gradients")
    kind = config.resolved_march_table()
    if config.march_vjp == "sorted" and kind not in ("super64", "super64s2"):
        raise ValueError(
            "march_vjp='sorted' requires march_table super64 or "
            f"super64s2; got {kind}")
    return value_and_grad_render(volume, tf, look_from, config, loss_fn,
                                 sampling_rate, u, ert, loss_args)


# The JAX package's jitted entry points; PyTorch runs eagerly, so these are
# the same functions.
render_jit = render
render_nondiff_jit = render_nondiff


__all__ = ["RenderOutput", "RaySoA", "march_diff", "march_diff_fwd",
           "march_diff_bwd", "march_diff_plain", "march_diff_bwd_plain",
           "ray_cotangents", "march_nondiff", "march_nondiff_plain",
           "render", "render_batch", "render_nondiff", "render_nondiff_batch",
           "render_jit",
           "render_nondiff_jit",
           "render_nondiff_strips", "render_strips", "render_depth_sorted",
           "choose_diff_renderer", "value_and_grad_render",
           "value_and_grad_blockwise"]
