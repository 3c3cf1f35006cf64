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
and the image alpha is ``1 - T``.  Gradients flow to the volume and the TF,
never to the camera (as in the reference).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _build
from .config import RenderConfig
from .geometry import RayBundle, make_rays, march_params
from .occupancy import build_occupancy, jump_steps
from .ops.bricks import grid_shape
from .sampling import (TF_DOT_MAX_TEXELS, apply_tf, march_tf,
                       sample_with_gradient, trilinear, voxel_scale)
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


def _ray_soa(rays: RayBundle):
    """Flat (H*W,) ray state: directions, ``t0``, ``dt`` and ``n``."""
    params = march_params(rays)
    n = rays.n_samples.numel()
    d = rays.dirs.reshape(n, 3)
    return d, params.t0.reshape(n), params.dt.reshape(n), \
        rays.n_samples.reshape(n)


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
                 nondiff, occupancy=None):
    """Sequential march over the rays still alive; returns the flat
    composite ``(rgb, T)`` and per-ray counts ``(visited, composited)``.
    Each ray carries its own step index ``s``.  With an ``occupancy`` grid
    (inference march only) a ray jumps at its head as kernel K3 does: at
    every ``occupancy_jump_every``-th iteration, unless its last sample
    composited.  Out of place, so autograd differentiates it when the volume
    or the TF requires grad (the differentiable path's TF is
    :func:`march_tf`)."""
    origin = rays.origin.to(torch.float32)
    dirs, t0, dt, _ = _ray_soa(rays)
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
            rgba = apply_tf(tf, trilinear(volume, pos))
            keep = rgba[:, 3] > skip
            if occupancy is not None:
                look[idx] = ~keep
            rgba, pos, on = rgba[keep], pos[keep], idx[keep]
            _, grad = sample_with_gradient(volume, pos, config.normal_delta)
        else:
            intensity, grad = sample_with_gradient(volume, pos,
                                                   config.normal_delta)
            rgba = march_tf(tf, intensity)
            on = idx
        shaded = shade(pos, grad, rgba, dirs[on], origin, sampling_rate,
                       config, clamp_light=not nondiff)
        Ti = T[on]
        rgb = rgb.index_add(0, on, Ti[:, None] * shaded[:, :3])
        T = T.index_copy(0, on, Ti * (1.0 - shaded[:, 3]))
        composited[on] += 1
        s[idx] += 1
        it += 1
    return rgb, T, visited, composited


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
    rgb, T, _, comp = _plain_march(volume, tf, rays, config, sampling_rate,
                                   limit, ert, nondiff=False)
    image = torch.cat([rgb, (1.0 - T)[:, None]], dim=-1).reshape(H, W, 4)
    return image, (comp + 1).reshape(H, W)


@torch.no_grad()
def march_nondiff_plain(volume: torch.Tensor, tf: torch.Tensor,
                        rays: RayBundle, config: RenderConfig,
                        sampling_rate, occupancy=None):
    """Plain torch inference march.  No ``max_samples`` cap; a sample
    composites only if its TF alpha is ``> alpha_skip``; no light clamp;
    the image ends with ``min(1, .)``.  With an ``occupancy`` grid
    (:class:`~differender_tpu_torch.occupancy.OccupancyGrid` of this volume
    and TF) each ray jumps over samples that provably classify at or below
    ``alpha_skip``, as K3 does; the image does not change.  Returns
    ``(image (H, W, 4), visited (H, W), composited (H, W))``: the samples
    each ray evaluated and the samples it composited."""
    H, W = config.image_shape
    _check_grid(occupancy, config)
    limit = rays.n_samples.reshape(-1)
    rgb, T, vis, comp = _plain_march(volume, tf, rays, config, sampling_rate,
                                     limit, ert=True, nondiff=True,
                                     occupancy=occupancy)
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
        "image", "steps", "shaded", "occ", "occ_far")]
        + [(f, ctypes.c_int) for f in (
            "H", "W", "X", "Y", "Z", "R", "max_steps", "ert",
            "nx", "ny", "nz", "cell", "jump_every")]
        + [(f, ctypes.c_float) for f in (
            "scale_x", "scale_y", "scale_z", "delta", "inv_sr", "thr",
            "ambient", "diffuse", "specular", "shininess",
            "lc_r", "lc_g", "lc_b", "alpha_skip", "cell_world")])


class _MarchBwdArgs(ctypes.Structure):
    """Mirror of ``struct MarchBwdArgs`` in ``csrc/march_bwd.cu``."""
    _fields_ = [("f", _MarchArgs)] + [(f, ctypes.c_void_p) for f in (
        "grad", "d_volume", "d_tf")]


def _checked(name, t, dev, shape=None, dtype=torch.float32):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}; the volume on {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}; got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}; "
                         f"got {tuple(t.shape)}")
    return t.detach().contiguous()


def _occupancy_args(occupancy, config, dev):
    """The grid's fields of ``MarchArgs`` (a null grid: no skip): its
    distance field, the field's largest value (on the device: K3 reads it),
    the ints and ``cell_world``."""
    if occupancy is None:
        return None, None, (0, 0, 0, 1, 1), 0.0
    nx, ny, nz = occupancy.shape
    dist = _checked("occupancy.dist", occupancy.dist, dev, (nx * ny * nz,),
                    torch.int32)
    ints = (nx, ny, nz, occupancy.cell, max(1, config.occupancy_jump_every))
    far = _checked("occupancy.far", occupancy.far, dev, (1,), torch.int32)
    return dist, far, ints, float(np.float32(occupancy.cell_world))


def _march_args(volume, tf, rays, config, sampling_rate, ert, max_steps,
                image, steps, shaded=None, occupancy=None):
    """Validate the operands and fill ``MarchArgs``.  Returns the struct and
    the tensors it points into, which the caller keeps referenced until the
    launch is enqueued (the caching allocator keeps their memory for the
    stream after that)."""
    dev = volume.device
    H, W = config.image_shape
    volume = _checked("volume", volume, dev, config.volume_shape)
    if tf.ndim != 2 or tf.shape[1] != 4 or tf.shape[0] < 1:
        raise ValueError(f"tf must be (R, 4); got {tuple(tf.shape)}")
    tf = _checked("tf", tf, dev)
    if tf.data_ptr() % 16:
        tf = tf.clone()          # float4 loads need 16-byte alignment
    origin = _checked("look_from", rays.origin, dev, (3,))
    dirs, t0, dt, n = _ray_soa(rays)
    dirs = _checked("ray dirs", dirs, dev, (H * W, 3))
    dx, dy, dz = (dirs[:, i].contiguous() for i in range(3))
    t0 = _checked("t0", t0, dev, (H * W,))
    dt = _checked("dt", dt, dev, (H * W,))
    n = _checked("n_samples", n, dev, (H * W,), torch.int32)
    image = _checked("image", image, dev, (H, W, 4))
    if image.data_ptr() % 16:
        image = image.clone()    # float4 loads need 16-byte alignment
    scale = voxel_scale(config.volume_shape)
    X, Y, Z = config.volume_shape
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
        H, W, X, Y, Z, tf.shape[0], max_steps, int(ert), *occ_ints,
        float(scale[0]), float(scale[1]), float(scale[2]),
        float(np.float32(config.normal_delta)),
        float(np.float32(1.0) / np.float32(sampling_rate)),
        _ert_threshold(config), config.ambient, config.diffuse,
        config.specular, config.shininess, lc[0], lc[1], lc[2],
        config.alpha_skip, cell_world)
    return args, (volume, tf, origin, dx, dy, dz, t0, dt, n, image, dist,
                  far)


def _launch(entry, args, volume):
    fn = getattr(_build.library(), entry)
    _build.check(fn(ctypes.byref(args), volume.device.index,
                    _build.stream_of(volume)), entry)


def _counts_out(name, counts, dev, shape):
    """Checks an optional int32 tensor of per-ray counts that a kernel
    writes, and returns it (or None)."""
    if counts is None:
        return None
    _checked(name, counts, dev, shape, torch.int32)
    if not counts.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return counts


def _launch_march(entry, volume, tf, rays, config, sampling_rate, ert,
                  max_steps, shaded=None, occupancy=None):
    """Allocate the outputs and launch one forward march kernel; ``shaded``
    (if given) receives its per-ray counts."""
    H, W = config.image_shape
    dev = volume.device
    image = torch.empty((H, W, 4), dtype=torch.float32, device=dev)
    steps = torch.empty((H, W), dtype=torch.int32, device=dev)
    args, keep = _march_args(volume, tf, rays, config, sampling_rate, ert,
                             max_steps, image, steps, shaded, occupancy)
    _launch(entry, args, keep[0])
    return image, steps


def march_diff_fwd(volume: torch.Tensor, tf: torch.Tensor, rays: RayBundle,
                   config: RenderConfig, sampling_rate, ert: bool = True, *,
                   counts: Optional[torch.Tensor] = None):
    """Kernel K1 on CUDA tensors (one launch, counted in
    ``march_diff_fwd.launches``), :func:`march_diff_plain` on CPU tensors.
    Returns ``(image (H, W, 4), valid_steps (H, W))``; no autograd.
    ``counts``, an (H, W, 2) int32 tensor beside the volume, receives two
    counts per ray: the samples of opacity exactly 0, which K1 composites
    without their gradient and shading, and the samples of the stencil's
    general branch (K1 only: ``chip_smoke.py`` reads them)."""
    if _build.uses_plain(volume):
        if counts is not None:
            raise ValueError("counts are counted by kernel K1 only; the "
                             "volume is on the CPU")
        with torch.no_grad():
            return march_diff_plain(volume, tf, rays, config, sampling_rate,
                                    ert)
    counts = _counts_out("counts", counts, volume.device,
                         config.image_shape + (2,))
    image, steps = _launch_march(
        "dr_march_diff_fwd", volume, tf, rays, config, sampling_rate, ert,
        config.max_samples, counts)
    march_diff_fwd.launches += 1
    return image, steps


march_diff_fwd.launches = 0


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


def march_diff_bwd(volume: torch.Tensor, tf: torch.Tensor, rays: RayBundle,
                   config: RenderConfig, sampling_rate, image: torch.Tensor,
                   grad: torch.Tensor, ert: bool = True, *,
                   counts: Optional[torch.Tensor] = None):
    """Backward of the differentiable march for the image cotangent
    ``grad`` (H, W, 4): kernel K2 on CUDA tensors (one launch, counted in
    ``march_diff_bwd.launches``), :func:`march_diff_bwd_plain` on CPU.

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
    general branch (K2 only: ``chip_smoke.py`` reads them for K2's bound)."""
    if _build.uses_plain(volume):
        if counts is not None:
            raise ValueError("counts are counted by kernel K2 only; "
                             "the volume is on the CPU")
        return march_diff_bwd_plain(volume, tf, rays, config, sampling_rate,
                                    grad, ert)
    H, W = config.image_shape
    dev = volume.device
    steps = torch.empty((H, W), dtype=torch.int32, device=dev)
    counts = _counts_out("counts", counts, dev, (H, W, 4))
    fwd, keep = _march_args(volume, tf, rays, config, sampling_rate, ert,
                            config.max_samples, image, steps, counts)
    grad = _checked("image cotangent", grad, dev, (H, W, 4))
    if grad.data_ptr() % 16:
        grad = grad.clone()      # float4 loads need 16-byte alignment
    d_volume = torch.zeros(config.volume_shape, dtype=torch.float32,
                           device=dev)
    d_tf = torch.zeros(keep[1].shape, dtype=torch.float32, device=dev)
    args = _MarchBwdArgs(fwd, grad.data_ptr(), d_volume.data_ptr(),
                         d_tf.data_ptr())
    _launch("dr_march_diff_bwd", args, keep[0])
    march_diff_bwd.launches += 1
    return d_volume, d_tf, steps


march_diff_bwd.launches = 0


class _MarchDiff(torch.autograd.Function):
    """K1 forward, K2 backward.  Saves the inputs and the image (O(H*W)
    state beside the volume); ``valid_steps`` is not differentiable."""

    @staticmethod
    def forward(ctx, volume, tf, rays, config, sampling_rate, ert):
        image, steps = march_diff_fwd(volume, tf, rays, config,
                                      sampling_rate, ert)
        ctx.save_for_backward(volume, tf, image)
        ctx.march = (rays, config, sampling_rate, ert)
        ctx.mark_non_differentiable(steps)
        return image, steps

    @staticmethod
    def backward(ctx, g_image, _g_steps):
        volume, tf, image = ctx.saved_tensors
        rays, config, sampling_rate, ert = ctx.march
        d_volume, d_tf, _ = march_diff_bwd(volume, tf, rays, config,
                                           sampling_rate, image, g_image,
                                           ert)
        need_v, need_t = ctx.needs_input_grad[:2]
        return (d_volume if need_v else None, d_tf if need_t else None,
                None, None, None, None)


def march_diff(volume: torch.Tensor, tf: torch.Tensor, rays: RayBundle,
               config: RenderConfig, sampling_rate, ert: bool = True):
    """Differentiable-path march, differentiable in ``volume`` and ``tf``:
    K1 forward and K2 backward on CUDA tensors, :func:`march_diff_plain`
    (differentiated by autograd) on CPU tensors.  Returns
    ``(image (H, W, 4), valid_steps (H, W))``."""
    if _build.uses_plain(volume):
        return march_diff_plain(volume, tf, rays, config, sampling_rate, ert)
    return _MarchDiff.apply(volume, tf, rays, config, sampling_rate, ert)


def march_nondiff(volume: torch.Tensor, tf: torch.Tensor, rays: RayBundle,
                  config: RenderConfig, sampling_rate, occupancy=None):
    """Inference march: kernel K3 on CUDA tensors (counted in
    ``march_nondiff.launches``), :func:`march_nondiff_plain` on CPU
    tensors.  With an ``occupancy`` grid each ray jumps over empty space.
    Returns ``(image, visited, composited)`` as the plain version does."""
    if _build.uses_plain(volume):
        return march_nondiff_plain(volume, tf, rays, config, sampling_rate,
                                   occupancy)
    _check_grid(occupancy, config)
    composited = torch.empty(config.image_shape, dtype=torch.int32,
                             device=volume.device)
    image, visited = _launch_march(
        "dr_march_nondiff", volume, tf, rays, config, sampling_rate, True,
        np.iinfo(np.int32).max, composited, occupancy)
    march_nondiff.launches += 1
    return image, visited, composited


march_nondiff.launches = 0


# ---------------------------------------------------------------------------
# Public functional API
# ---------------------------------------------------------------------------

def _inputs(volume, tf, look_from, config):
    """f32 views of the inputs; the camera never gets a gradient."""
    dev = volume.device
    look_from = torch.as_tensor(look_from, dtype=torch.float32,
                                device=dev).detach()
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
    to ``volume`` and ``tf``; ``look_from`` gets no gradient.
    """
    sr = config.sampling_rate if sampling_rate is None else sampling_rate
    volume, tf, look_from = _inputs(volume, tf, look_from, config)
    if u is None and generator is not None:
        u = torch.rand(config.image_shape, generator=generator,
                       dtype=torch.float32, device=volume.device)
    rays = make_rays(look_from, config, sr, u=u)
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
    volume, tf, look_from = _inputs(volume, tf, look_from, config)
    if occupancy is None and config.occupancy_skip:
        occupancy = build_occupancy(volume, tf, config)
    rays = make_rays(look_from, config, sr, u=u)
    image, _, _ = march_nondiff(volume, tf, rays, config, sr, occupancy)
    ones = torch.ones(config.image_shape, dtype=torch.int32,
                      device=volume.device)
    return RenderOutput(image=image, valid_steps=ones,
                        n_samples=rays.n_samples)


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
    ``(loss, (d_volume, d_tf))``, all detached."""
    v = volume.detach().to(torch.float32).requires_grad_(True)
    t = tf.detach().to(torch.float32).requires_grad_(True)
    with torch.enable_grad():
        out = render(v, t, look_from, config, sampling_rate, u=u, ert=ert)
        loss = loss_fn(out, *loss_args)
        d_v, d_t = torch.autograd.grad(loss, (v, t), allow_unused=True)
    d_v = torch.zeros_like(v) if d_v is None else d_v
    d_t = torch.zeros_like(t) if d_t is None else d_t
    return loss.detach(), (d_v, d_t)


__all__ = ["RenderOutput", "march_diff", "march_diff_fwd", "march_diff_bwd",
           "march_diff_plain", "march_diff_bwd_plain", "march_nondiff",
           "march_nondiff_plain", "render", "render_nondiff",
           "value_and_grad_render"]
