"""The ray-march renderer, forward paths (counterpart of
``differender_tpu/render.py``).

``march_diff`` runs kernel K1 (``march_diff_fwd``) and ``march_nondiff``
kernel K3 (``march_nondiff``), both in ``csrc/march.cu``, on CUDA tensors.
On CPU tensors each takes its plain sequential version beside it, which the
tests hold against the JAX package and ``chip_smoke.py`` holds the kernels
against on the card.  Both versions march each ray front to back and carry
the transmittance ``T`` multiplicatively: a step composites while
``T > f32(1 - ert_threshold)``, and the image alpha is ``1 - T``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _build
from .config import RenderConfig
from .geometry import RayBundle, make_rays, march_params
from .sampling import apply_tf, sample_with_gradient, trilinear, voxel_scale
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


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _plain_march(volume, tf, rays, config, sampling_rate, limit, ert,
                 nondiff):
    """Sequential march over the rays still alive; returns the flat
    composite ``(rgb, T)`` and per-ray counts ``(visited, composited)``."""
    origin = rays.origin.to(torch.float32)
    dirs, t0, dt, _ = _ray_soa(rays)
    N = dirs.shape[0]
    dev = volume.device
    thr = _ert_threshold(config)
    skip = float(np.float32(config.alpha_skip))
    T = torch.ones(N, dtype=torch.float32, device=dev)
    rgb = torch.zeros(N, 3, dtype=torch.float32, device=dev)
    visited = torch.zeros(N, dtype=torch.int32, device=dev)
    composited = torch.zeros(N, dtype=torch.int32, device=dev)
    idx = torch.arange(N, device=dev)
    s = 0
    while True:
        alive = limit[idx] > s
        if ert:
            alive &= T[idx] > thr
        idx = idx[alive]
        if idx.numel() == 0:
            break
        visited[idx] += 1
        t = t0[idx] + float(s) * dt[idx]
        pos = origin + t[:, None] * dirs[idx]
        if nondiff:
            rgba = apply_tf(tf, trilinear(volume, pos))
            keep = rgba[:, 3] > skip
            rgba, pos, on = rgba[keep], pos[keep], idx[keep]
            _, grad = sample_with_gradient(volume, pos, config.normal_delta)
        else:
            intensity, grad = sample_with_gradient(volume, pos,
                                                   config.normal_delta)
            rgba = apply_tf(tf, intensity)
            on = idx
        shaded = shade(pos, grad, rgba, dirs[on], origin, sampling_rate,
                       config, clamp_light=not nondiff)
        Ti = T[on]
        rgb[on] += Ti[:, None] * shaded[:, :3]
        T[on] = Ti * (1.0 - shaded[:, 3])
        composited[on] += 1
        s += 1
    return rgb, T, visited, composited


@torch.no_grad()
def march_diff_plain(volume: torch.Tensor, tf: torch.Tensor,
                     rays: RayBundle, config: RenderConfig, sampling_rate,
                     ert: bool = True):
    """Plain torch differentiable-path march (forward).  Marches samples
    ``s < min(n, max_samples)`` with the headlight clamped; returns
    ``(image (H, W, 4), valid_steps (H, W) int32)``."""
    H, W = config.image_shape
    limit = torch.clamp(rays.n_samples.reshape(-1), max=config.max_samples)
    rgb, T, _, comp = _plain_march(volume, tf, rays, config, sampling_rate,
                                   limit, ert, nondiff=False)
    image = torch.cat([rgb, (1.0 - T)[:, None]], dim=-1).reshape(H, W, 4)
    return image, (comp + 1).reshape(H, W)


@torch.no_grad()
def march_nondiff_plain(volume: torch.Tensor, tf: torch.Tensor,
                        rays: RayBundle, config: RenderConfig,
                        sampling_rate):
    """Plain torch inference march.  No ``max_samples`` cap; a sample
    composites only if its TF alpha is ``> alpha_skip``; no light clamp;
    the image ends with ``min(1, .)``.  Returns ``(image (H, W, 4),
    visited (H, W), composited (H, W))``: the samples each ray examined and
    the samples it composited."""
    H, W = config.image_shape
    limit = rays.n_samples.reshape(-1)
    rgb, T, vis, comp = _plain_march(volume, tf, rays, config, sampling_rate,
                                     limit, ert=True, nondiff=True)
    image = torch.cat([rgb, (1.0 - T)[:, None]], dim=-1)
    image = torch.clamp(image, max=1.0).reshape(H, W, 4)
    return image, vis.reshape(H, W), comp.reshape(H, W)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

class _MarchArgs(ctypes.Structure):
    """Mirror of ``struct MarchArgs`` in ``csrc/march.cu``."""
    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "dx", "dy", "dz", "t0", "dt", "n", "volume", "tf", "origin",
        "image", "steps", "shaded")]
        + [(f, ctypes.c_int) for f in (
            "H", "W", "X", "Y", "Z", "R", "max_steps", "ert")]
        + [(f, ctypes.c_float) for f in (
            "scale_x", "scale_y", "scale_z", "delta", "inv_sr", "thr",
            "ambient", "diffuse", "specular", "shininess",
            "lc_r", "lc_g", "lc_b", "alpha_skip")])


def _checked(name, t, dev, shape=None, dtype=torch.float32):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}; the volume on {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}; got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}; "
                         f"got {tuple(t.shape)}")
    return t.contiguous()


def _launch_march(entry, volume, tf, rays, config, sampling_rate, ert,
                  max_steps, with_shaded):
    """Validate, allocate the outputs and launch one march kernel."""
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

    image = torch.empty((H, W, 4), dtype=torch.float32, device=dev)
    steps = torch.empty((H, W), dtype=torch.int32, device=dev)
    shaded = (torch.empty((H, W), dtype=torch.int32, device=dev)
              if with_shaded else None)
    scale = voxel_scale(config.volume_shape)
    X, Y, Z = config.volume_shape
    lc = config.light_color
    args = _MarchArgs(
        dx.data_ptr(), dy.data_ptr(), dz.data_ptr(), t0.data_ptr(),
        dt.data_ptr(), n.data_ptr(), volume.data_ptr(), tf.data_ptr(),
        origin.data_ptr(), image.data_ptr(), steps.data_ptr(),
        shaded.data_ptr() if shaded is not None else None,
        H, W, X, Y, Z, tf.shape[0], max_steps, int(ert),
        float(scale[0]), float(scale[1]), float(scale[2]),
        float(np.float32(config.normal_delta)),
        float(np.float32(1.0) / np.float32(sampling_rate)),
        _ert_threshold(config), config.ambient, config.diffuse,
        config.specular, config.shininess, lc[0], lc[1], lc[2],
        config.alpha_skip)
    fn = getattr(_build.library(), entry)
    # The tensors above stay referenced until the launch is enqueued; the
    # caching allocator keeps their memory for the stream after that.
    _build.check(fn(ctypes.byref(args), dev.index,
                    _build.stream_of(volume)), entry)
    return image, steps, shaded


def march_diff(volume: torch.Tensor, tf: torch.Tensor, rays: RayBundle,
               config: RenderConfig, sampling_rate, ert: bool = True):
    """Differentiable-path march, forward: kernel K1 on CUDA tensors (one
    launch, counted in ``march_diff.launches``), :func:`march_diff_plain`
    on CPU tensors.  Returns ``(image (H, W, 4), valid_steps (H, W))``."""
    if _build.uses_plain(volume):
        return march_diff_plain(volume, tf, rays, config, sampling_rate, ert)
    image, steps, _ = _launch_march(
        "dr_march_diff_fwd", volume, tf, rays, config, sampling_rate, ert,
        config.max_samples, with_shaded=False)
    march_diff.launches += 1
    return image, steps


march_diff.launches = 0


def march_nondiff(volume: torch.Tensor, tf: torch.Tensor, rays: RayBundle,
                  config: RenderConfig, sampling_rate):
    """Inference march: kernel K3 on CUDA tensors (counted in
    ``march_nondiff.launches``), :func:`march_nondiff_plain` on CPU
    tensors.  Returns ``(image, visited, composited)`` as the plain
    version does."""
    if _build.uses_plain(volume):
        return march_nondiff_plain(volume, tf, rays, config, sampling_rate)
    image, visited, composited = _launch_march(
        "dr_march_nondiff", volume, tf, rays, config, sampling_rate, True,
        np.iinfo(np.int32).max, with_shaded=True)
    march_nondiff.launches += 1
    return image, visited, composited


march_nondiff.launches = 0


# ---------------------------------------------------------------------------
# Public functional API
# ---------------------------------------------------------------------------

def _inputs(volume, tf, look_from, config):
    if torch.is_grad_enabled() and (volume.requires_grad
                                    or tf.requires_grad):
        raise NotImplementedError(
            "gradients of the render are not ported yet; call under "
            "torch.no_grad() or pass tensors that do not require grad")
    dev = volume.device
    look_from = torch.as_tensor(look_from, dtype=torch.float32, device=dev)
    return volume.to(torch.float32), tf.to(torch.float32), look_from


def render(volume: torch.Tensor, tf: torch.Tensor, look_from,
           config: RenderConfig, sampling_rate: Optional[float] = None,
           u: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None,
           ert: bool = True) -> RenderOutput:
    """Differentiable-path render of one view, forward only.

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
    Runs where ``volume`` lives: kernel K1 on CUDA, the plain march on CPU.
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
    given.  ``occupancy`` is accepted and ignored: K3 ends each ray by itself
    and an empty-space skip does not change the image.  ``valid_steps`` is
    all ones, as in the JAX package."""
    sr = 4.0 * config.sampling_rate if sampling_rate is None else sampling_rate
    volume, tf, look_from = _inputs(volume, tf, look_from, config)
    rays = make_rays(look_from, config, sr, u=u)
    image, _, _ = march_nondiff(volume, tf, rays, config, sr)
    ones = torch.ones(config.image_shape, dtype=torch.int32,
                      device=volume.device)
    return RenderOutput(image=image, valid_steps=ones,
                        n_samples=rays.n_samples)


__all__ = ["RenderOutput", "march_diff", "march_diff_plain",
           "march_nondiff", "march_nondiff_plain", "render",
           "render_nondiff"]
