"""Camera model, ray generation and ray-AABB intersection (counterpart of
``differender_tpu/geometry.py``).

Plain float32 torch on the device of the camera tensor: ray setup is
elementwise over pixels and needs no kernel of its own.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .config import RenderConfig


class RayBundle(NamedTuple):
    """Per-pixel ray state; leading shape ``(H, W)``, row 0 = image top."""

    origin: torch.Tensor      # (3,) camera position
    dirs: torch.Tensor        # (H, W, 3) unit ray directions
    entry: torch.Tensor       # (H, W) distance to the (jittered) entry
    exit: torch.Tensor        # (H, W) distance to the exit
    n_samples: torch.Tensor   # (H, W) int32 sample count, 0 on a miss


class MarchParams(NamedTuple):
    """Sample ``s`` of a ray sits at ``t0 + s * dt`` (half-step ``t0``;
    ``dt = 0`` for ``n <= 1`` rays, ``t0 = 0`` for misses)."""

    t0: torch.Tensor   # (H, W)
    dt: torch.Tensor   # (H, W)


def normalize(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Unit-normalize (0/0 gives NaN, as in the JAX package)."""
    return v / torch.linalg.vector_norm(v, dim=dim, keepdim=True)


def ray_directions(look_from: torch.Tensor,
                   config: RenderConfig) -> torch.Tensor:
    """Perspective directions ``(H, W, 3)`` of a camera at ``look_from``
    looking at the origin.  Pixel ``(h, w)`` uses ``x=(w+0.5)/W`` and
    ``y=1-(h+0.5)/H``; the near plane is ``2*tan(fov)*near`` high."""
    H, W = config.image_shape
    dev = look_from.device
    look_from = look_from.to(torch.float32)
    view_dir = normalize(look_from * -1.0)

    x = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5) / W
    y = 1.0 - (torch.arange(H, dtype=torch.float32, device=dev) + 0.5) / H
    u = x - 0.5
    v = y - 0.5

    world_up = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=dev)
    alt_up = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float32, device=dev)
    right_raw = torch.linalg.cross(view_dir, world_up)
    # Pole guard: a camera on the y axis has no right vector from world_up;
    # fall back to x as the up hint there.
    degenerate = torch.sum(right_raw * right_raw) < 1e-12
    right_raw = torch.where(degenerate, torch.linalg.cross(view_dir, alt_up),
                            right_raw)
    right = normalize(right_raw)
    up = normalize(torch.linalg.cross(right, view_dir))

    # f32 host scalars, rounded as the JAX package rounds them.
    near_h = (np.float32(2.0) * np.tan(np.float32(config.fov_rad))
              * np.float32(config.near))
    near_w = float(near_h * np.float32(config.aspect))
    near_h = float(near_h)

    offset = (config.near * view_dir[None, None, :]
              + (u * near_w)[None, :, None] * right[None, None, :]
              + (v * near_h)[:, None, None] * up[None, None, :])
    return normalize(offset)


def ray_aabb(origin: torch.Tensor, dirs: torch.Tensor, box_min, box_max):
    """Slab-method intersection; returns ``(tmin, tmax, hit)`` with a miss
    where ``tmax < 0``, ``tmin > tmax`` or either is not finite."""
    box_min = torch.tensor(box_min, dtype=torch.float32, device=dirs.device)
    box_max = torch.tensor(box_max, dtype=torch.float32, device=dirs.device)
    dirfrac = 1.0 / dirs
    t_lo = (box_min - origin) * dirfrac
    t_hi = (box_max - origin) * dirfrac
    tmin = torch.amax(torch.minimum(t_lo, t_hi), dim=-1)
    tmax = torch.amin(torch.maximum(t_lo, t_hi), dim=-1)
    hit = ~((tmax < 0.0) | (tmin > tmax))
    hit = hit & torch.isfinite(tmin) & torch.isfinite(tmax)
    return tmin, tmax, hit


def make_rays(look_from: torch.Tensor, config: RenderConfig,
              sampling_rate: float, u: Optional[torch.Tensor] = None,
              box_min=(-1.0, -1.0, -1.0),
              box_max=(1.0, 1.0, 1.0)) -> RayBundle:
    """Full ray setup.  ``n_samples = hit * (floor(sr * len * diag) + 1)``;
    with a uniform draw ``u`` of shape ``(H, W)`` the entry advances by
    ``u * len / n`` (ray-start jitter)."""
    look_from = look_from.to(torch.float32)
    dirs = ray_directions(look_from, config)
    tmin, tmax, hit = ray_aabb(look_from, dirs, box_min, box_max)

    ray_len = tmax - tmin
    sr = float(np.float32(sampling_rate))
    diag = float(np.float32(config.vol_diag))
    n_f = torch.floor(sr * ray_len * diag) + 1.0
    zero = torch.zeros((), dtype=torch.float32, device=dirs.device)
    n_samples = torch.where(hit, n_f, zero).to(torch.int32)

    if u is not None:
        if tuple(u.shape) != tuple(tmin.shape):
            raise ValueError(f"jitter u must have shape {tuple(tmin.shape)}; "
                             f"got {tuple(u.shape)}")
        u = u.to(device=dirs.device, dtype=torch.float32)
        step = ray_len / torch.clamp(n_f, min=1.0)
        tmin = torch.where(hit, tmin + u * step, tmin)

    return RayBundle(origin=look_from, dirs=dirs, entry=tmin, exit=tmax,
                     n_samples=n_samples)


def march_params(rays: RayBundle) -> MarchParams:
    n_f = rays.n_samples.to(torch.float32)
    safe_n = torch.clamp(n_f, min=1.0)
    ray_len = rays.exit - rays.entry
    t0 = rays.entry + 0.5 * ray_len / safe_n
    dt = (rays.exit - t0) / torch.clamp(n_f - 1.0, min=1.0)
    zero = torch.zeros((), dtype=torch.float32, device=t0.device)
    t0 = torch.where(rays.n_samples == 0, zero, t0)
    dt = torch.where(rays.n_samples <= 1, zero, dt)
    return MarchParams(t0=t0, dt=dt)


__all__ = ["RayBundle", "MarchParams", "normalize", "ray_directions",
           "ray_aabb", "make_rays", "march_params"]
