"""Plain PyTorch reference of the two ray marches the benchmark times.

Written from the renderer's documented semantics, not from its code: a
perspective camera at ``look_from`` looking at the origin (near plane
``2 tan(fov) near`` high), rays clipped to the [-1, 1]^3 box, ``n =
floor(sr * len * diag) + 1`` samples at ``t0 + s dt`` (half-step ``t0``,
the entry jittered by ``u * len / n``), trilinear sampling on voxel
coordinates ``clamp(p/2 + 1/2, 0, 1) * (size - 1 - 1e-4)``, a 6-point
central-difference normal at ``+-delta`` (world units), a linear TF lookup
with clamped ends, the opacity correction ``1 - (1 - a)^(1/sr)``, a
headlight at ``look_from + (0, 1, 0)`` (ambient + diffuse + specular, the
differentiable march clamps the light at 1), front-to-back compositing
while the transmittance stays above ``1 - ert``.  The differentiable march
stops at ``max_samples``; the inference march has no cap, skips samples
whose TF alpha is at or below ``alpha_skip`` and clamps the image at 1.

Volumes come in the user layout ``(D, H, W)``; world x, y, z run along W,
D, H.  Images are ``(4, H, W)`` with row 0 at the top.

The march is vectorised over rays and over chunks of samples along them:
a chunk's transmittance is a running product (``cumprod``), so a ray's
last composited sample can differ from a one-sample-at-a-time march where
its transmittance sits within rounding of the threshold.  Gradients are
autograd's, through a trilinear gather that keeps only positions for its
backward, and the unit normal's VJP divides by ``max(|g|, 1e-6)``.  This
module imports nothing of the program under test.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

# Corner order of the trilinear sum (x fastest).
_CORNERS = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
            (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1))
# The centre, then +-delta along x, y, z.
_STENCIL = ((0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
            (0, 0, 1), (0, 0, -1))


@dataclasses.dataclass(frozen=True)
class Optics:
    """The renderer's constants, as a configuration file states them."""
    fov: float = 30.0
    near: float = 0.1
    ambient: float = 0.4
    diffuse: float = 0.8
    specular: float = 0.3
    shininess: float = 32.0
    ert_threshold: float = 0.99
    alpha_skip: float = 1e-3
    normal_delta: float = 1e-3

    @classmethod
    def from_config(cls, cfg: dict) -> "Optics":
        return cls(**{f.name: float(cfg[f.name])
                      for f in dataclasses.fields(cls)})


class Rays(NamedTuple):
    """Flat rays of one or more views: sample ``s`` of ray ``i`` sits at
    ``origin[i] + (t0[i] + s dt[i]) dirs[i]``."""
    origin: torch.Tensor   # (N, 3)
    dirs: torch.Tensor     # (N, 3)
    t0: torch.Tensor       # (N,)
    dt: torch.Tensor       # (N,)
    n: torch.Tensor        # (N,) int64 sample count, 0 on a miss

    def rows(self, sl) -> "Rays":
        return Rays(*(x[sl] for x in self))


def _f32(x: float) -> float:
    return float(np.float32(x))


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def camera_rays(look_from: torch.Tensor, height: int, width: int,
                volume_shape, sampling_rate: float, optics: Optics,
                u: Optional[torch.Tensor] = None) -> Rays:
    """The rays of one view, ``(H * W)`` of them in row-major pixel
    order; ``u`` (H, W) jitters each entry."""
    dev = look_from.device
    lf = look_from.to(torch.float32)
    view = _unit(-lf)
    right = torch.linalg.cross(view, torch.tensor([0.0, 1.0, 0.0],
                                                  device=dev))
    if float(right.dot(right)) < 1e-12:    # a camera on the y axis
        right = torch.linalg.cross(view, torch.tensor([1.0, 0.0, 0.0],
                                                      device=dev))
    right = _unit(right)
    up = _unit(torch.linalg.cross(right, view))
    px = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) / width
    py = 1.0 - (torch.arange(height, dtype=torch.float32, device=dev)
                + 0.5) / height
    near_h = np.float32(2.0) * np.tan(np.float32(math.radians(optics.fov))) \
        * np.float32(optics.near)
    near_w = float(near_h * np.float32(width / height))
    off = (optics.near * view
           + ((px - 0.5) * near_w)[None, :, None] * right
           + ((py - 0.5) * float(near_h))[:, None, None] * up)
    dirs = _unit(off).reshape(-1, 3)

    inv = 1.0 / dirs
    t_a = (-1.0 - lf) * inv
    t_b = (1.0 - lf) * inv
    tmin = torch.amax(torch.minimum(t_a, t_b), dim=-1)
    tmax = torch.amin(torch.maximum(t_a, t_b), dim=-1)
    hit = ((tmax >= 0.0) & (tmin <= tmax) & torch.isfinite(tmin)
           & torch.isfinite(tmax))
    length = tmax - tmin
    diag = _f32(math.sqrt(sum((s - 1.0) ** 2 for s in volume_shape)))
    n_f = torch.floor(_f32(sampling_rate) * length * diag) + 1.0
    n_f = torch.where(hit, n_f, torch.zeros_like(n_f))
    if u is not None:
        tmin = torch.where(hit, tmin + u.reshape(-1).to(torch.float32)
                           * length / torch.clamp(n_f, min=1.0), tmin)
    t0 = tmin + 0.5 * (tmax - tmin) / torch.clamp(n_f, min=1.0)
    dt = (tmax - t0) / torch.clamp(n_f - 1.0, min=1.0)
    t0 = torch.where(n_f == 0, torch.zeros_like(t0), t0)
    dt = torch.where(n_f <= 1, torch.zeros_like(dt), dt)
    return Rays(lf.expand(dirs.shape[0], 3), dirs, t0, dt, n_f.long())


def views_rays(look_froms: torch.Tensor, height, width, volume_shape,
               sampling_rate, optics: Optics,
               u: Optional[torch.Tensor] = None) -> Rays:
    """The rays of several views ``(V, 3)`` one after another."""
    per = [camera_rays(look_froms[i], height, width, volume_shape,
                       sampling_rate, optics, None if u is None else u[i])
           for i in range(look_froms.shape[0])]
    return Rays(*(torch.cat(parts) for parts in zip(*per)))


def _corner_terms(pos: torch.Tensor, shape):
    """Flat voxel offsets (int32) and weights of the 8 corners of each
    position, ``(M, 8)`` each, corners in the order of ``_CORNERS``.
    Coordinates stay below ``size - 1``, so a corner's high index is its
    low one plus 1 on every axis."""
    X, Y, Z = shape
    scale = torch.tensor([_f32(X - 1.0 - _f32(1e-4)),
                          _f32(Y - 1.0 - _f32(1e-4)),
                          _f32(Z - 1.0 - _f32(1e-4))], device=pos.device)
    c = torch.clamp(0.5 * pos.reshape(-1, 3) + 0.5, 0.0, 1.0) * scale
    low = torch.floor(c)
    f = c - low
    low = low.to(torch.int32)
    base = (low[:, 0] * Y + low[:, 1]) * Z + low[:, 2]
    offs = torch.tensor([cx * Y * Z + cy * Z + cz for cx, cy, cz in _CORNERS],
                        dtype=torch.int32, device=pos.device)
    idx = base[:, None] + offs
    w2 = torch.stack([1.0 - f, f], dim=-1)             # (M, 3, 2)
    wxy = w2[:, 0, None, :] * w2[:, 1, :, None]         # (M, y, x)
    w = wxy[:, None, :, :] * w2[:, 2, :, None, None]    # (M, z, y, x)
    return idx, w.reshape(-1, 8)


class _Trilinear(torch.autograd.Function):
    """Trilinear samples of an (X, Y, Z) volume at world positions; its
    backward recomputes the corners from the positions, so a march keeps
    12 bytes a point for its gradient rather than its corners."""

    @staticmethod
    def forward(ctx, volume, pos):
        idx, w = _corner_terms(pos, tuple(volume.shape))
        terms = volume.reshape(-1).index_select(0, idx.reshape(-1)) \
            .reshape(-1, 8) * w
        out = terms[:, 0]
        for k in range(1, 8):
            out = out + terms[:, k]
        ctx.save_for_backward(pos)
        ctx.shape = tuple(volume.shape)
        return out.reshape(pos.shape[:-1])

    @staticmethod
    def backward(ctx, grad):
        pos, = ctx.saved_tensors
        idx, w = _corner_terms(pos, ctx.shape)
        d = torch.zeros(int(np.prod(ctx.shape)), dtype=grad.dtype,
                        device=grad.device)
        d.index_add_(0, idx.reshape(-1),
                     (w * grad.reshape(-1, 1)).reshape(-1))
        return d.reshape(ctx.shape), None


def trilinear(volume: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    return _Trilinear.apply(volume, pos)


def stencil(volume: torch.Tensor, pos: torch.Tensor, delta: float):
    """The value at ``pos`` (M, 3) and the central differences ``v(p +
    delta e) - v(p - delta e)``."""
    offs = torch.tensor(_STENCIL, dtype=torch.float32,
                        device=pos.device) * _f32(delta)
    v = trilinear(volume, pos[:, None, :] + offs)
    return v[:, 0], torch.stack([v[:, 1] - v[:, 2], v[:, 3] - v[:, 4],
                                 v[:, 5] - v[:, 6]], dim=-1)


def tf_lookup(tf: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Linear RGBA lookup into ``tf`` (R, 4), ends clamped."""
    R = tf.shape[0]
    t = torch.maximum(x * float(R - 1), torch.zeros_like(x))
    low_f = torch.floor(t)
    frac = (t - low_f)[..., None]
    low = torch.clamp(low_f, max=float(R - 1)).long()
    high = torch.clamp(low + 1, max=R - 1)
    return tf[low] * (1.0 - frac) + tf[high] * frac


class _UnitNormal(torch.autograd.Function):
    """``g / |g|`` (0 for g = 0) with the VJP ``(v - (v.n) n) / max(|g|,
    1e-6)``, finite at a vanishing gradient."""

    @staticmethod
    def forward(ctx, g):
        g2 = (g * g).sum(-1)
        m = torch.where(g2 > 0.0, torch.rsqrt(torch.where(
            g2 > 0.0, g2, torch.ones_like(g2))), torch.zeros_like(g2))
        n = g * m[..., None]
        ctx.save_for_backward(g, n)
        return n

    @staticmethod
    def backward(ctx, v):
        g, n = ctx.saved_tensors
        inv = 1.0 / torch.clamp(torch.linalg.vector_norm(g, dim=-1),
                                min=1e-6)
        return (v - (v * n).sum(-1, keepdim=True) * n) * inv[..., None]


def shade(pos, grad, rgba, view, eye, sampling_rate, optics: Optics,
          clamp_light: bool) -> torch.Tensor:
    """Premultiplied ``(rgb * light * alpha, alpha)`` of samples, ``(M,
    4)``, ``alpha`` opacity-corrected."""
    zero = rgba.new_zeros(())
    alpha = 1.0 - torch.pow(torch.maximum(1.0 - rgba[:, 3], zero),
                            _f32(1.0 / _f32(sampling_rate)))
    has_n = (grad * grad).sum(-1) > 0.0
    n = _UnitNormal.apply(grad)
    light_pos = eye + torch.tensor([0.0, 1.0, 0.0], device=pos.device)
    ld = pos - light_pos
    lmag = torch.linalg.vector_norm(ld, dim=-1, keepdim=True)
    ld = ld / torch.where(lmag > 0.0, lmag, torch.ones_like(lmag))
    dot = (n * ld).sum(-1)
    diffuse = optics.diffuse * torch.where(has_n, torch.maximum(dot, zero),
                                           zero)
    refl = ld - 2.0 * dot[:, None] * n
    r_v = torch.maximum(-(refl * view).sum(-1), zero)
    specular = optics.specular * torch.where(
        has_n, torch.pow(r_v, optics.shininess), zero)
    light = diffuse + specular + optics.ambient
    if clamp_light:
        light = torch.minimum(light, torch.ones_like(light))
    return torch.cat([rgba[:, :3] * (light * alpha)[:, None],
                      alpha[:, None]], dim=-1)


BRICK = 8


def transparent_bricks(volume: torch.Tensor, tf: torch.Tensor,
                       below: float) -> torch.Tensor:
    """Per brick of ``BRICK``^3 cells, whether no sample in it can reach a
    TF alpha above ``below``: the largest alpha of the TF over the range
    of the brick's voxels (its cells' corners, one voxel past its end)
    does not.  A trilinear value lies in its cell's corner range and the TF
    is piecewise linear, so that range's largest alpha bounds every
    sample's; a margin covers rounding."""
    B = BRICK
    X, Y, Z = volume.shape
    nb = [-(-(n - 1) // B) for n in (X, Y, Z)]
    pad = [b * B + 1 - n for b, n in zip(nb, (X, Y, Z))]
    v = torch.nn.functional.pad(volume[None, None],
                                (0, pad[2], 0, pad[1], 0, pad[0]),
                                mode="replicate")
    hi = torch.nn.functional.max_pool3d(v, B + 1, B)[0, 0]
    lo = -torch.nn.functional.max_pool3d(-v, B + 1, B)[0, 0]
    alpha = tf[:, 3]
    R = alpha.numel()
    a_end = torch.maximum(tf_lookup(tf, lo)[..., 3], tf_lookup(tf, hi)[..., 3])
    # The texels strictly inside the range: their largest alpha.
    k0 = torch.clamp(torch.floor(lo * (R - 1)) + 1, 0, R - 1).long()
    k1 = torch.clamp(torch.ceil(hi * (R - 1)) - 1, 0, R - 1).long()
    ks = torch.arange(R, device=volume.device)
    inside = (ks[None, :] >= k0.reshape(-1, 1)) & \
        (ks[None, :] <= k1.reshape(-1, 1))
    a_in = torch.where(inside, alpha[None, :], torch.zeros_like(alpha)[None])
    amax = torch.maximum(a_end.reshape(-1), a_in.amax(1)).reshape(lo.shape)
    return amax <= 0.5 * below if below > 0 else amax <= 0.0


def brick_of(pos: torch.Tensor, shape) -> torch.Tensor:
    """Flat brick index of each position's cell."""
    X, Y, Z = shape
    scale = torch.tensor([_f32(n - 1.0 - _f32(1e-4)) for n in shape],
                         device=pos.device)
    c = torch.clamp(0.5 * pos + 0.5, 0.0, 1.0) * scale
    b = torch.div(torch.floor(c), BRICK, rounding_mode="floor").to(
        torch.int32)
    nb = [-(-(n - 1) // BRICK) for n in shape]
    return (b[..., 0] * nb[1] + b[..., 1]) * nb[2] + b[..., 2]


def march(volume: torch.Tensor, tf: torch.Tensor, rays: Rays,
          sampling_rate: float, optics: Optics, *, diff: bool,
          max_samples: int = 0, chunk_samples: int = 1 << 24
          ) -> torch.Tensor:
    """Front-to-back march of ``rays`` through ``volume`` (X, Y, Z);
    returns the flat composite (N, 4).  ``diff`` selects the
    differentiable march (cap ``max_samples``, no skip, light clamped);
    otherwise the inference march.  Samples are taken in chunks of about
    ``chunk_samples`` over the rays still alive."""
    dev = volume.device
    N = rays.n.shape[0]
    thr = _f32(1.0 - optics.ert_threshold)
    skip = _f32(optics.alpha_skip)
    limit = torch.clamp(rays.n, max=max_samples) if diff else rays.n
    rgb = torch.zeros((N, 3), dtype=torch.float32, device=dev)
    T = torch.ones(N, dtype=torch.float32, device=dev)
    if not diff:
        empty = transparent_bricks(volume, tf, skip)
    act = torch.nonzero(limit > 0).reshape(-1)
    base = 0
    while act.numel():
        k = int(max(4, min(512, chunk_samples // act.numel())))
        s = base + torch.arange(k, device=dev, dtype=torch.float32)
        lim = limit[act]
        valid = s[None, :] < lim[:, None].to(torch.float32)
        t = rays.t0[act][:, None] + s[None, :] * rays.dt[act][:, None]
        origin = rays.origin[act]
        dirs = rays.dirs[act]
        pos = origin[:, None, :] + t[..., None] * dirs[:, None, :]
        flat = pos.reshape(-1, 3)
        if diff:
            value, grad = stencil(volume, flat, optics.normal_delta)
            shaded = shade(flat, grad, tf_lookup(tf, value),
                           dirs[:, None, :].expand(-1, k, 3).reshape(-1, 3),
                           origin[:, None, :].expand(-1, k, 3).reshape(-1, 3),
                           sampling_rate, optics, clamp_light=True)
            shaded = shaded.reshape(act.numel(), k, 4)
            keep = valid
        else:
            # Only samples outside transparent bricks are looked up.
            cand = torch.nonzero(~empty.reshape(-1)[
                brick_of(flat, volume.shape)] & valid.reshape(-1))
            cand = cand.reshape(-1)
            rgba = tf_lookup(tf, trilinear(volume, flat[cand]))
            on = cand[rgba[:, 3] > skip]
            rgba = rgba[rgba[:, 3] > skip]
            keep = torch.zeros(flat.shape[0], dtype=torch.bool, device=dev)
            keep[on] = True
            keep = keep.reshape(act.numel(), k)
            shaded = torch.zeros((flat.shape[0], 4), dtype=torch.float32,
                                 device=dev)
            if on.numel():
                _, grad = stencil(volume, flat[on], optics.normal_delta)
                ray_of = on // k
                shaded[on] = shade(flat[on], grad, rgba, dirs[ray_of],
                                   origin[ray_of], sampling_rate, optics,
                                   clamp_light=False)
            shaded = shaded.reshape(act.numel(), k, 4)
        a = torch.where(keep, shaded[..., 3], torch.zeros_like(shaded[..., 3]))
        trans = torch.cumprod(1.0 - a, dim=1)
        T_act = T[act]
        T_before = T_act[:, None] * torch.cat(
            [torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=1)
        gate = keep & (T_before.detach() > thr)
        w = torch.where(gate, T_before, torch.zeros_like(T_before))
        rgb = rgb.index_add(0, act, (w[..., None] * shaded[..., :3]).sum(1))
        a_g = torch.where(gate, a, torch.zeros_like(a))
        T_new = T_act * torch.prod(1.0 - a_g, dim=1)
        T = T.index_copy(0, act, T_new)
        base += k
        alive = (T_new.detach() > thr) & (lim > base)
        act = act[alive]
    image = torch.cat([rgb, (1.0 - T)[:, None]], dim=-1)
    return image if diff else torch.clamp(image, max=1.0)


def internal(volume_user: torch.Tensor) -> torch.Tensor:
    """A user ``(D, H, W)`` volume as ``(X, Y, Z) = (W, D, H)``."""
    return volume_user.permute(2, 0, 1).contiguous()


def images(flat: torch.Tensor, views: int, height: int, width: int
           ) -> torch.Tensor:
    """Flat composites of ``views`` views to ``(V, 4, H, W)``."""
    return flat.reshape(views, height, width, 4).permute(0, 3, 1, 2)


@torch.no_grad()
def render_views(volume_user, tf_user, look_froms, height, width,
                 sampling_rate, optics: Optics, *, diff: bool,
                 max_samples: int = 0, u=None) -> torch.Tensor:
    """Images ``(V, 4, H, W)`` of views ``look_froms`` (V, 3) of a user
    volume ``(D, H, W)`` under a TF ``(4, R)``."""
    vol = internal(volume_user)
    rays = views_rays(look_froms, height, width, tuple(vol.shape),
                      sampling_rate, optics, u)
    flat = march(vol, tf_user.t().contiguous(), rays, sampling_rate, optics,
                 diff=diff, max_samples=max_samples)
    return images(flat, look_froms.shape[0], height, width)


def volume_vjp(volume_user, tf_user, look_froms, height, width,
               sampling_rate, optics: Optics, max_samples: int, u,
               cotangent: torch.Tensor, rays_per_block: int = 1 << 16
               ) -> torch.Tensor:
    """The gradient in a user volume of ``sum(cotangent * image)`` over
    the differentiable views, by autograd of :func:`march`, one block of
    rays at a time (each block's march is marched again under autograd)."""
    vol = internal(volume_user).requires_grad_(True)
    tf = tf_user.t().contiguous()
    rays = views_rays(look_froms, height, width, tuple(vol.shape),
                      sampling_rate, optics, u)
    cot = cotangent.permute(0, 2, 3, 1).reshape(-1, 4)
    N = rays.n.shape[0]
    with torch.enable_grad():
        for b in range(0, N, rays_per_block):
            sl = slice(b, min(N, b + rays_per_block))
            out = march(vol, tf, rays.rows(sl), sampling_rate, optics,
                        diff=True, max_samples=max_samples,
                        chunk_samples=1 << 22)
            torch.autograd.backward(out, cot[sl])
    return vol.grad.permute(1, 2, 0)
