"""Plain PyTorch reference of the shear-warp fast render that the
``viewer_fast`` job times.

The method is Lacroute and Levoy's perspective shear-warp factorization
(SIGGRAPH 1994), written here from the program's documented semantics,
not from its code:

- the volume ``(X, Y, Z)`` is augmented with its clamped central-difference
  gradient, each axis's difference scaled by ``size - 1``;
- the principal axis is the first of the largest ``|look_from|``; the
  frame moves it last (the other two follow in cyclic order: x, y after
  z; y, z after x; z, x after y) and, where the camera lies on its
  positive side, flips it, so that the camera is on the negative side;
  the flip negates the z gradient;
- the intermediate image is an ``O x O`` grid on the frame's ``z = 0``
  plane spanning the projections of the box's eight corners from the
  camera, widened by ``1e-3`` on each side;
- ``round(planes_per_voxel * Z)`` planes lie at ``linspace(-1, 1)`` in
  float32 (``s = i / (n - 1)``, then ``-1 * (1 - s) + 1 * s``, each
  operation rounded once, the last plane at 1); each plane is the lerp of
  its two voxel layers at ``z = (zw + 1) (Z - 1) / 2`` clamped to ``[0, Z -
  1]``;
- each intermediate pixel's ray crosses plane ``zw`` at ``l + sz (g - l)``
  with ``sz = (zw - l_z) / (0 - l_z)``; the plane is resampled there by a
  separable 2-tap lerp (along x, then along y) on voxel coordinates ``(c +
  1) (size - 1) / 2``, both weights 0 outside ``[0, size - 1]``, and the
  product of the two axes' weight sums is the sample's coverage;
- the resampled intensity goes through the linear TF lookup with clamped
  ends (:func:`dvr.tf_lookup`); the headlight at ``look_from + (0, 1, 0)``
  shades it with the resampled gradient's unit normal (ambient + diffuse
  + specular, the light clamped at 1); the opacity is corrected with the
  pixel's own exponent ``dz |g - l| / |l_z| * vol_diag`` (``dz = 2 / (n -
  1)``, ``vol_diag = |shape - 1|``) and weighed by the coverage;
- the samples are composited front to back, each while the pixel's
  transmittance T stays above ``1 - ert_threshold``;
- one bilinear warp maps the intermediate image onto each final pixel at
  its ray's crossing of the frame's ``z = 0`` plane (its index clamped to
  the grid), zero where the ray misses the box.

Departures from the published method: the planes lie at
``planes_per_voxel`` a voxel layer, each the z-lerp of its two layers
(the published method resamples the voxel slices themselves); the
classification follows the resample (the published method classifies the
voxels first); no run-length encoding skips transparent voxels (every
plane is marched; a sample outside the footprint has coverage 0 and adds
nothing), while the gate on T stops opaque pixels as the published
method's opaque-pixel links do; and the opacity correction takes each
intermediate pixel's own step between planes.

Plain float32, plane by plane over the whole intermediate grid, one view
at a time, with no kernels; it imports nothing of the program under test.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from . import dvr


class Frame(NamedTuple):
    """A view in its slab frame."""
    channels: torch.Tensor   # (4, X, Y, Z): intensity, gradient x, y, z
    cam: torch.Tensor        # (3,) the camera
    light: torch.Tensor      # (3,) the headlight
    perm: tuple              # the world axes that became x, y, z
    sign: float              # -1 where z was flipped, else 1


class Grid(NamedTuple):
    """The intermediate grid and the planes of a frame."""
    ga: torch.Tensor         # (O,) x of each grid row
    gb: torch.Tensor         # (O,) y of each grid column
    x0: torch.Tensor
    y0: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    zws: torch.Tensor        # (S,) each plane's z
    zlo: torch.Tensor        # (S,) int64: its lower voxel layer
    zhi: torch.Tensor        # (S,) its upper layer
    fz: torch.Tensor         # (S,) the upper layer's weight
    exponent: torch.Tensor   # (O, O) the opacity correction's exponent


class Taps(NamedTuple):
    """A 1-D linear resample's two taps at each position."""
    lo: torch.Tensor         # int64
    hi: torch.Tensor
    w_lo: torch.Tensor
    w_hi: torch.Tensor
    inside: torch.Tensor     # bool: the position lies in [0, size - 1]


def gradient_volume(vol: torch.Tensor) -> torch.Tensor:
    """``(4, X, Y, Z)``: the volume and its clamped central differences,
    each scaled by its axis's ``size - 1``."""
    out = [vol]
    for axis in range(3):
        n = vol.shape[axis]
        idx = torch.arange(n, device=vol.device)
        up = vol.index_select(axis, torch.clamp(idx + 1, max=n - 1))
        dn = vol.index_select(axis, torch.clamp(idx - 1, min=0))
        out.append((up - dn) * float(n - 1))
    return torch.stack(out)


def slab_frame(vol: torch.Tensor, look_from: torch.Tensor) -> Frame:
    """The view of ``vol`` (X, Y, Z) from ``look_from`` in its slab
    frame."""
    lf = [float(c) for c in look_from.tolist()]
    p = max(range(3), key=lambda i: abs(lf[i]))
    perm = ((p + 1) % 3, (p + 2) % 3, p)
    ch = gradient_volume(vol).permute(0, *(a + 1 for a in perm))
    ch = torch.stack([ch[0], ch[1 + perm[0]], ch[1 + perm[1]],
                      ch[1 + perm[2]]])
    sign = -1.0 if lf[p] > 0 else 1.0
    if sign < 0:
        ch = ch.flip(3)
        ch[3] = -ch[3]
    flip = torch.tensor([1.0, 1.0, sign], device=vol.device)
    lf_t = look_from.to(torch.float32)
    light = lf_t + torch.tensor([0.0, 1.0, 0.0], device=vol.device)
    return Frame(ch.contiguous(), lf_t[list(perm)] * flip,
                 light[list(perm)] * flip, perm, sign)


def _linspace_f32(n: int) -> torch.Tensor:
    """The planes' z on the host: ``i / (n - 1)`` a true f32 division (a
    CUDA tensor divided by a number is multiplied by its reciprocal)."""
    if n == 1:
        return torch.tensor([-1.0])
    i = torch.arange(n - 1, dtype=torch.float32)
    s = i / torch.full_like(i, n - 1)
    return torch.cat([-1.0 * (1.0 - s) + 1.0 * s, torch.ones(1)])


def grid(frame: Frame, O: int, planes_per_voxel: float) -> Grid:
    """The ``O x O`` intermediate grid and the planes of ``frame``."""
    dev = frame.cam.device
    _, X, Y, Z = frame.channels.shape
    lx, ly, lz = frame.cam.unbind(0)
    corners = torch.tensor([[x, y, z] for x in (-1.0, 1.0)
                            for y in (-1.0, 1.0) for z in (-1.0, 1.0)],
                           device=dev)
    t = -lz / (corners[:, 2] - lz)
    ax = lx + (corners[:, 0] - lx) * t
    ay = ly + (corners[:, 1] - ly) * t
    x0, y0 = ax.min() - 1e-3, ay.min() - 1e-3
    dx = (ax.max() + 1e-3 - x0) / (O - 1)
    dy = (ay.max() + 1e-3 - y0) / (O - 1)
    steps = torch.arange(O, dtype=torch.float32, device=dev)
    ga, gb = x0 + dx * steps, y0 + dy * steps
    n = max(1, int(round(planes_per_voxel * Z)))
    zws = _linspace_f32(n)
    zv = torch.clamp((zws + 1.0) * float(0.5 * (Z - 1)), 0.0, Z - 1.0)
    zlo = torch.floor(zv)
    zws, fz, zlo = zws.to(dev), (zv - zlo).to(dev), zlo.long().to(dev)
    zhi = torch.clamp(zlo + 1, max=Z - 1)
    dz = 2.0 / (n - 1) if n > 1 else 2.0
    dist = torch.sqrt((ga[:, None] - lx) ** 2 + (gb[None, :] - ly) ** 2
                      + lz ** 2)
    diag = math.sqrt(sum((s - 1.0) ** 2 for s in (X, Y, Z)))
    exponent = dz * dist / torch.abs(lz) * dvr._f32(diag)
    return Grid(ga, gb, x0, y0, dx, dy, zws, zlo, zhi, fz, exponent)


def taps(src: torch.Tensor, size: int) -> Taps:
    """The 2-tap lerp at voxel coordinates ``src`` along an axis of
    ``size`` voxels."""
    lo_f = torch.floor(src)
    frac = src - lo_f
    inside = (src >= 0.0) & (src <= size - 1.0)
    lo = torch.clamp(lo_f, 0.0, size - 1.0).long()
    zero = torch.zeros_like(src)
    return Taps(lo, torch.clamp(lo + 1, max=size - 1),
                torch.where(inside, 1.0 - frac, zero),
                torch.where(inside, frac, zero), inside)


def plane(frame: Frame, g: Grid, s: int):
    """Plane ``s``: its z, each row's and each column's crossing ``(px
    (O,), py (O,))`` and their taps."""
    _, X, Y, _ = frame.channels.shape
    lx, ly, lz = frame.cam.unbind(0)
    zw = g.zws[s]
    sz = (zw - lz) / (0.0 - lz)
    px = lx + sz * (g.ga - lx)
    py = ly + sz * (g.gb - ly)
    return (zw, px, py, taps((px + 1.0) * dvr._f32(0.5 * (X - 1)), X),
            taps((py + 1.0) * dvr._f32(0.5 * (Y - 1)), Y))


def _unit(x, y, z):
    """``(x, y, z) / |(x, y, z)|``, the squared norm held above 1e-30."""
    m = torch.sqrt(torch.clamp(x * x + y * y + z * z, min=1e-30))
    return x / m, y / m, z / m


def _shade(grad, px, py, pz, frame: Frame, optics: dvr.Optics):
    """The headlight's light at the samples, clamped at 1."""
    gx, gy, gz = grad
    g2 = gx * gx + gy * gy + gz * gz
    has_n = g2 > 0.0
    gm = torch.where(has_n, torch.sqrt(g2), torch.ones_like(g2))
    nx, ny, nz = (torch.where(has_n, a / gm, torch.zeros_like(a))
                  for a in (gx, gy, gz))
    hx, hy, hz = frame.light.unbind(0)
    ux, uy, uz = _unit(px - hx, py - hy, pz - hz)
    dot = nx * ux + ny * uy + nz * uz
    zero = torch.zeros_like(dot)
    diffuse = optics.diffuse * torch.where(has_n, torch.clamp(dot, min=0.0),
                                           zero)
    rx, ry, rz = ux - 2.0 * dot * nx, uy - 2.0 * dot * ny, uz - 2.0 * dot * nz
    cx, cy, cz = frame.cam.unbind(0)
    vx, vy, vz = _unit(px - cx, py - cy, pz - cz)
    rv = torch.clamp(-(rx * vx + ry * vy + rz * vz), min=0.0)
    specular = optics.specular * torch.where(
        has_n, torch.pow(rv, optics.shininess), zero)
    return torch.clamp(diffuse + specular + optics.ambient, max=1.0)


Visit = Callable[[int, Taps, Taps, torch.Tensor], None]


def intermediate(frame: Frame, tf: torch.Tensor, g: Grid,
                 optics: dvr.Optics, visit: Optional[Visit] = None
                 ) -> torch.Tensor:
    """The intermediate image ``(O, O, 4)`` of ``frame`` under ``tf`` (R,
    4), marched plane by plane front to back.  ``visit(s, taps_x, taps_y,
    alive)``, if given, sees each plane's taps and the pixels whose
    transmittance is above the gate before it."""
    O = g.ga.shape[0]
    dev = frame.cam.device
    thr = dvr._f32(1.0 - optics.ert_threshold)
    rgb = torch.zeros((O, O, 3), device=dev)
    T = torch.ones((O, O), device=dev)
    layers = frame.channels
    zlo, zhi = g.zlo.tolist(), g.zhi.tolist()
    for s in range(len(zlo)):
        if s % 16 == 0 and not bool((T > thr).any()):
            break
        zw, px, py, tx, ty = plane(frame, g, s)
        alive = T > thr
        if visit is not None:
            visit(s, tx, ty, alive)
        f = g.fz[s]
        slab = (layers[..., zlo[s]] * (1.0 - f)
                + layers[..., zhi[s]] * f)                         # (4, X, Y)
        along_x = (slab[:, tx.lo] * tx.w_lo[None, :, None]
                   + slab[:, tx.hi] * tx.w_hi[None, :, None])      # (4, O, Y)
        v = (along_x[:, :, ty.lo] * ty.w_lo[None, None, :]
             + along_x[:, :, ty.hi] * ty.w_hi[None, None, :])      # (4, O, O)
        cover = ((tx.w_lo + tx.w_hi)[:, None]
                 * (ty.w_lo + ty.w_hi)[None, :])
        c = dvr.tf_lookup(tf, v[0])                                # (O, O, 4)
        light = _shade(v[1:], px[:, None].expand(O, O),
                       py[None, :].expand(O, O), zw.expand(O, O), frame,
                       optics)
        alpha = (1.0 - torch.pow(torch.clamp(1.0 - c[..., 3], min=0.0),
                                 g.exponent)) * cover
        color = light[..., None] * c[..., :3] * alpha[..., None]
        rgb = torch.where(alive[..., None], rgb + T[..., None] * color, rgb)
        T = torch.where(alive, T * (1.0 - alpha), T)
    return torch.cat([rgb, (1.0 - T)[..., None]], -1)


def warp(inter: torch.Tensor, g: Grid, frame: Frame, look_from, height: int,
         width: int, shape, optics: dvr.Optics) -> torch.Tensor:
    """The final image ``(4, H, W)``: the intermediate image at each
    pixel's ray's crossing of the frame's ``z = 0`` plane, bilinear, zero
    where the ray misses the box."""
    O = inter.shape[0]
    rays = dvr.camera_rays(look_from, height, width, shape, 1.0, optics)
    flip = torch.tensor([1.0, 1.0, frame.sign], device=inter.device)
    d = rays.dirs[:, list(frame.perm)] * flip
    t = (0.0 - frame.cam[2]) / d[:, 2]
    ia = torch.clamp((frame.cam[0] + t * d[:, 0] - g.x0) / g.dx, 0.0, O - 1.0)
    ib = torch.clamp((frame.cam[1] + t * d[:, 1] - g.y0) / g.dy, 0.0, O - 1.0)
    a0, b0 = torch.floor(ia), torch.floor(ib)
    fa, fb = (ia - a0)[:, None], (ib - b0)[:, None]
    # Indices clamped again: a ray parallel to the plane gives NaN.
    a0 = torch.clamp(a0.nan_to_num(0.0).long(), 0, O - 1)
    b0 = torch.clamp(b0.nan_to_num(0.0).long(), 0, O - 1)
    a1, b1 = torch.clamp(a0 + 1, max=O - 1), torch.clamp(b0 + 1, max=O - 1)
    img = ((inter[a0, b0] * (1.0 - fa) + inter[a1, b0] * fa) * (1.0 - fb)
           + (inter[a0, b1] * (1.0 - fa) + inter[a1, b1] * fa) * fb)
    img = torch.where((rays.n > 0)[:, None], img, torch.zeros_like(img))
    return img.reshape(height, width, 4).permute(2, 0, 1)


@torch.no_grad()
def render_views(volume_user, tf_user, look_froms, height: int, width: int,
                 intermediate_size: int, planes_per_voxel: float,
                 optics: dvr.Optics) -> torch.Tensor:
    """Images ``(V, 4, H, W)`` of views ``look_froms`` (V, 3) of a user
    volume ``(D, H, W)`` under a TF ``(4, R)``."""
    vol = dvr.internal(volume_user.to(torch.float32))
    tf = tf_user.to(torch.float32).t().contiguous()
    out = []
    for lf in look_froms:
        frame = slab_frame(vol, lf)
        g = grid(frame, intermediate_size, planes_per_voxel)
        inter = intermediate(frame, tf, g, optics)
        out.append(warp(inter, g, frame, lf, height, width,
                        tuple(vol.shape), optics))
        del frame
    return torch.stack(out)
