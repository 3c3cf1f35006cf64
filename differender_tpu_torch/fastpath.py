"""Shear-warp fast volume renderer (counterpart of
``differender_tpu/fastpath.py``).

Lacroute's perspective shear-warp factorization, as in the JAX package:

  1. the volume is augmented with a clamped central-difference gradient
     field (:func:`intensity_gradient_volume`);
  2. along the principal axis of the view, each slab plane is resampled onto
     a fixed "intermediate image" grid (the rays' crossings with the ``z = 0``
     plane).  All rays pass through the camera, so that map is a per-slab
     scale and translation, and the resample is separable: a 2-tap lerp
     along x, then one along y.  The JAX package writes each 1-D resample as
     a matrix product against a hat-weight matrix for the TPU's matrix unit;
     each row of that matrix holds at most two non-zero weights, so here the
     two taps are gathered and weighed directly and no product is multiplied
     by zero;
  3. each slab sample is classified through the TF (kernel K0
     ``tf_lookup_fwd`` on CUDA tensors, its backward K0b ``tf_lookup_bwd``
     with the dot-form mask: ``d_intensity`` only where the lerp's
     ``frac > 0``, the VJP of the JAX package's ``apply_tf_dot``), shaded
     with the headlight and composited front to back in intermediate space
     with per-pixel opacity correction and the early-ray-termination gate;
  4. one bilinear warp maps the intermediate image onto the final pixels.

Semantics: a direct-volume renderer with the exact renderer's camera,
shading and compositing, but slab-aligned quadrature in place of per-ray
sampling; it converges to the exact renderer as ``intermediate`` and
``planes_per_voxel`` grow, and is not bit-exact with it.  Differentiable
with respect to the volume and the TF (the camera is held fixed).

Every value is computed in f32 by elementwise operations and gathers; no
product goes through a matrix multiply or a convolution, so neither the
``precision`` argument (kept for the JAX package's signature) nor PyTorch's
TF32 flags change the image.

Slabs are processed ``slab_batch`` at a time ("chunks").  Each chunk is
about a hundred small torch launches whatever its size, so on the card the
chunk count sets the time: the port's default batch is 32 slabs, not the
JAX package's 2 (its TPU sweep's winner).  Measured on an H100 80GB HBM3 at
700 W, the forward at 256^3 -> 512^2, O = 576, 2 planes per voxel took 641,
177 and 115 ms at batches 2, 8 and 32 on the noise scene (``chip_smoke.py``,
phase ``fastpath``).  A chunk whose pixels have all terminated is an exact
no-op, and since the transmittance only falls, the march stops at the first
chunk where no pixel is alive.  That test is a host sync on the card; it
is taken before every chunk after the first, as the JAX package takes it.
Under autograd each chunk runs
inside ``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint``):
the backward recomputes one chunk at a time, so it holds only each chunk's
inputs, O(O^2) per chunk, beside the slab stack.

The two powers of the shading (the opacity correction's exponent, below 1
at more than about 3.5 planes per voxel, and the specular shininess) have
an infinite slope at a base of 0.  Their VJP here is 0 wherever the incoming
cotangent is 0, so a pixel that the ERT gate or the footprint mask cuts off
contributes no ``0 * inf``: the gradient equals the JAX package's wherever
that is finite, and is NaN nowhere the JAX package's is not.

:func:`render_fast_plain` is the same code with the plain classify
(:func:`~differender_tpu_torch.sampling.apply_tf_dot`): the tests and
``chip_smoke.py`` hold :func:`render_fast` against it; :func:`render_fast`
never calls it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .config import RenderConfig
from .geometry import ray_aabb, ray_directions
from .ops.tf_lookup import tf_lookup
from .sampling import apply_tf_dot
from .shading import unit_normal

# Axis permutations that bring the principal axis p to the last position.
_PERMS = [(1, 2, 0), (2, 0, 1), (0, 1, 2)]

# Densities tried by choose_fast_params: (intermediate, planes_per_voxel).
_FAST_LADDER = ((None, 2.0), (768, 3.0), (1024, 4.0))


class FastRenderOutput(NamedTuple):
    image: torch.Tensor   # (H, W, 4)
    hit: torch.Tensor     # (H, W) bool: the pixel's ray meets the volume box


def intensity_gradient_volume(volume: torch.Tensor) -> torch.Tensor:
    """Channels ``(4, X, Y, Z)``: the intensity and its clamped central
    differences on the voxel grid, each scaled by ``shape[axis] - 1`` (a
    world-coordinate derivative per axis)."""
    def cdiff(axis):
        n = volume.shape[axis]
        up = torch.cat([volume.narrow(axis, 1, n - 1),
                        volume.narrow(axis, n - 1, 1)], axis)
        dn = torch.cat([volume.narrow(axis, 0, 1),
                        volume.narrow(axis, 0, n - 1)], axis)
        return (up - dn) * float(n - 1)

    return torch.stack([volume, cdiff(0), cdiff(1), cdiff(2)], 0)


def _lerp_taps(src: torch.Tensor, size: int):
    """The two taps of a 1-D linear resample at positions ``src`` (voxel
    coordinates) along an axis of ``size`` voxels: indices ``lo``,
    ``hi = min(lo + 1, size - 1)`` and weights ``1 - frac``, ``frac``, both
    weights 0 where ``src`` lies outside ``[0, size - 1]`` (the rows of the
    JAX package's ``_interp_matrix``)."""
    lo_f = torch.floor(src)
    frac = src - lo_f
    inside = (src >= 0.0) & (src <= size - 1.0)
    lo = torch.clamp(lo_f, 0.0, size - 1.0).to(torch.int64)
    hi = torch.clamp(lo + 1, max=size - 1)
    zero = src.new_zeros(())
    return lo, hi, torch.where(inside, 1.0 - frac, zero), \
        torch.where(inside, frac, zero)


def _resample(slab: torch.Tensor, taps_x, taps_y) -> torch.Tensor:
    """``(B, C, X, Y)`` slabs at the ``(B, R)`` x taps and the ``(B, O)`` y
    taps: ``(B, C, R, O)``, along x first and then along y."""
    B, C, X, Y = slab.shape
    lo, hi, w_lo, w_hi = taps_x
    R = lo.shape[1]
    ix = (B, C, R, Y)
    tmp = (torch.gather(slab, 2, lo[:, None, :, None].expand(ix))
           * w_lo[:, None, :, None]
           + torch.gather(slab, 2, hi[:, None, :, None].expand(ix))
           * w_hi[:, None, :, None])
    lo, hi, w_lo, w_hi = taps_y
    iy = (B, C, R, lo.shape[1])
    return (torch.gather(tmp, 3, lo[:, None, None, :].expand(iy))
            * w_lo[:, None, None, :]
            + torch.gather(tmp, 3, hi[:, None, None, :].expand(iy))
            * w_hi[:, None, None, :])


class _Pow(torch.autograd.Function):
    """``x ** e`` for a constant exponent ``e``, with the VJP
    ``g * (e * x ** (e - 1))`` (0 where ``e == 0``) taken as 0 wherever
    ``g == 0``, so that an infinite slope meets a zero cotangent as 0."""

    @staticmethod
    def forward(ctx, x, e):
        ctx.save_for_backward(x, e)
        return torch.pow(x, e)

    @staticmethod
    def backward(ctx, g):
        x, e = ctx.saved_tensors
        jac = torch.where(e == 0.0, torch.zeros_like(e),
                          e * torch.pow(x, e - 1.0))
        return torch.where(g == 0.0, torch.zeros_like(g), g * jac), None


def _shade(rgba, g, px, py, pz, lf, light, exponent, shininess, coverage,
           config: RenderConfig):
    """Headlight shading and opacity correction of classified slab samples
    ``rgba`` (..., 4) with gradients ``g`` (3, ...) at positions
    ``(px, py, pz)``; returns the premultiplied colour and the alpha.
    ``shininess`` is ``config.shininess`` as a 0-d tensor on the device."""
    lx, ly, lz = lf
    zero = px.new_zeros(())
    gx, gy, gz = g
    g2 = gx * gx + gy * gy + gz * gz
    nx, ny, nz = unit_normal(torch.stack([gx, gy, gz], -1)).unbind(-1)
    lxr, lyr, lzr = px - light[0], py - light[1], pz - light[2]
    lm = torch.rsqrt(torch.clamp(lxr * lxr + lyr * lyr + lzr * lzr,
                                 min=1e-30))
    lxr, lyr, lzr = lxr * lm, lyr * lm, lzr * lm
    ndl = torch.maximum(nx * lxr + ny * lyr + nz * lzr, zero)
    has_n = g2 > 0
    diffuse = config.diffuse * torch.where(has_n, ndl, zero)
    dot2 = nx * lxr + ny * lyr + nz * lzr
    rx = lxr - 2 * dot2 * nx
    ry = lyr - 2 * dot2 * ny
    rz = lzr - 2 * dot2 * nz
    vx, vy, vz = px - lx, py - ly, pz - lz
    vim = torch.rsqrt(torch.clamp(vx * vx + vy * vy + vz * vz, min=1e-30))
    vdx, vdy, vdz = vx * vim, vy * vim, vz * vim
    rdv = torch.maximum(-(rx * vdx + ry * vdy + rz * vdz), zero)
    specular = config.specular * torch.where(
        has_n, _Pow.apply(rdv, shininess), zero)
    lightf = torch.minimum(diffuse + specular + config.ambient,
                           px.new_ones(()))
    alpha = (1.0 - _Pow.apply(torch.maximum(1.0 - rgba[..., 3], zero),
                              exponent)) * coverage
    rgb = lightf[..., None] * rgba[..., :3] * alpha[..., None]
    return rgb, alpha


def _slab_planes(n_planes: int, Z: int):
    """Host-side f32 plane positions ``zws`` in [-1, 1] and each plane's two
    z layers and lerp weight.  The positions follow ``jnp.linspace``'s f32
    formula, ``-1 * (1 - s) + 1 * s`` with ``s = i / (n - 1)``, each
    operation rounded once: the JAX package's planes when its operations
    run one by one, and the same on every device."""
    f32 = np.float32
    if n_planes > 1:
        s = np.arange(n_planes - 1, dtype=f32) / f32(n_planes - 1)
        zws = np.append(f32(-1.0) * (f32(1.0) - s) + f32(1.0) * s, f32(1.0))
    else:
        zws = np.array([-1.0], f32)
    zsc = np.float32(0.5 * (Z - 1))
    zv = np.clip((zws + np.float32(1.0)) * zsc, np.float32(0.0),
                 np.float32(Z - 1.0))
    zlo = np.floor(zv).astype(np.int64)
    zhi = np.minimum(zlo + 1, Z - 1)
    fz = zv - np.floor(zv)
    return zws, zlo, zhi, fz


def _core(channels, tf, lf, light, config: RenderConfig, intermediate: int,
          planes_per_voxel: float, slab_batch: int, classify,
          row_offset: int = 0, n_rows: Optional[int] = None):
    """The intermediate image with the LAST axis as principal and the camera
    on its negative side: ``channels`` (4, X, Y, Z) already permuted and
    flipped, ``lf`` and ``light`` in that frame.  Computes only the
    intermediate rows ``[row_offset, row_offset + n_rows)`` (default all
    O): each row's pixels are computed as in the whole image, so strips
    join into it bit for bit (:func:`render_fast_sharded`).  Returns the
    intermediate RGBA ``(n_rows, O, 4)`` and the grid's extents ``(x0, y0,
    dx, dy)``."""
    C, X, Y, Z = channels.shape
    O = intermediate
    rows = O if n_rows is None else n_rows
    dev = channels.device
    lx, ly, lz = lf.unbind(0)

    # Intermediate grid: the volume corners' projections onto z = 0.
    corners = torch.tensor([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                            for sz in (-1, 1)], dtype=torch.float32,
                           device=dev)
    t0 = -lz / (corners[:, 2] - lz)
    ax = lx + (corners[:, 0] - lx) * t0
    ay = ly + (corners[:, 1] - ly) * t0
    x0, x1 = torch.min(ax) - 1e-3, torch.max(ax) + 1e-3
    y0, y1 = torch.min(ay) - 1e-3, torch.max(ay) + 1e-3
    dx = (x1 - x0) / (O - 1)
    dy = (y1 - y0) / (O - 1)
    ga = x0 + dx * torch.arange(row_offset, row_offset + rows,
                                dtype=torch.float32, device=dev)
    gb = y0 + dy * torch.arange(O, dtype=torch.float32, device=dev)

    # Per intermediate pixel, the opacity-correction exponent of its ray's
    # step between planes (the reference's density is vol_diag samples per
    # world unit).
    dmag = torch.sqrt((ga[:, None] - lx) ** 2 + (gb[None, :] - ly) ** 2
                      + lz ** 2)
    n_planes = max(1, int(round(planes_per_voxel * Z)))
    dz_world = 2.0 / (n_planes - 1) if n_planes > 1 else 2.0
    exponent = (dz_world * dmag / torch.abs(lz)
                * float(np.float32(config.vol_diag)))

    zws, zlo, zhi, fz = _slab_planes(n_planes, Z)
    fz_t = torch.from_numpy(fz).to(dev)[:, None, None, None]
    lo_slabs = torch.index_select(channels, 3, torch.from_numpy(zlo).to(dev))
    hi_slabs = torch.index_select(channels, 3, torch.from_numpy(zhi).to(dev))
    slabs = (lo_slabs.permute(3, 0, 1, 2) * (1.0 - fz_t)
             + hi_slabs.permute(3, 0, 1, 2) * fz_t).contiguous()  # (S,4,X,Y)
    del lo_slabs, hi_slabs

    B = max(1, int(slab_batch))
    S = n_planes
    n_chunks = -(-S // B)
    pad = n_chunks * B - S
    zws_c = torch.from_numpy(np.concatenate(
        [zws, np.ones(pad, np.float32)])).to(dev).reshape(n_chunks, B)
    valid_c = torch.from_numpy(np.concatenate(
        [np.ones(S, np.float32), np.zeros(pad, np.float32)])).to(
            dev).reshape(n_chunks, B)
    # Made once: a host-to-device copy waits for the stream.
    shininess = torch.tensor(float(config.shininess), device=dev)
    xsc = float(np.float32(0.5 * (X - 1)))
    ysc = float(np.float32(0.5 * (Y - 1)))
    thr = float(np.float32(1.0 - config.ert_threshold))

    def chunk(acc, T, slab, zw, vmask):
        sz = (zw - lz) / (0.0 - lz)                             # (B,)
        src_x = (lx + sz[:, None] * (ga[None] - lx) + 1.0) * xsc
        src_y = (ly + sz[:, None] * (gb[None] - ly) + 1.0) * ysc
        taps_x = _lerp_taps(src_x, X)
        taps_y = _lerp_taps(src_y, Y)
        res = _resample(slab, taps_x, taps_y)                   # (B, 4, O, O)
        # In-footprint coverage: each axis's two weights sum to 1 inside
        # [0, size - 1] and to 0 outside, and the resample is separable.
        coverage = ((taps_x[2] + taps_x[3])[:, :, None]
                    * (taps_y[2] + taps_y[3])[:, None, :]) \
            * vmask[:, None, None]
        rgba = classify(tf, res[:, 0])                          # (B, O, O, 4)
        px = lx + sz[:, None, None] * (ga[None, :, None] - lx)
        py = ly + sz[:, None, None] * (gb[None, None, :] - ly)
        shape = coverage.shape
        rgb, alpha = _shade(
            rgba, res[:, 1:4].unbind(1), px.expand(shape), py.expand(shape),
            zw[:, None, None].expand(shape), (lx, ly, lz), light, exponent,
            shininess, coverage, config)
        for m in range(zw.shape[0]):
            active = T > thr
            acc = acc + torch.where(active, T, T.new_zeros(()))[..., None] \
                * rgb[m]
            T = torch.where(active, T * (1.0 - alpha[m]), T)
        return acc, T

    grad = torch.is_grad_enabled() and (channels.requires_grad
                                        or tf.requires_grad)
    acc = torch.zeros((rows, O, 3), dtype=torch.float32, device=dev)
    T = torch.ones((rows, O), dtype=torch.float32, device=dev)
    for c, slab in enumerate(slabs.split(B)):
        if c and not bool((T > thr).any()):
            break
        if slab.shape[0] < B:
            slab = torch.cat([slab, slab.new_zeros(
                (B - slab.shape[0],) + tuple(slab.shape[1:]))])
        if grad:
            acc, T = checkpoint(chunk, acc, T, slab, zws_c[c], valid_c[c],
                                use_reentrant=False)
        else:
            acc, T = chunk(acc, T, slab, zws_c[c], valid_c[c])
    inter = torch.cat([acc, (1.0 - T)[..., None]], -1)
    return inter, (x0, y0, dx, dy)


def _warp_to_image(inter, extents, look_from, config: RenderConfig, perm,
                   sign: float):
    """Bilinear warp of the intermediate image onto the pixels: each ray's
    crossing with the (permuted, flipped) ``z = 0`` plane."""
    x0, y0, dx, dy = extents
    dirs = ray_directions(look_from, config)
    _, _, hit = ray_aabb(look_from, dirs, (-1, -1, -1), (1, 1, 1))
    flip = torch.tensor([1.0, 1.0, sign], dtype=torch.float32,
                        device=look_from.device)
    lf_p = look_from[list(perm)] * flip
    d_p = dirs[..., list(perm)] * flip
    t = (0.0 - lf_p[2]) / d_p[..., 2]
    a = lf_p[0] + t * d_p[..., 0]
    b = lf_p[1] + t * d_p[..., 1]
    O = inter.shape[0]
    ia = torch.clamp((a - x0) / dx, 0.0, O - 1.0)
    ib = torch.clamp((b - y0) / dy, 0.0, O - 1.0)
    a_lo_f = torch.floor(ia)
    b_lo_f = torch.floor(ib)
    fa = (ia - a_lo_f)[..., None]
    fb = (ib - b_lo_f)[..., None]
    # Clamped again as integers: a ray parallel to the plane gives NaN.
    a_lo = torch.clamp(a_lo_f.to(torch.int64), 0, O - 1)
    b_lo = torch.clamp(b_lo_f.to(torch.int64), 0, O - 1)
    a_hi = torch.clamp(a_lo + 1, max=O - 1)
    b_hi = torch.clamp(b_lo + 1, max=O - 1)
    flat = inter.reshape(O * O, 4)

    def fetch(ai, bi):
        return flat[ai * O + bi]

    img = ((fetch(a_lo, b_lo) * (1 - fa) + fetch(a_hi, b_lo) * fa) * (1 - fb)
           + (fetch(a_lo, b_hi) * (1 - fa) + fetch(a_hi, b_hi) * fa) * fb)
    img = torch.where(hit[..., None], img, img.new_zeros(()))
    return img, hit


def _classify_kernel(tf, intensity):
    return tf_lookup(tf, intensity, mask="dot")


def _intermediate(volume, tf, look_from, config: RenderConfig, O: int,
                  planes_per_voxel, slab_batch, classify, row_offset=0,
                  n_rows=None):
    """The intermediate image rows ``[row_offset, row_offset + n_rows)`` in
    the frame of the view's principal axis (:func:`_core`), and what the
    warp needs: ``(inter, extents, perm, sign)``."""
    channels = intensity_gradient_volume(volume)

    # The principal axis (the first of the largest |look_from|) and the side
    # of the camera, decided on the host.
    lf_host = look_from.cpu().tolist()
    p = max(range(3), key=lambda i: abs(lf_host[i]))
    perm = _PERMS[p]
    flip = lf_host[perm[2]] > 0
    sign = -1.0 if flip else 1.0
    ch = channels.permute(0, *(a + 1 for a in perm))
    ch = ch[[0, 1 + perm[0], 1 + perm[1], 1 + perm[2]]]
    if flip:
        # Flipping the z axis negates the z gradient component.
        ch = ch.flip(3)
        ch = torch.cat([ch[:3], -ch[3:]])
    flip_vec = torch.tensor([1.0, 1.0, sign], dtype=torch.float32,
                            device=volume.device)
    lf_f = look_from[list(perm)] * flip_vec
    # Headlight at look_from + (0, 1, 0) in world coordinates.
    light_w = look_from + torch.tensor([0.0, 1.0, 0.0], device=volume.device)
    light_f = light_w[list(perm)] * flip_vec
    inter, ext = _core(ch, tf, lf_f, light_f, config, O, planes_per_voxel,
                       slab_batch, classify, row_offset, n_rows)
    return inter, ext, perm, sign


def _fast_inputs(volume, tf, look_from, config: RenderConfig, intermediate):
    """f32 inputs on the volume's device (the camera held fixed) and O."""
    volume = volume.to(torch.float32)
    tf = tf.to(device=volume.device, dtype=torch.float32)
    look_from = torch.as_tensor(look_from, dtype=torch.float32,
                                device=volume.device).detach()
    H, W = config.image_shape
    O = intermediate or min(int(1.5 * max(H, W)), 1024)
    return volume, tf, look_from, O


def _render_fast_impl(volume, tf, look_from, config: RenderConfig,
                      intermediate, planes_per_voxel, slab_batch,
                      classify) -> FastRenderOutput:
    volume, tf, look_from, O = _fast_inputs(volume, tf, look_from, config,
                                            intermediate)
    inter, ext, perm, sign = _intermediate(volume, tf, look_from, config, O,
                                           planes_per_voxel, slab_batch,
                                           classify)
    img, hit = _warp_to_image(inter, ext, look_from, config, perm, sign)
    return FastRenderOutput(image=img, hit=hit)


def render_fast(volume: torch.Tensor, tf: torch.Tensor, look_from,
                config: RenderConfig, intermediate: Optional[int] = None,
                planes_per_voxel: float = 1.0, precision=None,
                slab_batch: int = 32) -> FastRenderOutput:
    """Shear-warp fast render of one view (see the module docstring).

    Args:
        volume: (X, Y, Z) f32 volume, internal axis order.
        tf: (R, 4) RGBA transfer function.
        look_from: (3,) camera position.
        intermediate: intermediate-image resolution O (default
            ``1.5 * max(H, W)`` capped at 1024).
        planes_per_voxel: slab planes per voxel layer along the principal
            axis (the fast path's sampling rate).
        precision: accepted for the JAX package's signature; the port
            computes in f32 whatever it is.
        slab_batch: slabs per chunk (a chunk is one classify launch, one
            checkpoint under autograd and the unit of the alive test); the
            image does not depend on it.
    Runs where ``volume`` lives: the classify is kernel K0 (forward) and
    K0b (backward, dot-form mask) on CUDA tensors, their plain versions on
    CPU tensors; the resample, shading and compositing are torch operations
    on the same device.  Differentiable in ``volume`` and ``tf``.
    """
    return _render_fast_impl(volume, tf, look_from, config, intermediate,
                             planes_per_voxel, slab_batch, _classify_kernel)


def render_fast_sharded(volume: torch.Tensor, tf: torch.Tensor, look_from,
                        config: RenderConfig, group=None,
                        intermediate: Optional[int] = None,
                        planes_per_voxel: float = 1.0, precision=None,
                        slab_batch: int = 32) -> FastRenderOutput:
    """:func:`render_fast` over the ranks of a process group (``None``: the
    default group; see ``parallel._collectives``): the intermediate image is
    split by rows, each rank resampling, classifying (K0, K0b in the
    backward), shading and compositing one strip of every slab, and one
    all-gather of the (O, O, 4) intermediate image precedes the warp.  The
    volume, the TF and the camera are replicated; every rank calls it with
    the same inputs and gets :func:`render_fast`'s output bit for bit, and
    the whole gradients in ``volume`` and ``tf``.  O must be a multiple of
    the group size.  For a volume too large for one card, see
    ``parallel.render_volume_sharded``."""
    from .parallel._collectives import gather, group_rank, replicated
    volume, tf, look_from, O = _fast_inputs(volume, tf, look_from, config,
                                            intermediate)
    k, n = group_rank(group, volume)
    if O % n:
        raise ValueError(f"intermediate size must divide the mesh axis: "
                         f"O = {O} over {n} ranks")
    strip, ext, perm, sign = _intermediate(
        replicated(volume, group), replicated(tf, group), look_from, config,
        O, planes_per_voxel, slab_batch, _classify_kernel, k * (O // n),
        O // n)
    inter = gather(strip, group, 0)
    img, hit = _warp_to_image(inter, ext, look_from, config, perm, sign)
    return FastRenderOutput(image=img, hit=hit)


def render_fast_plain(volume: torch.Tensor, tf: torch.Tensor, look_from,
                      config: RenderConfig,
                      intermediate: Optional[int] = None,
                      planes_per_voxel: float = 1.0, precision=None,
                      slab_batch: int = 32) -> FastRenderOutput:
    """:func:`render_fast` with the plain classify
    (:func:`~differender_tpu_torch.sampling.apply_tf_dot`) on any device:
    the version that :func:`render_fast` is held against."""
    return _render_fast_impl(volume, tf, look_from, config, intermediate,
                             planes_per_voxel, slab_batch, apply_tf_dot)


def choose_fast_params(volume, tf, look_from, config: RenderConfig,
                       ssim_gate: float = 0.9, ladder=_FAST_LADDER,
                       precision=None) -> dict:
    """The cheapest shear-warp density whose render passes an SSIM gate
    against the exact renderer for this scene, TF and view.

    Renders the exact image once (:func:`~differender_tpu_torch.render.
    render` at ``config.sampling_rate``, no jitter), then walks ``ladder``
    (pairs of ``(intermediate, planes_per_voxel)``) until the SSIM reaches
    ``ssim_gate``.  Returns a dict: ``renderer`` ("shearwarp", or "exact"
    when no rung passes), the chosen ``intermediate`` and
    ``planes_per_voxel``, and the per-rung ``ssim`` trace."""
    from .losses import ssim as _ssim
    from .render import render as _render

    with torch.no_grad():
        exact = _render(volume, tf, look_from, config,
                        sampling_rate=config.sampling_rate).image
        exact_cf = exact.permute(2, 0, 1)
        trace = []
        for inter, ppv in ladder:
            img = render_fast(volume, tf, look_from, config,
                              intermediate=inter,
                              planes_per_voxel=ppv).image
            ss = float(_ssim(img.permute(2, 0, 1), exact_cf))
            trace.append({"intermediate": inter, "planes_per_voxel": ppv,
                          "ssim": round(ss, 4)})
            if ss >= ssim_gate:
                return {"renderer": "shearwarp", "intermediate": inter,
                        "planes_per_voxel": ppv, "ssim": round(ss, 4),
                        "ssim_gate": ssim_gate, "trace": trace}
    return {"renderer": "exact", "intermediate": None,
            "planes_per_voxel": None, "ssim": None,
            "ssim_gate": ssim_gate, "trace": trace}


def render_fast_auto(volume, tf, look_from, config: RenderConfig,
                     ssim_gate: float = 0.9, ladder=_FAST_LADDER,
                     precision=None):
    """Shear-warp render with the fidelity gate applied: ``(output, info)``
    with ``info`` the record of :func:`choose_fast_params`.  Where no rung
    passes, the output is the exact renderer's
    (:class:`~differender_tpu_torch.render.RenderOutput`)."""
    from .render import render as _render

    info = choose_fast_params(volume, tf, look_from, config,
                              ssim_gate=ssim_gate, ladder=ladder)
    if info["renderer"] == "shearwarp":
        out = render_fast(volume, tf, look_from, config,
                          intermediate=info["intermediate"],
                          planes_per_voxel=info["planes_per_voxel"])
        return out, info
    return _render(volume, tf, look_from, config,
                   sampling_rate=config.sampling_rate), info


__all__ = ["FastRenderOutput", "intensity_gradient_volume", "render_fast",
           "render_fast_sharded", "render_fast_plain", "choose_fast_params",
           "render_fast_auto"]
