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
  3. each slab sample is classified through the TF, shaded with the
     headlight and composited front to back in intermediate space with
     per-pixel opacity correction and the early-ray-termination gate;
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

Where it runs.  Steps 1, the grid, the per-pixel exponent, the voxel
layers (the channels permuted to ``(Z, X, Y, 4)``, channels last) and step
4 are torch operations.  The march itself, steps 2 to 3 per plane with
the z-lerp of each plane from its two voxel layers, is
:func:`~differender_tpu_torch.ops.shear_warp.shear_warp_march`: on CUDA
tensors one launch of kernel K8 ``shear_warp_fwd`` and, in the backward,
one launch of K9 ``shear_warp_bwd``, which marches again, keeps no tape
and returns the layers' gradient.  Both kernels lerp each plane from the
layers themselves, so no ``(S, X, Y, 4)`` slab stack (537 MB at 256^3
and 512 planes) is built or differentiated; each pixel marches only the
planes where its ray crosses the volume's footprint (a sample outside it
has coverage 0 and is an exact no-op), up to its own gate.  No host sync
runs inside the march, and the backward holds the layers, the TF and the
(O, O, 4) image.  On CPU tensors it is
the plain version, the same arithmetic as chunks of ``slab_batch`` planes
of torch operations over every plane (by default 32, where the JAX
package takes 2: each chunk is about a hundred launches on the card,
whatever its length): the march stops at the first chunk where no pixel
is alive (a host sync), and under autograd each chunk, z-lerp included,
runs inside ``torch.utils.checkpoint`` (the JAX package's
``jax.checkpoint``).

The two powers of the shading (the opacity correction's exponent, below 1
at more than about 3.5 planes per voxel, and the specular shininess) have
an infinite slope at a base of 0.  Their VJP here is 0 wherever the incoming
cotangent is 0, so a pixel that the ERT gate or the footprint mask cuts off
contributes no ``0 * inf``: the gradient equals the JAX package's wherever
that is finite, and is NaN nowhere the JAX package's is not.

:func:`render_fast_plain` takes the plain march on any device, with the
plain classify (:func:`~differender_tpu_torch.sampling.apply_tf_dot`): the
tests and ``chip_smoke.py`` hold :func:`render_fast` against it;
:func:`render_fast` never calls it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .config import RenderConfig
from .geometry import ray_aabb, ray_directions
from .ops.shear_warp import (SlabGeometry, shear_warp_march,
                             shear_warp_march_plain)
from .sampling import apply_tf_dot

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


def _slab_inputs(channels, lf, light, config: RenderConfig,
                 intermediate: int, planes_per_voxel: float,
                 row_offset: int = 0, n_rows: Optional[int] = None):
    """The voxel layers and the march's geometry with the LAST axis as
    principal and the camera on its negative side: ``channels`` (4, X, Y,
    Z) already permuted and flipped, ``lf`` and ``light`` in that frame.
    Returns ``(layers, geom, extents)``: the layers ``(Z, X, Y, 4)``
    (channels last; the march z-lerps each plane from two of them), the
    :class:`~differender_tpu_torch.ops.shear_warp.SlabGeometry` of the
    intermediate rows ``[row_offset, row_offset + n_rows)`` (default all
    O) and the grid's extents ``(x0, y0, dx, dy)``."""
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
    layers = channels.permute(3, 1, 2, 0).contiguous()      # (Z, X, Y, 4)

    def dev_t(a):
        return torch.from_numpy(a).to(dev)

    geom = SlabGeometry(
        ga=ga, gb=gb, zws=dev_t(zws), zlo=dev_t(zlo.astype(np.int32)),
        zhi=dev_t(zhi.astype(np.int32)), fz=dev_t(fz), exponent=exponent,
        lf=lf, light=light, xsc=float(np.float32(0.5 * (X - 1))),
        ysc=float(np.float32(0.5 * (Y - 1))),
        thr=float(np.float32(1.0 - config.ert_threshold)),
        ambient=config.ambient, diffuse=config.diffuse,
        specular=config.specular, shininess=config.shininess)
    return layers, geom, (x0, y0, dx, dy)


def _core(channels, tf, lf, light, config: RenderConfig, intermediate: int,
          planes_per_voxel: float, slab_batch: int, march,
          row_offset: int = 0, n_rows: Optional[int] = None):
    """The intermediate rows ``[row_offset, row_offset + n_rows)`` (default
    all O) of the slab frame (:func:`_slab_inputs`): each row's pixels are
    computed as in the whole image, so strips join into it bit for bit
    (:func:`render_fast_sharded`).  ``march(layers, tf, geom, slab_batch)``
    is :func:`~differender_tpu_torch.ops.shear_warp.shear_warp_march` (K8
    and K9 on CUDA tensors) or :func:`_march_plain`.  Returns the
    intermediate RGBA
    ``(n_rows, O, 4)`` and the grid's extents ``(x0, y0, dx, dy)``."""
    layers, geom, extents = _slab_inputs(channels, lf, light, config,
                                         intermediate, planes_per_voxel,
                                         row_offset, n_rows)
    return march(layers, tf, geom, slab_batch), extents


def _march_plain(layers, tf, geom: SlabGeometry, slab_batch: int):
    """:func:`render_fast_plain`'s march: the plain chunk loop, classified
    by :func:`~differender_tpu_torch.sampling.apply_tf_dot`."""
    return shear_warp_march_plain(layers, tf, geom, apply_tf_dot,
                                  slab_batch)


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


def _frame(volume, look_from):
    """The view's slab frame: ``(channels, lf, light, perm, sign)``, the
    intensity-gradient channels (:func:`intensity_gradient_volume`) with
    the principal axis (the first of the largest |look_from|, decided on
    the host) last and flipped so that the camera sits on its negative
    side, the camera and the headlight in that frame, the axis permutation
    and the flip's sign."""
    channels = intensity_gradient_volume(volume)
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
    return ch, lf_f, light_f, perm, sign


def _intermediate(volume, tf, look_from, config: RenderConfig, O: int,
                  planes_per_voxel, slab_batch, march, row_offset=0,
                  n_rows=None):
    """The intermediate image rows ``[row_offset, row_offset + n_rows)`` in
    the frame of the view's principal axis (:func:`_frame`, :func:`_core`),
    and what the warp needs: ``(inter, extents, perm, sign)``."""
    ch, lf_f, light_f, perm, sign = _frame(volume, look_from)
    inter, ext = _core(ch, tf, lf_f, light_f, config, O, planes_per_voxel,
                       slab_batch, march, row_offset, n_rows)
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
                      march) -> FastRenderOutput:
    volume, tf, look_from, O = _fast_inputs(volume, tf, look_from, config,
                                            intermediate)
    inter, ext, perm, sign = _intermediate(volume, tf, look_from, config, O,
                                           planes_per_voxel, slab_batch,
                                           march)
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
        slab_batch: slabs per chunk of the plain march on CPU tensors (a
            chunk is one batch of torch operations, one checkpoint under
            autograd and the unit of the alive test).  Accepted and ignored
            on CUDA tensors, where the march is one kernel, as the JAX
            package's TPU-only knobs are; the image does not depend on it.
    Runs where ``volume`` lives.  On CUDA tensors the slab march is one
    launch of kernel K8 ``shear_warp_fwd`` and its gradient one launch of
    K9 ``shear_warp_bwd``, with no host sync inside the march (the z-lerp
    of each plane from two voxel layers is inside both); the gradient
    volume, the layers' permute, the grid and the warp are torch
    operations.  On CPU tensors the march is the plain chunk loop, which
    classifies through ``tf_lookup(mask="dot")``'s plain versions.
    Differentiable in ``volume`` and ``tf``.
    """
    return _render_fast_impl(volume, tf, look_from, config, intermediate,
                             planes_per_voxel, slab_batch, shear_warp_march)


def render_fast_sharded(volume: torch.Tensor, tf: torch.Tensor, look_from,
                        config: RenderConfig, group=None,
                        intermediate: Optional[int] = None,
                        planes_per_voxel: float = 1.0, precision=None,
                        slab_batch: int = 32) -> FastRenderOutput:
    """:func:`render_fast` over the ranks of a process group (``None``: the
    default group; see ``parallel._collectives``): the intermediate image is
    split by rows, each rank marching one strip of every slab (K8 through
    ``row_offset``/``n_rows``, K9 in the backward), and one all-gather of
    the (O, O, 4) intermediate image precedes the warp.  The volume, the TF
    and the camera are replicated; every rank calls it with the same inputs
    and gets :func:`render_fast`'s output bit for bit, and the whole
    gradients in ``volume`` and ``tf``.  O must be a multiple of the group
    size.  For a volume too large for one card, see
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
        O, planes_per_voxel, slab_batch, shear_warp_march, k * (O // n),
        O // n)
    inter = gather(strip, group, 0)
    img, hit = _warp_to_image(inter, ext, look_from, config, perm, sign)
    return FastRenderOutput(image=img, hit=hit)


def render_fast_plain(volume: torch.Tensor, tf: torch.Tensor, look_from,
                      config: RenderConfig,
                      intermediate: Optional[int] = None,
                      planes_per_voxel: float = 1.0, precision=None,
                      slab_batch: int = 32) -> FastRenderOutput:
    """:func:`render_fast` through the plain march
    (:func:`~differender_tpu_torch.ops.shear_warp.shear_warp_march_plain`,
    classified by :func:`~differender_tpu_torch.sampling.apply_tf_dot`) on
    any device: the version that :func:`render_fast` is held against."""
    return _render_fast_impl(volume, tf, look_from, config, intermediate,
                             planes_per_voxel, slab_batch, _march_plain)


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
