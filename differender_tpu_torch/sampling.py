"""Volume sampling and transfer-function lookup, the plain torch versions
(counterpart of ``differender_tpu/sampling.py``).

These are the per-op oracles of the march kernels in ``csrc/march.cu`` and
``csrc/march_bwd.cu``, which repeat the same f32 arithmetic per thread.
Sampling is differentiable by autograd of its gathers; the TF lookup keeps
the JAX package's two VJP rules (:func:`march_tf`).  Flat voxel offsets are
int64: ``(x*Y + y)*Z + z`` overflows int32 soon after 1024^3.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Corner order of the 8-point trilinear stencil (x fastest).
_CORNERS = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
            (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1))

# Per axis, the sign of each corner in the analytic in-cell derivative: +1
# where the corner's bit on that axis is 1, else -1.
_CORNER_SIGNS = np.array([[1.0 if c[ax] else -1.0 for c in _CORNERS]
                          for ax in range(3)], np.float32)

# The 7 points of a shaded sample: the centre, then +-delta per axis.
_NORMAL_OFFSETS = np.array(
    [[0, 0, 0],
     [1, 0, 0], [-1, 0, 0],
     [0, 1, 0], [0, -1, 0],
     [0, 0, 1], [0, 0, -1]], np.float32)


def voxel_scale(volume_shape) -> np.ndarray:
    """``f32(shape) - 1 - f32(1e-4)``: the 1e-4 keeps ``floor+1`` in range."""
    return np.asarray(volume_shape, np.float32) - 1.0 - np.float32(1e-4)


def voxel_coords(pos: torch.Tensor, volume_shape) -> torch.Tensor:
    """World positions in [-1, 1]^3 to continuous voxel coordinates,
    ``clamp(0.5*pos + 0.5, 0, 1) * scale``."""
    scale = torch.as_tensor(voxel_scale(volume_shape), device=pos.device)
    return torch.clamp(0.5 * pos + 0.5, 0.0, 1.0) * scale


def _corner_factors(pos: torch.Tensor, volume_shape):
    """Per-axis corner indices ``(ix, iy, iz)``, each ``(..., 8)`` int64,
    and per-axis weight factors ``(fx, fy, fz)``, each ``(..., 8)``: ``f``
    where the corner's bit on that axis is 1, else ``1 - f``.  ``low =
    floor(coord)``, ``high = min(low+1, size-1)``, ``frac`` taken before the
    high clamp."""
    pv = voxel_coords(pos, volume_shape)
    low_f = torch.floor(pv)
    frac = pv - low_f
    low = low_f.to(torch.int64)
    idx, fac = [], []
    for ax, size in enumerate(volume_shape):
        lo = low[..., ax]
        hi = torch.clamp(lo + 1, max=size - 1)
        idx.append(torch.stack([hi if c[ax] else lo for c in _CORNERS], -1))
        f = frac[..., ax]
        fac.append(torch.stack([f if c[ax] else 1.0 - f for c in _CORNERS],
                               -1))
    return idx, fac


def corner_indices_weights(pos: torch.Tensor, volume_shape):
    """Per-axis corner indices ``(ix, iy, iz)`` each ``(..., 8)`` int64 and
    trilinear weights ``(..., 8)``: ``low = floor(coord)``,
    ``high = min(low+1, size-1)``, ``frac`` taken before the high clamp."""
    (ix, iy, iz), fac = _corner_factors(pos, volume_shape)
    return ix, iy, iz, (fac[0] * fac[1]) * fac[2]


def corner_flat_weights(pos: torch.Tensor, volume_shape):
    """Flat int64 offsets ``(x*Y + y)*Z + z`` and weights, ``(..., 8)``."""
    _, Y, Z = volume_shape
    ix, iy, iz, w = corner_indices_weights(pos, volume_shape)
    return (ix * Y + iy) * Z + iz, w


def _corner_sum(terms: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (8 corners), corner by corner in the kernels'
    order and rounding."""
    out = terms[..., 0]
    for c in range(1, 8):
        out = out + terms[..., c]
    return out


def trilinear(volume: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of ``volume`` (X, Y, Z) at ``pos`` (..., 3)."""
    flat, w = corner_flat_weights(pos, tuple(volume.shape))
    return _corner_sum(volume.reshape(-1)[flat] * w)


def sample_with_gradient_analytic(volume: torch.Tensor, pos: torch.Tensor,
                                  delta: float = 1e-3):
    """Intensity at ``pos`` and the analytic in-cell gradient of the
    trilinear interpolant from the same 8 corners, ``(...)`` and
    ``(..., 3)`` (``analytic_normals=True``; the JAX package's
    ``sampling.py::sample_with_gradient_analytic``).

    Per axis the gradient is ``sum_c v_c * (+-1) * w'_c``, the sign the
    corner's bit on that axis and ``w'_c`` its weight's product over the
    other two axes, times ``f32(delta) * voxel_scale`` (the central
    difference's magnitude: ``2 * delta`` world is ``delta * scale``
    voxels).  Corner sums run corner by corner, as the kernels sum them.
    Differentiable by autograd in the volume and in ``pos``."""
    shape = tuple(volume.shape)
    (ix, iy, iz), fac = _corner_factors(pos, shape)
    _, Y, Z = shape
    vals = volume.reshape(-1)[(ix * Y + iy) * Z + iz]
    intensity = _corner_sum(vals * ((fac[0] * fac[1]) * fac[2]))
    sc = np.float32(delta) * voxel_scale(shape)
    pairs = (fac[1] * fac[2], fac[0] * fac[2], fac[0] * fac[1])
    signs = torch.as_tensor(_CORNER_SIGNS, device=pos.device)
    grad = torch.stack([_corner_sum(vals * (signs[ax] * pairs[ax]))
                        * float(sc[ax]) for ax in range(3)], dim=-1)
    return intensity, grad


def _stencil_points(pos: torch.Tensor, delta: float) -> torch.Tensor:
    """The 7 points ``(..., 7, 3)`` of each position's stencil."""
    offs = torch.as_tensor(_NORMAL_OFFSETS * np.float32(delta),
                           device=pos.device)
    return pos[..., None, :] + offs


def _value_gradient(vals: torch.Tensor):
    """The centre value and the central differences of the stencil's 7
    values ``(..., 7)``."""
    grad = torch.stack([vals[..., 1] - vals[..., 2],
                        vals[..., 3] - vals[..., 4],
                        vals[..., 5] - vals[..., 6]], dim=-1)
    return vals[..., 0], grad


def sample_with_gradient(volume: torch.Tensor, pos: torch.Tensor,
                         delta: float = 1e-3):
    """Intensity at ``pos`` and the unnormalized central-difference
    gradient ``(v(+x) - v(-x), ...)``, ``(...)`` and ``(..., 3)``."""
    return _value_gradient(trilinear(volume, _stencil_points(pos, delta)))


def trilinear_shard(padded: torch.Tensor, pos: torch.Tensor, global_shape,
                    x_start: int) -> torch.Tensor:
    """Trilinear sample of an X-sharded volume block (the JAX package's
    ``sampling.py::trilinear_shard``).  ``padded`` (Xp, Y, Z) holds the
    global x planes ``[x_start, x_start + Xp)``.  Corner indices are taken
    in global coordinates (``global_shape``), exactly as the unsharded
    :func:`trilinear` takes them, and then localised,
    ``lx = clamp(ix - x_start, 0, Xp - 1)``: a sample outside the block
    (which the caller's ownership test masks) reads an edge plane."""
    _, Y, Z = padded.shape
    ix, iy, iz, w = corner_indices_weights(pos, global_shape)
    lx = torch.clamp(ix - x_start, 0, padded.shape[0] - 1)
    return _corner_sum(padded.reshape(-1)[(lx * Y + iy) * Z + iz] * w)


def sample_with_gradient_shard(padded: torch.Tensor, pos: torch.Tensor,
                               global_shape, x_start: int,
                               delta: float = 1e-3):
    """:func:`sample_with_gradient` against an X-sharded volume block
    (:func:`trilinear_shard`): the same 7-point central-difference stencil,
    which reaches at most 2 planes past the shard's own for ``delta`` below
    a voxel (the halos of ``parallel.volume_sharding``)."""
    return _value_gradient(trilinear_shard(
        padded, _stencil_points(pos, delta), global_shape, x_start))


# Each stencil point's share of (value, gx, gy, gz): the centre gives the
# value, the +-delta points +-1 of their axis's gradient component.
_POINT_COEF = np.array(
    [[1, 0, 0, 0],
     [0, 1, 0, 0], [0, -1, 0, 0],
     [0, 0, 1, 0], [0, 0, -1, 0],
     [0, 0, 0, 1], [0, 0, 0, -1]], np.float32)


class Footprint(NamedTuple):
    """The distinct voxels of the 7-point stencils of N samples, one entry
    per (sample, voxel) pair."""
    sample: torch.Tensor   # (M,) int64: the sample of each entry
    index: torch.Tensor    # (M,) int64: its flat voxel index (x*Y + y)*Z + z
    weight: torch.Tensor   # (M, 4): its merged weight in the value and the
                           # three gradient components
    corner: torch.Tensor   # (N, 7, 8) int64: the entry that holds each
                           # point's corner (points as in
                           # :func:`sample_with_gradient`, corners as in
                           # :func:`corner_indices_weights`); (N, 8) for
                           # :func:`analytic_footprint`


def stencil_footprint(pos: torch.Tensor, volume_shape,
                      delta: float = 1e-3) -> Footprint:
    """The plain version of the march kernels' stencil gather and merged
    scatter: for positions ``pos`` (N, 3), the distinct voxels that the 56
    corners of each sample's 7 points (:func:`sample_with_gradient`) fall
    on, and each voxel's total weight in the value and the gradient.

    ``volume.reshape(-1)[fp.index][fp.corner]`` are the corner values of
    every point (one load per distinct voxel).  For cotangents ``cot``
    (N, 4) of each sample's value and gradient,
    ``d_volume.index_add_(0, fp.index, (fp.weight * cot[fp.sample]).sum(-1))``
    is the VJP of :func:`sample_with_gradient` (one add per distinct voxel).
    ``torch.bincount(fp.sample)`` counts each sample's distinct voxels."""
    n = pos.shape[0]
    offs = torch.as_tensor(_NORMAL_OFFSETS * np.float32(delta),
                           device=pos.device)
    flat, w = corner_flat_weights(pos[:, None, :] + offs, volume_shape)
    numel = int(np.prod(volume_shape))
    key = (torch.arange(n, device=pos.device)[:, None, None] * numel
           + flat).reshape(-1)
    uniq, inv = torch.unique(key, return_inverse=True)
    coef = torch.as_tensor(_POINT_COEF, device=pos.device)
    terms = (w[..., None] * coef[:, None, :]).reshape(-1, 4)
    weight = torch.zeros((uniq.numel(), 4), dtype=w.dtype,
                         device=pos.device).index_add_(0, inv, terms)
    return Footprint(uniq // numel, uniq % numel, weight,
                     inv.reshape(n, 7, 8))


def analytic_footprint(pos: torch.Tensor, volume_shape,
                       delta: float = 1e-3) -> Footprint:
    """The plain version of K2's analytic scatter: for positions ``pos``
    (N, 3), the distinct voxels among each sample's 8 corners (fewer than 8
    where a high index is clamped onto its low one) and each voxel's total
    weight in the value and the three components of
    :func:`sample_with_gradient_analytic`'s gradient.  Used as
    :func:`stencil_footprint` is; ``corner`` is (N, 8)."""
    n = pos.shape[0]
    (ix, iy, iz), fac = _corner_factors(pos, volume_shape)
    _, Y, Z = volume_shape
    flat = (ix * Y + iy) * Z + iz
    sc = np.float32(delta) * voxel_scale(volume_shape)
    signs = torch.as_tensor(_CORNER_SIGNS, device=pos.device)
    pairs = (fac[1] * fac[2], fac[0] * fac[2], fac[0] * fac[1])
    terms = torch.stack([(fac[0] * fac[1]) * fac[2]]
                        + [signs[ax] * pairs[ax] * float(sc[ax])
                           for ax in range(3)], -1).reshape(-1, 4)
    numel = int(np.prod(volume_shape))
    key = (torch.arange(n, device=pos.device)[:, None] * numel
           + flat).reshape(-1)
    uniq, inv = torch.unique(key, return_inverse=True)
    weight = torch.zeros((uniq.numel(), 4), dtype=terms.dtype,
                         device=pos.device).index_add_(0, inv, terms)
    return Footprint(uniq // numel, uniq % numel, weight, inv.reshape(n, 8))


def apply_tf(tf: torch.Tensor, intensity: torch.Tensor) -> torch.Tensor:
    """1D linear RGBA lookup into ``tf`` (R, 4): ``t = max(i*(R-1), 0)``,
    ``low = min(floor t, R-1)``, ``high = min(low+1, R-1)``, so intensities
    outside [0, 1] clamp to the end texels.  Returns ``(..., 4)``.

    Its gradient is plain autograd of the gather-lerp, the rule of the JAX
    march's TF for R > 1024 (``sampling.py::apply_tf_soa``): the slope
    ``tf[high] - tf[low]`` at every t, half of it at ``i == 0`` (the tie of
    ``max``)."""
    R = tf.shape[0]
    t = torch.maximum(intensity * float(R - 1), intensity.new_zeros(()))
    low_f = torch.floor(t)
    frac = (t - low_f)[..., None]
    low = torch.clamp(low_f, max=float(R - 1)).to(torch.int64)
    high = torch.clamp(low + 1, max=R - 1)
    return tf[low] * (1.0 - frac) + tf[high] * frac


def tf_lerp_bwd(tf: torch.Tensor, intensity: torch.Tensor, g: torch.Tensor,
                mask: str):
    """Both cotangents of the TF lerp for the cotangent ``g`` (..., 4);
    returns ``(d_tf (R, 4), d_intensity (...))``.

    ``d_tf`` puts ``(1 - frac) g`` on ``low`` and ``frac g`` on ``high``
    (the lerp's weights).  ``d_intensity = ((tf[high] - tf[low]) . g)
    * (R-1)`` where ``mask`` allows it, else 0:

    * ``"dot"`` -- where ``frac > 0``: the VJP of the JAX march's TF for
      R <= 1024 (``sampling.py::_apply_tf_dot_bwd``), zero at integer t and
      at the clipped ends;
    * ``"pallas"`` -- where ``0 < i*(R-1) < R-1`` on the raw t: the Pallas
      kernel ``ops/tf_lookup.py::_bwd_kernel``.

    The same rules, and autograd's rule of :func:`apply_tf`, are the modes
    of ``tf_lerp_bwd`` in ``csrc/tf_lerp.cuh``."""
    R = tf.shape[0]
    shape = intensity.shape
    x = intensity.reshape(-1)
    gm = g.reshape(-1, 4)
    t_raw = x * float(R - 1)
    t = torch.clamp(t_raw, min=0.0)
    low_f = torch.floor(t)
    frac = t - low_f
    low = torch.clamp(low_f, max=float(R - 1)).to(torch.int64)
    high = torch.clamp(low + 1, max=R - 1)
    d_tf = torch.zeros_like(tf)
    d_tf.index_add_(0, low, (1.0 - frac)[:, None] * gm)
    d_tf.index_add_(0, high, frac[:, None] * gm)
    slope = (tf[high] - tf[low]) * gm
    d_t = slope[:, 0] + slope[:, 1] + slope[:, 2] + slope[:, 3]
    if mask == "dot":
        keep = frac > 0.0
    elif mask == "pallas":
        keep = (t_raw > 0.0) & (t_raw < float(R - 1))
    else:
        raise ValueError(f"mask must be 'dot' or 'pallas'; got {mask!r}")
    d_int = torch.where(keep, d_t * float(R - 1), torch.zeros_like(d_t))
    return d_tf, d_int.reshape(shape)


class _ApplyTfDot(torch.autograd.Function):
    """:func:`apply_tf` values with the ``"dot"`` VJP of
    :func:`tf_lerp_bwd`."""

    @staticmethod
    def forward(ctx, tf, intensity):
        ctx.save_for_backward(tf, intensity)
        return apply_tf(tf, intensity)

    @staticmethod
    def backward(ctx, g):
        tf, intensity = ctx.saved_tensors
        d_tf, d_int = tf_lerp_bwd(tf, intensity, g, "dot")
        need_tf, need_int = ctx.needs_input_grad
        return (d_tf if need_tf else None), (d_int if need_int else None)


def apply_tf_dot(tf: torch.Tensor, intensity: torch.Tensor) -> torch.Tensor:
    """The JAX march's TF for R <= 1024 (``sampling.py::apply_tf_dot``):
    the values of :func:`apply_tf`, its own VJP (``"dot"`` rule)."""
    return _ApplyTfDot.apply(tf, intensity)


# The JAX march takes the MXU-dot TF up to this many texels and the
# gather-lerp above it (differender_tpu/render.py:213-217).
TF_DOT_MAX_TEXELS = 1024


def march_tf(tf: torch.Tensor, intensity: torch.Tensor) -> torch.Tensor:
    """The differentiable march's TF lookup: :func:`apply_tf_dot` for
    R <= 1024, :func:`apply_tf` above, so each R gets its JAX gradient."""
    if tf.shape[0] <= TF_DOT_MAX_TEXELS:
        return apply_tf_dot(tf, intensity)
    return apply_tf(tf, intensity)


__all__ = ["voxel_scale", "voxel_coords", "corner_indices_weights",
           "corner_flat_weights", "trilinear", "sample_with_gradient",
           "trilinear_shard", "sample_with_gradient_shard",
           "sample_with_gradient_analytic", "Footprint", "stencil_footprint",
           "analytic_footprint",
           "apply_tf", "apply_tf_dot", "march_tf", "tf_lerp_bwd",
           "TF_DOT_MAX_TEXELS"]
