"""Volume sampling and transfer-function lookup, the plain torch versions
(counterpart of ``differender_tpu/sampling.py``).

These are the per-op oracles of the march kernels in ``csrc/march.cu``,
which repeat the same f32 arithmetic per thread.  Flat voxel offsets are
int64: ``(x*Y + y)*Z + z`` overflows int32 soon after 1024^3.
"""
from __future__ import annotations

import numpy as np
import torch

# Corner order of the 8-point trilinear stencil (x fastest).
_CORNERS = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
            (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1))

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


def corner_indices_weights(pos: torch.Tensor, volume_shape):
    """Per-axis corner indices ``(ix, iy, iz)`` each ``(..., 8)`` int64 and
    trilinear weights ``(..., 8)``: ``low = floor(coord)``,
    ``high = min(low+1, size-1)``, ``frac`` taken before the high clamp."""
    pv = voxel_coords(pos, volume_shape)
    low_f = torch.floor(pv)
    frac = pv - low_f
    low = low_f.to(torch.int64)
    idx = []
    for ax, size in enumerate(volume_shape):
        lo = low[..., ax]
        hi = torch.clamp(lo + 1, max=size - 1)
        idx.append(torch.stack([hi if c[ax] else lo for c in _CORNERS], -1))
    w = torch.ones(frac.shape[:-1] + (8,), dtype=frac.dtype,
                   device=frac.device)
    for ax in range(3):
        f = frac[..., ax]
        w = w * torch.stack([f if c[ax] else 1.0 - f for c in _CORNERS], -1)
    return idx[0], idx[1], idx[2], w


def corner_flat_weights(pos: torch.Tensor, volume_shape):
    """Flat int64 offsets ``(x*Y + y)*Z + z`` and weights, ``(..., 8)``."""
    _, Y, Z = volume_shape
    ix, iy, iz, w = corner_indices_weights(pos, volume_shape)
    return (ix * Y + iy) * Z + iz, w


def trilinear(volume: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of ``volume`` (X, Y, Z) at ``pos`` (..., 3)."""
    flat, w = corner_flat_weights(pos, tuple(volume.shape))
    vals = volume.reshape(-1)[flat]
    return torch.sum(vals * w, dim=-1)


def sample_with_gradient(volume: torch.Tensor, pos: torch.Tensor,
                         delta: float = 1e-3):
    """Intensity at ``pos`` and the unnormalized central-difference
    gradient ``(v(+x) - v(-x), ...)``, ``(...)`` and ``(..., 3)``."""
    offs = torch.as_tensor(_NORMAL_OFFSETS * np.float32(delta),
                           device=pos.device)
    vals = trilinear(volume, pos[..., None, :] + offs)           # (..., 7)
    grad = torch.stack([vals[..., 1] - vals[..., 2],
                        vals[..., 3] - vals[..., 4],
                        vals[..., 5] - vals[..., 6]], dim=-1)
    return vals[..., 0], grad


def apply_tf(tf: torch.Tensor, intensity: torch.Tensor) -> torch.Tensor:
    """1D linear RGBA lookup into ``tf`` (R, 4): ``t = max(i*(R-1), 0)``,
    ``low = min(floor t, R-1)``, ``high = min(low+1, R-1)``, so intensities
    outside [0, 1] clamp to the end texels.  Returns ``(..., 4)``."""
    R = tf.shape[0]
    t = torch.clamp(intensity * float(R - 1), min=0.0)
    low_f = torch.floor(t)
    frac = (t - low_f)[..., None]
    low = torch.clamp(low_f, max=float(R - 1)).to(torch.int64)
    high = torch.clamp(low + 1, max=R - 1)
    return tf[low] * (1.0 - frac) + tf[high] * frac


__all__ = ["voxel_scale", "voxel_coords", "corner_indices_weights",
           "corner_flat_weights", "trilinear", "sample_with_gradient",
           "apply_tf"]
