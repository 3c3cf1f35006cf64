"""TF-dependent empty-space skip of the inference march (counterpart of
``differender_tpu/occupancy.py``).

The structure, as in the JAX package:

  1. per macrocell the (min, max) of the voxels of the cell and a one-voxel
     halo, the corner footprint of every sample whose position lies in the
     cell (kernel K6 ``cell_minmax`` on CUDA tensors);
  2. a TF alpha range-max table ``maxtab[lo, hi] = max(alpha[lo..hi])``
     (:func:`tf_alpha_range_max`): a cell is occupied when the TF's largest
     alpha over the texels its intensity range can reach exceeds
     ``alpha_skip`` (trilinear and TF interpolation are convex, so no
     sample in an empty cell classifies above it);
  3. an L-inf distance-to-occupied field over the macrocells, saturated at
     ``max_dist``.

Kernel K7 ``cell_distance`` makes steps 2 and 3 on CUDA tensors in one call
(three separable passes in place of JAX's ``max_dist - 1`` rounds of a 3^3
max-pool dilation, which its plain version keeps).

From a ray head in a cell at distance ``d``, every point within world L-inf
distance ``(d - 1) * cell_world`` lies in empty cells, so the march may skip
``floor((d - 1) * cell_world / dt)`` samples without evaluating them and
renders the same image.  Kernel K3 takes the whole jump at its head sample
(:func:`jump_steps` is the plain per-ray advance); sample positions stay
``t0 + s * dt`` on the no-skip lattice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .config import RenderConfig
from .ops.bricks import cell_minmax
from .ops.distance import cell_distance, tf_alpha_range_max


@dataclasses.dataclass(frozen=True)
class OccupancyGrid:
    """The empty-space structure of one (volume, TF) pair.

    Attributes:
        dist: (nx*ny*nz,) int32 flat L-inf distance to the nearest occupied
            macrocell, saturated at ``max_dist``; 0 = the cell itself may
            hold a sample with alpha above ``alpha_skip``.
        shape: (nx, ny, nz) macrocell grid shape.
        cell: macrocell edge in voxels.
        cell_world: world-space L-inf size of one macrocell step (the least
            over the axes).
        far: (1,) int32, the largest distance, on the device of ``dist``:
            below 2 no ray can jump, and kernel K3 looks up nothing (read
            there, so that no host sync decides it).
    """

    dist: torch.Tensor
    shape: Tuple[int, int, int]
    cell: int
    cell_world: float
    far: torch.Tensor


@torch.no_grad()
def build_occupancy(volume: torch.Tensor, tf: torch.Tensor,
                    config: RenderConfig, cell: Optional[int] = None,
                    max_dist: Optional[int] = None) -> OccupancyGrid:
    """The distance field of ``volume`` (X, Y, Z) under ``tf`` (R, 4), on
    the volume's device: K6 (``cell_minmax``) and K7 (``cell_distance``) on
    CUDA, two calls and no host sync; their plain versions on the CPU.
    ``cell``/``max_dist`` default to ``config.resolved_occupancy()``.
    Rebuild it whenever the volume or the TF changes; one grid serves every
    view of the pair."""
    auto_cell, auto_md = config.resolved_occupancy()
    cell = auto_cell if cell is None else cell
    max_dist = auto_md if max_dist is None else max_dist
    volume = volume.to(torch.float32)
    tf = tf.to(torch.float32)
    X, Y, Z = volume.shape
    lo, hi = cell_minmax(volume, cell)
    dist, far = cell_distance(lo, hi, tf, config.alpha_skip, max_dist)
    # World L-inf size of one macrocell: a voxel spans 2 / (size - 1 - 1e-4)
    # world units; the least over the axes holds on every axis.
    scale = min(2.0 * cell / (s - 1.0 - 1e-4) for s in (X, Y, Z))
    return OccupancyGrid(dist=dist.reshape(-1), shape=tuple(lo.shape),
                         cell=cell, cell_world=float(scale), far=far)


def cell_index(grid: OccupancyGrid, volume_shape, px, py, pz
               ) -> torch.Tensor:
    """Flat int64 index into ``grid.dist`` of the macrocell that holds each
    world position ``(px, py, pz)`` (clamped onto the grid)."""
    nx, ny, nz = grid.shape

    def cell_of(p, size, n):
        v = torch.clamp(0.5 * p + 0.5, 0.0, 1.0) * float(
            np.float32(size - 1.0 - 1e-4))
        return torch.clamp((v / grid.cell).to(torch.int32), 0,
                           n - 1).to(torch.int64)

    return ((cell_of(px, volume_shape[0], nx) * ny
             + cell_of(py, volume_shape[1], ny)) * nz
            + cell_of(pz, volume_shape[2], nz))


def jump_steps(grid: OccupancyGrid, volume_shape, px, py, pz,
               dt) -> torch.Tensor:
    """Per-ray safe advance (int32, >= 0) from head positions
    ``(px, py, pz)`` (N,): how many consecutive samples from the head lie
    provably at or below ``alpha_skip`` (0 where the head's cell is occupied
    or next to one, and where ``dt`` is 0)."""
    d = grid.dist[cell_index(grid, volume_shape, px, py, pz)]
    safe = torch.clamp(d - 1, min=0).to(torch.float32) * float(
        np.float32(grid.cell_world))
    q = safe / torch.clamp(dt, min=1e-30)
    return torch.where(dt > 0, q, torch.zeros_like(q)).to(torch.int32)


__all__ = ["OccupancyGrid", "tf_alpha_range_max", "build_occupancy",
           "cell_index", "jump_steps"]
