"""The occupancy grid's distance field: kernel K7 ``cell_distance`` in
``csrc/distance.cu``.

From the per-macrocell intensity range ``(lo, hi)`` (kernel K6) and the TF:
a cell is occupied when the TF range table (:func:`tf_alpha_range_max`) at
texels ``[floor(lo * (R-1)), ceil(hi * (R-1))]`` exceeds ``alpha_skip``,
and every cell gets its L-inf (chessboard) distance, in cells, to the
nearest occupied one, saturated at ``max_dist``.  The JAX package's
``build_occupancy`` takes the distance from ``max_dist - 1`` rounds of a
3^3 max-pool dilation (XLA code, not Pallas).  The kernel takes three
separable 1-D passes in one call: the first builds a sparse table of the
TF's alpha in shared memory, classifies each z-row and takes its distance
along z, the other two walk along y and x on tiles in shared memory.  Its
plain version below runs the dilation rounds as JAX does.  Both give the
same integers.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build


def tf_alpha_range_max(tf: torch.Tensor) -> torch.Tensor:
    """(R, R) table ``maxtab[lo, hi] = max(alpha[lo..hi])``, equal to the
    JAX package's: 0 for ``lo > hi``, and for ``lo <= hi`` the max also
    takes in a 0, except over the whole range ``(0, R - 1)`` (JAX masks the
    texels outside ``[lo, hi]`` to 0 before its max).  A running max along
    each row: O(R^2), so R = 4096 fits."""
    alpha = tf[:, 3].to(torch.float32)
    R = alpha.shape[0]
    # Row lo: 0 before column lo, alpha from there; the running max gives
    # max(alpha[lo..hi]) and, for lo > 0, the 0 that JAX's mask adds.
    tab = torch.cummax(torch.triu(alpha.expand(R, R)), dim=1).values
    tab = torch.clamp(tab, min=0.0)
    tab[0, R - 1] = alpha.max()
    return tab


def _occupied(lo: torch.Tensor, hi: torch.Tensor, table: torch.Tensor,
              alpha_skip: float) -> torch.Tensor:
    """Plain torch classification: ``table[li, hi_i] > alpha_skip`` with the
    texel range clamped to the table.  The TF coordinate ``x = intensity *
    (R - 1)`` is lerped between its floor and ceil texels, so a cell's
    samples reach texels ``[floor(lo * (R-1)), ceil(hi * (R-1))]``."""
    R = table.shape[0]
    li = torch.clamp(torch.floor(lo * (R - 1)), 0, R - 1).to(torch.int64)
    hi_i = torch.clamp(torch.ceil(hi * (R - 1)), 0, R - 1).to(torch.int64)
    return table[li, hi_i] > float(np.float32(alpha_skip))


def cell_distance_reference(lo: torch.Tensor, hi: torch.Tensor,
                            tf: torch.Tensor, alpha_skip: float,
                            max_dist: int):
    """Plain torch version of K7: :func:`_occupied` under
    :func:`tf_alpha_range_max`, then after ``k`` rounds of a 3^3 max-pool
    (stride 1, padded with -inf) a cell is 1 iff an occupied cell lies
    within L-inf distance ``k``; the distance is the number of rounds
    ``k < max_dist`` at which it is still 0.  Returns ``(dist, far)``:
    ``(nx, ny, nz)`` int32 and its largest value as a (1,) int32."""
    table = tf_alpha_range_max(tf)
    cur = _occupied(lo, hi, table, alpha_skip).to(torch.float32)
    cur = cur[None, None]
    hits = cur.clone()
    for _ in range(1, max_dist):
        cur = F.max_pool3d(cur, 3, 1, 1)
        hits += cur
    dist = torch.clamp(max_dist - hits[0, 0], min=0).to(torch.int32)
    return dist, dist.amax().reshape(1)


def cell_distance(lo: torch.Tensor, hi: torch.Tensor, tf: torch.Tensor,
                  alpha_skip: float, max_dist: int):
    """L-inf distance from each macrocell of the ``(lo, hi)`` grid
    (nx, ny, nz) f32 to the nearest one that ``tf`` (R, 4) f32 classifies
    above ``alpha_skip``, saturated at ``max_dist``.  Returns ``(dist,
    far)``: ``(nx, ny, nz)`` int32 and its largest value as a (1,) int32 on
    the same device.  Kernel K7 on CUDA tensors (one launch a call of its
    three passes), :func:`cell_distance_reference` on CPU tensors."""
    if _build.uses_plain(lo):
        return cell_distance_reference(lo, hi, tf, alpha_skip, max_dist)
    dev = lo.device
    with _build.launch("cell_distance"):
        lo = _build.operand("lo", lo, dev, (None,) * 3)
        hi = _build.operand("hi", hi, dev, lo.shape)
        if tf.ndim != 2 or tf.shape[1] != 4 or tf.shape[0] < 1:
            raise ValueError(f"tf must be (R, 4); got {tuple(tf.shape)}")
        tf = _build.operand("tf", tf, dev)
        out = torch.empty(lo.shape, dtype=torch.int32, device=dev)
        tmp = torch.empty_like(out)
        far = torch.empty(1, dtype=torch.int32, device=dev)
        _build.call("dr_cell_distance", lo.data_ptr(), hi.data_ptr(),
                    tf.data_ptr(), tf.shape[0], float(np.float32(alpha_skip)),
                    *lo.shape, max(int(max_dist), 0), tmp.data_ptr(),
                    out.data_ptr(), far.data_ptr(), like=lo)
    return out, far


__all__ = ["cell_distance", "cell_distance_reference", "tf_alpha_range_max"]
