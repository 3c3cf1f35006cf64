"""Box reductions of a volume: kernels K4 ``brick_sums``, K5 ``brick_rows``
and K6 ``cell_minmax``, all in ``csrc/bricks.cu``.

K4 and K5 are the ports of the two Pallas kernels of the TPU DMA probe
``experiments/exp_pallas_dma.py`` (``brick_sum_kernel`` launched by
``run_brick_sums``, ``brick_row_kernel`` launched by ``run_brick_rows``),
with their signatures and outputs: ``(n, 128)`` f32, every lane of row ``i``
holding the sum of brick ``i``.  K4 tiles the volume (:func:`k4_plan`),
lists each tile's bricks by a count, a scan and a fill, copies the bounding
box of a tile's intersections into shared memory once and sums each
intersection there into a slot of its brick; a last launch adds a brick's
slots in a fixed order.  K5 reads each distinct table brick once: the least
row index of each brick owns it, its owner sums it in chunks
(:func:`k5_plan`), and every row of the brick takes the owner's sum.  K6 is
the occupancy grid's per-macrocell ``(min, max)``
(``differender_tpu/occupancy.py::_cell_minmax``): a block of K6 streams the
x-planes of a tile of macrocells, folds each voxel along x into the windows
of its cells in registers, and reduces a window along z and y in shared
memory when it closes (:func:`k6_plan` chooses the tiling), so each voxel
is read from device memory about once.

On CUDA tensors each wrapper launches its kernel (counted in its
``launches``, once per call); on CPU tensors it takes the plain torch
version beside it.  A brick that does not lie wholly inside the volume (or
an index outside the table) gives a row of NaN in the kernels and the plain
versions alike: the Pallas DMA has no defined result there, and clamping
the origin would sum another brick.  The sums are taken in another order
than XLA's, so they agree to f32 rounding (the probe holds them at
``rtol=1e-5``); K4 and K5 use no float atomics and give the same bits on
every call.  Min and max are exact.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import _build

LANES = 128
B = 32       # brick edge of K4, as in the probe (exp_pallas_dma.py:36)

# K4's tiles, bricks.cu's kTileX, kTileY and kTileZ: 8 x 8 x 256 voxels, 64
# KiB of shared memory (three blocks an SM).  A row of a brick's
# intersection with a tile then lies in one tile row (tiles split a brick
# along z only at multiples of 256), and a brick meets at most 5 x 5 x 2
# tiles.
K4_TILE = (8, 8, 256)
# K5's chunk, bricks.cu's kChunk: 8192 floats (32 KiB), four to a 32^3
# brick.
K5_CHUNK = 8192


class K4Plan(NamedTuple):
    tiles: tuple         # tiles per axis
    slots: tuple         # slots per axis: the tiles a brick can meet
    scratch_words: int   # counts, cursors, list entries, partial sums


def k4_plan(volume_shape, n: int) -> K4Plan:
    """K4's tiling of a volume ``(X, Y, Z)`` for ``n`` bricks: the tiles of
    ``K4_TILE`` per axis, the most tiles a brick of edge ``B`` meets on each
    axis (``(B - 2) // t + 2``), and the scratch in 4-byte words (a count
    and a cursor per tile, then a list entry and a partial sum per brick
    and slot)."""
    tiles = tuple(-(-s // t) for s, t in zip(volume_shape, K4_TILE))
    slots = tuple((B - 2) // t + 2 for t in K4_TILE)
    n_slots = slots[0] * slots[1] * slots[2]
    words = 2 * tiles[0] * tiles[1] * tiles[2] + 2 * n * n_slots
    return K4Plan(tiles, slots, words)


class K5Plan(NamedTuple):
    chunks: int          # chunks of K5_CHUNK floats in a brick
    scratch_words: int   # an owner per table brick, a partial per chunk


def k5_plan(table_shape, n: int) -> K5Plan:
    """K5's chunks of a table ``(NB, rows, cols)`` for ``n`` indices and the
    scratch in 4-byte words (an owner per table brick, then a partial sum
    per index and chunk)."""
    nb, rows, cols = table_shape
    chunks = -(-(rows * cols) // K5_CHUNK)
    return K5Plan(chunks, nb + n * chunks)

# K6's tiling: a tile spans at most K6_COLS voxels along z and as many rows
# as keep its voxels (its cells' windows) within K6_SLOTS, the voxels a
# block's 256 threads hold, 8 each; the tile along z shrinks until one cell
# row fits (a tile of one cell from cell 44 on, whose voxels the kernel
# takes in bands).  Chunks along x give every SM K6_BLOCKS_PER_SM blocks.
K6_COLS = 64
K6_SLOTS = 2048
K6_BLOCKS_PER_SM = 3


class K6Plan(NamedTuple):
    ty: int        # cells of a tile along y
    tz: int        # cells of a tile along z
    cx: int        # cells of a chunk along x
    slots: int     # voxels of a band


def k6_plan(volume_shape, cell: int, sms: int) -> K6Plan:
    """K6's tiling of a volume ``(X, Y, Z)`` at ``cell`` on a card of ``sms``
    SMs: ``tz`` cells along z and ``ty`` along y per tile, ``cx`` along x
    per chunk (as many chunks as fill ``K6_BLOCKS_PER_SM`` blocks on every
    SM without a second wave), K6_SLOTS voxels per band."""
    nx, ny, nz = grid_shape(volume_shape, cell)
    tz = max(1, min(nz, K6_COLS // cell))
    while tz > 1 and (tz * cell + 2) * (cell + 2) > K6_SLOTS:
        tz -= 1
    cols = min(tz * cell + 2, volume_shape[2])
    ty = max(1, min(ny, (K6_SLOTS // cols - 2) // cell))
    tiles = -(-ny // ty) * -(-nz // tz)
    chunks = max(1, min(nx, K6_BLOCKS_PER_SM * sms // tiles))
    return K6Plan(ty, tz, -(-nx // chunks), K6_SLOTS)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _lanes(sums: torch.Tensor) -> torch.Tensor:
    return sums[:, None].expand(sums.shape[0], LANES).contiguous()


def brick_sums_reference(volume: torch.Tensor,
                         origins: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K4: ``volume[x:x+B, y:y+B, z:z+B].sum()`` for
    each origin row ``(x, y, z)``, NaN where the brick leaves the volume."""
    o = origins.to(torch.int64)
    limit = torch.tensor(volume.shape, device=o.device) - B
    inside = ((o >= 0) & (o <= limit)).all(dim=1)
    sums = torch.full((o.shape[0],), float("nan"), dtype=torch.float32,
                      device=volume.device)
    if bool(inside.any()):
        win = volume.unfold(0, B, 1).unfold(1, B, 1).unfold(2, B, 1)
        oi = o[inside]
        sums[inside] = win[oi[:, 0], oi[:, 1], oi[:, 2]].sum(dim=(1, 2, 3))
    return _lanes(sums)


def brick_rows_reference(bricks: torch.Tensor,
                         idx: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K5: ``bricks[idx[i]].sum()`` per row, NaN
    where ``idx[i]`` is outside ``[0, NB)``."""
    i = idx.to(torch.int64)
    inside = (i >= 0) & (i < bricks.shape[0])
    sums = torch.full((i.shape[0],), float("nan"), dtype=torch.float32,
                      device=bricks.device)
    sums[inside] = bricks[i[inside]].sum(dim=(1, 2))
    return _lanes(sums)


def grid_shape(volume_shape, cell: int):
    """Macrocell grid shape ``ceil(size / cell)`` per axis."""
    return tuple(-(-s // cell) for s in volume_shape)


def cell_minmax_reference(volume: torch.Tensor, cell: int):
    """Plain torch version of K6: per macrocell the ``(min, max)`` over the
    window ``[c*cell - 1, (c+1)*cell]`` per axis, clamped to the volume:
    replicate padding and a ``max_pool3d`` of window ``cell + 2`` and stride
    ``cell`` (the min by negation).  Returns ``(lo, hi)``, each
    ``(nx, ny, nz)`` f32."""
    shape = grid_shape(volume.shape, cell)
    pad = []
    for s, n in zip(reversed(volume.shape), reversed(shape)):
        pad += [1, n * cell - s + 1]
    v = F.pad(volume.to(torch.float32)[None, None], pad, mode="replicate")
    win = cell + 2
    hi = F.max_pool3d(v, win, cell)[0, 0]
    lo = -F.max_pool3d(-v, win, cell)[0, 0]
    return lo, hi


def _volume(name, t, ndim):
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32; got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dimensions; got "
                         f"{tuple(t.shape)}")
    return t.detach().contiguous()


def _index(name, t, dev, shape):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}; the data on {dev}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32; got {t.dtype}")
    if t.ndim != len(shape) or any(
            w is not None and a != w for a, w in zip(t.shape, shape)):
        raise ValueError(f"{name} must have shape {shape}; got "
                         f"{tuple(t.shape)}")
    return t.contiguous()


def brick_sums(volume: torch.Tensor, origins: torch.Tensor) -> torch.Tensor:
    """Sum of the ``B``^3 brick of ``volume`` (X, Y, Z) f32 at each row
    of ``origins`` (n, 3) int32, broadcast to ``(n, 128)``: kernel K4 on
    CUDA tensors (counted in ``brick_sums.launches``),
    :func:`brick_sums_reference` on CPU tensors."""
    if _build.uses_plain(volume):
        return brick_sums_reference(volume, origins)
    volume = _volume("volume", volume, 3)
    origins = _index("origins", origins, volume.device, (None, 3))
    n = origins.shape[0]
    out = torch.empty((n, LANES), dtype=torch.float32, device=volume.device)
    plan = k4_plan(volume.shape, n)
    scratch = torch.empty(plan.scratch_words, dtype=torch.int32,
                          device=volume.device)
    _build.check(_build.library().dr_brick_sums(
        volume.data_ptr(), *volume.shape, origins.data_ptr(), n,
        scratch.data_ptr(), plan.scratch_words, out.data_ptr(),
        volume.device.index, _build.stream_of(volume)), "brick_sums")
    brick_sums.launches += 1
    return out


brick_sums.launches = 0


def brick_rows(bricks: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Sum of the pre-bricked row block ``bricks[idx[i]]`` of ``bricks``
    (NB, rows, cols) f32 for each ``idx`` (n,) int32, broadcast to
    ``(n, 128)``: kernel K5 on CUDA tensors (counted in
    ``brick_rows.launches``), :func:`brick_rows_reference` on CPU tensors."""
    if _build.uses_plain(bricks):
        return brick_rows_reference(bricks, idx)
    bricks = _volume("bricks", bricks, 3)
    idx = _index("idx", idx, bricks.device, (None,))
    n = idx.shape[0]
    out = torch.empty((n, LANES), dtype=torch.float32, device=bricks.device)
    nb, rows, cols = bricks.shape
    plan = k5_plan(bricks.shape, n)
    scratch = torch.empty(plan.scratch_words, dtype=torch.int32,
                          device=bricks.device)
    _build.check(_build.library().dr_brick_rows(
        bricks.data_ptr(), nb, rows * cols, idx.data_ptr(), n,
        scratch.data_ptr(), plan.scratch_words, out.data_ptr(),
        bricks.device.index, _build.stream_of(bricks)), "brick_rows")
    brick_rows.launches += 1
    return out


brick_rows.launches = 0


def cell_minmax(volume: torch.Tensor, cell: int):
    """Per-macrocell ``(lo, hi)`` of ``volume`` (X, Y, Z) over each cell and
    its one-voxel halo: kernel K6 on CUDA tensors (counted in
    ``cell_minmax.launches``), :func:`cell_minmax_reference` on CPU
    tensors.  Both equal the JAX package's ``_cell_minmax`` bit for bit."""
    if _build.uses_plain(volume):
        return cell_minmax_reference(volume, cell)
    if cell < 1:
        raise ValueError(f"cell must be >= 1; got {cell}")
    volume = _volume("volume", volume, 3)
    shape = grid_shape(volume.shape, cell)
    lo = torch.empty(shape, dtype=torch.float32, device=volume.device)
    hi = torch.empty_like(lo)
    X, Y, Z = volume.shape
    plan = k6_plan(volume.shape, cell, _sms(volume.device.index))
    _build.check(_build.library().dr_cell_minmax(
        volume.data_ptr(), X, Y, Z, cell, *plan, lo.data_ptr(),
        hi.data_ptr(), volume.device.index, _build.stream_of(volume)),
        "cell_minmax")
    cell_minmax.launches += 1
    return lo, hi


cell_minmax.launches = 0


__all__ = ["brick_sums", "brick_rows", "cell_minmax", "brick_sums_reference",
           "brick_rows_reference", "cell_minmax_reference", "grid_shape",
           "k4_plan", "k5_plan", "k6_plan"]
