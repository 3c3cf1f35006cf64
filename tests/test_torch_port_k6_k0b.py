"""Numpy mirrors of kernels K6 (``cell_minmax``, ``csrc/bricks.cu``) and K0b
(``tf_lookup_bwd``, ``csrc/tf_lookup.cu``), held on the CPU against the
plain versions and the JAX package.

K6: its tiling (``ops.bricks.k6_plan``: tiles of macrocells in (y, z),
chunks along x), the bands a tile's voxels are taken in, the ring of open
windows along x that each voxel of a plane is folded into, and the reduction
of a window along z and then y when a plane ends it, a cell that several
bands meet combined after its first band wrote it.  It is bitwise
``cell_minmax_reference`` and the JAX package's ``_cell_minmax`` for volumes
the cell does not divide, volumes smaller than one tile, cells 1 to 48, and
plans with many chunks, one chunk per tile and many bands per tile.

K0b: a grid of 1024-thread blocks striding over the lookups; per block a
copy of ``d_tf`` with a column per lane (R <= 256) or one copy (R <= 14336),
its partial summed from the lanes in the kernel's rotated order, the
partials summed in the kernel's fixed order (block b to warp b % 32, then
the warps); above R = 14336 every term into ``d_tf`` directly.  Against the
Pallas backward ``_bwd`` in interpret mode.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from differender_tpu.occupancy import _cell_minmax
from differender_tpu.ops.tf_lookup import _bwd as pallas_bwd
import differender_tpu_torch as P
from differender_tpu_torch.ops.bricks import (K6_BLOCKS_PER_SM, K6_SLOTS,
                                              grid_shape, k6_plan)

F = np.float32
H100_SMS = 132
K6_THREADS = 256        # kCellThreads


# -- K6 ----------------------------------------------------------------------

def _k6_mirror(vol, cell, plan):
    """K6 block by block and band by band, as ``cell_minmax_kernel`` runs:
    the planes folded per voxel into the open windows along x (a ring of
    three, the third only at cell 1), each window reduced along z and then
    y into the band's cells when a plane ends it, a cell that several bands
    meet combined in the output after its first band wrote it."""
    X, Y, Z = vol.shape
    nx, ny, nz = grid_shape(vol.shape, cell)
    ty, tz, cx, slots = plan
    lo = np.full((nx, ny, nz), np.nan, F)
    hi = np.full((nx, ny, nz), np.nan, F)
    writes = np.zeros((nx, ny, nz), np.int64)
    tiles_z, tiles_y = -(-nz // tz), -(-ny // ty)
    for b in range(tiles_z * tiles_y * -(-nx // cx)):
        tz0 = (b % tiles_z) * tz
        ty0 = (b // tiles_z % tiles_y) * ty
        cx0 = (b // tiles_z // tiles_y) * cx
        ncy, ncz, cx1 = min(ty, ny - ty0), min(tz, nz - tz0), min(cx0 + cx, nx)
        y0 = max(ty0 * cell - 1, 0)
        rows = min((ty0 + ncy) * cell, Y - 1) - y0 + 1
        z0 = max(tz0 * cell - 1, 0)
        cols = min((tz0 + ncz) * cell, Z - 1) - z0 + 1
        p0, p1 = max(cx0 * cell - 1, 0), min(cx1 * cell, X - 1)
        nq = min(cols, slots)
        nr = max(1, min(rows, slots // nq))
        for br in range(0, rows, nr):
            for bq in range(0, cols, nq):
                hr, hq = min(nr, rows - br), min(nq, cols - bq)
                assert hr * hq <= slots and hr * ncz <= 2048
                band = vol[:, y0 + br:y0 + br + hr, z0 + bq:z0 + bq + hq]
                ring = [[np.full((hr, hq), np.inf, F),
                         np.full((hr, hq), -np.inf, F)] for _ in range(3)]
                cur = cx0
                for p in range(p0, p1 + 1):
                    opens = (True, p >= (cur + 1) * cell - 1,
                             cell == 1 and p >= (cur + 2) * cell - 1)
                    for acc, is_open in zip(ring, opens):
                        if is_open:
                            acc[0] = np.minimum(acc[0], band[p])
                            acc[1] = np.maximum(acc[1], band[p])
                    while cur < cx1 and p == min((cur + 1) * cell, X - 1):
                        w_lo, w_hi = ring[0]
                        for czi in range(ncz):
                            gz = tz0 + czi
                            za = max(gz * cell - 1, 0) - z0
                            zz = min((gz + 1) * cell, Z - 1) - z0
                            qa, qz = max(za, bq) - bq, min(zz, bq + hq - 1) - bq
                            if qa > qz:
                                continue
                            r_lo = w_lo[:, qa:qz + 1].min(1)
                            r_hi = w_hi[:, qa:qz + 1].max(1)
                            for cy in range(ncy):
                                gy = ty0 + cy
                                ra = max(gy * cell - 1, 0) - y0
                                rz = min((gy + 1) * cell, Y - 1) - y0
                                r0, r1 = max(ra, br) - br, min(rz, br + hr - 1) - br
                                if r0 > r1:
                                    continue
                                l, h = r_lo[r0:r1 + 1].min(), r_hi[r0:r1 + 1].max()
                                o = (cur, gy, gz)
                                if ra >= br and za >= bq:
                                    assert writes[o] == 0
                                    lo[o], hi[o] = l, h
                                else:
                                    assert writes[o] > 0
                                    lo[o], hi[o] = min(lo[o], l), max(hi[o], h)
                                writes[o] += 1
                        ring = ring[1:] + [[np.full((hr, hq), np.inf, F),
                                            np.full((hr, hq), -np.inf, F)]]
                        cur += 1
    assert (writes > 0).all()
    return lo, hi


def _plans(shape, cell):
    """The card's plan, one chunk per tile, and bands smaller than a tile
    (several row and column bands per tile)."""
    return {"h100": k6_plan(shape, cell, H100_SMS),
            "few_blocks": k6_plan(shape, cell, 1),
            "small_bands": k6_plan(shape, cell, H100_SMS)._replace(slots=37)}


def _volume(shape, seed):
    rng = np.random.default_rng(seed)
    # Coarse levels, so that windows often tie and the clamp matters.
    return (rng.integers(0, 50, size=shape) / F(49)).astype(F)


K6_CASES = [(shape, cell)
            for shape in ((17, 32, 33), (5, 7, 9))
            for cell in (1, 2, 3, 8, 32)] + [((40, 50, 60), 48)]


@pytest.mark.parametrize("shape,cell", K6_CASES)
def test_k6_mirror_is_bitwise_reference_and_jax(shape, cell):
    vol = _volume(shape, sum(shape) + cell)
    ref_lo, ref_hi = P.cell_minmax_reference(torch.from_numpy(vol), cell)
    j_lo, j_hi, j_shape = _cell_minmax(jnp.asarray(vol), cell)
    assert tuple(j_shape) == tuple(ref_lo.shape)
    np.testing.assert_array_equal(ref_lo.numpy(), np.asarray(j_lo))
    np.testing.assert_array_equal(ref_hi.numpy(), np.asarray(j_hi))
    for name, plan in _plans(shape, cell).items():
        lo, hi = _k6_mirror(vol, cell, plan)
        assert np.array_equal(lo, ref_lo.numpy()), (name, plan)
        assert np.array_equal(hi, ref_hi.numpy()), (name, plan)


def test_k6_mirror_volume_smaller_than_a_tile():
    """One tile and one chunk hold the whole grid; the far faces clamp on
    every axis (no cell divides 5, 7 or 9 but 1)."""
    shape = (5, 7, 9)
    for cell in (2, 3, 4):
        plan = k6_plan(shape, cell, H100_SMS)
        nx, ny, nz = grid_shape(shape, cell)
        assert (plan.ty, plan.tz) == (ny, nz)
        vol = _volume(shape, cell)
        lo, hi = _k6_mirror(vol, cell, plan)
        ref_lo, ref_hi = P.cell_minmax_reference(torch.from_numpy(vol), cell)
        assert np.array_equal(lo, ref_lo.numpy())
        assert np.array_equal(hi, ref_hi.numpy())


@pytest.mark.parametrize("cell", [1, 2, 3, 4, 8, 16, 32, 43, 48, 200])
def test_k6_plan_fits_the_kernel(cell):
    """A tile's cells fit the threads (2^ceil(log2 tz) <= 256), its voxels
    one band up to cell 43, and at 256^3 the grid is one wave of
    K6_BLOCKS_PER_SM blocks per SM of an H100, at least half full where
    there are cells enough."""
    shape = (256, 256, 256)
    plan = k6_plan(shape, cell, H100_SMS)
    nx, ny, nz = grid_shape(shape, cell)
    assert 1 << (plan.tz - 1).bit_length() <= K6_THREADS
    rows = min(plan.ty * cell + 2, 256)
    cols = min(plan.tz * cell + 2, 256)
    assert (rows * cols <= K6_SLOTS) == (cell <= 43)
    tiles = -(-ny // plan.ty) * -(-nz // plan.tz)
    blocks = tiles * -(-nx // plan.cx)
    wave = K6_BLOCKS_PER_SM * H100_SMS
    assert blocks <= max(wave, tiles)
    assert blocks >= min(wave, nx * tiles) // 2


def test_k6_plan_reads_each_voxel_about_once():
    """At 256^3, cell 2: the planes, rows and columns the blocks copy,
    halos included, come to under 1.3 times the volume."""
    shape, cell = (256, 256, 256), 2
    ty, tz, cx, _ = k6_plan(shape, cell, H100_SMS)
    nx, ny, nz = grid_shape(shape, cell)

    def span(n_cells, per, size):
        total = 0
        for c0 in range(0, n_cells, per):
            c1 = min(c0 + per, n_cells)
            total += min(c1 * cell, size - 1) - max(c0 * cell - 1, 0) + 1
        return total

    copied = span(nx, cx, 256) * span(ny, ty, 256) * span(nz, tz, 256)
    assert copied / 256 ** 3 < 1.3


def test_k6_cpu_is_the_plain_version():
    vol = torch.from_numpy(_volume((9, 10, 11), 3))
    P.reset_launch_counts()
    lo, hi = P.cell_minmax(vol, 3)
    ref_lo, ref_hi = P.cell_minmax_reference(vol, 3)
    assert torch.equal(lo, ref_lo) and torch.equal(hi, ref_hi)
    assert P.launch_counts()["cell_minmax"] == 0


# -- K0b ---------------------------------------------------------------------

THREADS = 1024          # kBwdThreads
LANE_TEXELS = 256       # kBwdLaneTexels
SHARED_TEXELS = 14336   # kBwdSharedTexels
SUM_WARPS = 32          # kSumWarps


def _k0b_blocks(n, blocks_per_sm=1, sms=H100_SMS):
    """dr_tf_lookup_bwd_plan: one block per 1024 lookups, at most what fits
    on the card."""
    return min(-(-n // THREADS), blocks_per_sm * sms)


def _k0b_mirror(tf, x, g, blocks):
    """K0b: ``(d_tf, d_int, partials)`` (partials None above
    SHARED_TEXELS).  The atomics of a block are taken in lookup order; the
    card's order among warps varies."""
    R, n = tf.shape[0], x.size
    t_raw = x * F(R - 1)
    t = np.maximum(t_raw, F(0))
    low_f = np.floor(t)
    frac = (t - low_f).astype(F)
    low = np.minimum(low_f, F(R - 1)).astype(np.int64)
    high = np.minimum(low + 1, R - 1)
    a, b = tf[low], tf[high]
    slope = (b[:, 0] - a[:, 0]) * g[:, 0]
    for c in (1, 2, 3):
        slope = (slope + (b[:, c] - a[:, c]) * g[:, c]).astype(F)
    keep = (t_raw > 0) & (t_raw < F(R - 1))
    d_int = np.where(keep, (slope * F(R - 1)).astype(F), F(0)).astype(F)

    # Each lookup's 8 terms in the kernel's order: low's 4 channels, then
    # high's where frac != 0.
    w = np.stack([F(1) - frac, frac], 1).astype(F)              # (n, 2)
    vals = (w[:, :, None] * g[:, None, :]).astype(F).reshape(n, 8)
    texel = np.stack([low, high], 1)                            # (n, 2)
    chan = np.repeat(texel, 4, axis=1) * 4 + np.tile(np.arange(4), 2)
    used = np.concatenate([np.ones((n, 4), bool),
                           np.repeat((frac != 0)[:, None], 4, 1)], 1)
    i = np.arange(n)
    gtid = i % (blocks * THREADS)
    blk = np.repeat(gtid // THREADS, 8).reshape(n, 8)[used]
    lane = np.repeat(gtid % 32, 8).reshape(n, 8)[used]
    j, v = chan[used], vals[used]
    if R > SHARED_TEXELS:
        d_tf = np.zeros(4 * R, F)
        np.add.at(d_tf, j, v)
        return d_tf.reshape(R, 4), d_int, None
    if R <= LANE_TEXELS:
        acc = np.zeros((blocks, 4 * R, 32), F)
        np.add.at(acc, (blk, j, lane), v)
        part = np.zeros((blocks, 4 * R), F)
        cols = np.arange(4 * R)
        for l in range(32):
            part = (part + acc[:, cols, (cols + l) & 31]).astype(F)
    else:
        acc = np.zeros((blocks, 4, R), F)
        np.add.at(acc, (blk, j & 3, j >> 2), v)
        part = acc.transpose(0, 2, 1).reshape(blocks, 4 * R)
    return _k0b_sum(part), d_int, part


def _k0b_sum(part):
    """tf_grad_sum_kernel: block b into warp b % 32 in increasing b, then
    the 32 warps in order."""
    warp_sums = np.zeros((SUM_WARPS, part.shape[1]), F)
    for b in range(part.shape[0]):
        warp_sums[b % SUM_WARPS] = (warp_sums[b % SUM_WARPS] + part[b]).astype(F)
    d_tf = np.zeros(part.shape[1], F)
    for w in range(SUM_WARPS):
        d_tf = (d_tf + warp_sums[w]).astype(F)
    return d_tf.reshape(-1, 4)


def _k0b_data(n, R, seed):
    """Uniform intensities, the edges -0.2, 0, 1, 1.3 and integer t (where
    the Pallas mask keeps the slope and frac is 0)."""
    rng = np.random.default_rng(seed)
    tf = rng.random((R, 4), dtype=F)
    k = np.arange(R, dtype=F) / F(R - 1) if R > 1 else np.zeros(1, F)
    k = k[(k * F(R - 1)) == np.round(k * F(R - 1))][:512]
    edges = np.array([-0.2, 0.0, 1.0, 1.3], F)
    x = np.concatenate([edges, k, rng.random(n - edges.size - k.size,
                                             dtype=F)])
    g = (rng.random((n, 4), dtype=F) - F(0.5)).astype(F)
    return tf, x, g


def _pallas(tf, x, g):
    with pltpu.force_tpu_interpret_mode():
        d_tf, d_int = pallas_bwd((jnp.asarray(tf), jnp.asarray(x)),
                                 jnp.asarray(g))
    return np.asarray(d_tf), np.asarray(d_int)


# n <= 2^16; the one-hot matrices of the Pallas kernel in interpret mode are
# (4096, R), so the large R take one 4096-lookup block.
K0B_CASES = [(2, 1 << 16), (128, 1 << 16), (1024, 1 << 14), (1025, 1 << 14),
             (4096, 4096), (16384, 4096)]


@pytest.mark.parametrize("R,n", K0B_CASES)
@pytest.mark.parametrize("grid", ["h100", "three_blocks"])
def test_k0b_mirror_matches_pallas_bwd(R, n, grid):
    tf, x, g = _k0b_data(n, R, R + n)
    blocks = _k0b_blocks(n) if grid == "h100" else 3
    d_tf, d_int, part = _k0b_mirror(tf, x, g, blocks)
    assert (part is None) == (R > SHARED_TEXELS)
    want_tf, want_int = _pallas(tf, x, g)
    np.testing.assert_allclose(d_int, want_int, rtol=0,
                               atol=1e-6 * max(1.0, np.abs(want_int).max()))
    np.testing.assert_allclose(d_tf, want_tf, rtol=0,
                               atol=1e-5 * np.abs(want_tf).max())
    # The edges: no slope at or below t = 0 nor at or above t = R - 1.
    assert (d_int[:4] == 0).all()
    t = x * F(R - 1)
    inner = (t > 0) & (t < R - 1) & (t == np.round(t))
    assert R <= 2 or (d_int[inner] != 0).any()


@pytest.mark.parametrize("R", [128, 1024])
def test_k0b_partials_sum_in_a_fixed_order(R):
    """The sum across blocks is the same on every call and is the partials'
    sum in the kernel's order; that order differs from a plain sum of the
    partials only in the last bits."""
    n = 1 << 15
    tf, x, g = _k0b_data(n, R, 7)
    blocks = _k0b_blocks(n)
    first, _, part = _k0b_mirror(tf, x, g, blocks)
    second, _, part2 = _k0b_mirror(tf, x, g, blocks)
    assert np.array_equal(first, second) and np.array_equal(part, part2)
    assert np.array_equal(first, _k0b_sum(part))
    np.testing.assert_allclose(first, part.sum(0, dtype=np.float64)
                               .reshape(-1, 4), rtol=0,
                               atol=1e-6 * np.abs(first).max())


@pytest.mark.parametrize("R", [2, 128, 1024, 16384])
def test_k0b_mirror_matches_the_plain_backward(R):
    """The mirror against ``tf_lookup_bwd_reference`` (the CPU path of
    ``tf_lookup_bwd``) at the card's tolerances."""
    n = 1 << 14
    tf, x, g = _k0b_data(n, R, R)
    d_tf, d_int, _ = _k0b_mirror(tf, x, g, _k0b_blocks(n))
    ref_tf, ref_int = P.tf_lookup_bwd(torch.from_numpy(tf),
                                      torch.from_numpy(x),
                                      torch.from_numpy(g))
    np.testing.assert_allclose(d_int, ref_int.numpy(), rtol=0,
                               atol=1e-5 * max(1.0, float(ref_int.abs().max())))
    np.testing.assert_allclose(d_tf, ref_tf.numpy(), rtol=0,
                               atol=1e-4 * float(ref_tf.abs().max()))
