"""Numpy mirrors of kernels K4 (``brick_sums``) and K5 (``brick_rows``),
``csrc/bricks.cu``, held on the CPU against the plain versions and the
Pallas kernels of ``experiments/exp_pallas_dma.py`` in interpret mode.

K4: the binning (a count per tile, the one-block exclusive scan over runs
of tiles, a fill in an arbitrary order), each tile's bounding box of
intersections copied into a tile buffer that holds NaN elsewhere (a read
outside the box would show), each intersection summed a row at a time with
lanes along z and a shuffle tree into its slot (written exactly once), and
the slots added in ``(dx, dy, dz)`` order.  K5: the owner pass (the least
row index of each brick, indices outside the table skipped), the owners'
chunk partials (thread ``t`` taking float4 ``t, t + 256, ...``, a shuffle
tree per warp, the warps in order), and every row, duplicates included,
taking its owner's partials in chunk order.

Tolerance: the probe's ``rtol=1e-5`` (the sums are taken in another order
than XLA's and torch's).
"""
import importlib.util
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import differender_tpu_torch as P
from differender_tpu_torch.ops.bricks import (B, K4_TILE, K5_CHUNK, k4_plan,
                                              k5_plan)

F = np.float32
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THREADS = 256           # kThreads
SCAN_THREADS = 1024     # kScanThreads
OWNER_INIT = 0x7F7F7F7F


@pytest.fixture(scope="module")
def probe():
    """The probe module with its kernels in interpret mode."""
    spec = importlib.util.spec_from_file_location(
        "exp_pallas_dma", os.path.join(ROOT, "experiments", "exp_pallas_dma.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.INTERPRET = True
    return mod


def _lane_tree(acc):
    """The xor shuffle tree over the last axis (32 lanes): lane 0's sum."""
    lanes = np.arange(32)
    for d in (16, 8, 4, 2, 1):
        acc = (acc + acc[..., lanes ^ d]).astype(F)
    return acc[..., 0]


# -- K4 ----------------------------------------------------------------------

def _scan(counts):
    """tile_scan_kernel: thread t sums a run of ``per`` tiles, the runs are
    scanned across the block, each thread writes its run's starts."""
    tiles = len(counts)
    per = -(-tiles // SCAN_THREADS)
    runs = [counts[min(t * per, tiles):min(t * per + per, tiles)].sum()
            for t in range(SCAN_THREADS)]
    starts = np.concatenate([[0], np.cumsum(runs)[:-1]])
    cursor = np.zeros(tiles, np.int64)
    for t in range(SCAN_THREADS):
        start = starts[t]
        for k in range(min(t * per, tiles), min(t * per + per, tiles)):
            cursor[k] = start
            start += counts[k]
    return cursor


def _k4_slots(tile):
    """kSlotsX/Y/Z: the most tiles a brick of edge B meets per axis."""
    return tuple((B - 2) // t + 2 for t in tile)


def _k4_mirror(vol, origins, tile=K4_TILE, vec=None, seed=0):
    """K4 pass by pass, on tiles of ``tile`` voxels (the card's are
    ``K4_TILE``).  Returns the (n, 128) output, the voxels copied into the
    tiles' buffers and the (brick, tile) pairs."""
    X, Y, Z = vol.shape
    origins = np.asarray(origins, np.int64).reshape(-1, 3)
    n = len(origins)
    tx, ty, tz = tile
    ntx, nty, ntz = (-(-s // t) for s, t in zip(vol.shape, tile))
    slots = _k4_slots(tile)
    sx, sy, sz = slots
    S = sx * sy * sz
    if vec is None:
        vec = Z % 4 == 0 and tz % 4 == 0
    t_edge = np.array(tile)
    inside = ((origins >= 0) & (origins <= np.array(vol.shape) - B)).all(1)

    # brick_bin_kernel: thread (i, s), slot s = (dx * sy + dy) * sz + dz.
    i_of = np.repeat(np.arange(n), S)
    s_of = np.tile(np.arange(S), n)
    o = origins[i_of]
    t3 = o // t_edge + np.stack([s_of // (sy * sz), s_of // sz % sy,
                                 s_of % sz], 1)
    ok = inside[i_of] & (t3 <= (o + B - 1) // t_edge).all(1)
    tid = (t3[:, 0] * nty + t3[:, 1]) * ntz + t3[:, 2]
    counts = np.bincount(tid[ok], minlength=ntx * nty * ntz)
    cursor = _scan(counts)
    np.testing.assert_array_equal(cursor, np.cumsum(counts) - counts)
    lst = np.full(max(int(ok.sum()), 1), -1, np.int64)
    for k in np.random.default_rng(seed).permutation(np.flatnonzero(ok)):
        lst[cursor[tid[k]]] = i_of[k]       # the atomics' order is free
        cursor[tid[k]] += 1
    assert (lst[:ok.sum()] >= 0).all()

    # brick_tile_kernel, one block per tile.
    partial = np.full((n, S), np.nan, F)
    written = np.zeros((n, S), np.int64)
    pitch = min(tz, Z)
    copied = 0
    for t in range(ntx * nty * ntz):
        cnt = counts[t]
        if cnt == 0:
            continue
        entries = lst[cursor[t] - cnt:cursor[t]]
        ix, iy, iz = t // (nty * ntz), t // ntz % nty, t % ntz
        org = np.array([ix * tx, iy * ty, iz * tz])
        ext = np.minimum(t_edge, np.array(vol.shape) - org)
        lo = np.maximum(origins[entries] - org, 0)
        hi = np.minimum(origins[entries] + B - org, ext)
        assert (hi > lo).all()
        b0, b1 = lo.min(0), hi.max(0)
        if vec:
            b0[2] &= ~3
            b1[2] = (b1[2] + 3) & ~3
        assert (b1 <= ext).all() and ext[2] <= pitch
        buf = np.full((tx, ty, pitch), np.nan, F)
        sl = tuple(slice(a, b) for a, b in zip(b0, b1))
        buf[sl] = vol[tuple(slice(g + a, g + b)
                            for g, a, b in zip(org, b0, b1))]
        copied += int(np.prod(b1 - b0))
        for e, (xa, ya, za), (xb, yb, zb) in zip(entries, lo, hi):
            assert zb - za <= 32
            rows = buf[xa:xb, ya:yb, za:zb].reshape(-1, zb - za)
            acc = np.zeros(32, F)
            acc[:zb - za] = np.cumsum(rows, axis=0, dtype=F)[-1]
            d = np.array([ix, iy, iz]) - origins[e] // t_edge
            slot = (d[0] * sy + d[1]) * sz + d[2]
            assert 0 <= d.min() and (d < slots).all()
            written[e, slot] += 1
            partial[e, slot] = _lane_tree(acc)

    # brick_final_kernel: the slots in (dx, dy, dz) order, NaN outside.
    out = np.full((n,), np.nan, F)
    for i in np.flatnonzero(inside):
        nt = (origins[i] + B - 1) // t_edge - origins[i] // t_edge + 1
        s = F(0)
        for dx in range(nt[0]):
            for dy in range(nt[1]):
                for dz in range(nt[2]):
                    slot = (dx * sy + dy) * sz + dz
                    assert written[i, slot] == 1
                    s = F(s + partial[i, slot])
        out[i] = s
    assert written.sum() == ok.sum() and written.max(initial=0) <= 1
    return np.repeat(out[:, None], 128, 1), copied, int(ok.sum())


def _union(shape, origins):
    cover = np.zeros(shape, bool)
    for x, y, z in origins:
        cover[x:x + B, y:y + B, z:z + B] = True
    return int(cover.sum())


def _check_k4(vol, origins, **kw):
    got, copied, pairs = _k4_mirror(vol, origins, **kw)
    want = P.brick_sums(torch.from_numpy(vol),
                        torch.from_numpy(np.asarray(origins, np.int32)
                                         .reshape(-1, 3))).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    return got, copied, pairs


def _draw(shape, n, seed, step=1):
    rng = np.random.default_rng(seed)
    hi = np.array(shape) - B
    return (rng.integers(0, hi // step + 1, size=(n, 3)) * step).astype(
        np.int32)


@pytest.fixture(scope="module")
def volume64():
    return np.random.default_rng(0).random((64, 64, 64), F)


@pytest.mark.parametrize("kind", ["aligned", "unaligned"])
def test_k4_mirror_matches_pallas_and_plain(probe, volume64, kind):
    """The probe's A1 (origins on multiples of 8, z of 16) and A2 draws,
    with a far-corner and a tile-edge origin among them."""
    o = _draw(volume64.shape, 10, 1, step=8 if kind == "aligned" else 1)
    if kind == "aligned":
        o[:, 2] = (o[:, 2] // 16) * 16
    o[0] = (32, 32, 32)                   # the far corner
    o[1] = (8, 16, 0)                     # on tile edges
    want = np.asarray(probe.run_brick_sums(jnp.asarray(volume64),
                                           jnp.asarray(o)))
    got, copied, pairs = _check_k4(volume64, o)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert _union(volume64.shape, o) <= copied <= volume64.size


@pytest.mark.parametrize("tile", [K4_TILE, (8, 8, 128), (4, 8, 16),
                                  (3, 5, 7), (64, 1, 64)])
def test_k4_mirror_tilings(tile):
    """Tiles that split bricks on every axis, tiles of one row, and the
    4-byte route (tz % 4 != 0); the volume is longer than 256 along z, so
    the card's tiles split bricks along z too."""
    vol = np.random.default_rng(3).random((40, 48, 300), F)
    o = _draw(vol.shape, 24, 4)
    o[0] = (8, 8, 240)                    # across z = 256
    o[1] = (8, 16, 256)                   # on a tile edge
    o[5] = (9, 3, 100)                    # across z = 128
    o[2] = (8, 16, 268)                   # the far corner
    o[3] = o[4]                           # a repeated origin
    _check_k4(vol, o, tile=tile)


def test_k4_slots_bound_every_offset():
    """The slots (``(B - 2) // t + 2`` per axis, as in ``bricks.cu`` and
    ``k4_plan``) are the most tiles a brick of edge B meets."""
    for t in range(1, 70):
        most = max((o + B - 1) // t - o // t + 1 for o in range(2 * t))
        assert _k4_slots((t, t, t)) == (most,) * 3
    assert k4_plan((256, 256, 256), 1).slots == _k4_slots(K4_TILE)


def test_k4_odd_volume_takes_the_scalar_route(probe):
    """70 x 45 x 97: Z % 4 != 0 (4-byte copies), tiles cut at the faces."""
    vol = np.random.default_rng(5).random((70, 45, 97), F)
    o = _draw(vol.shape, 12, 6)
    o[0] = (38, 13, 65)                   # the far corner
    o[1] = (32, 8, 0)
    got, _, _ = _check_k4(vol, o)
    want = np.asarray(probe.run_brick_sums(jnp.asarray(vol), jnp.asarray(o)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_k4_dense_draw_copies_each_voxel_once():
    """Many overlapping bricks: the tiles' boxes hold every voxel of the
    union, and no voxel is copied twice; the 16-byte route's boxes, widened
    along z to multiples of 4, hold those of the 4-byte route."""
    vol = np.random.default_rng(7).random((64, 48, 80), F)
    o = _draw(vol.shape, 60, 8)
    got, copied, pairs = _check_k4(vol, o)
    _, copied4, _ = _check_k4(vol, o, vec=False)
    assert _union(vol.shape, o) <= copied4 <= copied <= vol.size
    assert pairs <= 60 * np.prod(k4_plan(vol.shape, 60).slots)


@pytest.mark.parametrize("case", ["small_axis", "n0", "n1", "repeated",
                                  "outside"])
def test_k4_edge_cases(case):
    rng = np.random.default_rng(9)
    vol = rng.random((40, 36, 50), F)
    if case == "small_axis":              # Y < 32: every row NaN
        vol = rng.random((40, 31, 50), F)
        o = np.array([[0, 0, 0], [8, 0, 18], [0, -1, 0]], np.int32)
    elif case == "n0":
        o = np.zeros((0, 3), np.int32)
    elif case == "n1":
        o = np.array([[8, 4, 18]], np.int32)
    elif case == "repeated":
        o = np.array([[3, 2, 1]] * 5 + [[8, 4, 18]] * 3, np.int32)
    else:                                 # NaN rows among others
        o = np.array([[0, 0, 0], [9, 0, 0], [0, 5, 0], [0, 0, 19],
                      [-1, 0, 0], [8, 4, 18], [2 ** 30, 0, 0]], np.int32)
    got, _, pairs = _check_k4(vol, o)
    assert got.shape == (len(o), 128)
    if case == "small_axis":
        assert np.isnan(got).all() and pairs == 0
    if case == "repeated":
        assert (got[:5] == got[0]).all() and (got[5:] == got[5]).all()
    if case == "outside":
        assert np.isnan(got[[1, 2, 3, 4, 6]]).all()
        assert not np.isnan(got[[0, 5]]).any()


# -- K5 ----------------------------------------------------------------------

def _k5_mirror(table, idx, chunk=K5_CHUNK, seed=0):
    """K5 pass by pass, in chunks of ``chunk`` floats (the card's are
    ``K5_CHUNK``).  Returns the (n, 128) output and the floats read."""
    nb, rows, cols = table.shape
    length = rows * cols
    idx = np.asarray(idx, np.int64)
    n = len(idx)
    chunks = -(-length // chunk)
    flat = table.reshape(nb, length)
    vec = length % 4 == 0 and chunk % 4 == 0

    owner = np.full(nb, OWNER_INIT, np.int64)       # row_owner_kernel
    for i in np.random.default_rng(seed).permutation(n):
        if 0 <= idx[i] < nb:
            owner[idx[i]] = min(owner[idx[i]], i)

    partial = np.full((n, chunks), np.nan, F)       # row_chunk_kernel
    read = 0
    for i in range(n):
        b = idx[i]
        if not (0 <= b < nb and owner[b] == i):
            continue
        for c in range(chunks):
            data = flat[b, c * chunk:(c + 1) * chunk]
            read += data.size
            w = 4 if vec else 1
            # Thread t: elements (float4 groups) t, t + 256, ... in order,
            # zeros past the chunk.
            pad = np.zeros(-(-data.size // (THREADS * w)) * THREADS * w, F)
            pad[:data.size] = data
            per = pad.reshape(-1, THREADS, w).transpose(1, 0, 2)
            thread = np.cumsum(per.reshape(THREADS, -1), 1, dtype=F)[:, -1]
            warps = _lane_tree(thread.reshape(THREADS // 32, 32))
            partial[i, c] = np.cumsum(warps, dtype=F)[-1]

    out = np.full((n,), np.nan, F)                  # row_final_kernel
    for j in range(n):
        if 0 <= idx[j] < nb:
            p = partial[owner[idx[j]]]
            assert not np.isnan(p).any()
            out[j] = np.cumsum(p, dtype=F)[-1]
    return np.repeat(out[:, None], 128, 1), read


def _check_k5(table, idx, **kw):
    got, read = _k5_mirror(table, idx, **kw)
    want = P.brick_rows(torch.from_numpy(table),
                        torch.from_numpy(np.asarray(idx, np.int32))).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    nb = table.shape[0]
    distinct = len({int(b) for b in idx if 0 <= b < nb})
    assert read == distinct * table.shape[1] * table.shape[2]
    return got


def test_k5_mirror_matches_pallas_and_plain(probe):
    """The probe's (NB, 32, 1024) table: duplicates, the float4 route in
    chunks of 8192 floats (four to a brick)."""
    table = np.random.default_rng(2).random((8, B, B * B), F)
    idx = np.array([0, 7, 3, 3, 5, 0, 3], np.int32)
    want = np.asarray(probe.run_brick_rows(jnp.asarray(table),
                                           jnp.asarray(idx)))
    got = _check_k5(table, idx)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert k5_plan(table.shape, len(idx)).chunks == 4


@pytest.mark.parametrize("case", ["all_equal", "mixed_out_of_range", "n0",
                                  "n1", "scalar_route", "many_chunks"])
def test_k5_edge_cases(case):
    rng = np.random.default_rng(11)
    table = rng.random((6, 4, 40), F)
    chunk = K5_CHUNK
    if case == "all_equal":
        idx = np.full(9, 4, np.int32)
    elif case == "mixed_out_of_range":
        idx = np.array([2, 6, 2, -1, 5, 2 ** 31 - 1, 5, 0, -7, 2], np.int32)
    elif case == "n0":
        idx = np.zeros(0, np.int32)
    elif case == "n1":
        idx = np.array([3], np.int32)
    elif case == "scalar_route":          # 3 * 7 floats a brick: 4-byte loads
        table = rng.random((5, 3, 7), F)
        idx = np.array([4, 0, 4, 9], np.int32)
    else:                                 # 1000 floats in chunks of 64
        table = rng.random((4, 10, 100), F)
        idx = np.array([1, 3, 1, 2], np.int32)
        chunk = 64
    got = _check_k5(table, idx, chunk=chunk)
    assert got.shape == (len(idx), 128)
    if case == "all_equal":
        assert (got == got[0]).all()
    if case == "mixed_out_of_range":
        assert np.isnan(got[[1, 3, 5, 8]]).all()
        assert (got[[0, 2, 9]] == got[0]).all()


def _bricks_cu():
    with open(os.path.join(ROOT, "differender_tpu_torch", "csrc",
                           "bricks.cu")) as f:
        return f.read()


def test_k4_tile_is_the_kernels():
    """``K4_TILE`` is ``csrc/bricks.cu``'s compile-time tile."""
    src = _bricks_cu()
    assert tuple(int(re.search(rf"constexpr int kTile{a} = (\d+);", src)
                     .group(1)) for a in "XYZ") == K4_TILE


def test_plans_size_the_scratch():
    p4 = k4_plan((256, 256, 256), 2048)
    assert p4.tiles == (32, 32, 1) and p4.slots == (5, 5, 2)
    assert p4.scratch_words == 2 * 1024 + 2 * 2048 * 50
    chunk = re.search(r"constexpr int kChunk = (\d+);", _bricks_cu())
    assert int(chunk.group(1)) == K5_CHUNK
    p5 = k5_plan((4096, 32, 1024), 2048)
    assert p5.chunks == 4 and p5.scratch_words == 4096 + 2048 * 4
