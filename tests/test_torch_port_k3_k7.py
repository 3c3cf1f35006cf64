"""Numpy mirrors of kernels K3 (``march_nondiff``, ``csrc/march.cu``) and K7
(``cell_distance``, ``csrc/distance.cu``), held on the CPU against the plain
versions the kernels are held to on the card.

K3: its loop with the per-ray cell cache (the centre's 2x2x2 cell, loaded
when the centre's low voxel indices change), the memo of the jump lookup (a
macrocell whose lookup gave no jump is not read again while the head stays
in it) and the distinct-voxel stencil of its composited samples.  Its
visited and composited samples, its image, and each sample's value and
gradient are bitwise those of ``march_nondiff_plain`` and
``sample_with_gradient``; its cell loads equal the plain march's count; the
memo never reads the grid more often than the loop without it.

K7: its sparse table of the TF's alpha, its classification, its z pass
(ballot masks and bit scans) and its y and x passes (a forward and a
backward scan per line, with the last position of every value), against
``tf_alpha_range_max``, the classification of ``cell_distance_reference``,
a brute-force L-inf distance and ``cell_distance_reference`` itself.  All
integer or bitwise comparisons.
"""
import math

import numpy as np
import pytest
import torch

from conftest import make_shell_volume, make_sphere_volume
from test_torch_port_stencil import _extra, _point_sum, _stencil_axis
import differender_tpu_torch as P
from differender_tpu_torch import sampling as ps
from differender_tpu_torch.ops.distance import _occupied
from differender_tpu_torch.render import _ert_threshold, _ray_soa
from differender_tpu_torch.shading import shade

F = np.float32
LOOK_FROM = np.array([1.2, 0.8, 2.0], F)


# -- K3 ----------------------------------------------------------------------

def _centre(origin, dirs, t0, dt, s, scale, shape):
    """centre_at: the position of step s and, per axis, the voxel coordinate,
    its low and high indices and its fraction."""
    t = t0 + s.astype(F) * dt
    pos = origin + t[:, None] * dirs
    c = np.clip(F(0.5) * pos + F(0.5), F(0), F(1)) * scale
    lo_f = np.floor(c)
    lo = lo_f.astype(np.int64)
    hi = np.minimum(lo + 1, np.asarray(shape) - 1)
    return pos, c, lo, hi, c - lo_f


def _gather(flat, shape, x, y, z):
    return flat[(x * shape[1] + y) * shape[2] + z]


def _trilinear_np(flat, shape, scale, p):
    """One point, 8 loads, the plain sum's order and rounding."""
    c = np.clip(F(0.5) * p + F(0.5), F(0), F(1)) * scale
    lo_f = np.floor(c)
    lo = lo_f.astype(np.int64)
    hi = np.minimum(lo + 1, np.asarray(shape) - 1)
    f = c - lo_f
    v = [_gather(flat, shape, *((hi if k >> a & 1 else lo)[:, a]
                                for a in range(3))) for k in range(8)]
    return _point_sum(v, F(1) - f[:, 0], f[:, 0], F(1) - f[:, 1], f[:, 1],
                      F(1) - f[:, 2], f[:, 2])


def _gradient(flat, shape, scale, cell, pos, delta):
    """stencil_gradient: the compact branch from the cached cell and the
    extra layers, else 6 points of 8 loads.  Returns the gradient and the
    voxels loaded per sample."""
    d = F(delta)
    X, Y, Z = (_stencil_axis(pos[:, a], d, scale[a], shape[a])
               for a in range(3))
    ok = X["ok"] & Y["ok"] & Z["ok"]
    grad = np.zeros((pos.shape[0], 3), F)
    loads = np.full(pos.shape[0], 48, np.int64)
    for a in range(3):
        e = np.zeros((3,), F)
        e[a] = d
        grad[:, a] = (_trilinear_np(flat, shape, scale, pos + e)
                      - _trilinear_np(flat, shape, scale, pos - e))
    if not ok.any():
        return grad, loads
    X, Y, Z = ({k: v[ok] for k, v in A.items()} for A in (X, Y, Z))
    c = [cell[ok, k] for k in range(8)]
    ex, ey, ez = _extra(X), _extra(Y), _extra(Z)

    def at(x, y, z):
        return _gather(flat, shape, np.clip(x, 0, shape[0] - 1),
                       np.clip(y, 0, shape[1] - 1),
                       np.clip(z, 0, shape[2] - 1))

    xe = [at(ex, Y["lo"] + (o & 1), Z["lo"] + (o >> 1)) for o in range(4)]
    ye = [at(X["lo"] + (o & 1), ey, Z["lo"] + (o >> 1)) for o in range(4)]
    ze = [at(X["lo"] + (o & 1), Y["lo"] + (o >> 1), ez) for o in range(4)]
    gx, gy, gz = (F(1) - A["f"] for A in (X, Y, Z))
    for a, (A, step, extra) in enumerate(((X, 1, xe), (Y, 2, ye),
                                          (Z, 4, ze))):
        vp, vm = [None] * 8, [None] * 8
        for n, o in enumerate(k for k in range(8) if not k & step):
            vp[o] = np.where(A["pl"], c[o + step], c[o])
            vp[o + step] = np.where(A["pl"], extra[n], c[o + step])
            vm[o] = np.where(A["m"], extra[n], c[o])
            vm[o + step] = np.where(A["m"], c[o], c[o + step])
        wp = [gx, X["f"], gy, Y["f"], gz, Z["f"]]
        wm = list(wp)
        wp[2 * a:2 * a + 2] = [F(1) - A["fp"], A["fp"]]
        wm[2 * a:2 * a + 2] = [F(1) - A["fm"], A["fm"]]
        grad[ok, a] = _point_sum(vp, *wp) - _point_sum(vm, *wm)
    loads[ok] = 4 * sum((A["m"] | A["pl"]).astype(np.int64)
                        for A in (X, Y, Z))
    return grad, loads


def _k3_mirror(vol, tf, rays, cfg, sr, grid):
    """K3's loop over all rays at once, iteration by iteration (a ray's
    iteration count is the loop's).  Returns the image, per-ray counts and
    every visited sample (positions, values) and composited sample
    (positions, gradients)."""
    shape = vol.shape
    flat = vol.numpy().reshape(-1)
    scale = ps.voxel_scale(shape)
    _, dirs_t, t0_t, dt_t, n_t = _ray_soa(rays)
    dirs, t0, dt = dirs_t.numpy(), t0_t.numpy(), dt_t.numpy()
    limit = n_t.numpy().astype(np.int64)
    origin = rays.origin.numpy().astype(F)
    N = dirs.shape[0]
    thr = _ert_threshold(cfg)
    skip = float(F(cfg.alpha_skip))
    every = max(1, cfg.occupancy_jump_every)
    T = torch.ones(N)
    rgb = torch.zeros(N, 3)
    s = np.zeros(N, np.int64)
    look = np.full(N, grid is not None)
    key = np.full((N, 3), -1, np.int64)
    cell = np.zeros((N, 8), F)
    memo = np.full((N, 3), -1, np.int64)
    cnt = {k: np.zeros(N, np.int64) for k in (
        "visited", "composited", "cell_loads", "extra_loads", "grid_reads",
        "lookups")}
    visits, shades = [], []
    idx = np.arange(N)
    it = 0
    while True:
        idx = idx[(limit[idx] > s[idx]) & (T.numpy()[idx] > thr)]
        if grid is not None and it % every == 0 and idx.size:
            j = idx[look[idx]]
            _, c, lo, _, _ = _centre(origin, dirs[j], t0[j], dt[j], s[j],
                                     scale, shape)
            if grid.cell & (grid.cell - 1) == 0:
                q = lo >> int(math.log2(grid.cell))
            else:
                q = (c / F(grid.cell)).astype(np.int64)
            q = np.minimum(q, np.asarray(grid.shape) - 1)
            cnt["lookups"][j] += 1
            new = (q != memo[j]).any(-1)
            r, q = j[new], q[new]
            cnt["grid_reads"][r] += 1
            d = grid.dist.numpy()[(q[:, 0] * grid.shape[1] + q[:, 1])
                                  * grid.shape[2] + q[:, 2]]
            qj = (F(np.maximum(d - 1, 0)) * F(grid.cell_world)
                  / np.maximum(dt[r], F(1e-30)))
            jump = np.where((d > 1) & (dt[r] > 0),
                            np.minimum(qj, limit[r] - s[r]), 0).astype(
                                np.int64)
            memo[r[jump == 0]] = q[jump == 0]
            s[r] += jump
            idx = idx[limit[idx] > s[idx]]
        if idx.size == 0:
            break
        cnt["visited"][idx] += 1
        pos, _, lo, hi, f = _centre(origin, dirs[idx], t0[idx], dt[idx],
                                    s[idx], scale, shape)
        miss = (lo != key[idx]).any(-1)
        m = idx[miss]
        for k in range(8):
            cell[m, k] = _gather(flat, shape, *(
                (hi if k >> a & 1 else lo)[miss, a] for a in range(3)))
        key[m] = lo[miss]
        cnt["cell_loads"][m] += 1
        v = _point_sum([cell[idx, k] for k in range(8)], F(1) - f[:, 0],
                       f[:, 0], F(1) - f[:, 1], f[:, 1], F(1) - f[:, 2],
                       f[:, 2])
        visits.append((pos, v))
        rgba = ps.apply_tf(tf, torch.from_numpy(v))
        keep = (rgba[:, 3] > skip).numpy()
        if grid is not None:
            look[idx] = ~keep
        on = idx[keep]
        grad, loads = _gradient(flat, shape, scale, cell[on], pos[keep],
                                cfg.normal_delta)
        shades.append((pos[keep], grad))
        cnt["extra_loads"][on] += loads
        cnt["composited"][on] += 1
        on_t = torch.from_numpy(on)
        sh = shade(torch.from_numpy(pos[keep]), torch.from_numpy(grad),
                   rgba[torch.from_numpy(keep)], dirs_t[on_t],
                   rays.origin.to(torch.float32), sr, cfg, clamp_light=False)
        Ti = T[on_t]
        rgb = rgb.index_add(0, on_t, Ti[:, None] * sh[:, :3])
        T = T.index_copy(0, on_t, Ti * (1.0 - sh[:, 3]))
        s[idx] += 1
        it += 1
    H, W = cfg.image_shape
    image = torch.clamp(torch.cat([rgb, (1.0 - T)[:, None]], -1),
                        max=1.0).reshape(H, W, 4)
    cnt = {k: v.reshape(H, W) for k, v in cnt.items()}
    return image, cnt, visits, shades


SCENES = {"sphere": make_sphere_volume, "shell": make_shell_volume}
K3_CASES = [(scene, cell, delta) for scene in SCENES
            for cell in (None, 2, 3) for delta in (1e-3, "0.6vox")]


@pytest.mark.parametrize("scene,cell,delta", K3_CASES,
                         ids=[f"{s}-{c}-{d}" for s, c, d in K3_CASES])
def test_k3_mirror_matches_plain_march(scene, cell, delta):
    """With and without a grid (cell 2: the shift, cell 3: the division),
    at a stencil half-width of 1e-3 (compact branch) and 0.6 voxel (mostly
    the general branch)."""
    vol_np = SCENES[scene]()
    res = vol_np.shape[0]
    if isinstance(delta, str):
        delta = float(F(float(delta[:-3]) * 2.0
                        / float(ps.voxel_scale((res,) * 3)[0])))
    kw = dict(volume_shape=vol_np.shape, image_shape=(10, 10),
              normal_delta=delta)
    if cell is not None:
        kw.update(occupancy_cell=cell, occupancy_max_dist=16)
    cfg = P.RenderConfig(**kw)
    vol, tf, lf = P.state_from_numpy(vol_np, P.get_tf("tf1", 32, device="cpu").numpy(),
                                     LOOK_FROM, device="cpu")
    grid = P.build_occupancy(vol, tf, cfg) if cell is not None else None
    sr = 6.0
    rays = P.make_rays(lf, cfg, sr)
    loads = torch.zeros(cfg.image_shape, dtype=torch.int32)
    want, want_vis, want_comp = P.march_nondiff_plain(
        vol, tf, rays, cfg, sr, grid, cell_loads=loads)
    got, cnt, visits, shades = _k3_mirror(vol, tf, rays, cfg, sr, grid)

    assert torch.equal(got, want)
    np.testing.assert_array_equal(cnt["visited"], want_vis.numpy())
    np.testing.assert_array_equal(cnt["composited"], want_comp.numpy())
    np.testing.assert_array_equal(cnt["cell_loads"], loads.numpy())
    pos = np.concatenate([p for p, _ in visits])
    v = np.concatenate([x for _, x in visits])
    np.testing.assert_array_equal(
        v, ps.trilinear(vol, torch.from_numpy(pos)).numpy())
    pos = np.concatenate([p for p, _ in shades])
    grad = np.concatenate([g for _, g in shades])
    _, want_g = ps.sample_with_gradient(vol, torch.from_numpy(pos), delta)
    np.testing.assert_array_equal(grad, want_g.numpy())

    # The cache: consecutive samples share a cell (6 samples per voxel).
    assert cnt["cell_loads"].sum() < 0.5 * cnt["visited"].sum()
    per = cnt["extra_loads"][cnt["composited"] > 0] / cnt["composited"][
        cnt["composited"] > 0]
    assert ((per >= 0) & (per <= 48)).all()
    if delta < 0.01:
        assert per.max() <= 12
    else:
        assert per.mean() > 12
    if grid is None:
        assert cnt["grid_reads"].sum() == cnt["lookups"].sum() == 0
    else:
        assert (cnt["grid_reads"] <= cnt["lookups"]).all()
        assert cnt["grid_reads"].sum() < cnt["lookups"].sum()
        assert cnt["visited"].sum() < P.march_nondiff_plain(
            vol, tf, rays, cfg, sr)[1].sum()


def test_k3_counts_are_card_only():
    """On CPU tensors K3's counts raise, as K1's do; the plain march fills
    its cell-load count."""
    vol_np = make_sphere_volume((16, 16, 16))
    cfg = P.RenderConfig(volume_shape=vol_np.shape, image_shape=(4, 4))
    vol, tf, lf = P.state_from_numpy(vol_np, P.get_tf("tf1", 32, device="cpu").numpy(),
                                     LOOK_FROM, device="cpu")
    rays = P.make_rays(lf, cfg, 2.0)
    with pytest.raises(ValueError, match="K3 only"):
        P.march_nondiff(vol, tf, rays, cfg, 2.0,
                        counts=torch.zeros((4, 4, 3), dtype=torch.int32))
    loads = torch.zeros((4, 4), dtype=torch.int32)
    _, vis, _ = P.march_nondiff_plain(vol, tf, rays, cfg, 2.0,
                                      cell_loads=loads)
    assert bool(((loads >= 1) | (vis == 0)).all())
    assert bool((loads <= vis).all())


# -- K7 ----------------------------------------------------------------------

def _sparse_table(alpha, max_groups):
    """z_pass's table: group maxima over B texels, then levels of
    power-of-two spans of groups."""
    R = alpha.shape[0]
    B = 1
    while -(-R // B) > max_groups:
        B *= 2
    G = -(-R // B)
    sp = [np.array([np.fmax.reduce(alpha[g * B:(g + 1) * B])
                    for g in range(G)], F)]
    for k in range(1, G.bit_length()):
        half = 1 << (k - 1)
        prev = sp[-1]
        sp.append(np.fmax(prev[:G - 2 * half + 1],
                          prev[half:G - half + 1]))
    return B, G, sp


def _range_max(alpha, B, sp, lo, hi):
    gl, gh = (lo + B - 1) // B, (hi + 1) // B - 1
    if gl > gh:
        return np.fmax.reduce(alpha[lo:hi + 1])
    m = F(-np.inf)
    for i in list(range(lo, gl * B)) + list(range((gh + 1) * B, hi + 1)):
        m = np.fmax(m, alpha[i])
    k = int(gh - gl + 1).bit_length() - 1
    return np.fmax(m, np.fmax(sp[k][gl], sp[k][gh - (1 << k) + 1]))


def _classify(lo, hi, alpha, alpha_skip, max_groups):
    """occupied() per cell."""
    R = alpha.shape[0]
    B, _, sp = _sparse_table(alpha, max_groups)
    top = F(R - 1)
    li = np.clip(np.floor(lo * top), 0, top).astype(np.int64).reshape(-1)
    hi_i = np.clip(np.ceil(hi * top), 0, top).astype(np.int64).reshape(-1)
    out = np.zeros(li.shape, bool)
    for n, (a, b) in enumerate(zip(li, hi_i)):
        v = F(0)
        if a <= b:
            m = _range_max(alpha, B, sp, a, b)
            v = m if (a == 0 and b == R - 1) else np.fmax(m, F(0))
        out[n] = v > F(alpha_skip)
    return out.reshape(lo.shape)


def _z_pass(occ, maxd):
    """Ballot masks per z-row and the nearest occupied bit on each side."""
    nx, ny, nz = occ.shape
    nw = -(-nz // 32)
    out = np.zeros(occ.shape, np.int64)
    for x in range(nx):
        for y in range(ny):
            row = occ[x, y]
            masks = [sum(1 << b for b in range(32)
                         if w * 32 + b < nz and row[w * 32 + b])
                     for w in range(nw)]
            for z in range(nz):
                j, lane = divmod(z, 32)
                best = maxd
                m, w = masks[j] & ((1 << (lane + 1)) - 1), j
                while True:
                    if m:
                        best = min(best, z - (w * 32 + m.bit_length() - 1))
                        break
                    w -= 1
                    if w < 0 or z - (w * 32 + 31) >= best:
                        break
                    m = masks[w]
                m, w = masks[j] & ~((1 << lane) - 1) & 0xFFFFFFFF, j
                while True:
                    if m:
                        best = min(best, w * 32 + (m & -m).bit_length() - 1
                                   - z)
                        break
                    w += 1
                    if w >= nw or w * 32 - z >= best:
                        break
                    m = masks[w]
                out[x, y, z] = best
    return out


def _line_pass(f, axis, maxd):
    """line_pass along one axis: per line a forward scan L and a backward
    scan R, each keeping the last position of every value, and their
    minimum; the largest value, as the blocks reduce it."""
    g = np.moveaxis(f, axis, -1)
    n = g.shape[-1]
    out = np.empty_like(g)
    for idx in np.ndindex(g.shape[:-1]):
        line = np.minimum(g[idx], maxd)
        last = [-(1 << 30)] * (maxd + 1)
        a = maxd
        fwd = []
        for c in range(n):
            ap = a if last[a] >= c - a else a + 1
            a = min(line[c], ap, maxd)
            last[line[c]] = c
            fwd.append(a)
        last = [1 << 30] * (maxd + 1)
        b = maxd
        for c in range(n - 1, -1, -1):
            bp = b if last[b] <= c + b else b + 1
            b = min(line[c], bp, maxd)
            last[line[c]] = c
            out[idx + (c,)] = min(fwd[c], b)
    return np.moveaxis(out, -1, axis), int(out.max(initial=0))


def _chebyshev_brute(occ, max_dist):
    cells = np.stack(np.meshgrid(*(np.arange(n) for n in occ.shape),
                                 indexing="ij"), -1).reshape(-1, 3)
    on = cells[occ.reshape(-1)]
    if not len(on):
        return np.full(occ.shape, max_dist, np.int64)
    d = np.abs(cells[:, None, :] - on[None, :, :]).max(-1).min(1)
    return np.minimum(d, max_dist).reshape(occ.shape)


@pytest.mark.parametrize("max_dist", [1, 2, 48])
@pytest.mark.parametrize("share", [0.0, 0.01, 0.1, 1.0])
def test_k7_mirror_is_chebyshev(share, max_dist):
    """Grids from air only to all occupied, with sides that differ and rows
    longer than a mask word."""
    for shape in ((9, 13, 40), (21, 6, 7)):
        rng = np.random.default_rng(int(share * 100) + max_dist + shape[0])
        occ = rng.random(shape) < share
        want = _chebyshev_brute(occ, max_dist)
        # A two-texel TF, opaque at texel 1: hi = 1 marks a cell occupied.
        hi = occ.astype(F)
        lo = np.zeros_like(hi)
        alpha = np.array([0.0, 1.0], F)
        np.testing.assert_array_equal(_classify(lo, hi, alpha, 0.5, 512),
                                      occ)
        f = _z_pass(occ, max_dist)
        g, _ = _line_pass(f, 1, max_dist)
        g, far = _line_pass(g, 0, max_dist)
        np.testing.assert_array_equal(g, want)
        assert far == want.max()
        ref, ref_far = P.cell_distance_reference(
            torch.from_numpy(lo), torch.from_numpy(hi),
            torch.tensor([[0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0]]), 0.5,
            max_dist)
        np.testing.assert_array_equal(ref.numpy(), want)
        assert ref_far.tolist() == [want.max()]


@pytest.mark.parametrize("max_dist", [1, 2, 5, 48])
def test_k7_line_scan_is_exact(max_dist):
    """The y and x passes' scans on arbitrary inputs in [0, max_dist] (not
    only the distance fields of earlier passes): min over j of max(|c - j|,
    in(j)), saturated, by brute force."""
    rng = np.random.default_rng(max_dist)
    for n in (1, 2, 7, 64, 130):
        f = rng.integers(0, max_dist + 1, (40, n))
        f[:5] = max_dist
        f[5:10] = rng.choice([0, max_dist], (5, n))
        c = np.arange(n)
        want = np.minimum(np.maximum(np.abs(c[:, None] - c[None, :])[None],
                                     f[:, None, :]).min(-1), max_dist)
        got, far = _line_pass(f, 1, max_dist)
        np.testing.assert_array_equal(got, want)
        assert far == want.max()


@pytest.mark.parametrize("R,max_groups", [(16, 512), (128, 512), (128, 8),
                                          (4096, 512)])
def test_k7_mirror_classification(R, max_groups):
    """The sparse table's range maxima and the classification against the
    plain version's R x R table, with negative alphas (the 0 that JAX's
    mask adds), zero-alpha bands, empty and out-of-range intensity ranges
    and the whole range (0, R - 1)."""
    rng = np.random.default_rng(R + max_groups)
    tf = rng.random((R, 4), F)
    tf[rng.random(R) < 0.3, 3] = 0.0
    tf[rng.random(R) < 0.05, 3] = -0.25
    tf[0, 3] = -0.5
    tf[R // 2:R // 2 + R // 8, 3] = 0.0
    alpha = tf[:, 3].copy()
    table = P.tf_alpha_range_max(torch.from_numpy(tf)).numpy()
    B, _, sp = _sparse_table(alpha, max_groups)
    pairs = [(0, R - 1), (0, 0), (R - 1, R - 1)] + [
        tuple(sorted(rng.integers(0, R, 2))) for _ in range(400)]
    for a, b in pairs:
        m = _range_max(alpha, B, sp, a, b)
        v = m if (a == 0 and b == R - 1) else np.fmax(m, F(0))
        assert v == table[a, b], (a, b)
    lo = rng.uniform(-0.2, 1.2, (6, 7, 9)).astype(F)
    hi = np.clip(lo + rng.uniform(-0.1, 0.3, lo.shape).astype(F), -0.2, 1.2)
    lo[0, 0, 0], hi[0, 0, 0] = 0.0, 1.0
    for skip in (0.0, 0.3, 0.9):
        want = _occupied(torch.from_numpy(lo), torch.from_numpy(hi),
                         torch.from_numpy(table), skip).numpy()
        got = _classify(lo, hi, alpha, skip, max_groups)
        np.testing.assert_array_equal(got, want)
        assert 0 < want.sum() < want.size or skip == 0.9
