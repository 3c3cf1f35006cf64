"""The march kernels' 7-point stencil as a footprint of distinct voxels
(``sampling.stencil_footprint``) against the JAX package's
``sample_with_gradient`` and its VJP (CPU, f32), a numpy mirror of the
kernels' compact branch (``csrc/march_common.cuh``: ``stencil_axis``,
``sample_centre``, ``sample_gradient``; ``csrc/march_bwd.cu``:
``scatter_sample``), and the premise of K1's zero-opacity skip."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from differender_tpu import sampling as js
import differender_tpu_torch as P
from differender_tpu_torch import sampling as ps
from differender_tpu_torch import shading as psh

F = np.float32


def _delta(res, spec):
    """A stencil half-width in world units: a number as it is, or
    ``"<k>vox"``, k voxels at ``res`` (a voxel is 2 / scale in world units)."""
    if isinstance(spec, str):
        scale = float(ps.voxel_scale((res,) * 3)[0])
        return float(F(float(spec[:-3]) * 2.0 / scale))
    return spec


def _positions(res, seed):
    """Random positions inside the box, beyond all six faces (clamped), and
    on the faces and edges themselves."""
    rng = np.random.default_rng(seed)
    faces = []
    for ax in range(3):
        for side in (-1.0, 1.0):
            p = rng.uniform(-1, 1, (20, 3))
            p[:10, ax] = side
            p[10:, ax] = side * rng.uniform(1.0, 1.3, 10)
            faces.append(p)
    return np.concatenate([rng.uniform(-1, 1, (600, 3)),
                           rng.uniform(-1.3, 1.3, (200, 3)),
                           *faces, np.array([[-1, -1, -1], [1, 1, 1]])]
                          ).astype(F)


CASES = [(res, d) for res in (32, 256) for d in (1e-3, "0.51vox", "1.5vox")]
IDS = [f"{res}-{d}" for res, d in CASES]


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request):
    res, spec = request.param
    seed = res + len(str(spec))
    vol = np.random.default_rng(seed).random((res,) * 3, F)
    pos = _positions(res, seed)
    delta = _delta(res, spec)
    fp = ps.stencil_footprint(torch.from_numpy(pos), vol.shape, delta)
    return vol, pos, delta, fp


def _fp_vjp(fp, cot, n_vox):
    """d_volume from the footprint: one add per distinct voxel."""
    d = torch.zeros(n_vox, dtype=torch.float32)
    d.index_add_(0, fp.index, (fp.weight * cot[fp.sample]).sum(-1))
    return d


def test_footprint_vjp_matches_jax(case):
    """The merged weights sum the 56 terms of each sample's VJP, as JAX's
    VJP of sample_with_gradient does in another order."""
    vol, pos, delta, fp = case
    rng = np.random.default_rng(1)
    cot = rng.normal(size=(pos.shape[0], 4)).astype(F)
    _, pull = jax.vjp(lambda v: js.sample_with_gradient(
        v, jnp.asarray(pos), delta), jnp.asarray(vol))
    (want,) = pull((jnp.asarray(cot[:, 0]), jnp.asarray(cot[:, 1:])))
    want = np.asarray(want).reshape(-1)
    got = _fp_vjp(fp, torch.from_numpy(cot), vol.size).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_footprint_rebuilds_samples_bitwise(case):
    """Each point's 8 corner values taken from the distinct voxels (one load
    each) and summed in the kernels' corner order give sample_with_gradient
    bit for bit."""
    vol, pos, delta, fp = case
    volt, post = torch.from_numpy(vol), torch.from_numpy(pos)
    loads = volt.reshape(-1)[fp.index]
    corners = loads[fp.corner]                                 # (N, 7, 8)
    offs = torch.as_tensor(ps._NORMAL_OFFSETS * F(delta))
    _, w = ps.corner_flat_weights(post[:, None, :] + offs, vol.shape)
    terms = corners * w
    vals = terms[..., 0]
    for c in range(1, 8):
        vals = vals + terms[..., c]
    want_v, want_g = ps.sample_with_gradient(volt, post, delta)
    assert torch.equal(vals[:, 0], want_v)
    assert torch.equal(vals[:, 1] - vals[:, 2], want_g[:, 0])
    assert torch.equal(vals[:, 3] - vals[:, 4], want_g[:, 1])
    assert torch.equal(vals[:, 5] - vals[:, 6], want_g[:, 2])
    # The footprint's entries are distinct per sample.
    key = fp.sample * vol.size + fp.index
    assert torch.unique(key).numel() == key.numel()


def test_footprint_distinct_voxels_at_256():
    """At 256^3 and delta 1e-3 (0.1275 voxel) a sample touches the centre's
    cell plus at most one extra 2x2 layer per axis: 8 to 20 voxels, about
    8 + 12 * 0.255 on average."""
    pos = np.random.default_rng(7).uniform(-1, 1, (20000, 3)).astype(F)
    fp = ps.stencil_footprint(torch.from_numpy(pos), (256,) * 3, 1e-3)
    n = torch.bincount(fp.sample, minlength=pos.shape[0])
    assert int(n.min()) == 8 and int(n.max()) <= 20
    assert 10.5 < float(n.float().mean()) < 11.6


# -- A numpy mirror of the kernels' compact branch -----------------------------

def _voxel_axis(p, scale, size):
    c = np.clip(F(0.5) * p + F(0.5), F(0), F(1)) * scale
    lo_f = np.floor(c)
    lo = lo_f.astype(np.int64)
    return c - lo_f, lo, np.minimum(lo + 1, size - 1)


def _stencil_axis(p, d, scale, size):
    """stencil_axis: (lo, f, fm, fp, m, pl, ok), arrays over samples."""
    f, lo, hi = _voxel_axis(p, scale, size)
    fm, lom, him = _voxel_axis(p - d, scale, size)
    fp, lop, hip = _voxel_axis(p + d, scale, size)
    m, pl = lom != lo, lop != lo
    ok = ((hi == lo + 1) & (him == lom + 1) & (hip == lop + 1)
          & (~m | (lom == lo - 1)) & (~pl | (lop == lo + 1)) & ~(m & pl))
    return dict(lo=lo, f=f, fm=fm, fp=fp, m=m, pl=pl, ok=ok)


def _point_sum(v, gx, fx, gy, fy, gz, fz):
    s = v[0] * ((gx * gy) * gz)
    for c, w in enumerate([(fx * gy) * gz, (gx * fy) * gz, (fx * fy) * gz,
                           (gx * gy) * fz, (fx * gy) * fz, (gx * fy) * fz,
                           (fx * fy) * fz], start=1):
        s = s + v[c] * w
    return s


def _extra(a):
    return np.where(a["m"], a["lo"] - 1, a["lo"] + 2)


def _mirror(vol, pos, delta, cot):
    """The compact branch on every sample where it holds: the value and the
    gradient (sample_centre, sample_gradient) and the merged scatter
    (scatter_sample, scalar atomics).  Returns the mask of compact samples,
    (v, gx, gy, gz) there, d_volume of their cotangents and the atomics of
    each."""
    res = vol.shape[0]
    scale = ps.voxel_scale(vol.shape)[0]
    d = F(delta)
    X, Y, Z = (_stencil_axis(pos[:, i], d, scale, res) for i in range(3))
    ok = X["ok"] & Y["ok"] & Z["ok"]
    X, Y, Z = ({k: v[ok] for k, v in A.items()} for A in (X, Y, Z))
    cot = cot[ok]
    flat = vol.reshape(-1)

    def at(x, y, z):
        return (np.clip(x, 0, res - 1) * res + np.clip(y, 0, res - 1)) * res \
            + np.clip(z, 0, res - 1)

    xs, ys, zs = (A["m"] | A["pl"] for A in (X, Y, Z))
    ex, ey, ez = _extra(X), _extra(Y), _extra(Z)
    cell = [flat[at(X["lo"] + (c & 1), Y["lo"] + (c >> 1 & 1),
                    Z["lo"] + (c >> 2))] for c in range(8)]
    ze = [flat[at(X["lo"] + (o & 1), Y["lo"] + (o >> 1), ez)]
          for o in range(4)]
    xe = [flat[at(ex, Y["lo"] + (o & 1), Z["lo"] + (o >> 1))]
          for o in range(4)]
    ye = [flat[at(X["lo"] + (o & 1), ey, Z["lo"] + (o >> 1))]
          for o in range(4)]
    gx, gy, gz = (F(1) - A["f"] for A in (X, Y, Z))
    v = _point_sum(cell, gx, X["f"], gy, Y["f"], gz, Z["f"])
    grads = []
    for A, step, extra in ((X, 1, xe), (Y, 2, ye), (Z, 4, ze)):
        vp, vm = [None] * 8, [None] * 8
        for n, o in enumerate(c for c in range(8) if not c & step):
            vp[o] = np.where(A["pl"], cell[o + step], cell[o])
            vp[o + step] = np.where(A["pl"], extra[n], cell[o + step])
            vm[o] = np.where(A["m"], extra[n], cell[o])
            vm[o + step] = np.where(A["m"], cell[o], cell[o + step])
        ws = [gx, X["f"], gy, Y["f"], gz, Z["f"]]
        k = {1: 0, 2: 2, 4: 4}[step]
        wp, wm = list(ws), list(ws)
        wp[k:k + 2] = [F(1) - A["fp"], A["fp"]]
        wm[k:k + 2] = [F(1) - A["fm"], A["fm"]]
        grads.append(_point_sum(vp, *wp) - _point_sum(vm, *wm))

    # scatter_sample: arm_weights, then one total per distinct voxel.
    dv, dg = cot[:, 0], cot[:, 1:]
    arms = []
    for i, A in enumerate((X, Y, Z)):
        gp, gm = F(1) - A["fp"], F(1) - A["fm"]
        p0 = np.where(A["pl"], F(0), gp)
        p1 = np.where(A["pl"], gp, A["fp"])
        pe = np.where(A["pl"], A["fp"], F(0))
        m0 = np.where(A["m"], A["fm"], gm)
        m1 = np.where(A["m"], F(0), A["fm"])
        me = np.where(A["m"], gm, F(0))
        arms.append((dg[:, i] * (p0 - m0), dg[:, i] * (p1 - m1),
                     dg[:, i] * (pe - me)))
    wx = (gx, X["f"])
    wy = (gy, Y["f"])
    wz = (gz, Z["f"])
    (ax0, ax1, axe), (ay0, ay1, aye), (az0, az1, aze) = arms
    ax, ay, az = (ax0, ax1), (ay0, ay1), (az0, az1)
    idx, tot = [], []
    for j in range(2):
        for i in range(2):
            xv = dv * wx[i] + ax[i]
            for k in range(2):
                idx.append(at(X["lo"] + i, Y["lo"] + j, Z["lo"] + k))
                tot.append(xv * wy[j] * wz[k]
                           + wx[i] * (ay[j] * wz[k] + az[k] * wy[j]))
            idx.append(at(X["lo"] + i, Y["lo"] + j, ez))
            tot.append(np.where(zs, aze * (wx[i] * wy[j]), F(0)))
    for j in range(2):
        for k in range(2):
            idx.append(at(ex, Y["lo"] + j, Z["lo"] + k))
            tot.append(np.where(xs, axe * (wy[j] * wz[k]), F(0)))
            idx.append(at(X["lo"] + j, ey, Z["lo"] + k))
            tot.append(np.where(ys, aye * (wx[j] * wz[k]), F(0)))
    idx, tot = np.stack(idx, 1), np.stack(tot, 1)
    d_vol = np.zeros(vol.size, F)
    np.add.at(d_vol, idx.reshape(-1), tot.reshape(-1))
    atomics = (tot != 0).sum(1)
    return ok, (v, *grads), d_vol, atomics


def test_compact_branch_mirror(case):
    """The kernels' compact branch, mirrored in numpy f32: its samples equal
    sample_with_gradient bit for bit, its merged scatter is the footprint's
    VJP, and it issues one atomic per distinct voxel of non-zero weight.
    Below half a voxel every sample away from the faces is compact; at 1.5
    voxel only samples whose -delta point is clamped onto the centre's
    cell can be."""
    vol, pos, delta, fp = case
    cot = np.random.default_rng(2).normal(size=(pos.shape[0], 4)).astype(F)
    ok, got, d_vol, atomics = _mirror(vol, pos, delta, cot)
    scale = float(ps.voxel_scale(vol.shape)[0])
    delta_vox = 0.5 * delta * scale
    if delta_vox < 0.5:
        assert ok.all()
    elif delta_vox > 1.0:
        assert ok.mean() < 0.2
    else:
        assert not ok.all()
    assert ok.any()
    want_v, want_g = ps.sample_with_gradient(
        torch.from_numpy(vol), torch.from_numpy(pos[ok]), delta)
    np.testing.assert_array_equal(got[0], want_v.numpy())
    for i in range(3):
        np.testing.assert_array_equal(got[1 + i], want_g[:, i].numpy())
    cot_t = torch.from_numpy(np.where(ok[:, None], cot, F(0)))
    want = _fp_vjp(fp, cot_t, vol.size).numpy()
    np.testing.assert_allclose(d_vol, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    nz = (fp.weight * cot_t[fp.sample]).sum(-1) != 0
    per_sample = torch.bincount(fp.sample[nz], minlength=pos.shape[0])
    np.testing.assert_array_equal(atomics, per_sample.numpy()[ok])


# -- The zero-opacity skip's premise -------------------------------------------

@pytest.mark.parametrize("clamp_light", [True, False])
@pytest.mark.parametrize("tf_id", ["tf1", "tf2", "tf4", "rand0", "rand1"])
def test_zero_alpha_shades_to_zero(tf_id, clamp_light):
    """A TF colour of alpha 0 shades to exact zeros whatever the gradient
    (zero, tiny, huge, random), so K1 may composite it without the gradient
    points and the shading: r += T * 0 and T *= 1 leave the ray unchanged."""
    rng = np.random.default_rng(len(tf_id) + clamp_light)
    R = 128
    if tf_id.startswith("rand"):
        tf = rng.random((R, 4)).astype(F)
        tf[rng.random(R) < 0.4, 3] = 0.0
    else:
        tf = P.get_tf(tf_id, R, device="cpu").numpy()
    x = rng.random(4000).astype(F)
    rgba = ps.apply_tf(torch.from_numpy(tf), torch.from_numpy(x))
    zero = rgba[:, 3] == 0
    assert int(zero.sum()) > 50
    rgba = rgba[zero]
    n = rgba.shape[0]
    grad = rng.normal(size=(n, 3)).astype(F)
    grad[: n // 4] = 0.0
    grad[n // 4: n // 2] *= F(1e-30)
    grad[n // 2: 3 * n // 4] *= F(1e30)
    pos = rng.uniform(-1, 1, (n, 3)).astype(F)
    vd = rng.normal(size=(n, 3)).astype(F)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    cfg = P.RenderConfig(volume_shape=(8, 8, 8), image_shape=(2, 2))
    for sr in (0.5, 1.0, 4.0):
        out = psh.shade(torch.from_numpy(pos), torch.from_numpy(grad), rgba,
                        torch.from_numpy(vd),
                        torch.tensor([1.2, 0.8, 2.0]), sr, cfg,
                        clamp_light=clamp_light)
        assert bool((out == 0).all()), out[(out != 0).any(-1)][:3]
