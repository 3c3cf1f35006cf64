"""Numpy mirrors of the shear-warp slab march's kernels, K8
``shear_warp_fwd`` and K9 ``shear_warp_bwd`` (``csrc/shear_warp.cu``),
against the port's plain march (``ops/shear_warp.py::
shear_warp_march_plain``), autograd of it, and the JAX package's
``fastpath._core`` run one operation at a time.

The mirrors follow the kernels' per-pixel march over all pixels at once:
each plane is the z-lerp of its two voxel layers, and each pixel marches
only the planes of its footprint interval (found by the kernels' binary
search, :func:`_pixel_intervals`) front to back and stops at its first
sample with ``T <= thr``; positions, taps, lerps, shading sums and the
composite are rounded once per operation in the plain version's order, as
the kernels compute them unfused.  K9's mirror sums each plane's slab
cotangents first and adds them to the plane's two layers with weights
``1 - fz`` and ``fz`` (K9 adds each tap's to the two layers).  Tolerances: K8's
image within 1e-6 of the plain march (the power functions of numpy and
torch may differ in the last ulp) and within 1e-5 of the JAX package op by
op (as ``test_torch_port_fastpath.py`` holds the port); K9's ``d_layers``
and ``d_tf`` within 1e-5 * max|g| of autograd of the plain march, which
sums the same terms in another order.  The skip of the samples outside the
footprint is held bitwise: the mirrors without it give the same image and
gradients.  The card's run of the kernels themselves is
``chip_smoke.py``'s phase ``fastpath``.
"""
import ctypes
import os
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import make_sphere_volume
from differender_tpu import RenderConfig as JConfig
from differender_tpu import get_tf as j_get_tf
import differender_tpu.fastpath as JF
import differender_tpu_torch as P
from differender_tpu_torch import fastpath as F
from differender_tpu_torch.ops import shear_warp as SW

f32 = np.float32
HIGHEST = jax.lax.Precision.HIGHEST
PLAIN_TOL = 1e-6
JAX_TOL = 1e-5
GRAD_TOL = 1e-5
RESTART_BELOW = f32(1.0 / 128.0)
VIEWS = {                       # principal axis and side of the camera
    "+z": (1.3, 0.7, 2.1), "-z": (-1.2, 0.6, -2.0),
    "+x": (2.3, 0.5, -0.8), "-x": (-2.3, 0.5, 0.8),
    "+y": (0.4, 2.4, 0.7), "-y": (0.4, -2.4, 0.7),
}
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "differender_tpu_torch", "csrc", "shear_warp.cu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs, as the other fast-path
    modules: the plain march is many small torch operations."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(vol, **kw):
    return P.RenderConfig(volume_shape=vol.shape, image_shape=(16, 16),
                          tf_resolution=32, **kw)


def _inputs(vol, lf, cfg, O, ppv, row_offset=0, n_rows=None):
    """The port's slab frame, voxel layers and geometry for one view."""
    ch, lf_f, light_f, _, _ = F._frame(torch.from_numpy(vol),
                                       torch.from_numpy(np.asarray(lf, f32)))
    layers, geom, _ = F._slab_inputs(ch, lf_f, light_f, cfg, O, ppv,
                                     row_offset, n_rows)
    return (ch, lf_f, light_f), layers, geom


def _todays_stack(layers, geom):
    """The slab stack ``(S, X, Y, 4)`` as ``fastpath._slab_inputs`` built
    it before the z-lerp moved into the march, with the geometry that
    marches it as it stands: plane s is stack layer s (``zlo = zhi = s``,
    ``fz = 0``, so the march's z-lerp is ``x * 1 + x * 0 = x``)."""
    fz_t = geom.fz[:, None, None, None]
    stack = (torch.index_select(layers, 0, geom.zlo.long()) * (1.0 - fz_t)
             + torch.index_select(layers, 0, geom.zhi.long()) * fz_t)
    s = torch.arange(geom.zws.numel(), dtype=torch.int32)
    return stack, geom._replace(zlo=s, zhi=s, fz=torch.zeros_like(geom.fz))


def _run(S, q):
    """monotone_run: the run of s in [0, S) where the monotone q holds."""
    q0 = q(0)
    if q0 == q(S - 1):
        return (0, S - 1) if q0 else (S, -1)
    lo, hi = 0, S - 1
    while hi - lo > 1:
        mid = (lo + hi) >> 1
        if q(mid) == q0:
            lo = mid
        else:
            hi = mid
    return (0, lo) if q0 else (hi, S - 1)


def _interval(zws, l, lz, g, sc, size):
    """footprint_interval: the planes where the crossing of the ray through
    grid coordinate g lies inside [0, size - 1], by binary search over the
    kernels' rounded formula."""
    d = f32(g) - l

    def src(s):
        sz = (zws[s] - lz) / (f32(0.0) - lz)
        return (l + sz * d + f32(1.0)) * sc

    lo = _run(zws.size, lambda s: src(s) >= f32(0.0))
    hi = _run(zws.size, lambda s: src(s) <= f32(size - 1))
    return max(lo[0], hi[0]), min(lo[1], hi[1])


def _axis_intervals(geom, X, Y):
    """The intervals of each row and of each column, ``(rows, 2)`` and
    ``(O, 2)``."""
    zws = geom.zws.numpy()
    lx, ly, lz = geom.lf.numpy()
    ix = np.array([_interval(zws, lx, lz, g, f32(geom.xsc), X)
                   for g in geom.ga.numpy()], np.int64).reshape(-1, 2)
    iy = np.array([_interval(zws, ly, lz, g, f32(geom.ysc), Y)
                   for g in geom.gb.numpy()], np.int64).reshape(-1, 2)
    return ix, iy


def _pixel_intervals(geom, X, Y):
    """Each pixel's interval, its row's and its column's intersected:
    ``(first, last)``, each ``(rows * O,)``."""
    ix, iy = _axis_intervals(geom, X, Y)
    first = np.maximum(ix[:, None, 0], iy[None, :, 0]).ravel()
    last = np.minimum(ix[:, None, 1], iy[None, :, 1]).ravel()
    return first, last


def _inv_sqrt(x):
    return f32(1.0) / np.sqrt(x)


def _dot3(a, b):
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def _slope0(x):
    """d max(x, 0)/dx, half at the tie."""
    return np.where(x > 0, f32(1.0), np.where(x == 0, f32(0.5), f32(0.0)))


def _slope1(x):
    """d min(x, 1)/dx, half at the tie."""
    return np.where(x < 1, f32(1.0), np.where(x == 1, f32(0.5), f32(0.0)))


def _pow_vjp(g, x, e):
    """x^e's VJP, 0 wherever the cotangent is 0 (the kernels' pow_vjp)."""
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        jac = np.where(e == 0, f32(0.0), e * np.power(x, e - f32(1.0)))
        return np.where(g == 0, f32(0.0), g * jac).astype(f32)


def _taps(src, size):
    """lerp_taps: lo, hi and the two weights, 0 outside [0, size - 1]."""
    lo_f = np.floor(src)
    frac = src - lo_f
    inside = (src >= 0) & (src <= f32(size - 1))
    lo = np.clip(lo_f, f32(0.0), f32(size - 1)).astype(np.int64)
    hi = np.minimum(lo + 1, size - 1)
    return (lo, hi, np.where(inside, f32(1.0) - frac, f32(0.0)),
            np.where(inside, frac, f32(0.0)))


class _Mirror:
    """K8's and K9's device functions over the pixels of the intermediate
    image at once (``slab_texel``'s z-lerp, ``sample_at``,
    ``shade_terms``, ``sample_bwd``, ``tf_lerp_bwd`` with the dot mask,
    ``scatter_taps`` and ``add_to_layers``, here into a plane's sums that
    then go to its two layers).  With ``skip`` each pixel marches only its
    footprint interval, as the kernels do; without it every plane, as the
    plain march does."""

    def __init__(self, layers, tf, geom, skip=True):
        self.L = layers.detach().numpy()
        self.tf = tf.detach().numpy()
        _, self.X, self.Y, _ = self.L.shape
        self.zlo, self.zhi = geom.zlo.numpy(), geom.zhi.numpy()
        self.fz = geom.fz.numpy()
        self.S = self.fz.size
        self.R = self.tf.shape[0]
        ga, gb = geom.ga.numpy(), geom.gb.numpy()
        self.rows, self.O = ga.shape[0], gb.shape[0]
        self.lf = geom.lf.numpy()
        self.light = geom.light.numpy()
        r, o = np.meshgrid(np.arange(self.rows), np.arange(self.O),
                           indexing="ij")
        self.dxr = ga[r.ravel()] - self.lf[0]
        self.dyr = gb[o.ravel()] - self.lf[1]
        self.e = geom.exponent.numpy().ravel()
        self.zws = geom.zws.numpy()
        self.k = {n: f32(getattr(geom, n)) for n in (
            "xsc", "ysc", "thr", "ambient", "diffuse", "specular",
            "shininess")}
        if skip:
            self.first, self.last = _pixel_intervals(geom, self.X, self.Y)
        else:
            self.first = np.zeros(self.rows * self.O, np.int64)
            self.last = np.full(self.rows * self.O, self.S - 1, np.int64)
        self._slabs = {}

    def slab(self, s):
        """Plane s from its two layers: lo * (1 - fz) + hi * fz."""
        if s not in self._slabs:
            fz = self.fz[s]
            self._slabs[s] = (self.L[self.zlo[s]] * (f32(1.0) - fz)
                              + self.L[self.zhi[s]] * fz)
        return self._slabs[s]

    def marching(self, s, alive):
        """The pixels that take a sample on plane s."""
        return np.nonzero(alive & (self.first <= s) & (s <= self.last))[0]

    def _shade_terms(self, px, py, pz, g):
        k, h = self.k, {}
        g2 = _dot3(g, g)
        h["has_n"] = g2 > 0
        m = np.where(h["has_n"], _inv_sqrt(np.where(h["has_n"], g2, 1)),
                     f32(0.0)).astype(f32)
        h["n"] = [g[0] * m, g[1] * m, g[2] * m]
        lv = [px - self.light[0], py - self.light[1], pz - self.light[2]]
        lm = _inv_sqrt(np.maximum(_dot3(lv, lv), f32(1e-30)))
        h["u"] = [c * lm for c in lv]
        h["dot"] = _dot3(h["n"], h["u"])
        diffuse = k["diffuse"] * np.where(h["has_n"],
                                          np.maximum(h["dot"], f32(0.0)),
                                          f32(0.0))
        d2 = f32(2.0) * h["dot"]
        r = [h["u"][i] - d2 * h["n"][i] for i in range(3)]
        vv = [px - self.lf[0], py - self.lf[1], pz - self.lf[2]]
        vm = _inv_sqrt(np.maximum(_dot3(vv, vv), f32(1e-30)))
        h["v"] = [c * vm for c in vv]
        h["q"] = -_dot3(r, h["v"])
        specular = k["specular"] * np.where(
            h["has_n"], np.power(np.maximum(h["q"], f32(0.0)),
                                 k["shininess"]), f32(0.0))
        h["light_raw"] = (diffuse + specular) + k["ambient"]
        return h

    def sample(self, s, idx):
        """Plane s at the pixels ``idx``."""
        k, lx, ly, lz = self.k, *self.lf
        zw = self.zws[s]
        sz = (zw - lz) / (f32(0.0) - lz)
        q = {"px": lx + sz * self.dxr[idx], "py": ly + sz * self.dyr[idx]}
        q["pz"] = np.full(idx.shape, zw, f32)
        q["tx"] = _taps((q["px"] + f32(1.0)) * k["xsc"], self.X)
        q["ty"] = _taps((q["py"] + f32(1.0)) * k["ysc"], self.Y)
        (xl, xh, wxl, wxh), (yl, yh, wyl, wyh) = q["tx"], q["ty"]
        sl = self.slab(s)
        lo = sl[xl, yl] * wxl[:, None] + sl[xh, yl] * wxh[:, None]
        hi = sl[xl, yh] * wxl[:, None] + sl[xh, yh] * wxh[:, None]
        q["v"] = lo * wyl[:, None] + hi * wyh[:, None]
        q["cov"] = (wxl + wxh) * (wyl + wyh)
        t = np.maximum(q["v"][:, 0] * f32(self.R - 1), f32(0.0))
        low_f = np.floor(t)
        frac = (t - low_f)[:, None]
        low = np.minimum(low_f, f32(self.R - 1)).astype(np.int64)
        high = np.minimum(low + 1, self.R - 1)
        q["c"] = self.tf[low] * (f32(1.0) - frac) + self.tf[high] * frac
        h = self._shade_terms(q["px"], q["py"], q["pz"], q["v"][:, 1:].T)
        lightf = np.minimum(h["light_raw"], f32(1.0))
        mm = np.maximum(f32(1.0) - q["c"][:, 3], f32(0.0))
        q["alpha"] = (f32(1.0) - np.power(mm, self.e[idx])) * q["cov"]
        q["rgb"] = (lightf[:, None] * q["c"][:, :3]) * q["alpha"][:, None]
        return q

    def forward(self):
        """K8: ``(inter (rows, O, 4), steps (rows, O), taken (rows, O))``:
        the image, the plane where the gate first fails (or S) and the
        samples each pixel took."""
        n = self.rows * self.O
        acc = np.zeros((n, 3), f32)
        T = np.ones(n, f32)
        open_ = bool(f32(1.0) > self.k["thr"])
        steps = np.full(n, self.S if open_ else 0, np.int64)
        taken = np.zeros(n, np.int64)
        alive = np.full(n, open_)
        for s in range(self.S):
            idx = self.marching(s, alive)
            if not idx.size:
                continue
            q = self.sample(s, idx)
            acc[idx] = acc[idx] + T[idx, None] * q["rgb"]
            T[idx] = T[idx] * (f32(1.0) - q["alpha"])
            taken[idx] += 1
            died = idx[~(T[idx] > self.k["thr"])]
            alive[died] = False
            steps[died] = s + 1
        inter = np.concatenate([acc, (f32(1.0) - T)[:, None]], 1)
        shape = (self.rows, self.O)
        return (inter.reshape(shape + (4,)), steps.reshape(shape),
                taken.reshape(shape))

    def _rest(self, s, ri, Tn, G):
        """rest_of_march for the pixels ``ri`` after their sample s."""
        Ur = np.zeros(ri.shape, f32)
        Tl = np.ones(ri.shape, f32)
        Tr = Tn.copy()
        live = np.ones(ri.shape, bool)
        for s2 in range(s + 1, self.S):
            live &= (Tr > self.k["thr"]) & (s2 <= self.last[ri])
            j = np.nonzero(live)[0]
            if not j.size:
                break
            q = self.sample(s2, ri[j])
            Ur[j] += Tl[j] * (G[j, 0] * q["rgb"][:, 0]
                              + G[j, 1] * q["rgb"][:, 1]
                              + G[j, 2] * q["rgb"][:, 2])
            f = f32(1.0) - q["alpha"]
            Tl[j] *= f
            Tr[j] = Tr[j] * f
            live[j] &= Tl[j] != 0
        return Ur - G[:, 3] * Tl

    def _sample_bwd(self, q, idx, d_rgb, d_alpha):
        k = self.k
        h = self._shade_terms(q["px"], q["py"], q["pz"], q["v"][:, 1:].T)
        lightf = np.minimum(h["light_raw"], f32(1.0))
        c = q["c"]
        d_alpha = d_alpha + (d_rgb * (lightf[:, None] * c[:, :3])).sum(1)
        dl = d_rgb * q["alpha"][:, None]
        d_c = np.empty_like(c)
        d_c[:, :3] = dl * lightf[:, None]
        d_light = (dl * c[:, :3]).sum(1)
        m1 = f32(1.0) - c[:, 3]
        d_mm = _pow_vjp(-(d_alpha * q["cov"]), np.maximum(m1, f32(0.0)),
                        self.e[idx])
        d_c[:, 3] = -(d_mm * _slope0(m1))
        d_raw = d_light * _slope1(h["light_raw"])
        rdv = np.maximum(h["q"], f32(0.0))
        d_q = _pow_vjp(k["specular"] * d_raw, rdv, k["shininess"]) \
            * _slope0(h["q"])
        dr = [-d_q * c_ for c_ in h["v"]]
        n, u = h["n"], h["u"]
        d_dot = (k["diffuse"] * d_raw * _slope0(h["dot"])
                 - f32(2.0) * _dot3(dr, n))
        d2 = f32(2.0) * h["dot"]
        dn = [d_dot * u[i] - d2 * dr[i] for i in range(3)]
        g = q["v"][:, 1:]
        with np.errstate(divide="ignore"):
            inv = f32(1.0) / np.maximum(np.sqrt((g * g).sum(1)), f32(1e-6))
        vn = _dot3(dn, n)
        d_g = np.stack([(dn[i] - vn * n[i]) * inv for i in range(3)], 1)
        d_g[~h["has_n"]] = 0.0
        return d_c, d_g

    def _tf_bwd(self, x, d_c, d_tf):
        """tf_lerp_bwd with the dot mask: d_tf added where its weight is
        not 0, d_intensity where frac > 0."""
        R, tf = self.R, self.tf
        t = np.maximum(x * f32(R - 1), f32(0.0))
        low_f = np.floor(t)
        frac = t - low_f
        low = np.minimum(low_f, f32(R - 1)).astype(np.int64)
        high = np.minimum(low + 1, R - 1)
        w = f32(1.0) - frac
        with np.errstate(invalid="ignore"):
            np.add.at(d_tf, low[w != 0], (w[:, None] * d_c)[w != 0])
            np.add.at(d_tf, high[frac != 0],
                      (frac[:, None] * d_c)[frac != 0])
            sl = (tf[high] - tf[low]) * d_c
            d_t = ((sl[:, 0] + sl[:, 1]) + sl[:, 2]) + sl[:, 3]
            return np.where(frac > 0, d_t * f32(R - 1), f32(0.0))

    def _scatter(self, q, dv, d):
        """scatter_taps into the plane's sums ``d`` (X, Y, 4)."""
        (xl, xh, wxl, wxh), (yl, yh, wyl, wyh) = q["tx"], q["ty"]
        with np.errstate(invalid="ignore"):
            y_lo, y_hi = dv * wyl[:, None], dv * wyh[:, None]
            one_y, one_x = (yh == yl), (xh == xl)
            y_lo = np.where(one_y[:, None], y_lo + y_hi, y_lo)
            t00, t10 = y_lo * wxl[:, None], y_lo * wxh[:, None]
            t01, t11 = y_hi * wxl[:, None], y_hi * wxh[:, None]
            t00 = np.where(one_x[:, None], t00 + t10, t00)
            t01 = np.where(one_x[:, None], t01 + t11, t01)
        np.add.at(d, (xl, yl), t00)
        m = ~one_x
        np.add.at(d, (xh[m], yl[m]), t10[m])
        m = ~one_y
        np.add.at(d, (xl[m], yh[m]), t01[m])
        m = ~one_x & ~one_y
        np.add.at(d, (xh[m], yh[m]), t11[m])

    def backward(self, inter, grad):
        """K9: ``(d_layers, d_tf, restarts)`` for the cotangent ``grad`` of
        K8's image ``inter``."""
        G = grad.reshape(-1, 4).astype(f32)
        img = inter.reshape(-1, 4)
        d_L = np.zeros_like(self.L)
        d_tf = np.zeros_like(self.tf)
        U = (G[:, 0] * img[:, 0] + G[:, 1] * img[:, 1] + G[:, 2] * img[:, 2]
             - G[:, 3] * (f32(1.0) - img[:, 3]))
        n = G.shape[0]
        Tb, Tloc, T = (np.ones(n, f32) for _ in range(3))
        Pf = np.zeros(n, f32)
        alive = (G != 0).any(1) & bool(f32(1.0) > self.k["thr"])
        restarts = 0
        for s in range(self.S):
            idx = self.marching(s, alive)
            if not idx.size:
                continue
            q = self.sample(s, idx)
            f = f32(1.0) - q["alpha"]
            Tn = T[idx] * f
            last = (s + 1 == self.S) | ~(Tn > self.k["thr"])
            restart = ~last & (f < RESTART_BELOW)
            rest = ~last & ~restart
            d_a = np.empty(idx.shape, f32)
            d_a[last] = T[idx[last]] * G[idx[last], 3]
            if restart.any():
                ri = idx[restart]
                Ur = self._rest(s, ri, Tn[restart], G[ri])
                d_a[restart] = -T[ri] * Ur
                Tb[ri], U[ri], Pf[ri], Tloc[ri] = Tn[restart], Ur, 0.0, 1.0
                restarts += ri.size
            pi = idx[rest]
            Pf[pi] += Tloc[pi] * (G[pi, :3] * q["rgb"][rest]).sum(1)
            d_a[rest] = -(Tb[pi] / f[rest]) * (U[pi] - Pf[pi])
            Tloc[pi] *= f[rest]
            d_c, d_g = self._sample_bwd(q, idx, T[idx, None] * G[idx, :3],
                                        d_a)
            d_int = self._tf_bwd(q["v"][:, 0], d_c, d_tf)
            d_plane = np.zeros((self.X, self.Y, 4), f32)
            self._scatter(q, np.concatenate([d_int[:, None], d_g], 1),
                          d_plane)
            with np.errstate(invalid="ignore"):
                d_L[self.zlo[s]] += d_plane * (f32(1.0) - self.fz[s])
                d_L[self.zhi[s]] += d_plane * self.fz[s]
            T[idx] = Tn
            alive[idx] &= (Tn > self.k["thr"]) & (Tn != 0)
        return d_L, d_tf, restarts


def _opaque_tf(R=16, top=1.0):
    """Colours across the range, alpha 0 up to a third of it and ``top``
    from three quarters on."""
    tf = np.zeros((R, 4), f32)
    tf[:, :3] = np.linspace(0.2, 0.9, 3 * R, dtype=f32).reshape(R, 3)
    tf[:, 3] = np.clip(np.linspace(-0.5, 1.5, R), 0.0, top).astype(f32)
    return tf


@pytest.fixture(scope="module")
def sphere():
    return make_sphere_volume((20, 20, 20)), np.array(j_get_tf("tf5", 32))


@pytest.mark.parametrize("view", list(VIEWS))
def test_k8_mirror_matches_plain_and_jax(sphere, view):
    """All three principal axes, both sides: the mirror of K8 within 1e-6
    of the plain march and within 1e-5 of the JAX package's ``_core`` op
    by op, under a TF whose alpha reaches 1, so that the pixels through the
    sphere's core stop before the last plane and the others march their
    footprint to its end."""
    vol = sphere[0]
    tf = _opaque_tf(32)
    cfg = _cfg(vol)
    O, ppv = 24, 2.0
    (ch, lf_f, light_f), layers, geom = _inputs(vol, VIEWS[view], cfg, O,
                                                ppv)
    mirror, steps, taken = _Mirror(layers, torch.from_numpy(tf),
                                   geom).forward()
    plain = SW.shear_warp_march_plain(layers, torch.from_numpy(tf), geom)
    np.testing.assert_allclose(mirror, plain.numpy(), rtol=0,
                               atol=PLAIN_TOL)
    with jax.disable_jit():
        want = JF._core(jnp.asarray(ch.numpy()), jnp.asarray(tf),
                        jnp.asarray(lf_f.numpy()),
                        jnp.asarray(light_f.numpy()),
                        JConfig(volume_shape=vol.shape, image_shape=(16, 16),
                                tf_resolution=32), O, ppv,
                        precision=HIGHEST, slab_batch=8)[0]
    np.testing.assert_allclose(mirror, np.asarray(want), rtol=0,
                               atol=JAX_TOL)
    assert float(mirror[..., 3].max()) > 0.3
    S = geom.zws.numel()
    assert steps.max() == S and steps.min() < steps.max()
    assert 0 < taken.sum() < steps.sum()


def _grad_case(name):
    """(volume, tf, camera, config overrides, planes per voxel)."""
    rng = np.random.default_rng(7)
    if name == "sphere":
        return (make_sphere_volume((20, 20, 20)),
                np.array(j_get_tf("tf5", 32)), VIEWS["+z"], {}, 2.0)
    if name == "noise":
        return (rng.random((18, 20, 16), f32),
                np.array(j_get_tf("tf1", 32)), VIEWS["-x"], {}, 2.0)
    if name == "quantised":
        vol = (np.round(rng.random((16, 16, 16)) * 15) / f32(15)).astype(f32)
        return vol, _opaque_tf(16, 0.6), VIEWS["+y"], {}, 2.0
    if name == "opaque":
        return (make_sphere_volume((20, 20, 20)), _opaque_tf(), VIEWS["-z"],
                {}, 2.0)
    if name == "opaque_4ppv":
        return (make_sphere_volume((12, 12, 12)), _opaque_tf(), VIEWS["+z"],
                {}, 4.0)
    # "restart": no early termination (ert_threshold 1, the gate T > 0) and
    # an alpha plateau at 0.996: samples with f below 1/128 that are not a
    # pixel's last.
    return (make_sphere_volume((20, 20, 20)), _opaque_tf(16, 0.996),
            VIEWS["+x"], {"ert_threshold": 1.0}, 2.0)


def _grad_inputs(name):
    vol, tf, lf, kw, ppv = _grad_case(name)
    cfg = P.RenderConfig(volume_shape=vol.shape, image_shape=(16, 16),
                         tf_resolution=tf.shape[0], **kw)
    _, layers, geom = _inputs(vol, lf, cfg, 24, ppv)
    assert geom.zws.numel() <= 48
    g = (np.random.default_rng(3).random((24, 24, 4), f32) - f32(0.3))
    return layers, torch.from_numpy(tf), geom, g


@pytest.mark.parametrize("name", ["sphere", "noise", "quantised", "opaque",
                                  "opaque_4ppv", "restart"])
def test_k9_mirror_matches_autograd(name):
    """The mirror of K9's cotangent scheme (U from K8's image, restarts
    below f = 1/128, the exact U at the last sample, the dot mask, the
    powers' zero rule, half at ties, merged edge taps, each plane's sums
    added to its two layers) against autograd of the plain march: d_layers
    and d_tf within 1e-5 * max|g|, finite where autograd's are and infinite
    or NaN where they are (the opacity correction's infinite slope at
    exponents below 1, times a z-lerp weight of 0)."""
    layers, tf, geom, g = _grad_inputs(name)
    m = _Mirror(layers, tf, geom)
    inter, _, _ = m.forward()
    d_L, d_tf, restarts = m.backward(inter, g)
    lay = layers.clone().requires_grad_(True)
    t = tf.clone().requires_grad_(True)
    SW.shear_warp_march_plain(lay, t, geom).backward(torch.from_numpy(g))
    for got, want in ((d_L, lay.grad.numpy()), (d_tf, t.grad.numpy())):
        finite = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), finite)
        np.testing.assert_array_equal(got[~finite], want[~finite])
        scale = float(np.abs(want[finite]).max())
        assert scale > 0.0
        np.testing.assert_allclose(got[finite], want[finite], rtol=0,
                                   atol=GRAD_TOL * scale)
    assert (restarts > 0) == (name == "restart")
    if name == "opaque_4ppv":
        assert float(geom.exponent.min()) < 1.0
        assert not np.isfinite(d_tf).all()
    if name == "opaque":
        assert float(inter[..., 3].max()) == 1.0


@pytest.mark.parametrize("name", ["sphere", "opaque", "opaque_4ppv",
                                  "restart"])
def test_skip_is_exact(name):
    """Marching only each pixel's footprint interval changes nothing: the
    mirrors with the skip give bitwise the image, the stop planes and the
    gradients (non-finite entries included) of the mirrors that march
    every plane, from fewer samples."""
    layers, tf, geom, g = _grad_inputs(name)
    runs = []
    for skip in (True, False):
        m = _Mirror(layers, tf, geom, skip=skip)
        inter, steps, taken = m.forward()
        runs.append((inter, steps, taken) + m.backward(inter, g))
    (i1, s1, t1, dl1, dt1, r1), (i0, s0, t0, dl0, dt0, r0) = runs
    assert np.array_equal(i1, i0) and np.array_equal(s1, s0)
    np.testing.assert_array_equal(dl1, dl0)
    np.testing.assert_array_equal(dt1, dt0)
    assert r1 == r0
    assert t1.sum() < t0.sum()


@pytest.mark.parametrize("view", ["+z", "-x", "+y"])
def test_plain_march_from_layers_is_todays_image(sphere, view):
    """The plain march z-lerps each chunk's planes from the layers with the
    expression that built the slab stack: its image is bitwise the march
    over that stack (built here as ``_slab_inputs`` built it), and its
    gradient in the layers is the stack's pulled through the z-lerp."""
    vol, tf = sphere
    tf_t = torch.from_numpy(tf)
    _, layers, geom = _inputs(vol, VIEWS[view], _cfg(vol), 24, 2.0)
    stack, geom_s = _todays_stack(layers, geom)
    want = SW.shear_warp_march_plain(stack, tf_t, geom_s)
    for batch in (32, 5):
        assert torch.equal(SW.shear_warp_march_plain(layers, tf_t, geom,
                                                     slab_batch=batch), want)
    g = torch.from_numpy(np.random.default_rng(5).random((24, 24, 4), f32))
    lay = layers.clone().requires_grad_(True)
    SW.shear_warp_march_plain(lay, tf_t, geom).backward(g)
    lay_s = layers.clone().requires_grad_(True)
    stack_s, _ = _todays_stack(lay_s, geom)
    SW.shear_warp_march_plain(stack_s, tf_t, geom_s).backward(g)
    scale = float(lay_s.grad.abs().max())
    assert scale > 0.0
    torch.testing.assert_close(lay.grad, lay_s.grad, rtol=0,
                               atol=GRAD_TOL * scale)


INTERVAL_CASES = {
    **{v: (VIEWS[v], 24, 0, None) for v in VIEWS},
    "strip": (VIEWS["-y"], 24, 7, 9),
    "near": ((0.3, 0.2, 1.15), 24, 0, None),
    "O_below_X": ((-1.2, 0.6, -2.0), 8, 0, None),
}


@pytest.mark.parametrize("case", list(INTERVAL_CASES))
def test_footprint_interval_matches_coverage(sphere, case):
    """The kernels' binary search over their rounded formula finds, for
    every pixel, exactly the planes where ``_lerp_taps`` gives a non-zero
    coverage (one interval, possibly empty), and ``footprint`` marks the
    same samples: at both sides of all three principal axes, at a strip of
    rows, at a camera near the box and at O below X."""
    vol = sphere[0]
    lf, O, off, n = INTERVAL_CASES[case]
    _, layers, geom = _inputs(vol, lf, _cfg(vol), O, 2.0, off, n)
    X, Y = layers.shape[1:3]
    S = geom.zws.numel()
    _, src_x, src_y = SW._sources(geom, geom.zws)
    tx, ty = SW._lerp_taps(src_x, X), SW._lerp_taps(src_y, Y)
    cov = ((tx[2] + tx[3])[:, :, None] * (ty[2] + ty[3])[:, None, :]) != 0
    cov = cov.reshape(S, -1).numpy()
    first, last = _pixel_intervals(geom, X, Y)
    planes = np.arange(S)[:, None]
    assert np.array_equal((first <= planes) & (planes <= last), cov)
    x_in, y_in = SW.footprint(geom, X, Y)
    assert np.array_equal((x_in[:, :, None] & y_in[:, None, :]).reshape(
        S, -1).numpy(), cov)
    # Not trivial: some pixels miss the box, some enter late or leave early.
    assert (first > last).any() and (first <= last).any()
    assert ((first > 0) | (last < S - 1))[first <= last].any()


def test_strips_of_the_mirror_join_bitwise(sphere):
    """Rows computed in a strip (row_offset, n_rows) are the whole image's
    rows bit for bit, in the mirror of K8 as in the plain march."""
    vol, tf = sphere
    cfg = _cfg(vol)
    lf = VIEWS["-y"]
    tf_t = torch.from_numpy(tf)
    _, layers, geom = _inputs(vol, lf, cfg, 24, 2.0)
    whole = _Mirror(layers, tf_t, geom).forward()
    parts = []
    for k in range(4):
        _, layers_k, geom_k = _inputs(vol, lf, cfg, 24, 2.0, 6 * k, 6)
        parts.append(_Mirror(layers_k, tf_t, geom_k).forward())
        assert torch.equal(
            SW.shear_warp_march_plain(layers_k, tf_t, geom_k),
            SW.shear_warp_march_plain(layers, tf_t, geom)[6 * k:6 * k + 6])
    for i in range(3):
        assert np.array_equal(np.concatenate([p[i] for p in parts]),
                              whole[i])


def test_wrappers_are_plain_on_cpu(sphere):
    """On CPU tensors K8's wrapper is the plain march, K9's autograd of it,
    both classified as shear_warp_march classifies there (tf_lookup's dot
    mask, bit for bit apply_tf_dot's), and neither counts a launch."""
    vol, tf = sphere
    _, layers, geom = _inputs(vol, VIEWS["+z"], _cfg(vol), 16, 1.0)
    tf_t = torch.from_numpy(tf)
    P.reset_launch_counts()
    inter = P.shear_warp_fwd(layers, tf_t, geom)
    assert torch.equal(inter, SW.shear_warp_march_plain(layers, tf_t, geom))
    assert torch.equal(inter, SW.shear_warp_march_plain(
        layers, tf_t, geom, SW._classify_dot))
    g = torch.rand(inter.shape, generator=torch.Generator().manual_seed(0))
    d_L, d_tf = P.shear_warp_bwd(layers, tf_t, geom, inter, g)
    lay = layers.clone().requires_grad_(True)
    t = tf_t.clone().requires_grad_(True)
    out = SW.shear_warp_march(lay, t, geom)
    assert torch.equal(out, inter)
    out.backward(g)
    assert torch.equal(lay.grad, d_L) and torch.equal(t.grad, d_tf)
    assert P.launch_counts()["shear_warp_fwd"] == 0
    assert P.launch_counts()["shear_warp_bwd"] == 0


def test_args_mirror_the_c_struct():
    """The ctypes mirror lists the fields of ``struct ShearWarpArgs`` in
    order: 18 pointers, 6 ints and 7 floats, padded to 8 bytes."""
    with open(CSRC) as f:
        src = f.read()
    body = re.search(r"struct ShearWarpArgs \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    c_fields = re.findall(r"(\w+)\s*[,;]", body)
    assert c_fields == [name for name, _ in SW._ShearWarpArgs._fields_]
    assert ctypes.sizeof(SW._ShearWarpArgs) == 18 * 8 + 6 * 4 + 7 * 4 + 4


@pytest.mark.parametrize("bad", ["layout", "dtype", "contiguity", "zws",
                                 "tf", "zlo"])
def test_wrapper_checks_raise(sphere, bad):
    """The checks that guard the C entries raise on what the kernels do not
    take (they run before any launch, so the CPU reaches them)."""
    vol, tf = sphere
    _, layers, geom = _inputs(vol, VIEWS["+z"], _cfg(vol), 8, 1.0)
    tf_t = torch.from_numpy(tf)
    if bad == "layout":
        layers = layers.permute(0, 3, 1, 2).contiguous()
    elif bad == "dtype":
        layers = layers.double()
    elif bad == "contiguity":
        layers = layers.transpose(1, 2)
    elif bad == "zws":
        geom = geom._replace(zws=geom.zws[:-1])
    elif bad == "zlo":
        geom = geom._replace(zlo=geom.zlo.long())
    else:
        tf_t = tf_t[:, :3]
    with pytest.raises((ValueError, TypeError)):
        SW._args(layers, tf_t, geom)
