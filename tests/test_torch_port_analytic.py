"""Analytic normals (``RenderConfig(analytic_normals=True)``) in the torch
port against the JAX package: the plain sampler against JAX's
``sample_with_gradient_analytic``, the images of ``render`` and
``render_nondiff`` and the gradients of ``render`` against JAX's analytic
mode, the occupancy grid's jumps, and a numpy mirror of kernel K2's
analytic scatter (``scatter_cell`` in ``csrc/march_bwd.cu``) against
``analytic_footprint``.

Tolerances: the sampler within 1e-6 of JAX (the same f32 products, summed in
another order); images 2e-4 (ERT off), and with ERT on
the knife-edge bounds of tests/test_render.py; gradients 2e-3 * max|g|, the
bound of tests/test_grads.py for two exact VJPs that sum the same terms in
another order.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from differender_tpu import RenderConfig as JConfig
from differender_tpu import get_tf as j_get_tf
from differender_tpu import render as j_render
from differender_tpu import render_nondiff as j_render_nondiff
from differender_tpu.sampling import \
    sample_with_gradient_analytic as j_sample_analytic
import differender_tpu_torch as P
from differender_tpu_torch.sampling import (analytic_footprint,
                                            sample_with_gradient_analytic,
                                            voxel_scale)

CAMERAS = {
    "oblique": (1.2, 0.8, 2.0),
    "pole+y": (0.0, 2.5, 0.0),
    "pole-y": (0.0, -2.5, 0.0),
    "behind": (-2.0, 0.3, -0.4),
}
CFG = dict(volume_shape=(20, 24, 28), image_shape=(16, 16),
           tf_resolution=32, max_samples=64, analytic_normals=True)
GRAD_TOL = 2e-3


@pytest.fixture(scope="module")
def noise():
    vol = np.random.default_rng(0).random((20, 24, 28), np.float32) * 0.5
    return vol, np.array(j_get_tf("tf1", 32))


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(ert, jitter):
    """One jitted ``value_and_grad`` (with the image as aux) per ERT mode
    and jitter: cameras, weights and the key are arguments."""
    cfg = JConfig(**CFG)

    def loss(v, t, lf, w, key):
        img = j_render(v, t, lf, cfg, sampling_rate=1.0,
                       key=key if jitter else None, ert=ert).image
        return jnp.sum(img * w), img

    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))


def _jax_case(vol, tf, lf, ert, jitter, seed=1):
    """JAX's image and gradients, and the port's inputs for the same case:
    the loss weights and JAX's jitter draw as ``u``."""
    w = np.random.default_rng(seed).random((16, 16, 4), np.float32) - 0.3
    key = jax.random.PRNGKey(7)
    (_, img), grads = _jax_value_and_grad(ert, jitter)(vol, tf, lf, w, key)
    u = (torch.from_numpy(np.array(jax.random.uniform(key, (16, 16),
                                                      jnp.float32)))
         if jitter else None)
    return np.asarray(img), [np.asarray(g) for g in grads], w, u


def _check_image(got, want, ert):
    err = np.abs(got - want)
    if ert:
        assert (err > 2e-4).mean() <= 1e-3 and err.max() < 0.08, err.max()
    else:
        assert err.max() <= 2e-4, err.max()


# -- the plain sampler ---------------------------------------------------------

@pytest.mark.parametrize("delta", [1e-3, 6e-3])
@pytest.mark.parametrize("shape", [(20, 24, 28), (4100, 2, 3)])
def test_sampler_matches_jax(shape, delta):
    """Values, gradients and their VJP in the volume and the positions
    (the mixed second derivatives of the camera path) against JAX's
    ``sample_with_gradient_analytic``, positions inside and outside the
    box; at 4100 voxels f32(size - 1 - 1e-4) is size - 1, so samples at
    x = 1 clamp their high index onto the low one.  At |p| = 1 exactly the
    rules part: JAX's ``jnp.clip`` gives the tie half the slope,
    ``torch.clamp`` (the port's, which the kernels repeat) the whole; the
    position VJP is compared off that knife edge, and on it the port's
    slope is twice JAX's."""
    rng = np.random.default_rng(3)
    vol = rng.random(shape, np.float32)
    pos = rng.uniform(-1.1, 1.1, (400, 3)).astype(np.float32)
    pos[:50, 0] = 1.0
    cot_v = rng.random(400, np.float32) - 0.5
    cot_g = rng.random((400, 3), np.float32) - 0.5

    def j_loss(v, p):
        val, grad = j_sample_analytic(v, p, delta)
        return jnp.sum(val * cot_v) + jnp.sum(grad * cot_g)

    want_v, want_g = j_sample_analytic(jnp.asarray(vol), jnp.asarray(pos),
                                       delta)
    want_dv, want_dp = jax.grad(j_loss, argnums=(0, 1))(vol, pos)
    v = torch.from_numpy(vol).requires_grad_()
    p = torch.from_numpy(pos).requires_grad_()
    got_v, got_g = sample_with_gradient_analytic(v, p, delta)
    (torch.sum(got_v * torch.from_numpy(cot_v))
     + torch.sum(got_g * torch.from_numpy(cot_g))).backward()
    for got, want in ((got_v, want_v), (got_g, want_g), (v.grad, want_dv)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-6 * max(1.0, np.abs(want).max()))
    # Where a high index is clamped, equal corners cancel in the x slope: to
    # rounding in the port's order, exactly in JAX's.
    want_dp = np.asarray(want_dp)
    edge = np.abs(pos) == 1.0
    off = ~edge.any(1)
    atol = 1e-5 * np.abs(want_dp).max()
    np.testing.assert_allclose(p.grad[off].numpy(), want_dp[off], rtol=1e-5,
                               atol=atol)
    np.testing.assert_allclose(p.grad[edge].numpy(), 2.0 * want_dp[edge],
                               rtol=1e-5, atol=atol)


def _mirror_scatter_cell(pos, shape, delta, cot):
    """Numpy mirror of K2's ``scatter_cell``: per sample the 8 corner
    weights dv w_c + sum_axis dg_axis sc_axis (+-1) w'_c, merged where a
    high index is clamped onto its low one (x, then y, then z), and one add
    per non-zero total.  Returns d_volume and the adds per sample."""
    pos = pos.astype(np.float32)
    scale = voxel_scale(shape)
    sc = np.float32(delta) * scale
    u = np.float32(0.5) * pos + np.float32(0.5)
    c = np.clip(u, 0, 1) * scale
    lo = np.floor(c)
    f = (c - lo).astype(np.float32)
    lo = lo.astype(np.int64)
    hi = np.minimum(lo + 1, np.asarray(shape) - 1)
    e = np.float32(1) - f
    n = pos.shape[0]
    w = np.zeros((n, 8), np.float32)
    idx = np.zeros((n, 8), np.int64)
    for k in range(8):
        bits = [(k >> ax) & 1 for ax in range(3)]
        wa = [f[:, ax] if bits[ax] else e[:, ax] for ax in range(3)]
        yz, xz, xy = wa[1] * wa[2], wa[0] * wa[2], wa[0] * wa[1]
        pairs = (yz, xz, xy)
        w[:, k] = cot[:, 0] * (xy * wa[2]) + sum(
            cot[:, 1 + ax] * sc[ax] * (pairs[ax] if bits[ax] else -pairs[ax])
            for ax in range(3))
        ix, iy, iz = (hi[:, ax] if bits[ax] else lo[:, ax] for ax in range(3))
        idx[:, k] = (ix * shape[1] + iy) * shape[2] + iz
    for ax, bit in enumerate((1, 2, 4)):
        same = hi[:, ax] == lo[:, ax]
        for k in range(8):
            if not k & bit:
                w[same, k] += w[same, k + bit]
                w[same, k + bit] = 0.0
    d_vol = np.zeros(int(np.prod(shape)), np.float64)
    nz = w != 0.0
    np.add.at(d_vol, idx[nz], w[nz])
    return d_vol, nz.sum(1)


@pytest.mark.parametrize("shape", [(20, 24, 28), (4100, 2, 3)])
def test_scatter_cell_mirror_matches_footprint(shape):
    """K2's analytic scatter (mirrored in numpy) adds each sample's
    cotangents to its distinct corners once: the same d_volume as
    ``analytic_footprint`` and as autograd of the plain sampler, one add
    per distinct voxel of non-zero weight.  At 4100 voxels on x, samples at
    x = 1 clamp their high index, and their corners merge in pairs."""
    rng = np.random.default_rng(4)
    pos = rng.uniform(-1.0, 1.0, (600, 3)).astype(np.float32)
    pos[:100, 0] = 1.0
    cot = (rng.random((600, 4), np.float32) - 0.5)
    delta = 1e-3
    got, adds = _mirror_scatter_cell(pos, shape, delta, cot)
    fp = analytic_footprint(torch.from_numpy(pos), shape, delta)
    want = torch.zeros(int(np.prod(shape)), dtype=torch.float64).index_add_(
        0, fp.index, (fp.weight.double()
                      * torch.from_numpy(cot).double()[fp.sample]).sum(-1))
    vol = torch.from_numpy(rng.random(shape, np.float32)).requires_grad_()
    v, g = sample_with_gradient_analytic(vol, torch.from_numpy(pos), delta)
    (torch.sum(v * torch.from_numpy(cot[:, 0]))
     + torch.sum(g * torch.from_numpy(cot[:, 1:]))).backward()
    scale = float(np.abs(want.numpy()).max())
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(vol.grad.numpy().reshape(-1), want.numpy(),
                               rtol=0, atol=1e-6 * scale)
    distinct = torch.bincount(fp.sample[(fp.weight * torch.from_numpy(cot)[
        fp.sample]).sum(-1) != 0], minlength=600).numpy()
    np.testing.assert_array_equal(adds, distinct)
    assert adds.max() == 8
    if shape[0] > 4096:
        assert adds[:100].max() == 4


# -- renders and gradients against JAX ----------------------------------------

@pytest.mark.parametrize("ert", [False, True])
@pytest.mark.parametrize("cam", list(CAMERAS))
def test_render_matches_jax(noise, cam, ert):
    vol, tf = noise
    lf = np.array(CAMERAS[cam], np.float32)
    want, _, _, _ = _jax_case(vol, tf, lf, ert, jitter=False)
    got = P.render(torch.from_numpy(vol), torch.from_numpy(tf),
                   torch.from_numpy(lf), P.RenderConfig(**CFG), 1.0,
                   ert=ert).image.numpy()
    _check_image(got, want, ert)
    parity = P.render(torch.from_numpy(vol), torch.from_numpy(tf),
                      torch.from_numpy(lf),
                      P.RenderConfig(**dict(CFG, analytic_normals=False)),
                      1.0, ert=ert).image.numpy()
    assert np.abs(parity - got).max() > 1e-3       # the mode changes normals


@pytest.mark.parametrize("cam", list(CAMERAS))
def test_render_nondiff_matches_jax(noise, cam):
    vol, tf = noise
    lf = np.array(CAMERAS[cam], np.float32)
    want = np.asarray(_jax_nondiff()(vol, tf, lf))
    got = P.render_nondiff(torch.from_numpy(vol), torch.from_numpy(tf),
                           torch.from_numpy(lf), P.RenderConfig(**CFG))
    _check_image(got.image.numpy(), want, ert=True)


@functools.lru_cache(maxsize=None)
def _jax_nondiff():
    cfg = JConfig(**CFG)
    return jax.jit(lambda v, t, lf: j_render_nondiff(v, t, lf, cfg).image)


@pytest.mark.parametrize("ert,jitter", [(False, False), (True, False),
                                        (True, True)])
@pytest.mark.parametrize("cam", ["oblique", "behind"])
def test_grads_match_jax(noise, cam, ert, jitter):
    """d_volume and d_tf of the port's render (autograd of the plain march)
    against ``jax.value_and_grad`` of JAX's render in analytic mode, with
    and without ERT, and with JAX's jitter draw injected as ``u``."""
    vol, tf = noise
    lf = np.array(CAMERAS[cam], np.float32)
    want_img, (want_v, want_t), w, u = _jax_case(vol, tf, lf, ert, jitter)
    wt = torch.from_numpy(w)
    loss, (d_v, d_t) = P.value_and_grad_render(
        torch.from_numpy(vol), torch.from_numpy(tf), torch.from_numpy(lf),
        P.RenderConfig(**CFG), lambda out: torch.sum(out.image * wt),
        sampling_rate=1.0, u=u, ert=ert)
    for got, want in ((d_v, want_v), (d_t, want_t)):
        scale = float(np.abs(want).max())
        assert scale > 0.0 and bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=GRAD_TOL * scale)
    np.testing.assert_allclose(float(loss), float(np.sum(want_img * w)),
                               rtol=1e-4)


# -- the occupancy grid and the entry points -----------------------------------

@pytest.mark.parametrize("cell", [2, 3])
def test_grid_march_bitwise_without_grid(noise, cell):
    """The inference march in analytic mode jumps over empty space with the
    grid and gives the image and composited counts it gives without it,
    bitwise (K3's contract, held by the plain march)."""
    vol, tf = noise
    vol = vol.copy()
    vol[:, :, :16] *= 0.1              # empty space for the grid to skip
    cfg = P.RenderConfig(**dict(CFG, occupancy_cell=cell))
    v, t = torch.from_numpy(vol), torch.from_numpy(tf)
    rays = P.make_rays(torch.tensor(CAMERAS["oblique"]), cfg, 4.0)
    grid = P.build_occupancy(v, t, cfg)
    with_grid = P.march_nondiff_plain(v, t, rays, cfg, 4.0, grid)
    without = P.march_nondiff_plain(v, t, rays, cfg, 4.0)
    assert torch.equal(with_grid[0], without[0])
    assert torch.equal(with_grid[2], without[2])
    assert int(with_grid[1].sum()) < int(without[1].sum())


def test_raycaster_honours_analytic_normals(noise):
    """``Raycaster.forward`` and ``raycast_nondiff`` render in analytic mode
    as ``render`` and ``render_nondiff`` do."""
    vol, tf = noise
    d, h, w = 24, 28, 20               # user (D, H, W) of internal (20, 24, 28)
    rc = P.Raycaster((d, h, w), (16, 16), 32, jitter=False, max_samples=64,
                     device="cpu", analytic_normals=True)
    v_user = P.volume_from_internal(torch.from_numpy(vol))[None]
    tf_user = torch.from_numpy(tf).T
    lf = torch.tensor(CAMERAS["oblique"])
    cfg = P.RenderConfig(**CFG)
    want = P.render(torch.from_numpy(vol), torch.from_numpy(tf), lf, cfg)
    assert torch.equal(rc(v_user, tf_user, lf), want.image.permute(2, 0, 1))
    want_nd = P.render_nondiff(torch.from_numpy(vol), torch.from_numpy(tf),
                               lf, cfg)
    assert torch.equal(rc.raycast_nondiff(v_user, tf_user, lf),
                       want_nd.image.permute(2, 0, 1))
