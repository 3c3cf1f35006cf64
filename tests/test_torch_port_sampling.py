"""Sampling, TF lookup, shading and TF presets of the torch port against the
JAX package (CPU, f32)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from differender_tpu import RenderConfig as JConfig
from differender_tpu import sampling as js
from differender_tpu import shading as jsh
from differender_tpu.transfer import get_tf as j_get_tf
from differender_tpu.transfer import get_tf_torch_layout as j_get_tf_torch
import differender_tpu_torch as P
from differender_tpu_torch import sampling as ps
from differender_tpu_torch import shading as psh

SHAPE = (20, 24, 28)
ATOL = 1e-6


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    vol = rng.random(SHAPE, np.float32)
    # Inside the box, on and beyond its faces.
    pos = np.concatenate([rng.uniform(-1, 1, (200, 3)),
                          rng.uniform(-1.4, 1.4, (100, 3)),
                          np.array([[-1, -1, -1], [1, 1, 1], [1, -1, 0.3]])]
                         ).astype(np.float32)
    return vol, pos


def test_voxel_coords(data):
    _, pos = data
    want = np.asarray(js.voxel_coords(jnp.asarray(pos), SHAPE))
    got = ps.voxel_coords(torch.from_numpy(pos), SHAPE)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_corner_indices_weights(data):
    _, pos = data
    jx, jy, jz, jw = (np.asarray(a) for a in
                      js.corner_indices_weights(jnp.asarray(pos), SHAPE))
    px, py, pz, pw = ps.corner_indices_weights(torch.from_numpy(pos), SHAPE)
    for a, b in ((px, jx), (py, jy), (pz, jz)):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_allclose(pw.numpy(), jw, atol=ATOL)
    flat, _ = ps.corner_flat_weights(torch.from_numpy(pos), SHAPE)
    assert flat.dtype == torch.int64 and int(flat.max()) < np.prod(SHAPE)


def test_trilinear(data):
    vol, pos = data
    want = np.asarray(js.trilinear(jnp.asarray(vol), jnp.asarray(pos)))
    got = ps.trilinear(torch.from_numpy(vol), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("delta", [1e-3, 0.05])
def test_sample_with_gradient(data, delta):
    vol, pos = data
    ji, jg = js.sample_with_gradient(jnp.asarray(vol), jnp.asarray(pos), delta)
    pi, pg = ps.sample_with_gradient(torch.from_numpy(vol),
                                     torch.from_numpy(pos), delta)
    np.testing.assert_allclose(pi.numpy(), np.asarray(ji), atol=ATOL)
    np.testing.assert_allclose(pg.numpy(), np.asarray(jg), atol=ATOL)


@pytest.mark.parametrize("R", [16, 128])
def test_apply_tf(R):
    rng = np.random.default_rng(R)
    tf = rng.random((R, 4), np.float32)
    x = np.concatenate([rng.random(500, np.float32),
                        np.array([-0.2, 0.0, 0.999999, 1.0, 1.3], np.float32)])
    want = np.asarray(js.apply_tf(jnp.asarray(tf), jnp.asarray(x)))
    got = ps.apply_tf(torch.from_numpy(tf), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    # The march's MXU-dot form clips t instead of clamping low; same values.
    want_dot = np.asarray(js.apply_tf_dot(jnp.asarray(tf), jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want_dot, atol=ATOL)


def test_opacity_correction():
    a = np.linspace(-0.1, 1.1, 61).astype(np.float32)
    for sr in (0.5, 1.0, 4.0):
        want = np.asarray(jsh.opacity_correction(jnp.asarray(a), sr))
        got = psh.opacity_correction(torch.from_numpy(a), sr)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("clamp_light", [True, False])
def test_shade(clamp_light):
    rng = np.random.default_rng(5)
    n = 300
    pos = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    grad = rng.normal(size=(n, 3)).astype(np.float32) * 0.3
    grad[:20] = 0.0                                  # ambient only
    rgba = rng.random((n, 4), np.float32)
    vd = rng.normal(size=(n, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    lf = np.array([1.2, 0.8, 2.0], np.float32)
    kw = dict(volume_shape=SHAPE, image_shape=(4, 4), ambient=0.3,
              diffuse=0.9, specular=0.5, shininess=20.0,
              light_color=(1.0, 0.9, 0.8))
    want = np.asarray(jsh.shade(jnp.asarray(pos), jnp.asarray(grad),
                                jnp.asarray(rgba), jnp.asarray(vd),
                                jnp.asarray(lf), 1.7, JConfig(**kw),
                                clamp_light=clamp_light))
    got = psh.shade(torch.from_numpy(pos), torch.from_numpy(grad),
                    torch.from_numpy(rgba), torch.from_numpy(vd),
                    torch.from_numpy(lf), 1.7, P.RenderConfig(**kw),
                    clamp_light=clamp_light)
    # rtol: pow(r.v, shininess) multiplies a one-ulp difference of its base
    # (XLA's and PyTorch's f32 pow and rsqrt differ by an ulp) by the
    # exponent.
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=1e-5)
    assert np.isfinite(got.numpy()).all()


@pytest.mark.parametrize("tf_id", ["tf1", "tf2", "tf3", "tf4", "tf5",
                                   "black", "gray"])
@pytest.mark.parametrize("res", [1, 32, 128])
def test_tf_presets(tf_id, res):
    got = P.get_tf(tf_id, res, device="cpu")
    assert got.shape == (res, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(j_get_tf(tf_id, res)),
                               atol=ATOL)
    np.testing.assert_allclose(
        P.get_tf_torch_layout(tf_id, res, device="cpu").numpy(),
        np.asarray(j_get_tf_torch(tf_id, res)), atol=ATOL)


def test_rand_tf_needs_a_generator():
    with pytest.raises(ValueError):
        P.get_tf("rand", 8, device="cpu")
    g = torch.Generator().manual_seed(0)
    t = P.get_tf("rand", 8, generator=g, device="cpu")
    assert t.shape == (8, 4) and float(t.min()) >= 0 and float(t.max()) < 1


def test_scenes_match():
    from differender_tpu.utils import scenes as jscenes
    np.testing.assert_array_equal(P.ct_phantom(24), jscenes.ct_phantom(24))
    np.testing.assert_array_equal(P.noise_volume(16, seed=3),
                                  jscenes.noise_volume(16, seed=3))


# -- Gradients: the clamped unit-normal VJP and the march's two TF rules ------

def test_unit_normal_vjp():
    rng = np.random.default_rng(8)
    g = rng.normal(size=(200, 3)).astype(np.float32)
    g[:10] = 0.0                                     # |g| = 0: clamped
    g[10:20] *= 1e-8                                 # below the clamp
    v = rng.normal(size=(200, 3)).astype(np.float32)
    n_j, pull = jax.vjp(jsh.unit_normal, jnp.asarray(g))
    (want,) = pull(jnp.asarray(v))
    gt = torch.from_numpy(g).requires_grad_()
    n_p = psh.unit_normal(gt)
    (got,) = torch.autograd.grad(n_p, gt, torch.from_numpy(v))
    np.testing.assert_allclose(n_p.detach().numpy(), np.asarray(n_j),
                               atol=ATOL)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _tf_edge_intensities(R, rng):
    """Random intensities plus t = 0, t < 0, t > R-1, t = R-1 and interior
    t that land exactly on integers in f32 (the subgradient cases)."""
    k = np.arange(1, R - 1, max(1, (R - 2) // 24), dtype=np.float32)
    x = k / np.float32(R - 1)
    on_int = x[(x * np.float32(R - 1)) == np.round(x * np.float32(R - 1))]
    assert on_int.size > 0
    return np.concatenate([
        rng.random(400, np.float32), on_int,
        np.array([0.0, 0.0, -0.3, 1.0, 1.3, 0.999999], np.float32)])


@pytest.mark.parametrize("R", [17, 128, 2048])
def test_march_tf_vjp_matches_jax(R):
    """R <= 1024: the MXU-dot VJP (slope only where frac > 0); R > 1024:
    AD of the gather-lerp (slope at every t, half at i = 0).  These are the
    TF operands of the JAX march (render.py:213-217)."""
    rng = np.random.default_rng(R)
    tf = rng.random((R, 4), np.float32)
    x = _tf_edge_intensities(R, rng)
    g = rng.random((x.size, 4), np.float32) - 0.5
    if R <= P.sampling.TF_DOT_MAX_TEXELS:
        fn = js.apply_tf_dot
    else:
        def fn(t, i):
            return jnp.stack(js.apply_tf_soa(js.tf_table8(t), i), axis=-1)
    out_j, pull = jax.vjp(fn, jnp.asarray(tf), jnp.asarray(x))
    want_tf, want_x = pull(jnp.asarray(g))
    tt = torch.from_numpy(tf).requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    out = ps.march_tf(tt, xt)
    got_tf, got_x = torch.autograd.grad(out, (tt, xt), torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               atol=ATOL)
    np.testing.assert_allclose(got_tf.numpy(), np.asarray(want_tf),
                               atol=1e-5)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x),
                               rtol=1e-5, atol=1e-4)
    # The subgradient cases are where the two rules differ.
    t = x * np.float32(R - 1)
    at_int = (t == np.round(t)) & (t > 0) & (t < R - 1)
    if R <= P.sampling.TF_DOT_MAX_TEXELS:
        assert (got_x.numpy()[at_int] == 0).all()
    else:
        assert (got_x.numpy()[at_int] != 0).any()


@pytest.mark.parametrize("clamp_light", [True, False])
def test_shade_vjp_matches_jax(clamp_light):
    """shade's gradients in the TF colour and the volume gradient: ties of
    max/min split as in JAX, including a TF alpha of exactly 1."""
    rng = np.random.default_rng(6)
    n = 300
    pos = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    grad = rng.normal(size=(n, 3)).astype(np.float32) * 0.3
    grad[:20] = 0.0
    rgba = rng.random((n, 4), np.float32)
    rgba[20:40, 3] = 1.0
    vd = rng.normal(size=(n, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    lf = np.array([1.2, 0.8, 2.0], np.float32)
    cot = rng.random((n, 4), np.float32) - 0.5
    kw = dict(volume_shape=SHAPE, image_shape=(4, 4))

    def j_fn(g_, c_):
        return jsh.shade(jnp.asarray(pos), g_, c_, jnp.asarray(vd),
                         jnp.asarray(lf), 1.0, JConfig(**kw),
                         clamp_light=clamp_light)

    _, pull = jax.vjp(j_fn, jnp.asarray(grad), jnp.asarray(rgba))
    want_g, want_c = pull(jnp.asarray(cot))
    gt = torch.from_numpy(grad).requires_grad_()
    ct = torch.from_numpy(rgba).requires_grad_()
    out = psh.shade(torch.from_numpy(pos), gt, ct, torch.from_numpy(vd),
                    torch.from_numpy(lf), 1.0, P.RenderConfig(**kw),
                    clamp_light=clamp_light)
    got_g, got_c = torch.autograd.grad(out, (gt, ct), torch.from_numpy(cot))
    assert np.isfinite(got_g.numpy()).all()
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                               rtol=1e-4, atol=1e-4)
