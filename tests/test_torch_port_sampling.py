"""Sampling, TF lookup, shading and TF presets of the torch port against the
JAX package (CPU, f32)."""
import numpy as np
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
