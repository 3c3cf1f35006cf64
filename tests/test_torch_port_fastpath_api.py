"""The port's shear-warp entry points around ``render_fast`` against the
JAX package's: the fidelity policy (``choose_fast_params``,
``render_fast_auto``), ``Raycaster.raycast_fast``, and the gradient where
the shading's powers have infinite slopes.  Tolerances and their reasons
are those of tests/test_torch_port_fastpath.py: images 1e-4 (every
reference here is a compiled JAX program), SSIM 1e-3, gradients
``2e-3 * max|g|``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import make_sphere_volume
from differender_tpu import RenderConfig as JConfig
from differender_tpu import get_tf as j_get_tf
import differender_tpu.fastpath as JF
from differender_tpu.raycaster import Raycaster as JRaycaster
import differender_tpu_torch as P

HIGHEST = jax.lax.Precision.HIGHEST
FAST_TOL = 1e-4
GRAD_TOL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its plain marches are
    many small torch operations, which slow down many times over when their
    threads contend with other test workers' on a shared machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def sphere():
    return make_sphere_volume(), np.asarray(j_get_tf("tf5", 32))


def _cfgs(vol, hw=(16, 16), **kw):
    kw = dict(volume_shape=vol.shape, image_shape=hw, tf_resolution=32, **kw)
    return JConfig(**kw), P.RenderConfig(**kw)


LADDER = ((None, 2.0), (40, 3.0))


@pytest.mark.parametrize("gate", [-1.0, 1.01])
def test_choose_fast_params_matches_jax(sphere, gate):
    """The policy records: the renderer and rung equal the JAX package's,
    each rung's SSIM within 1e-3; render_fast_auto renders the chosen rung
    (or the exact renderer where none passes)."""
    vol, tf = sphere
    jcfg, cfg = _cfgs(vol, max_samples=64)
    lf = np.array([1.3, 0.7, 2.1], np.float32)
    want = JF.choose_fast_params(vol, tf, lf, jcfg, ssim_gate=gate,
                                 ladder=LADDER, precision=HIGHEST)
    out, got = P.render_fast_auto(_t(vol), _t(tf), _t(lf), cfg,
                                  ssim_gate=gate, ladder=LADDER)
    assert got["renderer"] == want["renderer"]
    assert got["intermediate"] == want["intermediate"]
    assert got["planes_per_voxel"] == want["planes_per_voxel"]
    assert len(got["trace"]) == len(want["trace"])
    for a, b in zip(got["trace"], want["trace"]):
        assert abs(a["ssim"] - b["ssim"]) <= 1e-3
    if got["renderer"] == "shearwarp":
        ref = P.render_fast(_t(vol), _t(tf), _t(lf), cfg,
                            intermediate=got["intermediate"],
                            planes_per_voxel=got["planes_per_voxel"]).image
    else:
        ref = P.render(_t(vol), _t(tf), _t(lf), cfg).image
    assert torch.equal(out.image, ref)


def test_raycast_fast_matches_jax(sphere):
    """``Raycaster.raycast_fast``, unbatched and batched over cameras,
    against the JAX package's (its batch under ``vmap``)."""
    vol, tf = sphere
    vol_user = np.ascontiguousarray(np.transpose(vol, (1, 2, 0)))[None]
    tf_user = np.ascontiguousarray(tf.T)
    kw = dict(volume_shape=vol_user.shape[1:], output_shape=(16, 16),
              tf_shape=32)
    jrc = JRaycaster(**kw)
    prc = P.Raycaster(device="cpu", **kw)
    lf = np.array([1.2, 0.8, 2.0], np.float32)
    lfs = np.array([[1.2, 0.8, 2.0], [-1.0, 0.4, 2.1]], np.float32)
    for cams in (lf, lfs):
        want = np.asarray(jrc.raycast_fast(vol_user, tf_user, cams,
                                           intermediate=32))
        got = prc.raycast_fast(_t(vol_user), _t(tf_user), _t(cams),
                               intermediate=32)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FAST_TOL)
    one = prc.raycast_fast(_t(vol_user), _t(tf_user), _t(lf),
                           intermediate=32)
    assert torch.equal(got[0], one)


def test_render_fast_grads_at_infinite_slopes():
    """At 4 planes per voxel the opacity correction's exponent is below 1,
    and this TF's alpha reaches 1, so ``max(1 - a, 0) ** e`` has an
    infinite slope at 0: the gradient is the JAX package's wherever that is
    finite, and NaN nowhere that it is not."""
    vol = make_sphere_volume((24, 24, 24))
    R = 16
    tf = np.zeros((R, 4), np.float32)
    tf[:, :3] = 0.8
    tf[:, 3] = np.clip(np.linspace(-0.5, 1.5, R), 0.0, 1.0)
    kw = dict(volume_shape=vol.shape, image_shape=(12, 12), tf_resolution=R)
    lf = np.array([1.3, 0.7, 2.1], np.float32)
    w = np.random.default_rng(1).random((12, 12, 4), np.float32) - 0.3
    want = jax.grad(lambda v, t: jnp.sum(JF.render_fast(
        v, t, lf, JConfig(**kw), intermediate=24, planes_per_voxel=4.0,
        precision=HIGHEST).image * w), argnums=(0, 1))(
            jnp.asarray(vol), jnp.asarray(tf))
    v, t = _t(vol).requires_grad_(True), _t(tf).requires_grad_(True)
    img = P.render_fast(v, t, _t(lf), P.RenderConfig(**kw), intermediate=24,
                        planes_per_voxel=4.0).image
    torch.sum(img * _t(w)).backward()
    pairs = [(g.numpy(), np.asarray(r))
             for g, r in zip((v.grad, t.grad), want)]
    assert any(not np.isfinite(want).all() for _, want in pairs)
    for got, want in pairs:
        finite = np.isfinite(want)
        assert np.isfinite(got[finite]).all()
        scale = float(np.abs(want[finite]).max())
        np.testing.assert_allclose(got[finite], want[finite], rtol=0,
                                   atol=GRAD_TOL * scale)
