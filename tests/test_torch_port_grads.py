"""Gradients of the torch port's render (the plain march, differentiated by
autograd on the CPU) against ``jax.value_and_grad`` of the JAX package's
``render`` with its default ``march_vjp='ad'``, and of the port's
``Raycaster`` against ``torch_interop.TorchRaycaster``.

Tolerance: ``2e-3 * max|g|`` per gradient tensor, the bound of
tests/test_grads.py for two exact VJPs that sum the same f32 terms in
another order (JAX composites blocks in closed form and scatters through
its tables; the port marches ray by ray).  With ERT on, a ray whose
transmittance lands a few ulps either side of the gate composites one
sample more or less; such a sample carries T ~ 0.01 of the ray's weight.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import make_sphere_volume
from differender_tpu import RenderConfig as JConfig
from differender_tpu import get_tf as j_get_tf
from differender_tpu import render as j_render
from differender_tpu.torch_interop import TorchRaycaster
import differender_tpu_torch as P

CAMERAS = {
    "oblique": (1.2, 0.8, 2.0),
    "pole+y": (0.0, 2.5, 0.0),
    "pole-y": (0.0, -2.5, 0.0),
    "behind": (-2.0, 0.3, -0.4),
}
NOISE_CFG = dict(volume_shape=(20, 24, 28), image_shape=(24, 32),
                 tf_resolution=32, max_samples=64)
SPHERE_CFG = dict(image_shape=(16, 16), tf_resolution=32, max_samples=64,
                  block_size=16)
GRAD_TOL = 2e-3


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(cfg_items, sr, ert):
    """One jitted ``value_and_grad`` per config: cameras, weights and the
    jitter key are arguments, so the cases of a config share a compile."""
    cfg = JConfig(**dict(cfg_items))

    def loss(v, t, lf, w, key):
        img = j_render(v, t, lf, cfg, sampling_rate=sr, key=key,
                       ert=ert).image
        return jnp.sum(img * w)

    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))


def _weights(image_shape, seed):
    return np.random.default_rng(seed).random(image_shape + (4,),
                                              np.float32) - 0.3


def _check_grads(vol, tf, lf, cfg_kw, sr=1.0, ert=True, key=None, seed=1):
    w = _weights(cfg_kw["image_shape"], seed)
    want_loss, (want_v, want_t) = _jax_value_and_grad(
        tuple(sorted(cfg_kw.items())), sr, ert)(vol, tf, lf, w, key)
    u = None
    if key is not None:
        u = torch.from_numpy(np.array(jax.random.uniform(
            key, cfg_kw["image_shape"], jnp.float32)))
    wt = torch.from_numpy(w)
    loss, (d_v, d_t) = P.value_and_grad_render(
        torch.from_numpy(vol), torch.from_numpy(tf), torch.from_numpy(lf),
        P.RenderConfig(**cfg_kw), lambda out: torch.sum(out.image * wt),
        sampling_rate=sr, u=u, ert=ert)
    for got, want in ((d_v, want_v), (d_t, want_t)):
        got, want = got.numpy(), np.asarray(want)
        assert np.isfinite(got).all()
        scale = float(np.abs(want).max())
        assert scale > 0.0
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=GRAD_TOL * scale)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)


@pytest.fixture(scope="module")
def noise():
    vol = np.random.default_rng(0).random((20, 24, 28), np.float32) * 0.5
    return vol, np.array(j_get_tf("tf1", 32))


@pytest.mark.parametrize("ert", [False, True])
@pytest.mark.parametrize("cam", list(CAMERAS))
def test_render_grads_match_jax(noise, cam, ert):
    vol, tf = noise
    _check_grads(vol, tf, np.array(CAMERAS[cam], np.float32), NOISE_CFG,
                 ert=ert)


@pytest.mark.parametrize("ert", [False, True])
def test_jittered_render_grads_match_jax(noise, ert):
    """JAX's jitter draw, injected as ``u``, gives the same gradients."""
    vol, tf = noise
    _check_grads(vol, tf, np.array(CAMERAS["oblique"], np.float32),
                 NOISE_CFG, ert=ert, key=jax.random.PRNGKey(7), seed=2)


@pytest.mark.parametrize("ert", [False, True])
def test_sphere_grads_match_jax(ert):
    vol = make_sphere_volume()
    cfg = dict(SPHERE_CFG, volume_shape=vol.shape)
    _check_grads(vol, np.array(j_get_tf("tf1", 32)),
                 np.array([1.2, 0.8, 2.0], np.float32), cfg, sr=0.8,
                 ert=ert, seed=3)


@pytest.mark.parametrize("ert", [False, True])
def test_opaque_tf_grads_match_jax(noise, ert):
    """A TF alpha of exactly 1 over part of its range at sampling rate 1:
    samples of opacity 1 end the transmittance.  No NaN, and the gradients
    JAX's closed-form composite gives (with ERT off the samples behind an
    opaque one still reach its alpha's gradient)."""
    vol, tf = noise
    tf = tf.copy()
    tf[12:, 3] = 1.0
    tf[20:22, :] = 1.0
    _check_grads(vol, tf, np.array(CAMERAS["oblique"], np.float32),
                 NOISE_CFG, ert=ert, seed=4)


# -- Raycaster against torch_interop.TorchRaycaster ---------------------------

RC_SHAPE = (20, 24, 28)       # (D, H, W)
RC_OUT = (10, 12)             # (W, H)
RC_R = 16
RC_KW = dict(sampling_rate=1.0, jitter=False, max_samples=32)


@pytest.fixture(scope="module")
def raycasters():
    return (TorchRaycaster(RC_SHAPE, RC_OUT, RC_R, **RC_KW),
            P.Raycaster(RC_SHAPE, RC_OUT, RC_R, device="cpu", **RC_KW))


@pytest.mark.parametrize("batched", [False, True])
def test_raycaster_matches_torch_interop(raycasters, batched):
    """The same torch tensors in give the same image and the same volume
    and TF gradients out; the camera gets none from either."""
    jr, pr = raycasters
    rng = np.random.default_rng(11)
    vol = rng.random((2, 1) + RC_SHAPE, np.float32) * 0.5
    tf = np.asarray(P.get_tf_torch_layout("tf1", RC_R, device="cpu"))
    lf = np.array([1.2, 0.8, 2.0], np.float32)
    if not batched:
        vol = vol[0]
    w = torch.from_numpy(
        rng.random(vol.shape[:-4] + (4, RC_OUT[1], RC_OUT[0]), np.float32))
    outs = []
    for rc in (jr, pr):
        ins = [torch.from_numpy(a.copy()).requires_grad_()
               for a in (vol, tf, lf)]
        img = rc(*ins)
        torch.sum(img * w).backward()
        outs.append((img.detach().numpy(), ins))
    (want, (wv, wt, wl)), (got, (gv, gt, gl)) = outs
    err = np.abs(got - want)
    assert (err > 2e-4).mean() <= 1e-3 and err.max() < 0.08, err.max()
    assert wl.grad is None and gl.grad is None
    for g, w_ in ((gv.grad, wv.grad), (gt.grad, wt.grad)):
        scale = float(w_.abs().max())
        assert scale > 0.0
        np.testing.assert_allclose(g.numpy(), w_.numpy(), rtol=0,
                                   atol=GRAD_TOL * scale)
