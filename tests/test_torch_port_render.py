"""The torch port's renders (plain marches on the CPU) against the JAX
package's ``render``/``render_nondiff`` and the golden fixtures.

Tolerances: 1e-4 on the golden images; 2e-4 against JAX at the 20x24x28
scale, where both sum the same f32 terms in another order (JAX composites
blocks in closed form, the port ray by ray); with ERT on, the knife-edge
bounds of tests/test_render.py, since a transmittance a few ulps either side
of the gate ends a ray one sample earlier or later.
"""
import os

import numpy as np
import jax
import pytest
import torch

from conftest import make_shell_volume, make_sphere_volume
from differender_tpu import RenderConfig as JConfig
from differender_tpu import get_tf as j_get_tf
from differender_tpu import render as j_render
from differender_tpu import render_nondiff as j_render_nondiff
import differender_tpu_torch as P

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_renders.npz")
CAMERAS = {
    "oblique": (1.2, 0.8, 2.0),
    "pole+y": (0.0, 2.5, 0.0),
    "pole-y": (0.0, -2.5, 0.0),
    "behind": (-2.0, 0.3, -0.4),
}
NOISE_CFG = dict(volume_shape=(20, 24, 28), image_shape=(24, 32),
                 tf_resolution=32, max_samples=64)


def _state(vol, tf, lf):
    return P.state_from_numpy(vol, tf, lf, layout="internal", device="cpu")


@pytest.fixture(scope="module")
def golden():
    vol = make_sphere_volume()
    cfg = dict(volume_shape=vol.shape, image_shape=(16, 16),
               tf_resolution=32, max_samples=64, block_size=16)
    tf = np.asarray(j_get_tf("tf1", 32))
    lf = np.array([1.2, 0.8, 2.0], np.float32)
    return np.load(GOLDEN), _state(vol, tf, lf), P.RenderConfig(**cfg)


def test_golden_diff(golden):
    g, (vol, tf, lf), cfg = golden
    img = P.render(vol, tf, lf, cfg, sampling_rate=0.8).image
    np.testing.assert_allclose(img.numpy(), g["diff"], atol=1e-4)


def test_golden_jittered(golden):
    g, (vol, tf, lf), cfg = golden
    u = torch.from_numpy(np.array(
        jax.random.uniform(jax.random.PRNGKey(7), cfg.image_shape)))
    img = P.render(vol, tf, lf, cfg, sampling_rate=0.8, u=u).image
    np.testing.assert_allclose(img.numpy(), g["jittered"], atol=1e-4)


def test_golden_nondiff(golden):
    g, (vol, tf, lf), cfg = golden
    out = P.render_nondiff(vol, tf, lf, cfg, sampling_rate=1.5)
    np.testing.assert_allclose(out.image.numpy(), g["nondiff"], atol=1e-4)
    assert bool((out.valid_steps == 1).all())


def test_generator_jitter_is_reproducible(golden):
    _, (vol, tf, lf), cfg = golden
    imgs = [P.render(vol, tf, lf, cfg, 0.8,
                     generator=torch.Generator().manual_seed(3)).image
            for _ in range(2)]
    plain = P.render(vol, tf, lf, cfg, 0.8).image
    assert torch.equal(imgs[0], imgs[1])
    assert not torch.equal(imgs[0], plain)


@pytest.fixture(scope="module")
def noise():
    vol = np.random.default_rng(0).random((20, 24, 28), np.float32) * 0.5
    tf = np.asarray(j_get_tf("tf1", 32))
    return vol, tf


@pytest.mark.parametrize("ert", [False, True])
@pytest.mark.parametrize("cam", list(CAMERAS))
def test_render_matches_jax(noise, cam, ert):
    vol, tf = noise
    lf = np.array(CAMERAS[cam], np.float32)
    want = j_render(vol, tf, lf, JConfig(**NOISE_CFG), sampling_rate=1.0,
                    ert=ert)
    got = P.render(*_state(vol, tf, lf), P.RenderConfig(**NOISE_CFG),
                   sampling_rate=1.0, ert=ert)
    np.testing.assert_array_equal(got.n_samples.numpy(),
                                  np.asarray(want.n_samples))
    err = np.abs(got.image.numpy() - np.asarray(want.image))
    steps = np.abs(got.valid_steps.numpy() - np.asarray(want.valid_steps))
    if ert:
        assert (err > 2e-4).mean() <= 1e-3 and err.max() < 0.08, err.max()
        assert steps.max() <= 1
    else:
        assert err.max() <= 2e-4, err.max()
        assert steps.max() == 0
    assert int(got.n_samples.max()) > 0


@pytest.mark.parametrize("cam", list(CAMERAS))
def test_render_nondiff_matches_jax(noise, cam):
    vol, tf = noise
    lf = np.array(CAMERAS[cam], np.float32)
    want = j_render_nondiff(vol, tf, lf, JConfig(**NOISE_CFG))
    got = P.render_nondiff(*_state(vol, tf, lf), P.RenderConfig(**NOISE_CFG))
    np.testing.assert_array_equal(got.n_samples.numpy(),
                                  np.asarray(want.n_samples))
    err = np.abs(got.image.numpy() - np.asarray(want.image))
    assert (err > 2e-4).mean() <= 1e-3 and err.max() < 0.08, err.max()


def test_opaque_shell_ert():
    """Near-opaque TF: ERT ends rays inside the shell (the knife-edge case
    of tests/test_render.py::test_diff_render_opaque_ert)."""
    vol = make_shell_volume()
    cfg = dict(volume_shape=vol.shape, image_shape=(8, 8))
    tf = np.zeros((16, 4), np.float32)
    tf[8:, :] = 0.95
    lf = np.array([0.0, 0.5, 2.6], np.float32)
    want = j_render(vol, tf, lf, JConfig(**cfg), sampling_rate=1.0)
    got = P.render(*_state(vol, tf, lf), P.RenderConfig(**cfg),
                   sampling_rate=1.0)
    err = np.abs(got.image.numpy() - np.asarray(want.image))
    assert (err > 1.5e-2).mean() < 0.02, (err.max(), (err > 1.5e-2).mean())
    assert err.max() < 0.08, err.max()
    n = got.n_samples.numpy()
    c = got.valid_steps.numpy() - 1
    assert (c[n > 0] < n[n > 0]).any()          # ERT kicked in
    assert np.abs(got.valid_steps.numpy()
                  - np.asarray(want.valid_steps)).max() <= 1


def test_max_samples_cap():
    vol = make_sphere_volume()
    cfg = dict(volume_shape=vol.shape, image_shape=(6, 6), max_samples=5)
    tf = np.asarray(j_get_tf("gray", 16))
    lf = np.array([0.0, 0.3, 2.5], np.float32)
    want = j_render(vol, tf, lf, JConfig(**cfg), sampling_rate=1.0)
    got = P.render(*_state(vol, tf, lf), P.RenderConfig(**cfg),
                   sampling_rate=1.0)
    np.testing.assert_allclose(got.image.numpy(), np.asarray(want.image),
                               atol=2e-4)
    np.testing.assert_array_equal(got.valid_steps.numpy(),
                                  np.asarray(want.valid_steps))
    assert int((got.valid_steps - 1).max()) <= 5


def test_march_diff_returns_plain_on_cpu(golden):
    _, (vol, tf, lf), cfg = golden
    rays = P.make_rays(lf, cfg, 0.8)
    a = P.march_diff(vol, tf, rays, cfg, 0.8)
    b = P.march_diff_plain(vol, tf, rays, cfg, 0.8)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    img, visited, composited = P.march_nondiff(vol, tf, rays, cfg, 0.8)
    assert bool((composited <= visited).all())
    assert bool((visited <= rays.n_samples).all())


def test_render_grads_flow_on_cpu(golden):
    """Gradients reach the volume and the TF, never the camera."""
    _, (vol, tf, lf), cfg = golden
    vol = vol.clone().requires_grad_()
    tf = tf.clone().requires_grad_()
    lf = lf.clone().requires_grad_()
    img = P.render(vol, tf, lf, cfg).image
    assert img.requires_grad
    img.square().mean().backward()
    for g in (vol.grad, tf.grad):
        assert g is not None and bool(torch.isfinite(g).all())
        assert float(g.abs().max()) > 0.0
    assert lf.grad is None
    with torch.no_grad():
        assert not P.render(vol, tf, lf, cfg).image.requires_grad


def test_march_diff_bwd_is_plain_on_cpu(golden):
    """On CPU tensors K2's wrapper is autograd of the plain march; the
    per-ray counts (scattering samples, light-only samples, atomics, the
    stencil's general branch) exist only in the kernel, as do K1's."""
    _, (vol, tf, lf), cfg = golden
    rays = P.make_rays(lf, cfg, 0.8)
    image, _ = P.march_diff(vol, tf, rays, cfg, 0.8)
    g = torch.from_numpy(np.random.default_rng(5).random(
        image.shape, np.float32) - 0.3)
    got = P.march_diff_bwd(vol, tf, rays, cfg, 0.8, image, g)
    want = P.march_diff_bwd_plain(vol, tf, rays, cfg, 0.8, g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="K2 only"):
        P.march_diff_bwd(vol, tf, rays, cfg, 0.8, image, g,
                         counts=torch.zeros(cfg.image_shape + (4,),
                                            dtype=torch.int32))
    with pytest.raises(ValueError, match="K1 only"):
        P.march_diff_fwd(vol, tf, rays, cfg, 0.8,
                         counts=torch.zeros(cfg.image_shape + (2,),
                                            dtype=torch.int32))
