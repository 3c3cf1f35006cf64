"""Ray setup of the torch port against the JAX package (CPU, f32)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from differender_tpu import RenderConfig as JConfig
from differender_tpu import geometry as jg
import differender_tpu_torch as P
from differender_tpu_torch import geometry as pg

CAMERAS = {
    "oblique": (1.2, 0.8, 2.0),
    "pole+y": (0.0, 2.5, 0.0),
    "pole-y": (0.0, -2.5, 0.0),
    "behind": (-2.0, 0.3, -0.4),
}
CFG = dict(volume_shape=(20, 24, 28), image_shape=(24, 32), max_samples=64)
ATOL = 1e-6


@pytest.fixture(scope="module")
def u():
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(7), (24, 32)))


def _lf(cam):
    return np.array(CAMERAS[cam], np.float32)


@pytest.mark.parametrize("cam", list(CAMERAS))
def test_ray_directions(cam):
    want = np.asarray(jg.ray_directions(jnp.asarray(_lf(cam)), JConfig(**CFG)))
    got = pg.ray_directions(torch.from_numpy(_lf(cam)), P.RenderConfig(**CFG))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("cam", list(CAMERAS))
def test_ray_aabb(cam):
    lf = _lf(cam)
    dirs = np.asarray(jg.ray_directions(jnp.asarray(lf), JConfig(**CFG)))
    box = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))
    jmin, jmax, jhit = (np.asarray(a) for a in jg.ray_aabb(
        jnp.asarray(lf), jnp.asarray(dirs), *box))
    pmin, pmax, phit = pg.ray_aabb(torch.from_numpy(lf),
                                   torch.tensor(dirs), *box)
    np.testing.assert_array_equal(phit.numpy(), jhit)
    np.testing.assert_allclose(pmin.numpy()[jhit], jmin[jhit], atol=ATOL)
    np.testing.assert_allclose(pmax.numpy()[jhit], jmax[jhit], atol=ATOL)


@pytest.mark.parametrize("jitter", [False, True])
@pytest.mark.parametrize("cam", list(CAMERAS))
def test_make_rays_and_march_params(cam, jitter, u):
    lf = _lf(cam)
    key = jax.random.PRNGKey(7) if jitter else None
    jr = jg.make_rays(lf, JConfig(**CFG), 1.3, jitter_key=key)
    pr = pg.make_rays(torch.from_numpy(lf), P.RenderConfig(**CFG), 1.3,
                      u=torch.from_numpy(u) if jitter else None)
    np.testing.assert_array_equal(pr.n_samples.numpy(),
                                  np.asarray(jr.n_samples))
    assert pr.n_samples.dtype == torch.int32
    hit = np.asarray(jr.n_samples) > 0
    assert hit.any()
    for name in ("entry", "exit"):
        np.testing.assert_allclose(getattr(pr, name).numpy()[hit],
                                   np.asarray(getattr(jr, name))[hit],
                                   atol=ATOL)
    jp, pp = jg.march_params(jr), pg.march_params(pr)
    np.testing.assert_allclose(pp.t0.numpy(), np.asarray(jp.t0), atol=ATOL)
    np.testing.assert_allclose(pp.dt.numpy(), np.asarray(jp.dt), atol=ATOL)


def test_jitter_shape_is_checked():
    with pytest.raises(ValueError):
        pg.make_rays(torch.tensor([1.0, 2.0, 3.0]), P.RenderConfig(**CFG),
                     1.0, u=torch.zeros(3, 3))
