"""The port's row-split shear-warp render (``render_fast_sharded``) and the
shear-warp train step against the port's ``render_fast`` and the JAX
package, on gloo ranks.

The port's ranks are processes of ``torch_port_ranks`` (spawned once per
world size for this module, 2 and 4 ranks of one gloo group).  The scene
is JAX's ``tests/test_parallel.py``: the 32^3 sphere, tf5 at R = 16, 8x8
images, O = 16, a plane per voxel, at its three cameras.

Limits: each rank's strip of the intermediate image is computed as in the
whole image, so the joined image is ``render_fast``'s (held within 1e-6,
``hit`` equal) and the gradients are the same sums in another order (1e-5
* max|g|); against the JAX package's compiled ``render_fast``, the fast
path's limit of tests/test_torch_port_fastpath.py, 1e-4; the train step's
gradients 2e-3 * max|g| and its loss 1e-4 relative, as in
tests/test_torch_port_parallel.py.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import make_sphere_volume
import torch_port_ranks as ranks
from differender_tpu import RenderConfig as JConfig
from differender_tpu import get_tf as j_get_tf
from differender_tpu import render_nondiff as j_render_nondiff
from differender_tpu.fastpath import render_fast as j_render_fast
from differender_tpu.losses import mse_loss as j_mse
import differender_tpu_torch as P
from differender_tpu_torch import parallel as PP

VOL = make_sphere_volume()
TF = np.array(j_get_tf("tf5", 16))
CFG = dict(volume_shape=VOL.shape, image_shape=(8, 8), max_samples=48,
           block_size=8)
LFS = np.array([[1.3, 0.7, 2.1], [2.5, 0.05, 0.1], [-0.2, -2.3, 0.4]],
               np.float32)
W = np.random.default_rng(1).random((8, 8, 4), np.float32)
HIGHEST = jax.lax.Precision.HIGHEST
IMG_TOL = 1e-4
FAST_GRAD_TOL = 1e-5
GRAD_TOL = 2e-3
LOSS_TOL = 1e-4


def _inputs(world):
    fast = {"cfg": CFG, "lfs": LFS, "intermediate": 16, "ppv": 1.0}
    if world == 4:
        fast["w"] = W
    return {"vol": VOL, "tf": TF, "fast": fast}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each world size's ranks, spawned once: their results by rank."""
    return ranks.worlds(tmp_path_factory, {2: ["fast"], 4: ["fast"]},
                        _inputs)


@pytest.fixture(scope="module")
def jax_fast():
    """JAX's compiled render_fast at each camera (one program)."""
    fn = jax.jit(functools.partial(
        j_render_fast, config=JConfig(**CFG), intermediate=16,
        planes_per_voxel=1.0, precision=HIGHEST))
    outs = [fn(jnp.asarray(VOL), jnp.asarray(TF), jnp.asarray(lf))
            for lf in LFS]
    return [(np.asarray(o.image), np.asarray(o.hit)) for o in outs]


def _port(a):
    return torch.from_numpy(np.array(a))


def _port_fast(lf, vol=None, tf=None):
    return P.render_fast(_port(VOL) if vol is None else vol,
                         _port(TF) if tf is None else tf, _port(lf),
                         P.RenderConfig(**CFG), intermediate=16,
                         planes_per_voxel=1.0)


@pytest.mark.parametrize("n", [2, 4])
def test_render_fast_sharded(worlds, jax_fast, n):
    """n row strips: the port's render_fast, and JAX's within the fast
    path's limit, at the three cameras of JAX's test."""
    got = ranks.same_on_ranks(worlds(n), "fast")
    for i, lf in enumerate(LFS):
        own = _port_fast(lf)
        np.testing.assert_allclose(got[f"image{i}"], own.image.numpy(),
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got[f"hit{i}"], own.hit.numpy())
        want_img, want_hit = jax_fast[i]
        np.testing.assert_allclose(got[f"image{i}"], want_img, rtol=0,
                                   atol=IMG_TOL)
        np.testing.assert_array_equal(got[f"hit{i}"], want_hit)


def test_render_fast_sharded_grads(worlds):
    """Gradients of sum(image * w) on 4 ranks, whole on every rank, against
    the port's render_fast."""
    got = ranks.same_on_ranks(worlds(4), "fast")
    vol = _port(VOL).requires_grad_(True)
    tf = _port(TF).requires_grad_(True)
    (_port_fast(LFS[0], vol, tf).image * _port(W)).sum().backward()
    for g, want in ((got["d_volume"], vol.grad), (got["d_tf"], tf.grad)):
        want = want.numpy()
        np.testing.assert_allclose(g, want, rtol=0,
                                   atol=FAST_GRAD_TOL * np.abs(want).max())


def test_row_strips_join_into_render_fast():
    """The intermediate rows computed strip by strip (_core's row_offset
    and n_rows) join into the whole intermediate image bit for bit."""
    from differender_tpu_torch import fastpath as F
    vol, tf, lf = _port(VOL), _port(TF), _port(LFS[0])
    cfg = P.RenderConfig(**CFG)
    args = (vol, tf, lf, cfg, 16, 1.0, 4, F._march_plain)
    whole = F._intermediate(*args)[0]
    strips = torch.cat([F._intermediate(*args, 4 * k, 4)[0]
                        for k in range(4)])
    assert torch.equal(strips, whole)


def test_train_step_shearwarp_accum():
    """renderer="shearwarp" (planes_per_voxel = the sampling rate) in mode
    "accum", two views, against JAX's serial mean loss of render_fast."""
    cfg = JConfig(**CFG)
    lfs = LFS[[0, 2]]
    targets = np.stack([np.asarray(j_render_nondiff(
        VOL, TF, lf, cfg, sampling_rate=2.0).image) for lf in lfs])

    def one(v, t, lf, tgt):
        return j_mse(j_render_fast(v, t, lf, cfg, planes_per_voxel=1.0,
                                   precision=HIGHEST).image, tgt)

    # The serial mean loss, view by view (one program for both views).
    fn = jax.jit(jax.value_and_grad(one, argnums=(0, 1)))
    per_view = [fn(jnp.asarray(VOL), jnp.asarray(TF), jnp.asarray(lf),
                   jnp.asarray(tgt)) for lf, tgt in zip(lfs, targets)]
    want_l = np.mean([float(lv) for lv, _ in per_view])
    want_v = np.mean([np.asarray(g[0]) for _, g in per_view], axis=0)
    want_t = np.mean([np.asarray(g[1]) for _, g in per_view], axis=0)
    loss, (gv, gt) = PP.train_step_views(
        P.mse_loss, _port(VOL), _port(TF), _port(lfs), _port(targets),
        P.RenderConfig(**CFG), sampling_rate=1.0, mode="accum",
        renderer="shearwarp")
    np.testing.assert_allclose(float(loss), float(want_l), rtol=LOSS_TOL)
    for g, want in ((gv, want_v), (gt, want_t)):
        want = np.asarray(want)
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=GRAD_TOL * np.abs(want).max())
