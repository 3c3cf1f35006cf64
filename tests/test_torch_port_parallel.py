"""The port's multi-view data parallelism and its multi-view train step
(``differender_tpu_torch.parallel``) against the JAX package, on gloo
ranks.

The port's ranks are processes of ``torch_port_ranks`` (spawned once per
world size for this module, 2 and 4 ranks of one gloo group); the JAX
package runs here on the CPU from the same numpy inputs.  Scenes are JAX's
``tests/test_parallel.py``: the 32^3 sphere, tf5 at R = 16, 6x6 images for
the views (8 orbit cameras, sampling rate 0.5, targets 0.9 times JAX's
images) and 8x8 for the train step (4 cameras, sampling rate 0.7, targets
of JAX's ``render_nondiff``).

Limits: images 1e-4 against the JAX package and 1e-6 against the port's
own per-view ``render``; gradients 2e-3 * max|g|, the port's CPU gradient
limit; losses 1e-4 relative (readings up to 3.2e-5: a loss of images
against targets close to them is a small difference of large terms, and
the two packages' images differ in their last bits).  The group-dependent
refusals of every entry point are checked on 4 ranks.
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
from differender_tpu import render as j_render
from differender_tpu import render_nondiff as j_render_nondiff
from differender_tpu.losses import mse_loss as j_mse
import differender_tpu_torch as P
from differender_tpu_torch import parallel as PP

VOL = make_sphere_volume()
TF = np.array(j_get_tf("tf5", 16))
IMG_TOL = 1e-4
GRAD_TOL = 2e-3
LOSS_TOL = 1e-4

VIEWS_CFG = dict(volume_shape=VOL.shape, image_shape=(6, 6), max_samples=48,
                 block_size=8)
VIEWS_SR = 0.5
VIEWS_LFS = np.stack([[np.cos(a) * 2.4, 0.6, np.sin(a) * 2.4]
                      for a in np.linspace(0, 3, 8)]).astype(np.float32)
TRAIN_CFG = dict(volume_shape=VOL.shape, image_shape=(8, 8), max_samples=48,
                 block_size=8)
TRAIN_SR = 0.7
TRAIN_LFS = np.array([[1.3, 0.7, 2.1], [-2.0, 0.5, 1.0], [0.5, -1.5, 1.8],
                      [2.2, 0.2, -0.8]], np.float32)
TRAIN_KEYS = jax.random.split(jax.random.PRNGKey(3), 4)


def _draws(keys, shape):
    """JAX's jitter draw of each key (what its render draws from it)."""
    return np.stack([np.asarray(jax.random.uniform(k, shape)) for k in keys])


@functools.lru_cache(maxsize=None)
def _views_targets():
    cfg = JConfig(**VIEWS_CFG)
    imgs = np.stack([np.asarray(j_render(VOL, TF, lf, cfg,
                                         sampling_rate=VIEWS_SR).image)
                     for lf in VIEWS_LFS])
    return imgs, imgs * 0.9


@functools.lru_cache(maxsize=None)
def _train_targets():
    cfg = JConfig(**TRAIN_CFG)
    return np.stack([np.asarray(j_render_nondiff(VOL, TF, lf, cfg,
                                                 sampling_rate=2.0).image)
                     for lf in TRAIN_LFS])


def _jax_view_grad(views, with_key):
    """One view's loss and gradients, compiled once (the camera, the
    target and the key are arguments): the views' setup or the train
    step's."""
    cfg = JConfig(**(VIEWS_CFG if views else TRAIN_CFG))
    sr = VIEWS_SR if views else TRAIN_SR

    def one(v, t, lf, tgt, key):
        img = j_render(v, t, lf, cfg, sr,
                       key=key if with_key else None).image
        return j_mse(img, tgt)

    return jax.jit(jax.value_and_grad(one, argnums=(0, 1)))


def _jax_serial(views, lfs, targets, keys=None):
    """The JAX package's serial mean loss over the views and its gradients
    (JAX's ``_serial`` form of tests/test_parallel.py, taken view by view
    and summed)."""
    fn = _jax_view_grad(views, keys is not None)
    loss, gv, gt = 0.0, 0.0, 0.0
    for i in range(len(lfs)):
        li, (gvi, gti) = fn(jnp.asarray(VOL), jnp.asarray(TF),
                            jnp.asarray(lfs[i]), jnp.asarray(targets[i]),
                            keys[i] if keys is not None else None)
        loss, gv, gt = loss + float(li), gv + np.asarray(gvi), \
            gt + np.asarray(gti)
    n = len(lfs)
    return loss / n, gv / n, gt / n


@pytest.fixture(scope="module")
def jax_views():
    """JAX's per-view renders, and its serial mean loss and gradients."""
    imgs, targets = _views_targets()
    loss, gv, gt = _jax_serial(True, VIEWS_LFS, targets)
    return {"images": imgs, "loss": loss, "d_volume": gv, "d_tf": gt}


def _inputs(world):
    imgs, targets = _views_targets()
    return {
        "vol": VOL, "tf": TF,
        "views": {"cfg": VIEWS_CFG, "lfs": VIEWS_LFS, "sr": VIEWS_SR,
                  "targets": targets},
        "train": {"cfg": TRAIN_CFG, "lfs": TRAIN_LFS, "sr": TRAIN_SR,
                  "targets": _train_targets(),
                  "u": _draws(TRAIN_KEYS, TRAIN_CFG["image_shape"])},
    }


_SCENARIOS = {2: ["views", "view_grads", "train"],
              4: ["views", "view_grads", "train", "refusals"]}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each world size's ranks, spawned once: their results by rank."""
    return ranks.worlds(tmp_path_factory, _SCENARIOS, _inputs)


def _grads_close(got_v, got_t, want_v, want_t):
    np.testing.assert_allclose(got_v, want_v, rtol=0,
                               atol=GRAD_TOL * np.abs(want_v).max())
    np.testing.assert_allclose(got_t, want_t, rtol=0,
                               atol=GRAD_TOL * np.abs(want_t).max())


def _port(a):
    return torch.from_numpy(np.array(a))


# -- render_views, view_parallel_grads --------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_render_views(worlds, jax_views, n):
    """8 views over n ranks: every rank holds all 8 images, each JAX's
    render of that view and the port's own render of it alone."""
    got = ranks.same_on_ranks(worlds(n), "views")["images"]
    assert got.shape == (8, 6, 6, 4)
    np.testing.assert_allclose(got, jax_views["images"], rtol=0,
                               atol=IMG_TOL)
    cfg = P.RenderConfig(**VIEWS_CFG)
    own = np.stack([P.render(_port(VOL), _port(TF), _port(lf), cfg,
                             VIEWS_SR).image.numpy() for lf in VIEWS_LFS])
    np.testing.assert_allclose(got, own, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", [2, 4])
def test_view_parallel_grads(worlds, jax_views, n):
    got = ranks.same_on_ranks(worlds(n), "view_grads")
    np.testing.assert_allclose(got["loss"], jax_views["loss"], rtol=LOSS_TOL)
    _grads_close(got["d_volume"], got["d_tf"], jax_views["d_volume"],
                 jax_views["d_tf"])


# -- train_step_views ---------------------------------------------------------

@pytest.fixture(scope="module")
def jax_serial():
    targets = _train_targets()
    return {"plain": _jax_serial(False, TRAIN_LFS, targets),
            "draws": _jax_serial(False, TRAIN_LFS, targets, TRAIN_KEYS)}


def test_train_step_accum(jax_serial):
    """Mode "accum" in one process (no group), and "auto" without a group
    is "accum"."""
    args = (P.mse_loss, _port(VOL), _port(TF), _port(TRAIN_LFS),
            _port(_train_targets()), P.RenderConfig(**TRAIN_CFG))
    loss, (gv, gt) = PP.train_step_views(*args, sampling_rate=TRAIN_SR,
                                         mode="accum")
    want_l, want_v, want_t = jax_serial["plain"]
    np.testing.assert_allclose(float(loss), want_l, rtol=LOSS_TOL)
    _grads_close(gv.numpy(), gt.numpy(), want_v, want_t)
    loss_a, (gv_a, _) = PP.train_step_views(*args, sampling_rate=TRAIN_SR)
    assert float(loss_a) == float(loss) and torch.equal(gv_a, gv)


@pytest.mark.parametrize("draws", ["plain", "draws"])
@pytest.mark.parametrize("n", [2, 4])
def test_train_step_shard_map(worlds, jax_serial, n, draws):
    """Mode "shard_map" (the default with a group) on n ranks, without and
    with per-view draws (JAX's keys' draws)."""
    got = ranks.same_on_ranks(worlds(n), "train")[draws]
    want_l, want_v, want_t = jax_serial[draws]
    np.testing.assert_allclose(got["loss"], want_l, rtol=LOSS_TOL)
    _grads_close(got["d_volume"], got["d_tf"], want_v, want_t)


def test_train_step_refusals():
    args = (P.mse_loss, _port(VOL), _port(TF), _port(TRAIN_LFS),
            _port(_train_targets()), P.RenderConfig(**TRAIN_CFG))
    with pytest.raises(ValueError, match="unknown mode 'bogus'"):
        PP.train_step_views(*args, mode="bogus")
    with pytest.raises(ValueError, match="requires a group"):
        PP.train_step_views(*args, mode="shard_map")


def test_views_need_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        PP.render_views(_port(VOL), _port(TF), _port(VIEWS_LFS),
                        P.RenderConfig(**VIEWS_CFG))


# -- refusals on 4 ranks ------------------------------------------------------

@pytest.mark.parametrize("what,match", [
    ("shard_volume_X", "volume X axis must divide the mesh axis"),
    ("render_volume_sharded_X", "volume X axis must divide the mesh axis"),
    ("render_fast_sharded_O", "intermediate size must divide the mesh axis"),
    ("render_views_B", "must divide the view batch 6"),
    ("train_step_views_B", "must divide the view batch 6")])
def test_refusals(worlds, what, match):
    for r in worlds(4):
        assert r["refusals"][what] is not None and \
            match in r["refusals"][what], r["refusals"][what]
