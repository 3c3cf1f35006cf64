"""The port's large-scale entry points against the JAX package's: row strips
(``render_nondiff_strips``, ``render_strips``), depth-sorted chunks
(``render_depth_sorted`` and its sort key ``_predict_march_depth``), the
scene policy (``choose_diff_renderer``) and ``value_and_grad_blockwise``.

On CPU tensors each runs the plain marches.  Images are held to the JAX
package's within 2e-4 (the bound of tests/test_torch_port_render.py: the
two packages sum the same f32 terms in other orders) and to the port's own
monolithic forms bit for bit (every ray marches the same samples in either
form); gradients within ``2e-3 * max|g|`` of ``jax.grad`` of the JAX
package's ``render`` (the bound of tests/test_torch_port_grads.py).  JAX's
jitter draw is injected as ``u``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import make_shell_volume, make_sphere_volume
import differender_tpu as J
from differender_tpu import RenderConfig as JConfig
from differender_tpu import get_tf as j_get_tf
from differender_tpu.geometry import make_rays as j_make_rays
from differender_tpu.render import _predict_march_depth as j_predict
import differender_tpu_torch as P
from differender_tpu_torch.render import _predict_march_depth as p_predict

IMAGE_TOL = 2e-4
GRAD_TOL = 2e-3
STRIP_CFG = dict(image_shape=(12, 8), max_samples=48, block_size=8)
SORT_CFG = dict(image_shape=(16, 16), max_samples=64, block_size=8)


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


def _u(key, shape):
    return _t(jax.random.uniform(key, shape, jnp.float32))


@pytest.fixture(scope="module")
def sphere():
    return make_sphere_volume(), np.asarray(j_get_tf("tf5", 16))


@pytest.fixture(scope="module")
def shell():
    return make_shell_volume(), np.asarray(j_get_tf("tf1", 32))


def _grads(fn, vol, tf, w):
    v = _t(vol).requires_grad_(True)
    t = _t(tf).requires_grad_(True)
    torch.sum(fn(v, t).image * _t(w)).backward()
    return v.grad.numpy(), t.grad.numpy()


def _assert_grads(got, want):
    for g, r in zip(got, want):
        r = np.asarray(r)
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=GRAD_TOL * float(np.abs(r).max()))


def test_render_nondiff_strips_matches_jax(sphere):
    vol, tf = sphere
    lf = np.array([1.3, 0.7, 2.1], np.float32)
    kw = dict(STRIP_CFG, volume_shape=vol.shape)
    want = J.render_nondiff_strips(vol, tf, lf, JConfig(**kw),
                                   sampling_rate=1.5, n_strips=3)
    cfg = P.RenderConfig(**kw)
    got = P.render_nondiff_strips(_t(vol), _t(tf), _t(lf), cfg,
                                  sampling_rate=1.5, n_strips=3)
    np.testing.assert_allclose(got.image.numpy(), np.asarray(want.image),
                               atol=IMAGE_TOL)
    mono = P.render_nondiff(_t(vol), _t(tf), _t(lf), cfg, sampling_rate=1.5)
    assert torch.equal(got.image, mono.image)
    assert torch.equal(got.valid_steps, mono.valid_steps)
    with pytest.raises(ValueError, match="must divide the image height"):
        P.render_nondiff_strips(_t(vol), _t(tf), _t(lf), cfg, n_strips=5)


def test_render_strips_matches_jax(sphere):
    vol, tf = sphere
    lf = np.array([1.3, 0.7, 2.1], np.float32)
    key = jax.random.PRNGKey(5)
    kw = dict(STRIP_CFG, volume_shape=vol.shape)
    jcfg, cfg = JConfig(**kw), P.RenderConfig(**kw)
    u = _u(key, kw["image_shape"])
    want = J.render_strips(vol, tf, lf, jcfg, sampling_rate=0.7, key=key,
                           n_strips=3)
    got = P.render_strips(_t(vol), _t(tf), _t(lf), cfg, sampling_rate=0.7,
                          u=u, n_strips=3)
    np.testing.assert_allclose(got.image.numpy(), np.asarray(want.image),
                               atol=IMAGE_TOL)
    np.testing.assert_array_equal(got.valid_steps.numpy(),
                                  np.asarray(want.valid_steps))
    mono = P.render(_t(vol), _t(tf), _t(lf), cfg, sampling_rate=0.7, u=u)
    assert torch.equal(got.image, mono.image)
    assert torch.equal(got.valid_steps, mono.valid_steps)

    w = np.random.default_rng(1).random((12, 8, 4), np.float32)
    want_g = jax.grad(lambda v, t: jnp.sum(J.render(
        v, t, lf, jcfg, sampling_rate=0.7, key=key).image * w),
        argnums=(0, 1))(jnp.asarray(vol), jnp.asarray(tf))
    got_g = _grads(lambda v, t: P.render_strips(
        v, t, _t(lf), cfg, sampling_rate=0.7, u=u, n_strips=3), vol, tf, w)
    _assert_grads(got_g, want_g)


def test_render_strips_camera_grad_is_renders(sphere):
    """A camera that requires grad gets the monolithic render's gradient
    through the strips (the same terms; autograd sums the rays' shares of
    the camera in another order)."""
    vol, tf = sphere
    cfg = P.RenderConfig(volume_shape=vol.shape, **STRIP_CFG)
    grads = []
    for fn in (P.render, lambda *a, **k: P.render_strips(*a, n_strips=2,
                                                         **k)):
        lf = _t(np.array([1.3, 0.7, 2.1], np.float32)).requires_grad_(True)
        torch.sum(fn(_t(vol), _t(tf), lf, cfg,
                     sampling_rate=0.7).image ** 2).backward()
        grads.append(lf.grad)
    assert torch.count_nonzero(grads[0]) == 3
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-5, atol=0)


@pytest.mark.parametrize("lf", [(1.2, 0.8, 2.0), (0.0, 2.5, 0.0)])
def test_predict_march_depth_matches_jax(shell, lf):
    """The sort keys equal the JAX package's, and so does the stable
    order (the pole camera leaves rays that miss the volume: ties)."""
    vol, tf = shell
    lf = np.array(lf, np.float32)
    key = jax.random.PRNGKey(2)
    kw = dict(SORT_CFG, volume_shape=vol.shape)
    rays = j_make_rays(jnp.asarray(lf), JConfig(**kw), 0.8, jitter_key=key)
    want = np.asarray(j_predict(jnp.asarray(vol), jnp.asarray(tf), rays,
                                JConfig(**kw)))
    cfg = P.RenderConfig(**kw)
    got = p_predict(_t(vol), _t(tf),
                    P.make_rays(_t(lf), cfg, 0.8,
                                u=_u(key, kw["image_shape"])), cfg)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        torch.argsort(got, stable=True).numpy(),
        np.asarray(jnp.argsort(jnp.asarray(want))))


def test_render_depth_sorted_matches_jax(shell):
    vol, tf = shell
    lf = np.array([1.2, 0.8, 2.0], np.float32)
    key = jax.random.PRNGKey(2)
    kw = dict(SORT_CFG, volume_shape=vol.shape)
    jcfg, cfg = JConfig(**kw), P.RenderConfig(**kw)
    u = _u(key, kw["image_shape"])
    want = J.render_depth_sorted(vol, tf, lf, jcfg, sampling_rate=0.8,
                                 key=key, chunks=4)
    got = P.render_depth_sorted(_t(vol), _t(tf), _t(lf), cfg,
                                sampling_rate=0.8, u=u, chunks=4)
    np.testing.assert_allclose(got.image.numpy(), np.asarray(want.image),
                               atol=IMAGE_TOL)
    np.testing.assert_array_equal(got.valid_steps.numpy(),
                                  np.asarray(want.valid_steps))
    mono = P.render(_t(vol), _t(tf), _t(lf), cfg, sampling_rate=0.8, u=u)
    assert torch.equal(got.image, mono.image)
    assert torch.equal(got.valid_steps, mono.valid_steps)

    w = np.random.default_rng(2).random((16, 16, 4), np.float32)
    want_g = jax.grad(lambda v, t: jnp.sum(J.render(
        v, t, lf, jcfg, sampling_rate=0.8, key=key).image * w),
        argnums=(0, 1))(jnp.asarray(vol), jnp.asarray(tf))
    got_g = _grads(lambda v, t: P.render_depth_sorted(
        v, t, _t(lf), cfg, sampling_rate=0.8, u=u, chunks=4), vol, tf, w)
    _assert_grads(got_g, want_g)


@pytest.mark.parametrize("chunks", [32, 64])
def test_render_depth_sorted_narrow_chunks(shell, chunks):
    """Chunks that the height does not divide march as (M // w, w) images
    with w = gcd(M, W), and still render as ``render``: the same counts,
    and the image within an ulp (PyTorch's CPU kernels round a tensor's
    vectorised body and its tail differently, and these chunks cut the
    rays into other tensor lengths; the card's per-ray threads do not)."""
    vol, tf = shell
    lf = _t(np.array([1.2, 0.8, 2.0], np.float32))
    cfg = P.RenderConfig(volume_shape=vol.shape, **SORT_CFG)
    got = P.render_depth_sorted(_t(vol), _t(tf), lf, cfg, sampling_rate=0.8,
                                chunks=chunks)
    mono = P.render(_t(vol), _t(tf), lf, cfg, sampling_rate=0.8)
    torch.testing.assert_close(got.image, mono.image, rtol=0, atol=1e-6)
    assert torch.equal(got.valid_steps, mono.valid_steps)
    with pytest.raises(ValueError, match="must divide H\\*W"):
        P.render_depth_sorted(_t(vol), _t(tf), lf, cfg, chunks=3)


def _noise(shape):
    return np.asarray(0.36 + jax.random.uniform(
        jax.random.PRNGKey(3), shape, jnp.float32) * 0.08)


@pytest.mark.parametrize("case,want_name", [
    ("shell", "depth_sorted"), ("noise", "compacted"),
    ("noise_no_compaction", "plain")])
def test_choose_diff_renderer_matches_jax(shell, case, want_name):
    """The three cases of the JAX package's policy test: the names equal
    the JAX package's, and each returned function renders as ``render``."""
    vol, tf = shell
    if case != "shell":
        vol = _noise(vol.shape)
    ca = 0 if case == "noise_no_compaction" else 2
    lf = np.array([1.2, 0.8, 2.0], np.float32)
    kw = dict(SORT_CFG, volume_shape=vol.shape)
    _, j_name = J.choose_diff_renderer(jnp.asarray(vol), jnp.asarray(tf),
                                       jnp.asarray(lf), JConfig(**kw),
                                       sampling_rate=0.8, compact_after=ca)
    cfg = P.RenderConfig(**kw)
    fn, name = P.choose_diff_renderer(_t(vol), _t(tf), _t(lf), cfg,
                                      sampling_rate=0.8, compact_after=ca)
    assert name == j_name == want_name
    if name == "plain":
        assert fn is P.render
    u = _u(jax.random.PRNGKey(2), kw["image_shape"])
    got = fn(_t(vol), _t(tf), _t(lf), cfg, sampling_rate=0.8, u=u)
    mono = P.render(_t(vol), _t(tf), _t(lf), cfg, sampling_rate=0.8, u=u)
    assert torch.equal(got.image, mono.image)


def test_choose_diff_renderer_timed_probe(shell):
    vol, tf = shell
    lf = _t(np.array([1.2, 0.8, 2.0], np.float32))
    cfg = P.RenderConfig(volume_shape=vol.shape, **SORT_CFG)
    fn, name = P.choose_diff_renderer(_t(vol), _t(tf), lf, cfg,
                                      sampling_rate=0.8, probe="timed")
    assert name in ("plain", "depth_sorted")
    got = fn(_t(vol), _t(tf), lf, cfg, sampling_rate=0.8)
    mono = P.render(_t(vol), _t(tf), lf, cfg, sampling_rate=0.8)
    assert torch.equal(got.image, mono.image)
    with pytest.raises(ValueError, match="probe"):
        P.choose_diff_renderer(_t(vol), _t(tf), lf, cfg, probe="bogus")


BLOCKWISE_CFG = dict(image_shape=(8, 8), tf_resolution=16, max_samples=16,
                     block_size=8)


def test_value_and_grad_blockwise_matches_jax(sphere):
    """Against the JAX package's host-level blockwise backward at block
    size 8, with a target passed through ``loss_args``."""
    vol = sphere[0]
    tf = np.asarray(j_get_tf("tf1", 16))
    lf = np.array([1.2, 0.8, 2.0], np.float32)
    kw = dict(BLOCKWISE_CFG, volume_shape=vol.shape, march_vjp="ad")
    target = np.random.default_rng(3).random((8, 8, 4), np.float32)

    def j_loss(out, tgt):
        return jnp.mean((out.image - tgt) ** 2)

    def p_loss(out, tgt):
        return torch.mean((out.image - tgt) ** 2)

    want_l, want_g = J.value_and_grad_blockwise(
        jnp.asarray(vol), jnp.asarray(tf), jnp.asarray(lf), JConfig(**kw),
        j_loss, sampling_rate=0.8, loss_args=(jnp.asarray(target),))
    got_l, got_g = P.value_and_grad_blockwise(
        _t(vol), _t(tf), _t(lf), P.RenderConfig(**kw), p_loss,
        sampling_rate=0.8, loss_args=(_t(target),))
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-4)
    _assert_grads([g.numpy() for g in got_g], want_g)


@pytest.mark.parametrize("knobs,match", [
    (dict(march_table="super64", march_vjp="tiled", vjp_tile=4),
     "blockwise"),
    (dict(camera_grads=True), "camera_grads"),
    (dict(march_table="cell8", march_vjp="sorted"), "super64")])
def test_value_and_grad_blockwise_refusals(sphere, knobs, match):
    """The JAX package's three refusals, with its messages."""
    vol = sphere[0]
    tf = np.asarray(j_get_tf("tf1", 16))
    lf = np.array([1.2, 0.8, 2.0], np.float32)
    kw = dict(BLOCKWISE_CFG, volume_shape=vol.shape, **knobs)
    with pytest.raises(ValueError, match=match) as want:
        J.value_and_grad_blockwise(
            jnp.asarray(vol), jnp.asarray(tf), jnp.asarray(lf),
            JConfig(**kw), lambda out: jnp.mean(out.image ** 2),
            sampling_rate=0.8)
    with pytest.raises(ValueError, match=match) as got:
        P.value_and_grad_blockwise(
            _t(vol), _t(tf), _t(lf), P.RenderConfig(**kw),
            lambda out: torch.mean(out.image ** 2), sampling_rate=0.8)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("shape", [(32, 32, 32), (512, 512, 512),
                                   (250, 256, 243), (2000, 2000, 1024)])
@pytest.mark.parametrize("analytic", [False, True])
def test_resolved_march_table_matches_jax(shape, analytic):
    kw = dict(volume_shape=shape, image_shape=(8, 8),
              analytic_normals=analytic)
    assert (P.RenderConfig(**kw).resolved_march_table()
            == JConfig(**kw).resolved_march_table())
