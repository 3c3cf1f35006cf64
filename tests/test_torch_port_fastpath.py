"""The port's shear-warp fast path (``differender_tpu_torch.fastpath``) and
the dot-form mask of the TF-lookup backward, against the JAX package's
``differender_tpu.fastpath``.

On CPU tensors ``render_fast`` classifies through the plain versions of K0
and K0b, so it equals ``render_fast_plain`` bit for bit.  The JAX package
is run at ``Precision.HIGHEST`` (f32 products on the CPU).

Image tolerances.  The port computes the JAX package's operations in the
same order and rounds each once, so against the JAX package's functions
run one operation at a time (:func:`_jax_op_by_op`, under
``jax.disable_jit``) it is held to 1e-5 (readings 6.0e-7 to 3.2e-6 over
the six views of ``test_render_fast_matches_jax``, 9.5e-7 at the golden
setup).  The JAX package's ``render_fast`` compiled as one program is
another rounding of the same sums: XLA turns divisions by constants into
reciprocal products and fuses multiply-adds, and the image is sensitive to
an ulp of the slab plane positions with these narrow-band TFs.  That
program differs from its own functions run op by op by up to 5.0e-5 at
those views and by 6.1e-5 at the golden setup, whose fixture it wrote; the
port is held to it, and to the fixture, within 1e-4 (readings up to 5.1e-5
and 6.1e-5); ``PYTHONPATH=.:tests python
tests/test_torch_port_fastpath.py`` prints these readings.  Gradients:
``2e-3 * max|g|``, as for the exact path.  The policy,
``Raycaster.raycast_fast`` and the gradient at infinite slopes are in
tests/test_torch_port_fastpath_api.py.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import make_sphere_volume
from differender_tpu import RenderConfig as JConfig
from differender_tpu import get_tf as j_get_tf
import differender_tpu.fastpath as JF
from differender_tpu.sampling import _apply_tf_dot_bwd
import differender_tpu_torch as P
from differender_tpu_torch import fastpath as F

HIGHEST = jax.lax.Precision.HIGHEST
FAST_TOL = 1e-5                 # against the JAX package op by op
COMPILED_TOL = 1e-4             # against its compiled program and fixture
GRAD_TOL = 2e-3
GOLDEN = os.path.join(os.path.dirname(__file__), "golden_renders.npz")
VIEWS = {                       # principal axis and side of the camera
    "+z": (1.3, 0.7, 2.1), "-z": (-1.2, 0.6, -2.0),
    "+x": (2.3, 0.5, -0.8), "-x": (-2.3, 0.5, 0.8),
    "+y": (0.4, 2.4, 0.7), "-y": (0.4, -2.4, 0.7),
}


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


def _jax_op_by_op(vol, tf, lf, cfg, O, ppv, slab_batch=2):
    """The JAX package's render_fast composed from its own functions, each
    JAX operation run on its own (``jax.disable_jit``: no compiled program,
    the slab scan included)."""
    with jax.disable_jit():
        return _jax_composed(vol, tf, lf, cfg, O, ppv, slab_batch)


def _jax_composed(vol, tf, lf, cfg, O, ppv, slab_batch):
    channels = JF.intensity_gradient_volume(jnp.asarray(vol))
    perm = JF._PERMS[int(np.argmax(np.abs(lf)))]
    ch = jnp.transpose(channels, (0,) + tuple(a + 1 for a in perm))
    ch = jnp.concatenate([ch[:1], ch[1 + np.asarray(perm)]], axis=0)
    flip = lf[perm[2]] > 0
    sign = np.float32(-1.0 if flip else 1.0)
    ch = (jnp.flip(ch, axis=3) if flip else ch).at[3].multiply(sign)
    fv = np.array([1.0, 1.0, sign], np.float32)
    light = (lf + np.array([0, 1, 0], np.float32))[np.asarray(perm)] * fv
    inter, ext = JF._core(ch, jnp.asarray(tf),
                          jnp.asarray(lf[list(perm)] * fv),
                          jnp.asarray(light), cfg, O, ppv, precision=HIGHEST,
                          slab_batch=slab_batch)
    return np.asarray(JF._warp_to_image(inter, ext, jnp.asarray(lf), cfg,
                                        perm, fv)[0])


def test_intensity_gradient_volume_matches_jax(sphere):
    vol = sphere[0][:, :20, :27]
    np.testing.assert_array_equal(
        F.intensity_gradient_volume(_t(vol)).numpy(),
        np.asarray(JF.intensity_gradient_volume(jnp.asarray(vol))))


@pytest.mark.parametrize("view", list(VIEWS))
def test_render_fast_matches_jax(sphere, view):
    """All three principal axes, both sides: the image within 1e-5 of the
    JAX package's functions op by op and within 1e-4 of its compiled
    render_fast, and ``hit`` equal."""
    vol, tf = sphere
    lf = np.array(VIEWS[view], np.float32)
    jcfg, cfg = _cfgs(vol)
    want = JF.render_fast(vol, tf, lf, jcfg, intermediate=40,
                          planes_per_voxel=2.0, precision=HIGHEST)
    got = P.render_fast(_t(vol), _t(tf), _t(lf), cfg, intermediate=40,
                        planes_per_voxel=2.0)
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(want.hit))
    np.testing.assert_allclose(got.image.numpy(), np.asarray(want.image),
                               rtol=0, atol=COMPILED_TOL)
    np.testing.assert_allclose(got.image.numpy(),
                               _jax_op_by_op(vol, tf, lf, jcfg, 40, 2.0),
                               rtol=0, atol=FAST_TOL)
    assert float(got.image[..., 3].max()) > 0.05


def test_golden_shearwarp():
    """The JAX package's shear-warp fixture (tests/test_golden.py's setup,
    O = 32, 2 planes per voxel), written by its compiled program: within
    1e-4 of it, and within 1e-5 of the JAX package's functions op by op at
    the same setup (which are 6.1e-5 from the fixture themselves)."""
    vol = make_sphere_volume()
    tf = np.asarray(j_get_tf("tf1", 32))
    lf = np.array([1.2, 0.8, 2.0], np.float32)
    jcfg, cfg = _cfgs(vol, max_samples=64, block_size=16)
    img = P.render_fast(_t(vol), _t(tf), _t(lf), cfg, intermediate=32,
                        planes_per_voxel=2.0).image.numpy()
    np.testing.assert_allclose(img, np.load(GOLDEN)["shearwarp"], rtol=0,
                               atol=COMPILED_TOL)
    np.testing.assert_allclose(img, _jax_op_by_op(vol, tf, lf, jcfg, 32,
                                                  2.0),
                               rtol=0, atol=FAST_TOL)


def test_slab_batches_agree():
    """Padding slabs are exact no-ops, also for a TF with alpha at
    intensity 0 and a camera whose padding planes re-enter the footprint
    (tests/test_fastpath.py's case): batches 1, 2 and 4 give one image,
    within an ulp of each other (the chunks' tensors have other lengths,
    which PyTorch's CPU kernels round differently at their tails).  This TF
    lays fog where the volume is flat, whose normals are the direction of a
    gradient at rounding level: no other program's rounding is comparable
    there, so the JAX package is not the reference of this test."""
    vol = make_sphere_volume()
    tfb = np.asarray(j_get_tf("black", 32))
    lf = np.array([1.2, 0.8, -2.0], np.float32)
    _, cfg = _cfgs(vol)
    ppv = 63 / 32.0              # an odd slab count: padding at batch > 1
    imgs = [P.render_fast(_t(vol), _t(tfb), _t(lf), cfg, intermediate=32,
                          planes_per_voxel=ppv, slab_batch=b).image
            for b in (1, 2, 4)]
    for img in imgs[1:]:
        torch.testing.assert_close(img, imgs[0], rtol=0, atol=1e-6)
    assert float(imgs[0][..., 3].max()) > 0.0


def test_render_fast_is_plain_on_cpu(sphere):
    """On CPU tensors the wrapper's classify is the plain one: render_fast
    and render_fast_plain agree bit for bit, forward and backward, and no
    kernel is launched."""
    vol, tf = sphere
    _, cfg = _cfgs(vol)
    lf = _t(np.array([-2.3, 0.5, 0.8], np.float32))
    P.reset_launch_counts()
    outs = []
    for fn in (P.render_fast, P.render_fast_plain):
        v, t = _t(vol).requires_grad_(True), _t(tf).requires_grad_(True)
        img = fn(v, t, lf, cfg, intermediate=32, planes_per_voxel=2.0).image
        torch.sum(img ** 2).backward()
        outs.append((img.detach(), v.grad, t.grad))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert set(P.launch_counts().values()) == {0}


def test_precision_flags_leave_the_image(sphere):
    """No product of the fast path goes through a matrix multiply: the
    ``precision`` argument and PyTorch's TF32 settings change nothing."""
    vol, tf = sphere
    _, cfg = _cfgs(vol)
    lf = _t(np.array([1.3, 0.7, 2.1], np.float32))
    ref = P.render_fast(_t(vol), _t(tf), lf, cfg, intermediate=32).image
    old = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("medium")
        img = P.render_fast(_t(vol), _t(tf), lf, cfg, intermediate=32,
                            precision="default").image
    finally:
        torch.set_float32_matmul_precision(old)
    assert torch.equal(img, ref)


def _grad_check(vol, tf, lf, jcfg, cfg, ppv, seed):
    w = np.random.default_rng(seed).random(cfg.image_shape + (4,),
                                           np.float32) - 0.3
    want = jax.grad(lambda v, t: jnp.sum(JF.render_fast(
        v, t, lf, jcfg, intermediate=24, planes_per_voxel=ppv,
        precision=HIGHEST).image * w), argnums=(0, 1))(
            jnp.asarray(vol), jnp.asarray(tf))
    v, t = _t(vol).requires_grad_(True), _t(tf).requires_grad_(True)
    img = P.render_fast(v, t, _t(lf), cfg, intermediate=24,
                        planes_per_voxel=ppv).image
    torch.sum(img * _t(w)).backward()
    return [(g.numpy(), np.asarray(r)) for g, r in zip((v.grad, t.grad),
                                                       want)]


@pytest.mark.parametrize("view", ["-x", "+y"])
def test_render_fast_grads_match_jax(sphere, view):
    vol, tf = sphere
    jcfg, cfg = _cfgs(vol, hw=(12, 12))
    for got, want in _grad_check(vol, tf, np.array(VIEWS[view], np.float32),
                                 jcfg, cfg, 2.0, seed=1):
        assert np.isfinite(got).all()
        scale = float(np.abs(want).max())
        assert scale > 0.0
        np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_TOL * scale)


def test_dot_mask_matches_jax():
    """The dot-form mask of the TF-lookup backward (K0b's ``mask="dot"``,
    its plain version here) against the JAX package's ``_apply_tf_dot_bwd``,
    with intensities on integer t (quantised data) and between; the
    Pallas mask keeps the slope at interior integer t, the dot form does
    not."""
    R = 32
    rng = np.random.default_rng(0)
    tf = rng.random((R, 4), np.float32)
    x = np.concatenate([np.arange(R, dtype=np.float32) / np.float32(R - 1),
                        rng.random(200, np.float32),
                        np.array([-0.2, 1.3], np.float32)])
    g = rng.standard_normal((x.size, 4)).astype(np.float32)
    want_tf, want_x = _apply_tf_dot_bwd(HIGHEST, (jnp.asarray(tf),
                                                  jnp.asarray(x)),
                                        jnp.asarray(g))
    got_tf, got_x = P.tf_lookup_bwd(_t(tf), _t(x), _t(g), mask="dot")
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_tf.numpy(), np.asarray(want_tf),
                               rtol=1e-5, atol=1e-5)
    on_grid = slice(1, R - 1)
    assert not got_x[on_grid].any()
    _, pallas_x = P.tf_lookup_bwd(_t(tf), _t(x), _t(g))
    assert pallas_x[on_grid].all()
    xt = _t(x).requires_grad_(True)
    P.tf_lookup(_t(tf), xt, mask="dot").backward(_t(g))
    assert torch.equal(xt.grad, got_x)
    with pytest.raises(ValueError, match="mask"):
        P.tf_lookup(_t(tf), xt, mask="bogus")


def test_render_fast_empty_and_misses(sphere):
    """An empty volume under a TF of zero renders black; rays that miss
    the volume are 0 (tests/test_fastpath.py's cases)."""
    vol, tf = sphere
    _, cfg = _cfgs(vol, hw=(32, 32))
    out = P.render_fast(torch.zeros(vol.shape), torch.zeros((32, 4)),
                        _t(np.array([1.3, 0.7, 2.1], np.float32)), cfg,
                        intermediate=48)
    assert float(out.image.abs().max()) == 0.0
    out = P.render_fast(_t(vol), _t(tf),
                        _t(np.array([0.0, 0.3, 1.8], np.float32)),
                        cfg.replace(fov=60.0), intermediate=48)
    assert (~out.hit).any()
    assert float(out.image[~out.hit].abs().max()) == 0.0


if __name__ == "__main__":
    # The readings the image tolerances above were set from: max |port -
    # JAX| against the JAX package's functions op by op and its compiled
    # render_fast at each view, and against the golden fixture.
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    vol = make_sphere_volume()
    tf = np.asarray(j_get_tf("tf5", 32))
    jcfg, cfg = _cfgs(vol)
    for view, cam in VIEWS.items():
        lf = np.array(cam, np.float32)
        got = P.render_fast(_t(vol), _t(tf), _t(lf), cfg, intermediate=40,
                            planes_per_voxel=2.0).image.numpy()
        compiled = np.asarray(JF.render_fast(
            vol, tf, lf, jcfg, intermediate=40, planes_per_voxel=2.0,
            precision=HIGHEST).image)
        op_by_op = _jax_op_by_op(vol, tf, lf, jcfg, 40, 2.0)
        print(f"{view}: op by op {np.abs(got - op_by_op).max():.3e}, "
              f"compiled {np.abs(got - compiled).max():.3e}, compiled - op "
              f"by op {np.abs(compiled - op_by_op).max():.3e}")
    tf = np.asarray(j_get_tf("tf1", 32))
    lf = np.array([1.2, 0.8, 2.0], np.float32)
    jcfg, cfg = _cfgs(vol, max_samples=64, block_size=16)
    got = P.render_fast(_t(vol), _t(tf), _t(lf), cfg, intermediate=32,
                        planes_per_voxel=2.0).image.numpy()
    golden = np.load(GOLDEN)["shearwarp"]
    op_by_op = _jax_op_by_op(vol, tf, lf, jcfg, 32, 2.0)
    print(f"golden setup: fixture {np.abs(got - golden).max():.3e}, op by "
          f"op {np.abs(got - op_by_op).max():.3e}, op by op - fixture "
          f"{np.abs(op_by_op - golden).max():.3e}")
