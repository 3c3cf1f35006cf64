"""Camera gradients of the torch port: ``d_look_from`` of ``render`` (the
plain march on the CPU, differentiated by autograd through the ray setup)
against ``jax.grad`` of the JAX package's ``render`` (default config,
``march_vjp='ad'``), a numpy mirror of kernel K2's camera instantiation
(its per-sample position cotangent and its 12 per-ray sums, mapped onto the
ray tensors) against autograd of the plain march, and ``Raycaster``'s
``camera_grads`` against ``torch_interop.TorchRaycaster``.

Tolerances.  ``d_look_from`` is a sum of many signed per-ray terms, and a
sample whose gradient is small carries large terms through the unit
normal's VJP (1/|g|) that the two packages sum in other orders: it is held
to JAX within 1e-3 * |d_look_from| at the oblique and behind cameras
(readings 5e-6 to 7e-5) and 5e-3 at the poles (readings 4.7e-4 to 3.0e-3).
The poles' gap comes from the box's kinks, where the two packages take
other subgradients.  The last sample of most rays sits on their exit face,
where ``voxel_coords`` clamps: the port (and K2) take the inside slope
there, JAX's ``jnp.clip`` half of it, and its default ``super64`` table a
central difference at a coordinate of 0.  Where a ray leaves through a face
the choice cancels (the exit moves with the camera, so the last sample
stays on the face); at a pole 16 rays on the image's diagonals leave
through an edge, where ``ray_aabb``'s two slab exits tie and split the
gradient, and it does not.  ``test_camera_grads_match_jax_inside`` moves
every exit 1e-3 of a step into the box in both packages and holds analytic
mode to JAX within 1e-4 at all four cameras (readings 1.3e-6 to 1.6e-5).
Parity mode there still differs at the poles by up to 3.7e-3, not traced
further: its stencil points fall on faces and integer coordinates (75 at a
pole), and under ``jit`` JAX rounds the ray setup an ulp off its eager
form, which the port's rays equal bitwise.  JAX's gradient is finite at
both poles (its pole guard picks the x hint by a ``where`` whose other
branch stays finite), and the test asserts it.  The mirror's per-sample
position cotangents are held to autograd's within 1e-4 of their largest,
the ray tensors' cotangents within 1e-4 of theirs.  From the repo root,
``PYTHONPATH=. python tests/test_torch_port_camera.py`` prints the
readings.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from differender_tpu import RenderConfig as JConfig
from differender_tpu import get_tf as j_get_tf
from differender_tpu import render as j_render
from differender_tpu.geometry import make_rays as j_make_rays
from differender_tpu.render import march_diff as j_march_diff
from differender_tpu.torch_interop import TorchRaycaster
import differender_tpu_torch as P
from differender_tpu_torch.render import march_diff_cotangents_plain, ray_sums
from differender_tpu_torch.sampling import voxel_scale

CAMERAS = {
    "oblique": (1.2, 0.8, 2.0),
    "pole+y": (0.0, 2.5, 0.0),
    "pole-y": (0.0, -2.5, 0.0),
    "behind": (-2.0, 0.3, -0.4),
}
CFG = dict(volume_shape=(20, 24, 28), image_shape=(16, 16),
           tf_resolution=32, max_samples=64)
CAMERA_TOL = {"oblique": 1e-3, "behind": 1e-3, "pole+y": 5e-3,
              "pole-y": 5e-3}
# The exit moved into the box by this share of a step, off the box's kinks.
INSET = 1e-3
INSIDE_TOL = 1e-4
MIRROR_TOL = 1e-4


@pytest.fixture(scope="module")
def noise():
    vol = np.random.default_rng(0).random((20, 24, 28), np.float32) * 0.5
    return vol, np.array(j_get_tf("tf1", 32))


@functools.lru_cache(maxsize=None)
def _jax_camera_grad(analytic, ert, inset):
    """One jitted ``jax.grad`` in ``look_from`` of JAX's ``render`` per
    mode, ERT and inset: volume, camera, weights and the jitter key are
    arguments.  With an ``inset`` every exit moves that share of a step into
    the box (``render``'s ray setup and march, the exit moved between)."""
    cfg = JConfig(**CFG, analytic_normals=analytic)

    def loss(v, t, lf, w, key):
        if not inset:
            return jnp.sum(j_render(v, t, lf, cfg, sampling_rate=1.0,
                                    key=key, ert=ert).image * w)
        rays = j_make_rays(lf, cfg, 1.0, jitter_key=key)
        n = jnp.maximum(rays.n_samples.astype(jnp.float32), 1.0)
        rays = rays._replace(exit=rays.exit
                             - inset * (rays.exit - rays.entry) / n)
        return jnp.sum(j_march_diff(v, t, rays, cfg, 1.0, 1.0,
                                    ert=ert)[0] * w)

    return jax.jit(jax.grad(loss, argnums=2))


def _camera_grads(vol, tf, cam, analytic, ert, inset=0.0):
    """``d_look_from`` of the port and of JAX at a camera, for the same
    image weights, with JAX's jitter draw injected as ``u`` (its
    ``u * len / n`` term is differentiated too)."""
    lf = np.array(CAMERAS[cam], np.float32)
    w = np.random.default_rng(1).random((16, 16, 4), np.float32) - 0.3
    key = jax.random.PRNGKey(7)
    want = np.asarray(_jax_camera_grad(analytic, ert, inset)(vol, tf, lf, w,
                                                             key))
    u = torch.from_numpy(np.array(jax.random.uniform(key, (16, 16),
                                                     jnp.float32)))
    cfg = P.RenderConfig(**CFG, analytic_normals=analytic)
    vol_t, tf_t = torch.from_numpy(vol), torch.from_numpy(tf)
    lf_t = torch.from_numpy(lf).requires_grad_()
    if inset:
        rays = P.make_rays(lf_t, cfg, 1.0, u=u)
        n = torch.clamp(rays.n_samples.to(torch.float32), min=1.0)
        rays = rays._replace(exit=rays.exit
                             - inset * (rays.exit - rays.entry) / n)
        img, _ = P.march_diff_plain(vol_t, tf_t, rays, cfg, 1.0, ert=ert)
    else:
        img = P.render(vol_t, tf_t, lf_t, cfg, 1.0, u=u, ert=ert).image
    torch.sum(img * torch.from_numpy(w)).backward()
    return lf_t.grad.numpy(), want


@pytest.mark.parametrize("ert", [False, True])
@pytest.mark.parametrize("analytic", [False, True])
@pytest.mark.parametrize("cam", list(CAMERAS))
def test_camera_grads_match_jax(noise, cam, analytic, ert):
    """The port's ``render`` gives ``look_from`` the gradient JAX's
    functional AD gives it, in parity and analytic mode."""
    got, want = _camera_grads(*noise, cam, analytic, ert)
    assert np.isfinite(want).all(), f"JAX's d_look_from at {cam}: {want}"
    norm = float(np.linalg.norm(want))
    assert norm > 0.0 and np.isfinite(got).all()
    assert np.abs(got - want).max() <= CAMERA_TOL[cam] * norm, (got, want)


@pytest.mark.parametrize("cam", list(CAMERAS))
def test_camera_grads_match_jax_inside(noise, cam):
    """Off the box's faces and edges, where the two packages take other
    subgradients, the port's ``d_look_from`` in analytic mode is JAX's
    within INSIDE_TOL at every camera, the poles included: the ray setup,
    its jitter term, and shading's light and view terms, which both modes
    share."""
    got, want = _camera_grads(*noise, cam, True, True, INSET)
    norm = float(np.linalg.norm(want))
    assert norm > 0.0 and np.isfinite(got).all()
    assert np.abs(got - want).max() <= INSIDE_TOL * norm, (got, want)


# -- a numpy mirror of K2's camera instantiation ------------------------------

def _axes(p, shape):
    """voxel_axis per axis: low and high indices, fractions, and
    coord_slope (0.5 * scale inside the clamp, bounds included)."""
    scale = voxel_scale(shape)
    u = np.float32(0.5) * p + np.float32(0.5)
    c = np.clip(u, 0, 1) * scale
    lo = np.floor(c)
    f = (c - lo).astype(np.float32)
    lo = lo.astype(np.int64)
    hi = np.minimum(lo + 1, np.asarray(shape) - 1)
    slope = np.where((u >= 0) & (u <= 1), np.float32(0.5) * scale,
                     np.float32(0)).astype(np.float32)
    return lo, hi, f, slope


def _corners(vol, lo, hi):
    """(M, 8) corner values, order i + 2j + 4k."""
    out = np.empty(lo.shape[:1] + (8,), np.float32)
    for k in range(8):
        ix, iy, iz = ((hi if (k >> ax) & 1 else lo)[:, ax] for ax in range(3))
        out[:, k] = vol[ix, iy, iz]
    return out


def _signs(k):
    return [1.0 if (k >> ax) & 1 else -1.0 for ax in range(3)]


def _derivatives(v, f):
    """cell_derivatives: the three in-cell derivatives, (M, 3)."""
    e = 1.0 - f
    d = np.zeros(f.shape, np.float32)
    for k in range(8):
        w = [f[:, ax] if (k >> ax) & 1 else e[:, ax] for ax in range(3)]
        s = _signs(k)
        d[:, 0] += s[0] * v[:, k] * (w[1] * w[2])
        d[:, 1] += s[1] * v[:, k] * (w[0] * w[2])
        d[:, 2] += s[2] * v[:, k] * (w[0] * w[1])
    return d


def _point_gradient(vol, p):
    """add_point_gradient: the trilinear interpolant's position gradient."""
    lo, hi, f, slope = _axes(p, vol.shape)
    return slope * _derivatives(_corners(vol, lo, hi), f)


def _mirror_d_pos(vol, pos, dv, dg, d_light, analytic, delta):
    """K2's position cotangent of each sample (add_position_cotangent plus
    shading's light term)."""
    out = d_light.copy()
    if analytic:
        lo, hi, f, slope = _axes(pos, vol.shape)
        v = _corners(vol, lo, hi)
        d = _derivatives(v, f)
        e = 1.0 - f
        mixed = np.zeros(pos.shape, np.float32)      # dxy, dxz, dyz
        for k in range(8):
            s = _signs(k)
            w = [f[:, ax] if (k >> ax) & 1 else e[:, ax] for ax in range(3)]
            mixed[:, 0] += s[0] * s[1] * v[:, k] * w[2]
            mixed[:, 1] += s[0] * s[2] * v[:, k] * w[1]
            mixed[:, 2] += s[1] * s[2] * v[:, k] * w[0]
        a = dg * (np.float32(delta) * voxel_scale(vol.shape))
        dxy, dxz, dyz = mixed.T
        out[:, 0] += slope[:, 0] * (dv * d[:, 0] + a[:, 1] * dxy
                                    + a[:, 2] * dxz)
        out[:, 1] += slope[:, 1] * (dv * d[:, 1] + a[:, 0] * dxy
                                    + a[:, 2] * dyz)
        out[:, 2] += slope[:, 2] * (dv * d[:, 2] + a[:, 0] * dxz
                                    + a[:, 1] * dyz)
        return out
    out += dv[:, None] * _point_gradient(vol, pos)
    for ax in range(3):
        off = np.zeros(3, np.float32)
        off[ax] = np.float32(delta)
        out += dg[:, ax:ax + 1] * (_point_gradient(vol, pos + off)
                                   - _point_gradient(vol, pos - off))
    return out


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("ert", [False, True])
@pytest.mark.parametrize("analytic", [False, True])
def test_k2_camera_mirror_matches_autograd(noise, analytic, ert):
    """Per sample, K2's position cotangent (mirrored in numpy from the
    sample's value and gradient cotangents and its light term) against
    autograd's; then K2's 12 per-ray sums P, S, L, V and their map onto the
    ray tensors, ``d_o = sum(P - L)``, ``d_d = t0 P + dt S + V``,
    ``d_t0 = d.P``, ``d_dt = d.S``, pulled through ``march_params``, against
    autograd of the plain march in the ray bundle's origin, directions,
    entry and exit."""
    vol, tf = noise
    cfg = P.RenderConfig(**CFG, analytic_normals=analytic)
    v, t = torch.from_numpy(vol), torch.from_numpy(tf)
    u = torch.from_numpy(np.random.default_rng(2).random((16, 16),
                                                         np.float32))
    base = P.make_rays(torch.tensor(CAMERAS["oblique"]), cfg, 1.0, u=u)
    g = torch.from_numpy(np.random.default_rng(3).random(
        (16, 16, 4), np.float32) - 0.3)

    leaves = [x.detach().clone().requires_grad_()
              for x in (base.origin, base.dirs, base.entry, base.exit)]
    rays = base._replace(origin=leaves[0], dirs=leaves[1], entry=leaves[2],
                         exit=leaves[3])
    image, _ = P.march_diff_plain(v, t, rays, cfg, 1.0, ert=ert)
    want = torch.autograd.grad(image, leaves, g)

    cot = march_diff_cotangents_plain(v, t, base, cfg, 1.0, g, ert=ert)
    d_pos = _mirror_d_pos(vol, cot.pos.numpy(), cot.d_value.numpy(),
                          cot.d_grad.numpy(), cot.d_light.numpy(), analytic,
                          cfg.normal_delta)
    _close(d_pos, cot.d_pos, MIRROR_TOL)

    n_rays = 16 * 16
    sums = np.zeros((n_rays, 12), np.float32)
    s = cot.s.numpy().astype(np.float32)[:, None]
    np.add.at(sums, cot.ray.numpy(),
              np.concatenate([d_pos, s * d_pos, cot.d_light.numpy(),
                              cot.d_view.numpy()], -1))
    _close(sums, ray_sums(cot, (16, 16)).reshape(n_rays, 12), MIRROR_TOL)
    Pm, Sm, Lm, Vm = np.split(sums, 4, axis=-1)
    prm = P.march_params(rays)
    dirs = rays.dirs.detach().reshape(-1, 3).numpy()
    t0 = prm.t0.detach().reshape(-1, 1).numpy()
    dt = prm.dt.detach().reshape(-1, 1).numpy()
    d_o = (Pm - Lm).sum(0)
    d_d = t0 * Pm + dt * Sm + Vm
    d_t0 = (dirs * Pm).sum(-1)
    d_dt = (dirs * Sm).sum(-1)
    got_entry, got_exit = torch.autograd.grad(
        (prm.t0, prm.dt), leaves[2:],
        (torch.from_numpy(d_t0).reshape(16, 16),
         torch.from_numpy(d_dt).reshape(16, 16)), allow_unused=True)
    _close(d_o, want[0], MIRROR_TOL)
    _close(d_d.reshape(16, 16, 3), want[1], MIRROR_TOL)
    _close(got_entry, want[2], MIRROR_TOL)
    _close(got_exit, want[3], MIRROR_TOL)
    # The wrapper's own map gives the same cotangents.
    d_o2, d_d2, d_t02, d_dt2 = P.ray_cotangents(
        torch.from_numpy(sums), torch.from_numpy(dirs),
        torch.from_numpy(t0[:, 0]), torch.from_numpy(dt[:, 0]))
    for a, b in ((d_o2, d_o), (d_d2, d_d), (d_t02, d_t0), (d_dt2, d_dt)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-6)


# -- Raycaster against torch_interop.TorchRaycaster ---------------------------

RC_SHAPE = (20, 24, 28)       # (D, H, W)
RC_OUT = (10, 12)             # (W, H)
RC_KW = dict(sampling_rate=1.0, jitter=False, max_samples=32)


@pytest.mark.parametrize("batched", [False, True])
def test_raycaster_camera_grads_match_torch_interop(batched):
    """With ``camera_grads=True`` both modules give the camera the same
    gradient (a camera broadcast over a batch: the sum over its views);
    without it the port's ``look_from.grad`` stays None (as
    TorchRaycaster's does, test_torch_port_grads.py)."""
    rng = np.random.default_rng(11)
    vol = rng.random((2, 1) + RC_SHAPE, np.float32) * 0.5
    if not batched:
        vol = vol[0]
    tf = np.asarray(P.get_tf_torch_layout("tf1", 16, device="cpu"))
    lf = np.array([1.2, 0.8, 2.0], np.float32)
    w = torch.from_numpy(
        rng.random(vol.shape[:-4] + (4, RC_OUT[1], RC_OUT[0]), np.float32))
    grads = []
    for rc in (TorchRaycaster(RC_SHAPE, RC_OUT, 16, camera_grads=True,
                              **RC_KW),
               P.Raycaster(RC_SHAPE, RC_OUT, 16, device="cpu",
                           camera_grads=True, **RC_KW),
               P.Raycaster(RC_SHAPE, RC_OUT, 16, device="cpu", **RC_KW)):
        lf_t = torch.from_numpy(lf.copy()).requires_grad_()
        img = rc(torch.from_numpy(vol).requires_grad_(),
                 torch.from_numpy(tf.copy()), lf_t)
        torch.sum(img * w).backward()
        grads.append(lf_t.grad)
    want, got, none = grads
    assert none is None
    want, got = want.numpy(), got.numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-3 * np.linalg.norm(want), (got,
                                                                     want)


if __name__ == "__main__":
    # The readings the tolerances above were set from: max |port - JAX| /
    # |JAX's d_look_from| per camera, mode and ERT, as the tests compute
    # them and with the exits moved inside.
    jax.config.update("jax_platforms", "cpu")
    rng = np.random.default_rng(0)
    data = (rng.random((20, 24, 28), np.float32) * 0.5,
            np.array(j_get_tf("tf1", 32)))
    for inset in (0.0, INSET):
        for cam in CAMERAS:
            for analytic in (False, True):
                for ert in (False, True):
                    got, want = _camera_grads(*data, cam, analytic, ert,
                                              inset)
                    err = np.abs(got - want).max() / np.linalg.norm(want)
                    print(f"inset={inset} {cam} analytic={analytic} "
                          f"ert={ert}: {err:.3e}")
