"""The torch port's losses, optimizers and camera helpers against the JAX
package, and a few volume-fitting steps on the CPU (the loop of
examples/optimize_volume.py at a tiny size)."""
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from differender_tpu import losses as jl
from differender_tpu import optim as jo
from differender_tpu.utils import camera as jcam
import differender_tpu_torch as P


def _images(seed, shape=(2, 4, 24, 20)):
    rng = np.random.default_rng(seed)
    pred = rng.random(shape, np.float32)
    target = np.clip(pred + 0.1 * rng.normal(size=shape), 0, 1)
    return pred, target.astype(np.float32)


@pytest.mark.parametrize("name", ["mse_loss", "ssim", "dssim_mse_loss"])
def test_losses_and_grads_match_jax(name):
    pred, target = _images(1)
    want, want_g = jax.value_and_grad(getattr(jl, name))(
        jnp.asarray(pred), jnp.asarray(target))
    pt = torch.from_numpy(pred).requires_grad_()
    got = getattr(P, name)(pt, torch.from_numpy(target))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5,
                               atol=1e-6)
    scale = float(np.abs(np.asarray(want_g)).max())
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(want_g),
                               atol=1e-4 * scale)


def test_ssim_shapes_and_identity():
    pred, _ = _images(2, (3, 16, 16))
    p = torch.from_numpy(pred)
    assert abs(float(P.ssim(p, p)) - 1.0) < 1e-5
    per = P.ssim(torch.stack([p, p]), torch.stack([p, 1 - p]),
                 size_average=False)
    assert per.shape == (2,) and float(per[1]) < float(per[0])


def _one_update(j_opt, make_p_opt, seed, sched_step=False):
    rng = np.random.default_rng(seed)
    p0 = rng.random((5, 4), np.float32)
    g = (rng.random((5, 4), np.float32) - 0.5) * 0.5
    state = j_opt.init(jnp.asarray(p0))
    upd, _ = j_opt.update(jnp.asarray(g), state, jnp.asarray(p0))
    want = np.asarray(optax.apply_updates(jnp.asarray(p0), upd))
    p = torch.from_numpy(p0.copy()).requires_grad_()
    opt = make_p_opt(p)
    p.grad = torch.from_numpy(g)
    if sched_step:
        opt, sched = opt
        opt.step()
        sched.step()
    else:
        opt.step()
    return p.detach().numpy(), want


def test_tf_momentum_one_update():
    got, want = _one_update(jo.tf_momentum(lr=0.3, gamma=0.8, max_grad=0.1),
                            lambda p: P.tf_momentum([p], lr=0.3, gamma=0.8,
                                                    max_grad=0.1), 3)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_adamw_onecycle_one_update():
    got, want = _one_update(jo.adamw_onecycle(0.05, 20, weight_decay=0.01),
                            lambda p: P.adamw_onecycle([p], 0.05, 20,
                                                       weight_decay=0.01),
                            4, sched_step=True)
    np.testing.assert_allclose(got, want, atol=1e-6)
    with pytest.raises(ValueError):
        P.adamw_onecycle([torch.zeros(2, requires_grad=True)], 0.1, 3)


def test_projections_and_nan_scrub():
    x = torch.tensor([-0.5, 0.2, 1.7])
    y = x.clone()
    P.project_nonneg(x)
    P.project_unit([y])
    np.testing.assert_array_equal(
        x.numpy(), np.asarray(jo.project_nonneg(jnp.array([-0.5, 0.2, 1.7]))))
    np.testing.assert_array_equal(
        y.numpy(), np.asarray(jo.project_unit(jnp.array([-0.5, 0.2, 1.7]))))
    bad = torch.tensor([np.nan, np.inf, 1.0])
    got = P.nan_to_num_grads({"v": bad, "t": (bad, bad)})
    want = np.asarray(jo.nan_to_num_grads(jnp.asarray(bad.numpy())))
    np.testing.assert_array_equal(got["v"].numpy(), want)
    assert isinstance(got["t"], tuple)


def test_cameras():
    i = np.array([0.0, 0.7, 2.5, -1.2], np.float32)
    np.testing.assert_allclose(P.in_circles(torch.from_numpy(i)).numpy(),
                               np.asarray(jcam.in_circles(i)), atol=1e-6)
    np.testing.assert_allclose(P.in_circles(0.3, y=0.1, dist=3.0).numpy(),
                               np.asarray(jcam.in_circles(0.3, 0.1, 3.0)),
                               atol=1e-6)
    a = P.get_rand_pos(torch.Generator().manual_seed(4), 5)
    b = P.get_rand_pos(torch.Generator().manual_seed(4), 5)
    assert a.shape == (5, 3) and torch.equal(a, b)
    np.testing.assert_allclose(torch.linalg.vector_norm(a, dim=-1).numpy(),
                               2.7, rtol=1e-6)
    assert P.get_rand_pos(torch.Generator().manual_seed(0)).shape == (3,)


def test_volume_fitting_steps_lower_the_loss():
    """examples/optimize_volume.py's step at 16^3/16^2: targets from the
    inference render of the clean volume, dssim+mse, AdamW + OneCycle,
    projection to [0, 1]."""
    res, img = 16, 16
    xs = np.linspace(-1, 1, res, dtype=np.float32)
    g = np.meshgrid(xs, xs, xs, indexing="ij")
    r = np.sqrt(sum(x * x for x in g))
    clean = (1.0 / (1.0 + np.exp((r - 0.55) * 14.0))).astype(np.float32)
    rng = np.random.default_rng(0)
    vol = clean.copy()
    mask = rng.random(vol.shape) < 0.05
    vol[mask] = rng.random(int(mask.sum()), dtype=np.float32)
    rc = P.Raycaster((res,) * 3, (img, img), 32, max_samples=64,
                     jitter=False, device="cpu")
    tf = P.get_tf_torch_layout("tf1", 32, device="cpu")
    views = torch.stack([P.in_circles(0.0),
                         P.get_rand_pos(torch.Generator().manual_seed(1))])
    targets = rc.raycast_nondiff(torch.from_numpy(clean)[None, None]
                                 .expand(2, 1, res, res, res), tf, views)
    v = torch.from_numpy(vol)[None].requires_grad_()
    opt, sched = P.adamw_onecycle([v], 0.05, 5)
    losses = []
    for _ in range(5):
        opt.zero_grad()
        loss = P.dssim_mse_loss(rc(v.expand(2, 1, res, res, res), tf, views),
                                targets)
        loss.backward()
        assert bool(torch.isfinite(v.grad).all())
        opt.step()
        sched.step()
        P.project_unit(v)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
