"""The plain reference agrees with the port's plain CPU path at 32^3 and
16^2 (here only: the reference itself imports nothing of the port)."""
import pytest
import torch

import differender_tpu_torch as P
from dvrbench import harness, inputs
from dvrbench.reference import dvr, fit

N, H = 32, 16


def _scene(traffic, seed, corrupt=False):
    gen = inputs.generator(seed, 0, "cpu")
    v = inputs.volume(harness.traffic(traffic), N, gen)
    return inputs.corrupt(v, 0.05, gen) if corrupt else v


def _cfg(name, **kw):
    return dict(harness.config(name), volume=[N, N, N], image=[H, H], **kw)


def _poses(seed, n):
    g = inputs.generator(seed, 1, "cpu")
    return (torch.cat([inputs.orbit(0.3, 0.7, 2.5, "cpu")[None],
                       inputs.random_poses(g, n - 1, 2.7)]),
            torch.rand((n, H, H), generator=g))


def _rc(cfg, **kw):
    return P.Raycaster((N, N, N), (H, H), 128, fov=cfg["fov"],
                       near=cfg["near"], device="cpu", **kw)


@pytest.mark.parametrize("traffic", ["ct_head", "dense_sim"])
@pytest.mark.parametrize("sr", [8.0, 16.0])
def test_inference_march_matches_the_port(traffic, sr):
    cfg = _cfg("viewer_800")
    vol = _scene(traffic, 3)
    tf = inputs.transfer_function("tf1", 128, "cpu")
    lfs, _ = _poses(3, 3)
    got = _rc(cfg, jitter=False).raycast_nondiff(vol[None], tf, lfs, sr)
    want = dvr.render_views(vol, tf, lfs, H, H, sr,
                            dvr.Optics.from_config(cfg), diff=False)
    assert float((got - want).abs().max()) < 2e-6


@pytest.mark.parametrize("traffic", ["ct_head", "dense_sim"])
def test_differentiable_march_and_its_gradient_match_the_port(traffic):
    cfg = _cfg("volfit_256")
    vol = _scene(traffic, 4, corrupt=True)
    tf = inputs.transfer_function("tf1", 128, "cpu")
    lfs, u = _poses(4, 3)
    leaf = vol[None].clone().requires_grad_(True)
    got = _rc(cfg, max_samples=1024)(leaf, tf, lfs, u=u)
    optics = dvr.Optics.from_config(cfg)
    want = dvr.render_views(vol, tf, lfs, H, H, 1.0, optics, diff=True,
                            max_samples=1024, u=u)
    assert float((got - want).abs().max()) < 1e-5
    cot = torch.rand_like(want) - 0.3
    (got * cot).sum().backward()
    g = dvr.volume_vjp(vol, tf, lfs, H, H, 1.0, optics, 1024, u, cot,
                       rays_per_block=200)
    assert float((g - leaf.grad[0]).abs().max()) \
        < 1e-4 * float(leaf.grad.abs().max())


def test_loss_matches_the_port():
    torch.manual_seed(0)
    a = torch.rand(4, 4, H, H, requires_grad=True)
    b = torch.rand(4, 4, H, H)
    a2 = a.detach().clone().requires_grad_(True)
    lp = P.dssim_mse_loss(a, b)
    lr = fit.dssim_mse(a2, b)
    lp.backward()
    lr.backward()
    assert abs(float(lp) - float(lr)) < 1e-6
    assert float((a.grad - a2.grad).abs().max()) < 1e-8


def test_schedule_and_adamw_match_torch():
    cfg = harness.config("volfit_256")
    p = torch.rand(50, requires_grad=True)
    q = p.detach().clone()
    opt, sched = P.adamw_onecycle([p], max_lr=cfg["max_lr"],
                                  total_steps=cfg["total_steps"])
    ref = fit.AdamW()
    for k in range(6):
        g = torch.randn(50)
        p.grad = g.clone()
        opt.step()
        sched.step()
        lr = fit.one_cycle_lr(k, cfg["max_lr"], cfg["total_steps"],
                              cfg["pct_start"], cfg["div_factor"],
                              cfg["final_div_factor"])
        ref.step(q, g, lr)
        assert float((p.detach() - q).abs().max()) < 1e-9


@pytest.mark.parametrize("skip", [0.0, 1e-3])
def test_transparent_bricks_hold_no_visible_sample(skip):
    tf = inputs.transfer_function("tf1", 128, "cpu").t().contiguous()
    vol = dvr.internal(_scene("ct_head", 6))
    pos = torch.rand((200000, 3), generator=torch.Generator().manual_seed(1)
                     ) * 2.0 - 1.0
    empty = dvr.transparent_bricks(vol, tf, skip)
    alpha = dvr.tf_lookup(tf, dvr.trilinear(vol, pos))[:, 3]
    in_empty = empty.reshape(-1)[dvr.brick_of(pos, vol.shape)]
    assert bool(in_empty.any()) and bool((~in_empty).any())
    assert not bool((in_empty & (alpha > skip)).any())
