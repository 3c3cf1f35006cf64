"""Ray setup's constant vectors (``geometry._constant``): made once per
device and values, then reused, with every output bitwise what a fresh
``torch.tensor`` per call gives.

On the CPU: ``make_rays`` against a local copy of the construction that
makes the four vectors anew in every call (default and other boxes, a
camera on the y axis, jitter), renders and gradients under both, the
cache keyed on values, the ``dr.sync`` spans of a first and a second call,
and a first call under ``inference_mode`` before a graph that saves the
vectors.  The tests marked ``card`` run a warmed fitting step and a viewer
frame under ``torch.cuda.set_sync_debug_mode("error")``; they skip without
a card.  This file imports no JAX, so on the card's machine it runs
without the suite's ``conftest.py``::

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_port_ray_setup.py
"""
import contextlib

import numpy as np
import pytest
import torch

import differender_tpu_torch as P
from differender_tpu_torch import geometry as G
from differender_tpu_torch import profiling as PPR
from differender_tpu_torch.config import RenderConfig

CFG = dict(volume_shape=(10, 12, 14), image_shape=(9, 11), max_samples=32)
CAMERAS = {
    "oblique": (1.2, 0.8, 2.0),
    "pole+y": (0.0, 2.5, 0.0),        # takes alt_up
    "behind": (-2.0, 0.3, -0.4),
}
BOXES = {
    "default": ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)),
    "other": ((-0.7, -1.0, -0.3), (0.9, 0.55, 1.0)),
}


# -- the construction this cache replaced: four fresh tensors a call ----------

def _fresh_ray_directions(look_from, config):
    H, W = config.image_shape
    dev = look_from.device
    look_from = look_from.to(torch.float32)
    view_dir = G.normalize(look_from * -1.0)
    x = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5) / W
    y = 1.0 - (torch.arange(H, dtype=torch.float32, device=dev) + 0.5) / H
    u = x - 0.5
    v = y - 0.5
    world_up = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=dev)
    alt_up = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float32, device=dev)
    right_raw = torch.linalg.cross(view_dir, world_up)
    degenerate = torch.sum(right_raw * right_raw) < 1e-12
    right_raw = torch.where(degenerate, torch.linalg.cross(view_dir, alt_up),
                            right_raw)
    right = G.normalize(right_raw)
    up = G.normalize(torch.linalg.cross(right, view_dir))
    near_h = (np.float32(2.0) * np.tan(np.float32(config.fov_rad))
              * np.float32(config.near))
    near_w = float(near_h * np.float32(config.aspect))
    near_h = float(near_h)
    offset = (config.near * view_dir[None, None, :]
              + (u * near_w)[None, :, None] * right[None, None, :]
              + (v * near_h)[:, None, None] * up[None, None, :])
    return G.normalize(offset)


def _fresh_ray_aabb(origin, dirs, box_min, box_max):
    box_min = torch.tensor(box_min, dtype=torch.float32, device=dirs.device)
    box_max = torch.tensor(box_max, dtype=torch.float32, device=dirs.device)
    dirfrac = 1.0 / dirs
    t_lo = (box_min - origin) * dirfrac
    t_hi = (box_max - origin) * dirfrac
    tmin = torch.amax(torch.minimum(t_lo, t_hi), dim=-1)
    tmax = torch.amin(torch.maximum(t_lo, t_hi), dim=-1)
    hit = ~((tmax < 0.0) | (tmin > tmax))
    hit = hit & torch.isfinite(tmin) & torch.isfinite(tmax)
    return tmin, tmax, hit


@contextlib.contextmanager
def _fresh_vectors():
    """``make_rays`` and every renderer with the fresh construction."""
    mp = pytest.MonkeyPatch()
    mp.setattr(G, "ray_directions", _fresh_ray_directions)
    mp.setattr(G, "ray_aabb", _fresh_ray_aabb)
    try:
        yield
    finally:
        mp.undo()


def _bitwise(a, b):
    """Equal bit for bit (NaNs and signed zeros included)."""
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == torch.float32:
        a, b = (t.contiguous().view(torch.int32) for t in (a, b))
    assert torch.equal(a, b)


def _u(seed=5, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    return torch.rand(CFG["image_shape"], generator=gen).to(device)


def _make_rays(cam, box, jitter, device="cpu"):
    lf = torch.tensor(CAMERAS[cam], device=device)
    return G.make_rays(lf, RenderConfig(**CFG), 1.3,
                       u=_u(device=device) if jitter else None,
                       box_min=BOXES[box][0], box_max=BOXES[box][1])


def _assert_rays_equal(got, want):
    for a, b in zip(got, want):
        _bitwise(a, b)
    for a, b in zip(G.march_params(got), G.march_params(want)):
        _bitwise(a, b)


CASES = [("oblique", "default", False), ("oblique", "other", False),
         ("pole+y", "default", False), ("pole+y", "other", True),
         ("behind", "default", True), ("oblique", "other", True)]


@pytest.mark.parametrize("cam,box,jitter", CASES)
def test_make_rays_bitwise_fresh_construction(cam, box, jitter):
    G._constant_of.cache_clear()
    first = _make_rays(cam, box, jitter)      # fills the cache
    again = _make_rays(cam, box, jitter)      # reads it
    with _fresh_vectors():
        want = _make_rays(cam, box, jitter)
    _assert_rays_equal(first, want)
    _assert_rays_equal(again, want)


def test_pole_camera_takes_the_alt_up_branch():
    cfg = RenderConfig(**CFG)
    dirs = G.ray_directions(torch.tensor(CAMERAS["pole+y"]), cfg)
    assert torch.isfinite(dirs).all()
    # Without the fallback the right vector is 0/0.
    view_dir = G.normalize(torch.tensor(CAMERAS["pole+y"]) * -1.0)
    up = torch.tensor([0.0, 1.0, 0.0])
    assert float(torch.linalg.cross(view_dir, up).square().sum()) < 1e-12


def test_boxes_in_turn_each_get_their_own():
    cfg = RenderConfig(**CFG)
    lf = torch.tensor(CAMERAS["oblique"])
    dirs = G.ray_directions(lf, cfg)
    got = {name: [] for name in BOXES}
    for _ in range(2):
        for name, box in BOXES.items():
            got[name].append(G.ray_aabb(lf, dirs, *box))
    for name, box in BOXES.items():
        want = _fresh_ray_aabb(lf, dirs, *box)
        for out in got[name]:
            for a, b in zip(out, want):
                _bitwise(a, b)
    assert not torch.equal(got["default"][0][0], got["other"][0][0])
    dev = torch.device("cpu")
    lo, hi = BOXES["other"]
    assert G._constant(lo, dev) is G._constant(list(lo), dev)
    assert G._constant(lo, dev) is not G._constant(hi, dev)
    # Keyed on the f32 bits: -0.0 is not 0.0, an int is its float.
    assert G._constant((0.0, 1.0, 0.0), dev) is not \
        G._constant((-0.0, 1.0, 0.0), dev)
    assert G._constant((-1, -1, -1), dev) is G._constant((-1.0,) * 3, dev)
    _bitwise(G._constant((-0.0, 1.0, 0.0), dev),
             torch.tensor((-0.0, 1.0, 0.0), dtype=torch.float32))


def _scene(device="cpu"):
    gen = torch.Generator().manual_seed(11)
    d, h, w = 8, 9, 10
    vol = torch.rand((3, 1, d, h, w), generator=gen).to(device)
    u = torch.rand((3, 7, 6), generator=gen).to(device)
    tf = P.get_tf_torch_layout("tf1", 16, device="cpu").to(device)
    look = torch.tensor([CAMERAS[c] for c in CAMERAS], device=device)
    return (d, h, w), vol, tf, look, u


def _renders(device="cpu"):
    """A 3-view forward with the camera's gradient and its backward, then a
    3-view inference render."""
    shape, vol, tf, look, u = _scene(device)
    rc = P.Raycaster(shape, (6, 7), 16, max_samples=24, device=device,
                     camera_grads=True)
    v = vol.clone().requires_grad_(True)
    t = tf.clone().requires_grad_(True)
    lf = look.clone().requires_grad_(True)
    out = rc.forward_with_aux(v, t, lf, u=u)
    (out.image.square().mean() + out.image[:, 3].mean()).backward()
    gt = rc.raycast_nondiff(vol, tf, look)
    return (out.image.detach(), out.valid_steps, out.n_samples, v.grad,
            t.grad, lf.grad, gt)


def test_renders_and_gradients_bitwise_fresh_construction():
    G._constant_of.cache_clear()
    got = _renders()
    again = _renders()
    with _fresh_vectors():
        want = _renders()
    for a, b, c in zip(got, again, want):
        _bitwise(a, c)
        _bitwise(b, c)
    # The pole camera's gradient is NaN on both paths: six of its rays have
    # a zero x component, so ``1 / dirs`` is infinite in ``ray_aabb``.
    d_look = got[5][[0, 2]]
    assert torch.isfinite(d_look).all() and d_look.abs().sum() > 0


def _sync_spans(log_dir, fn):
    with PPR.trace(str(log_dir), device="cpu") as prof:
        fn()
    return sum(e.count for e in prof.key_averages() if e.key == "dr.sync")


def test_sync_spans_on_a_first_and_a_second_call(tmp_path):
    G._constant_of.cache_clear()
    assert _sync_spans(tmp_path / "a",
                       lambda: _make_rays("oblique", "default", True)) == 4
    assert _sync_spans(tmp_path / "b",
                       lambda: _make_rays("pole+y", "default", False)) == 0
    # Another box is two more vectors, once.
    assert _sync_spans(tmp_path / "c",
                       lambda: _make_rays("oblique", "other", False)) == 2
    assert _sync_spans(tmp_path / "d",
                       lambda: _make_rays("behind", "other", True)) == 0


def test_first_call_in_inference_mode_then_camera_gradients():
    G._constant_of.cache_clear()
    shape, vol, tf, look, _ = _scene()
    vol, look = vol[[0, 2]], look[[0, 2]]     # off the pole
    rc = P.Raycaster(shape, (6, 7), 16, max_samples=24, device="cpu",
                     camera_grads=True, jitter=False)
    with torch.inference_mode():
        rc.raycast_nondiff(vol, tf, look)
    dev = torch.device("cpu")
    for vec in ((0.0, 1.0, 0.0), (1.0, 0.0, 0.0), (-1.0,) * 3, (1.0,) * 3):
        c = G._constant(vec, dev)
        assert not c.is_inference() and not c.requires_grad
    lf = look.clone().requires_grad_(True)
    img = rc(vol, tf, lf)
    img.square().mean().backward()
    assert lf.grad is not None and torch.isfinite(lf.grad).all()
    assert lf.grad.abs().sum() > 0


# -- on the card --------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels and the host syncs it "
                    "checks exist only there")


@contextlib.contextmanager
def _syncs_raise():
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.card
def test_fitting_step_and_frame_make_no_host_sync_on_the_card(card):
    """A warmed 2-view fitting step (forward, ``dssim_mse_loss`` backward,
    AdamW, ``project_unit``) and a warmed viewer frame make no sync."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    rc = P.Raycaster((64, 64, 64), (128, 128), 64, max_samples=64,
                     device="cuda")
    vol_gt = torch.rand((1, 1, 64, 64, 64), generator=gen, device="cuda")
    vol = vol_gt.clone().mul_(0.9).requires_grad_(True)
    tf = P.get_tf_torch_layout("tf1", 64, device="cpu").cuda()
    lfs = torch.tensor([CAMERAS["oblique"], CAMERAS["pole+y"]],
                       device="cuda")
    opt, sched = P.adamw_onecycle([vol], max_lr=0.01, total_steps=10)

    def step():
        with torch.no_grad():
            gts = rc.raycast_nondiff(vol_gt.expand(2, -1, -1, -1, -1), tf,
                                     lfs)
        imgs = rc(vol.expand(2, -1, -1, -1, -1), tf, lfs)
        loss = P.dssim_mse_loss(imgs, gts)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        sched.step()
        P.project_unit(vol)
        return loss.detach()

    def frame():
        return rc.raycast_nondiff(vol_gt[0], tf, lfs[0], 4.0)

    step(), frame()                 # builds the kernels, fills the caches
    with _syncs_raise():
        loss = step()
        img = frame()
    assert torch.isfinite(loss) and torch.isfinite(img).all()


@pytest.mark.card
def test_rays_and_renders_bitwise_fresh_construction_on_the_card(card):
    """On the card: the rays, K1's image and steps and K3's image are
    bitwise those of the fresh construction (K2's gradients are summed by
    atomics, so their last bits vary from run to run on either path)."""
    for cam, box, jitter in CASES:
        got = _make_rays(cam, box, jitter, "cuda")
        with _fresh_vectors():
            want = _make_rays(cam, box, jitter, "cuda")
        _assert_rays_equal(got, want)
    gen = torch.Generator(device="cuda").manual_seed(4)
    rc = P.Raycaster((64, 64, 64), (96, 80), 64, max_samples=64,
                     device="cuda", seed=3)
    vol = torch.rand((3, 1, 64, 64, 64), generator=gen, device="cuda")
    tf = P.get_tf_torch_layout("tf1", 64, device="cpu").cuda()
    look = torch.tensor([CAMERAS[c] for c in CAMERAS], device="cuda")
    u = torch.rand((3, 80, 96), generator=gen, device="cuda")

    def renders():
        out = rc.forward_with_aux(vol, tf, look, u=u)
        return (out.image, out.valid_steps, out.n_samples,
                rc.raycast_nondiff(vol, tf, look))

    got = renders()
    with _fresh_vectors():
        want = renders()
    for a, b in zip(got, want):
        _bitwise(a, b)
