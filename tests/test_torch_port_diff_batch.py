"""The batched differentiable render (``render_batch``) and the views of
K1's launch grid (``march_diff`` and ``march_diff_fwd`` on a bundle of
views).

On the CPU: ``Raycaster.forward`` of views of one volume and TF is one
batched render whose images, ``valid_steps`` and gradients (volume, TF,
camera) are the loop of ``render`` over the views with the same jitter;
it engages for a volume and TF shared by the batch (unbatched, a batch of
one, batched with stride 0), not for distinct ones (the ``dr.view.batch``
span and the ``march_diff_fwd.views`` tally); on a stand-in kernel library
the batch is one K1 call over the V views, view-major, and a K2 call a
view, each adding into one ``d_volume`` and one ``d_tf``.  The test marked
``card`` holds one batched K1 launch bitwise to a launch a view, and the
batched backward to the loop's gradients; it skips without a card.  This
file imports no JAX::

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_port_diff_batch.py
"""
import collections
import ctypes
import glob
import json
import os
import sys

import pytest
import torch

import differender_tpu_torch as P
from differender_tpu_torch import _build
from differender_tpu_torch import profiling as PPR
import differender_tpu_torch.render  # noqa: F401  (the module, not the function)
PR = sys.modules["differender_tpu_torch.render"]

VOL, R, IMG, SR = (32, 32, 32), 16, (16, 20), 1.0
LOOK = torch.tensor([[1.2, 0.8, 2.0], [2.0, 0.1, 0.3], [-1.0, 1.0, -1.5]])
# The batch and the loop run the same plain march per view; the gradients
# of the views are summed in another order (the loop's leaves one view at
# a time, the batch's autograd over the one shared tensor).
GRAD_TOL = 1e-5


def _volume(seed=3):
    """Noise in a ball (user layout (1, D, H, W)), empty space around it."""
    gen = torch.Generator().manual_seed(seed)
    axes = [torch.linspace(-1.0, 1.0, n) for n in VOL]
    r = torch.stack(torch.meshgrid(*axes, indexing="ij")).norm(dim=0)
    return (torch.rand(VOL, generator=gen) * (r < 0.8))[None]


def _tf():
    return P.get_tf_torch_layout("tf1", R, device="cpu")


def _u(views, seed=5):
    gen = torch.Generator().manual_seed(seed)
    return torch.rand((views, IMG[1], IMG[0]), generator=gen)


def _spans(log_dir):
    [path] = glob.glob(os.path.join(str(log_dir), "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return collections.Counter(
        e["name"] for e in events if e.get("cat") == "user_annotation"
        and e["name"].startswith("dr."))


def _close(got, want, tol=GRAD_TOL):
    scale = float(want.abs().max())
    assert scale > 0
    assert float((got - want).abs().max()) <= tol * scale


def _shared(vol, form, views):
    """The one volume (or TF) given as the batch's: unbatched, a batch of
    one, or batched with stride 0."""
    if form == "unbatched":
        return vol
    if form == "batch_of_one":
        return vol[None]
    return vol[None].expand((views,) + tuple(vol.shape))


def _loop(rc, vol, tf, look, u, cam=False):
    """The views rendered one by one through ``Raycaster.forward`` and
    their loss (mean of img² over the batch), with the gradients of fresh
    leaves of the volume, the TF and (with ``cam``) the cameras."""
    v = vol.clone().requires_grad_(True)
    t = tf.clone().requires_grad_(True)
    lf = look.clone().requires_grad_(cam)
    outs = [rc.forward_with_aux(v, t, lf[i],
                                u=None if u is None else u[i])
            for i in range(look.shape[0])]
    images = torch.stack([o.image for o in outs])
    (images.square().sum() / images.numel()).backward()
    return (images.detach(), torch.stack([o.valid_steps for o in outs]),
            v.grad, t.grad, lf.grad)


def _batch(rc, vol, tf, look, u, vol_form="unbatched", tf_form="unbatched",
           cam=False, need=(True, True)):
    v = vol.clone().requires_grad_(need[0])
    t = tf.clone().requires_grad_(need[1])
    lf = look.clone().requires_grad_(cam)
    V = look.shape[0]
    out = rc.forward_with_aux(_shared(v, vol_form, V), _shared(t, tf_form, V),
                              lf, u=u)
    out.image.square().mean().backward()
    return out.image.detach(), out.valid_steps, v.grad, t.grad, lf.grad


@pytest.mark.parametrize("tf_form", ["unbatched", "stride0"])
@pytest.mark.parametrize("vol_form", ["unbatched", "stride0"])
@pytest.mark.parametrize("jitter", [False, True])
def test_batched_forward_is_the_loop(vol_form, tf_form, jitter):
    rc = P.Raycaster(VOL, IMG, R, max_samples=48, jitter=False, device="cpu")
    vol, tf = _volume(), _tf()
    u = _u(3) if jitter else None
    want = _loop(rc, vol, tf, LOOK, u)
    P.reset_launch_counts()
    got = _batch(rc, vol, tf, LOOK, u, vol_form, tf_form)
    assert got[0].shape == (3, 4, IMG[1], IMG[0])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert 0.0 < float(got[0][:, 3].mean()) < 1.0
    _close(got[2], want[2])
    _close(got[3], want[3])
    counts = P.launch_counts()
    assert counts["march_diff_fwd.views"] == 3
    assert counts["march_diff_fwd"] == 0           # the plain path


def test_jitter_drawn_by_the_module_is_each_views_own_row():
    rc = P.Raycaster(VOL, IMG, R, max_samples=48, jitter=True, device="cpu")
    vol, tf = _volume(), _tf()
    got = rc(vol, tf, LOOK)
    u = rc._last_u
    assert u.shape == (3, IMG[1], IMG[0])
    want = torch.stack([rc(vol, tf, LOOK[i], u=u[i]) for i in range(3)])
    assert torch.equal(got, want)


@pytest.mark.parametrize("analytic", [False, True])
def test_camera_gradients_of_the_batch_are_the_loops(analytic):
    rc = P.Raycaster(VOL, IMG, R, max_samples=48, jitter=False, device="cpu",
                     camera_grads=True, analytic_normals=analytic)
    vol, tf, u = _volume(), _tf(), _u(3)
    want = _loop(rc, vol, tf, LOOK, u, cam=True)
    got = _batch(rc, vol, tf, LOOK, u, cam=True)
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[2:], want[2:]):
        _close(g, w)
    assert got[4].shape == (3, 3)


def test_tf_only_gradient_of_the_batch_is_the_loops():
    rc = P.Raycaster(VOL, IMG, R, max_samples=48, jitter=False, device="cpu")
    vol, tf, u = _volume(), _tf(), _u(3)
    want = _loop(rc, vol, tf, LOOK, u)
    got = _batch(rc, vol, tf, LOOK, u, need=(False, True))
    assert got[2] is None and torch.equal(got[0], want[0])
    _close(got[3], want[3])


@pytest.mark.parametrize("form", ["unbatched", "batch_of_one"])
def test_a_batch_of_one_view_is_render(form):
    """One camera (1, 3), the volume and the TF unbatched or each a batch
    of one (a batch of one sets the batch's size, so its cameras are one
    too)."""
    rc = P.Raycaster(VOL, IMG, R, max_samples=48, jitter=False, device="cpu")
    vol, tf, u = _volume(), _tf(), _u(1)
    want = _loop(rc, vol, tf, LOOK[:1], u)
    P.reset_launch_counts()
    got = _batch(rc, vol, tf, LOOK[:1], u, form, form)
    assert got[0].shape == (1, 4, IMG[1], IMG[0])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    _close(got[2], want[2])
    _close(got[3], want[3])
    assert P.launch_counts()["march_diff_fwd.views"] == 1


@pytest.mark.parametrize("distinct", ["volume", "tf"])
def test_distinct_volumes_or_tfs_stay_on_the_loop(distinct, tmp_path):
    rc = P.Raycaster(VOL, IMG, R, max_samples=48, jitter=False, device="cpu")
    vol, tf = _volume(), _tf()
    if distinct == "volume":
        vol = torch.cat([_volume(s) for s in (3, 4, 5)])[:, None]
    else:
        tf = torch.stack([tf, tf.flip(-1), tf * 0.5])
    v = vol.clone().requires_grad_(True)
    P.reset_launch_counts()
    with PPR.trace(str(tmp_path), device="cpu"):
        got = rc(v, tf, LOOK)
    got.square().mean().backward()
    spans = _spans(tmp_path)
    assert P.launch_counts()["march_diff_fwd.views"] == 0
    assert spans["dr.view.batch"] == 0 and spans["dr.view"] == 3
    for i in range(3):
        v_i = (vol[i] if distinct == "volume" else vol).clone() \
            .requires_grad_(True)
        one = rc(v_i, tf[i] if distinct == "tf" else tf, LOOK[i])
        assert torch.equal(got[i].detach(), one.detach())
        (one.square().sum() / got.numel()).backward()
        if distinct == "volume":
            _close(v.grad[i], v_i.grad)


def test_a_batch_opens_one_span(tmp_path):
    rc = P.Raycaster(VOL, IMG, R, max_samples=48, jitter=False, device="cpu")
    with PPR.trace(str(tmp_path), device="cpu"):
        rc(_volume(), _tf(), LOOK)
    spans = _spans(tmp_path)
    assert spans["dr.raycaster"] == spans["dr.view.batch"] == 1
    assert spans["dr.view"] == 0 and spans["dr.rays"] == 3


def _cfg(**kw):
    return P.RenderConfig(volume_shape=VOL, image_shape=(IMG[1], IMG[0]),
                          tf_resolution=R, max_samples=48, **kw)


def _internal():
    return (P.volume_to_internal(_volume()[0]).contiguous(),
            P.tf_to_internal(_tf()).contiguous())


def test_render_batch_is_render_per_view():
    cfg = _cfg()
    vol, tf = _internal()
    u = _u(3)
    out = P.render_batch(vol, tf, LOOK, cfg, SR, u=u)
    for v in range(3):
        want = P.render(vol, tf, LOOK[v], cfg, SR, u=u[v])
        assert torch.equal(out.image[v], want.image)
        assert torch.equal(out.valid_steps[v], want.valid_steps)
        assert torch.equal(out.n_samples[v], want.n_samples)


@pytest.mark.parametrize("ert", [True, False])
def test_march_diff_fwd_of_views_is_each_view_alone(ert):
    cfg = _cfg()
    vol, tf = _internal()
    u = _u(3)
    per_view = [P.make_rays(lf, cfg, SR, u=u[v]) for v, lf in enumerate(LOOK)]
    rays = P.RayBundle(*(torch.stack(f) for f in zip(*per_view)))
    P.reset_launch_counts()
    image, steps = P.march_diff_fwd(vol, tf, rays, cfg, SR, ert=ert)
    assert image.shape == (3, IMG[1], IMG[0], 4)
    assert P.launch_counts()["march_diff_fwd.views"] == 3
    for v, r in enumerate(per_view):
        want = P.march_diff_fwd(vol, tf, r, cfg, SR, ert=ert)
        assert torch.equal(image[v], want[0])
        assert torch.equal(steps[v], want[1])


def test_ray_cotangents_of_views_are_each_views():
    gen = torch.Generator().manual_seed(9)
    n = IMG[0] * IMG[1]
    sums = torch.randn((3, IMG[1], IMG[0], 12), generator=gen)
    dirs = torch.randn((3 * n, 3), generator=gen)
    t0, dt = torch.rand(3 * n, generator=gen), torch.rand(3 * n,
                                                          generator=gen)
    got = P.ray_cotangents(sums, dirs, t0, dt, 3)
    assert got[0].shape == (3, 3)
    for v in range(3):
        rows = slice(v * n, (v + 1) * n)
        want = P.ray_cotangents(sums[v], dirs[rows], t0[rows], dt[rows])
        assert torch.allclose(got[0][v], want[0], rtol=1e-6, atol=1e-5)
        for g, w in zip(got[1:], want[1:]):
            assert torch.equal(g[rows], w)


def test_render_batch_refuses_malformed_arguments():
    cfg = _cfg()
    vol, tf = _internal()
    with pytest.raises(ValueError, match=r"\(V, 3\)"):
        P.render_batch(vol, tf, LOOK[0], cfg)
    with pytest.raises(ValueError, match="u must have shape"):
        P.render_batch(vol, tf, LOOK, cfg, u=_u(2))
    rays = P.RayBundle(*(torch.stack(f) for f in zip(
        *[P.make_rays(lf, cfg, SR) for lf in LOOK])))
    with pytest.raises(ValueError, match="counts are counted by kernel K1"):
        P.march_diff_fwd(vol, tf, rays, cfg, SR,
                         counts=torch.zeros((3, IMG[1], IMG[0], 2),
                                            dtype=torch.int32))


# -- the kernel path on a stand-in library -----------------------------------

class _Library:
    """Stands in for the kernel library: every C entry records its
    arguments (and what ``read`` reads of them while the operands are
    alive) and returns 0; its outputs stay as allocated."""

    def __init__(self):
        self.calls = collections.defaultdict(list)
        self.read, self.seen = None, []

    def __getattr__(self, name):
        if not name.startswith("dr_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls[name].append(args)
            if self.read is not None:
                self.seen.append(self.read(args))
            return 0
        return entry


@pytest.fixture
def stand_in(monkeypatch):
    lib = _Library()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 7)
    monkeypatch.setattr(_build, "uses_plain", lambda t: False)
    P.reset_launch_counts()
    return lib


@pytest.mark.parametrize("need", ["both", "tf_only", "camera"])
def test_a_batch_is_one_k1_call_and_a_k2_call_a_view(stand_in, need):
    cfg = _cfg()
    vol, tf = _internal()
    v = vol.clone().requires_grad_(need != "tf_only")
    t = tf.clone().requires_grad_(True)
    lf = LOOK.clone().requires_grad_(need == "camera")
    out = P.render_batch(v, t, lf, cfg, SR, u=_u(3))
    [k1] = stand_in.calls["dr_march_diff_fwd"]
    fwd, views = k1[0]._obj, k1[1]
    assert views == 3 and out.image.shape == (3, IMG[1], IMG[0], 4)
    assert fwd.image == out.image.data_ptr()
    assert fwd.steps == out.valid_steps.data_ptr()
    counts = P.launch_counts()
    assert counts["march_diff_fwd"] == 1
    assert counts["march_diff_fwd.views"] == 3

    torch.nan_to_num(out.image, 0.0, 0.0, 0.0).sum().backward()
    k2 = [c[0]._obj for c in stand_in.calls["dr_march_diff_bwd"]]
    assert len(k2) == 3 and all(len(c) == 3
                                for c in stand_in.calls["dr_march_diff_bwd"])
    # One d_volume and one d_tf, zeroed once, shared by every view's call.
    assert len({b.d_volume for b in k2}) == 1
    assert len({b.d_tf for b in k2}) == 1
    assert (k2[0].d_volume is None) == (need == "tf_only")
    assert k2[0].d_tf == t.grad.data_ptr()
    if need != "tf_only":
        assert k2[0].d_volume == v.grad.data_ptr()
        assert not v.grad.any()
    # Each call on its own view's rays and image, its sums in its own slice.
    hw = IMG[0] * IMG[1]
    for i, b in enumerate(k2):
        assert b.f.image == out.image[i].data_ptr()
        assert (b.f.H, b.f.W) == (IMG[1], IMG[0])
        assert (b.ray_sums is not None) == (need == "camera")
    if need == "camera":
        assert len({b.ray_sums for b in k2}) == 3
        assert k2[1].ray_sums - k2[0].ray_sums == hw * 12 * 4
        assert lf.grad.shape == (3, 3)
    counts = P.launch_counts()
    assert counts["march_diff_bwd"] == 3
    assert counts["march_diff_bwd.tf_only"] == 3 * (need == "tf_only")
    assert counts["march_diff_bwd.camera"] == 3 * (need == "camera")


def test_batched_k1_operands_are_view_major(stand_in):
    """The struct K1 reads for a bundle of views: ray ``p`` of view ``v``
    at ``v*H*W + p`` in every per-ray operand, one origin row a view."""
    cfg = _cfg()
    vol, tf = _internal()
    per_view = [P.make_rays(lf, cfg, SR) for lf in LOOK]
    rays = P.RayBundle(*(torch.stack(f) for f in zip(*per_view)))
    counts = torch.zeros((3, IMG[1], IMG[0], 2), dtype=torch.int32)
    hw = IMG[0] * IMG[1]

    def read(args):
        a = args[0]._obj
        return (list((ctypes.c_float * 9).from_address(a.origin)),
                list((ctypes.c_float * (3 * hw)).from_address(a.dx)),
                list((ctypes.c_int * (3 * hw)).from_address(a.n)))

    stand_in.read = read
    image, steps = P.march_diff_fwd(vol, tf, rays, cfg, SR, counts=counts)
    [(args, views, _, _)] = stand_in.calls["dr_march_diff_fwd"]
    [(origin, dx, n)] = stand_in.seen
    a = args._obj
    assert views == 3 and a.shaded == counts.data_ptr()  # K1 counts there
    assert image.shape == (3, IMG[1], IMG[0], 4) and a.image == \
        image.data_ptr()
    assert steps.shape == (3, IMG[1], IMG[0]) and a.steps == \
        steps.data_ptr()
    for v, r in enumerate(per_view):
        soa = PR._ray_soa(r)
        assert list(origin[3 * v:3 * v + 3]) == r.origin.tolist()
        assert list(dx[v * hw:(v + 1) * hw]) == soa.dirs[:, 0].tolist()
        assert list(n[v * hw:(v + 1) * hw]) == soa.n.tolist()


# -- on the card -------------------------------------------------------------

@pytest.mark.card
def test_one_batched_k1_launch_is_a_launch_a_view_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 and K2 run on the chip")
    cfg = P.RenderConfig(volume_shape=(64, 64, 64), image_shape=(67, 45),
                         tf_resolution=64, max_samples=128)
    vol = torch.from_numpy(P.ct_phantom(64)).cuda()
    tf = P.tf_to_internal(P.get_tf_torch_layout("tf1", 64, device="cpu")
                          ).contiguous().cuda()
    lfs = LOOK.cuda()
    gen = torch.Generator(device="cuda").manual_seed(21)
    u = torch.rand((3, 67, 45), generator=gen, device="cuda")
    per_view = [P.make_rays(lf, cfg, 1.0, u=u[v]) for v, lf in enumerate(lfs)]
    rays = P.RayBundle(*(torch.stack(f) for f in zip(*per_view)))
    counts = torch.empty((3, 67, 45, 2), dtype=torch.int32, device="cuda")
    P.reset_launch_counts()
    image, steps = P.march_diff_fwd(vol, tf, rays, cfg, 1.0, counts=counts)
    assert P.launch_counts()["march_diff_fwd"] == 1
    assert P.launch_counts()["march_diff_fwd.views"] == 3
    for v, r in enumerate(per_view):
        one = torch.empty((67, 45, 2), dtype=torch.int32, device="cuda")
        want = P.march_diff_fwd(vol, tf, r, cfg, 1.0, counts=one)
        assert torch.equal(image[v], want[0])
        assert torch.equal(steps[v], want[1])
        assert torch.equal(counts[v], one)
    # The batched backward against the loop of render's: K2's f32 atomics
    # add in another order each launch.
    v_b = vol.clone().requires_grad_(True)
    t_b = tf.clone().requires_grad_(True)
    P.reset_launch_counts()
    out = P.render_batch(v_b, t_b, lfs, cfg, 1.0, u=u)
    out.image.square().mean().backward()
    assert P.launch_counts()["march_diff_fwd"] == 1
    assert P.launch_counts()["march_diff_bwd"] == 3
    v_l = vol.clone().requires_grad_(True)
    t_l = tf.clone().requires_grad_(True)
    for v in range(3):
        one = P.render(v_l, t_l, lfs[v], cfg, 1.0, u=u[v]).image
        assert torch.equal(one.detach(), out.image[v].detach())
        (one.square().sum() / out.image.numel()).backward()
    _close(v_b.grad, v_l.grad, 1e-4)
    _close(t_b.grad, t_l.grad, 1e-4)
