"""The batched inference render (``render_nondiff_batch``) and the views of
K3's launch grid (``march_nondiff`` on a bundle of views).

On the CPU: ``Raycaster.raycast_nondiff`` of views of one volume and TF is
one batched render, bitwise the per-view loop (one and three views, the
occupancy grid on and off, parity and analytic normals, images whose sides
are not multiples of K3's 16x8 blocks); it engages only for one volume and
TF (the ``dr.view.batch`` span and the ``march_nondiff.views`` tally); the
operands it hands K3 are view-major; malformed batches are refused.  The
test marked ``card`` holds one batched K3 launch bitwise to a launch a
view, counts included; it skips without a card.  This file imports no
JAX::

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_port_view_batch.py
"""
import collections
import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

import differender_tpu_torch as P
from differender_tpu_torch import profiling as PPR
import differender_tpu_torch.render  # noqa: F401  (the module, not the function)
PR = sys.modules["differender_tpu_torch.render"]

VOL, R, SR = (10, 9, 11), 16, 2.0
LOOK = torch.tensor([[1.2, 0.8, 2.0], [2.0, 0.1, 0.3], [-1.0, 1.0, -1.5]])


def _volume(seed=3):
    """Noise in a ball, empty space around it (so the grid's rays jump)."""
    gen = torch.Generator().manual_seed(seed)
    axes = [torch.linspace(-1.0, 1.0, n) for n in VOL]
    r = torch.stack(torch.meshgrid(*axes, indexing="ij")).norm(dim=0)
    return (torch.rand(VOL, generator=gen) * (r < 0.7))[None]


def _tf():
    return P.get_tf_torch_layout("tf1", R, device="cpu")


def _spans(log_dir):
    [path] = glob.glob(os.path.join(str(log_dir), "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return collections.Counter(
        e["name"] for e in events if e.get("cat") == "user_annotation"
        and e["name"].startswith("dr."))


@pytest.mark.parametrize("image", [(16, 8), (19, 13)])
@pytest.mark.parametrize("analytic", [False, True])
@pytest.mark.parametrize("grid", [True, False])
@pytest.mark.parametrize("views", [1, 3])
def test_batched_raycast_nondiff_is_the_loop(views, grid, analytic, image):
    rc = P.Raycaster(VOL, image, R, device="cpu", occupancy_skip=grid,
                     analytic_normals=analytic)
    vol, tf, lf = _volume(), _tf(), LOOK[:views]
    loop = torch.stack([rc.raycast_nondiff(vol, tf, lf[v], SR)
                        for v in range(views)])
    P.reset_launch_counts()
    got = rc.raycast_nondiff(vol, tf, lf, SR)
    assert got.shape == (views, 4, image[1], image[0])
    assert torch.equal(got, loop)
    assert 0.0 < float(got[:, 3].mean()) < 1.0
    assert P.launch_counts()["march_nondiff.views"] == views
    assert P.launch_counts()["march_nondiff"] == 0     # the plain path


@pytest.mark.parametrize("grid", [True, False])
def test_a_batch_opens_one_span_one_grid(grid, tmp_path):
    rc = P.Raycaster(VOL, (19, 13), R, device="cpu", occupancy_skip=grid)
    with PPR.trace(str(tmp_path), device="cpu"):
        rc.raycast_nondiff(_volume(), _tf(), LOOK, SR)
    spans = _spans(tmp_path)
    assert spans["dr.raycaster"] == spans["dr.view.batch"] == 1
    assert spans["dr.view"] == 0 and spans["dr.rays"] == 3
    assert spans["dr.grid"] == int(grid)


@pytest.mark.parametrize("analytic", [False, True])
def test_march_nondiff_of_views_is_each_view_alone(analytic):
    """Images, visited and composited samples of a bundle of views, bitwise
    each view's march, with and without the grid."""
    cfg = P.RenderConfig(volume_shape=(11, 10, 9), image_shape=(13, 19),
                         tf_resolution=R, analytic_normals=analytic)
    vol = _volume()[0].permute(2, 0, 1).contiguous()
    tf = P.tf_to_internal(_tf()).contiguous()
    grid = P.build_occupancy(vol, tf, cfg)
    per_view = [P.make_rays(lf, cfg, SR) for lf in LOOK]
    rays = P.RayBundle(*(torch.stack(f) for f in zip(*per_view)))
    for occ in (grid, None):
        got = P.march_nondiff(vol, tf, rays, cfg, SR, occ)
        for v, r in enumerate(per_view):
            want = P.march_nondiff_plain(vol, tf, r, cfg, SR, occ)
            for g, w in zip(got, want):
                assert torch.equal(g[v], w)


@pytest.mark.parametrize("grid", [True, False])
def test_render_nondiff_batch_is_render_nondiff_per_view(grid):
    cfg = P.RenderConfig(volume_shape=(11, 10, 9), image_shape=(13, 19),
                         tf_resolution=R, occupancy_skip=grid)
    vol = _volume()[0].permute(2, 0, 1).contiguous()
    tf = P.tf_to_internal(_tf()).contiguous()
    out = P.render_nondiff_batch(vol, tf, LOOK, cfg, SR)
    for v in range(3):
        want = P.render_nondiff(vol, tf, LOOK[v], cfg, SR)
        assert torch.equal(out.image[v], want.image)
        assert torch.equal(out.n_samples[v], want.n_samples)
        assert torch.equal(out.valid_steps[v], want.valid_steps)


def test_a_batch_shared_with_stride_0_is_batched(tmp_path):
    rc = P.Raycaster(VOL, (19, 13), R, device="cpu")
    vol, tf = _volume(), _tf()
    want = rc.raycast_nondiff(vol, tf, LOOK, SR)
    P.reset_launch_counts()
    with PPR.trace(str(tmp_path), device="cpu"):
        got = rc.raycast_nondiff(vol[None].expand(3, -1, -1, -1, -1),
                                 tf[None].expand(3, -1, -1), LOOK[0], SR)
    assert torch.equal(got, want[:1].expand(3, -1, -1, -1))
    assert P.launch_counts()["march_nondiff.views"] == 3
    assert _spans(tmp_path)["dr.view.batch"] == 1


@pytest.mark.parametrize("distinct", ["volume", "tf"])
def test_distinct_volumes_or_tfs_stay_on_the_loop(distinct, tmp_path):
    rc = P.Raycaster(VOL, (19, 13), R, device="cpu")
    vol, tf = _volume(), _tf()
    if distinct == "volume":
        vol = torch.stack([_volume(s) for s in (3, 4, 5)])
    else:
        tf = torch.stack([tf, tf.flip(-1), tf * 0.5])
    P.reset_launch_counts()
    with PPR.trace(str(tmp_path), device="cpu"):
        got = rc.raycast_nondiff(vol, tf, LOOK, SR)
    spans = _spans(tmp_path)
    assert P.launch_counts()["march_nondiff.views"] == 0
    assert spans["dr.view.batch"] == 0
    assert spans["dr.view"] == spans["dr.grid"] == 3
    for v in range(3):
        one = rc.raycast_nondiff(vol[v] if distinct == "volume" else vol,
                                 tf[v] if distinct == "tf" else tf, LOOK[v],
                                 SR)
        assert torch.equal(got[v], one)


def test_batched_operands_are_view_major():
    """The struct K3 reads for a bundle of views: ray ``p`` of view ``v`` at
    ``v*H*W + p`` in every per-ray operand, one origin row a view."""
    cfg = P.RenderConfig(volume_shape=(11, 10, 9), image_shape=(13, 19),
                         tf_resolution=R)
    vol = _volume()[0].permute(2, 0, 1).contiguous()
    tf = P.tf_to_internal(_tf()).contiguous()
    per_view = [P.make_rays(lf, cfg, 4.0) for lf in LOOK]
    rays = P.RayBundle(*(torch.stack(f) for f in zip(*per_view)))
    image = torch.empty((3, 13, 19, 4))
    steps = torch.empty((3, 13, 19), dtype=torch.int32)
    args, keep = PR._march_args(vol, tf, PR._ray_soa(rays), cfg, 4.0, True,
                                2 ** 31 - 1, image, steps, views=3)
    origin, dx, t0, n = keep[2], keep[3], keep[6], keep[8]
    assert (args.H, args.W) == (13, 19)
    assert args.origin == origin.data_ptr() and origin.shape == (3, 3)
    assert args.image == image.data_ptr()
    for v, r in enumerate(per_view):
        sl = slice(v * 13 * 19, (v + 1) * 13 * 19)
        soa = PR._ray_soa(r)
        assert torch.equal(origin[v], r.origin)
        assert torch.equal(dx[sl], soa.dirs[:, 0])
        assert torch.equal(t0[sl], soa.t0)
        assert torch.equal(n[sl], soa.n)


def _bundle(cfg):
    per_view = [P.make_rays(lf, cfg, 4.0) for lf in LOOK]
    return P.RayBundle(*(torch.stack(f) for f in zip(*per_view)))


@pytest.mark.parametrize("field,bad,match", [
    ("origin", torch.zeros(3, 4), "look_from"),
    ("origin", torch.zeros(3, 3, 1), "look_from"),
    ("origin", torch.zeros(0, 3), "1 to 65535 views"),
    ("dirs", torch.zeros(3, 19, 13, 3), "dirs"),
    ("entry", torch.zeros(2, 13, 19), "entry"),
    ("n_samples", torch.zeros(3, 13, 19, 1, dtype=torch.int32),
     "n_samples"),
])
def test_malformed_batches_are_refused(field, bad, match):
    cfg = P.RenderConfig(volume_shape=(11, 10, 9), image_shape=(13, 19),
                         tf_resolution=R)
    vol = _volume()[0].permute(2, 0, 1).contiguous()
    tf = P.tf_to_internal(_tf()).contiguous()
    rays = _bundle(cfg)._replace(**{field: bad})
    with pytest.raises(ValueError, match=match):
        P.march_nondiff(vol, tf, rays, cfg, 4.0)


def test_render_nondiff_batch_refuses_malformed_arguments():
    cfg = P.RenderConfig(volume_shape=(11, 10, 9), image_shape=(13, 19),
                         tf_resolution=R)
    vol = _volume()[0].permute(2, 0, 1).contiguous()
    tf = P.tf_to_internal(_tf()).contiguous()
    with pytest.raises(ValueError, match=r"\(V, 3\)"):
        P.render_nondiff_batch(vol, tf, LOOK[0], cfg)
    with pytest.raises(ValueError, match="counts are counted by kernel K3"):
        P.march_nondiff(vol, tf, _bundle(cfg), cfg, 4.0,
                        counts=torch.zeros((3, 13, 19, 3),
                                           dtype=torch.int32))


# -- on the card ------------------------------------------------------------------

@pytest.mark.card
def test_one_batched_k3_launch_is_a_launch_a_view_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K3 runs on the chip")
    cfg = P.RenderConfig(volume_shape=(64, 64, 64), image_shape=(67, 45),
                         tf_resolution=64)
    vol = torch.from_numpy(P.ct_phantom(64)).cuda()
    tf = P.tf_to_internal(P.get_tf_torch_layout("tf1", 64, device="cpu")
                          ).contiguous().cuda()
    grid = P.build_occupancy(vol, tf, cfg)
    lfs = LOOK.cuda()
    per_view = [P.make_rays(lf, cfg, 8.0) for lf in lfs]
    rays = P.RayBundle(*(torch.stack(f) for f in zip(*per_view)))
    counts = torch.empty((3, 67, 45, 3), dtype=torch.int32, device="cuda")
    P.reset_launch_counts()
    got = P.march_nondiff(vol, tf, rays, cfg, 8.0, grid, counts=counts)
    assert P.launch_counts()["march_nondiff"] == 1
    assert P.launch_counts()["march_nondiff.views"] == 3
    for v, r in enumerate(per_view):
        one = torch.empty((67, 45, 3), dtype=torch.int32, device="cuda")
        want = P.march_nondiff(vol, tf, r, cfg, 8.0, grid, counts=one)
        for g, w in zip(got, want):
            assert torch.equal(g[v], w)
        assert torch.equal(counts[v], one)
    assert np.isfinite(got[0].cpu().numpy()).all()
