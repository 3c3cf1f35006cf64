"""The shear-warp path's spans: ``dr.fast.frame`` (the slab frame before
the march) and ``dr.fast.warp`` (the warp onto the pixels), one each a
frame, each inside the frame's ``dr.view``, for ``render_fast``, its plain
form and ``Raycaster.raycast_fast``; the image bitwise the same under the
profiler as without it.

The test marked ``card`` traces frames of ``raycast_fast`` on the card: one
K8 launch a frame and no other kernel of the program.  This file imports no
JAX, so on the card's machine it runs without the suite's ``conftest.py``::

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_fast_spans.py
"""
import collections
import glob
import json
import os

import pytest
import torch

import differender_tpu_torch as P
from differender_tpu_torch import profiling as PPR

VOL, IMG, R = (10, 12, 11), (9, 8), 16
LOOK = torch.tensor([[1.2, 0.8, 2.0], [-2.2, 0.1, 0.3]])


def _scene(device="cpu"):
    gen = torch.Generator().manual_seed(23)
    vol = torch.rand((1,) + VOL, generator=gen).to(device)
    tf = P.get_tf_torch_layout("tf1", R, device="cpu").to(device)
    return vol, tf


def _annotations(log_dir):
    [path] = glob.glob(os.path.join(str(log_dir), "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"
            and e["name"].startswith("dr.")]


def _inside(inner, outer):
    """Whether ``inner`` lies within ``outer`` on its thread (1 ns of slack
    for the trace's rounding of microseconds)."""
    a, b = inner["ts"], inner["ts"] + inner["dur"]
    return (outer["tid"] == inner["tid"] and outer["ts"] - 1e-3 <= a
            and b <= outer["ts"] + outer["dur"] + 1e-3)


def _check(spans, views):
    """``views`` frames: one ``dr.fast.frame`` and one ``dr.fast.warp``
    inside each ``dr.view``, the frame before the warp."""
    count = collections.Counter(e["name"] for e in spans)
    assert count["dr.view"] == views
    assert count["dr.fast.frame"] == count["dr.fast.warp"] == views
    by = collections.defaultdict(list)
    for e in spans:
        by[e["name"]].append(e)
    for view in by["dr.view"]:
        frame = [e for e in by["dr.fast.frame"] if _inside(e, view)]
        warp = [e for e in by["dr.fast.warp"] if _inside(e, view)]
        assert len(frame) == len(warp) == 1, view
        assert frame[0]["ts"] + frame[0]["dur"] <= warp[0]["ts"] + 1e-3
    return by


@pytest.mark.parametrize("fn", ["render_fast", "render_fast_plain"])
def test_render_fast_opens_one_frame_and_one_warp_span(fn, tmp_path):
    vol, tf = _scene()
    cfg = P.RenderConfig(volume_shape=VOL, image_shape=IMG,
                         tf_resolution=R)
    render = getattr(P, fn)

    def go():
        return render(vol[0], tf.t(), LOOK[0], cfg, intermediate=14,
                      planes_per_voxel=2.0).image
    plain = go()
    with PPR.trace(str(tmp_path), device="cpu"):
        traced = go()
    _check(_annotations(tmp_path), 1)
    assert torch.equal(plain, traced)


@pytest.mark.parametrize("batch", [False, True])
def test_raycast_fast_opens_them_in_each_view(batch, tmp_path):
    vol, tf = _scene()
    rc = P.Raycaster(VOL, IMG, R, device="cpu")
    look = LOOK if batch else LOOK[0]

    def go():
        return rc.raycast_fast(vol, tf, look, intermediate=14)
    plain = go()
    with PPR.trace(str(tmp_path), device="cpu"):
        traced = go()
    by = _check(_annotations(tmp_path), 2 if batch else 1)
    [outer] = by["dr.raycaster"]
    assert all(_inside(e, outer) for e in by["dr.view"])
    assert torch.equal(plain, traced)


# -- on the card ------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K8 and its trace run on the chip")


@pytest.mark.card
def test_a_traced_fast_frame_is_one_k8_launch_on_the_card(card, tmp_path):
    from dvrbench import tracing
    vol = torch.rand((1, 64, 64, 64), device="cuda")
    tf = P.get_tf_torch_layout("tf1", 64, device="cpu").cuda()
    rc = P.Raycaster((64, 64, 64), (96, 80), 64, device="cuda")
    lf = torch.tensor([2.0, 1.0, -0.7], device="cuda")

    def frame(i):
        return rc.raycast_fast(vol, tf, lf, intermediate=128)
    plain = frame(-1)
    torch.cuda.synchronize()
    P.reset_launch_counts()
    tr = tracing.profile_units(frame, 3, torch.cuda.synchronize,
                               str(tmp_path / "trace.json"))
    counts = {k: n for k, n in P.launch_counts().items()
              if "." not in k and n}
    assert counts == {"shear_warp_fwd": 3}
    names = collections.Counter(h[2] for h in tr.host_ops
                                if h[3] == "user_annotation")
    assert names["dr.fast.frame"] == names["dr.fast.warp"] == 3
    assert tr.kernel_ms_per_unit(("shear_warp_fwd_kernel",)) > 0.0
    assert torch.equal(frame(0), plain)
