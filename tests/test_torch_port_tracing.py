"""The port's spans (``differender_tpu_torch.profiling.span``) and the
benchmark's per-layer metrics that read them (``dvrbench/program_spans.py``
and its readers in ``dvrbench/metrics/``).

On the CPU: the spans a traced forward, backward and inference render open,
and how they nest; no ``record_function`` outside a profiler session, and
images bitwise the same under it; every reader on a hand-made trace.  The
tests marked ``card`` hold the spans against the card's kernels on the
profiler's one clock; they skip without a card.  This file imports no JAX,
so on the card's machine it runs without the suite's ``conftest.py``::

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_port_tracing.py
"""
import collections
import glob
import json
import os

import pytest
import torch

import differender_tpu_torch as P
from differender_tpu_torch import profiling as PPR
from dvrbench import harness, tracing

VOL, IMG, R = (8, 8, 8), (6, 5), 16
LOOK = torch.tensor([[1.2, 0.8, 2.0], [2.0, 0.1, 0.3], [-1.0, 1.0, 1.5]])


def _scene(device="cpu"):
    gen = torch.Generator().manual_seed(3)
    vol = torch.rand((3, 1) + VOL, generator=gen).to(device)
    u = torch.rand((3, IMG[1], IMG[0]), generator=gen).to(device)
    tf = P.get_tf_torch_layout("tf1", R, device="cpu").to(device)
    rc = P.Raycaster(VOL, IMG, R, max_samples=16, device=device)
    return rc, vol, tf, u


def _renders(rc, vol, tf, u):
    """A 3-view forward and its backward, then a 2-view inference render."""
    v = vol.clone().requires_grad_(True)
    img = rc(v, tf, LOOK.to(vol.device), u=u)
    img.square().mean().backward()
    gt = rc.raycast_nondiff(vol[:2], tf, LOOK[:2].to(vol.device))
    return img.detach(), v.grad, gt


def _annotations(log_dir):
    [path] = glob.glob(os.path.join(str(log_dir), "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"
            and e["name"].startswith("dr.")]


def _inside(inner, outers):
    """Whether ``inner`` lies within one of ``outers`` on its thread (1 ns
    of slack for the trace's rounding of microseconds)."""
    a, b = inner["ts"], inner["ts"] + inner["dur"]
    return any(o["tid"] == inner["tid"] and o["ts"] - 1e-3 <= a
               and b <= o["ts"] + o["dur"] + 1e-3 for o in outers)


def test_spans_of_a_forward_backward_and_inference_render(tmp_path):
    rc, vol, tf, u = _scene()
    with PPR.trace(str(tmp_path), device="cpu"):
        _renders(rc, vol, tf, u)
    spans = _annotations(tmp_path)
    count = collections.Counter(e["name"] for e in spans)
    assert count["dr.raycaster"] == 2
    assert count["dr.view"] == 5
    assert count["dr.grid"] == 2
    assert count["dr.rays"] == 5
    # The plain path launches no kernel.
    assert not [n for n in count if n.startswith("dr.launch.")]
    by = collections.defaultdict(list)
    for e in spans:
        by[e["name"]].append(e)
    for e in spans:
        if e["name"].startswith("dr.rays") or e["name"] == "dr.grid":
            assert _inside(e, by["dr.view"]), e
    for e in by["dr.view"]:
        assert _inside(e, by["dr.raycaster"]), e


def test_no_record_function_outside_a_profiler(tmp_path, monkeypatch):
    entered = []
    real = PPR.record_function

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(PPR, "record_function", counting)
    assert PPR.span("dr.a") is PPR.span("dr.b")
    assert PPR.annotate is PPR.span
    rc, vol, tf, u = _scene()
    plain = _renders(rc, vol, tf, u)
    assert entered == []
    with PPR.trace(str(tmp_path), device="cpu"):
        traced = _renders(rc, vol, tf, u)
    assert "dr.view" in entered
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


# -- the readers, on a hand-made trace -----------------------------------------

def _x(name, ts, end, cat="user_annotation", tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": end - ts,
            "pid": 1, "tid": tid}


# Device busy [100, 400] and [600, 700] of the window [0, 1000]: idle 600
# us.  The main thread's spans (a batched inference render, then a
# single-view render, with a shear-warp frame's slab frame and warp inside
# it), the autograd thread's (2) overlapping them in time,
# one span before the window (left out) and one past its end (clipped).
# Two units.
KERNELS = [_x("march_nondiff_kernel", 100, 300, "kernel", 7),
           _x("cell_minmax_kernel", 250, 400, "kernel", 7),
           _x("march_diff_bwd_kernel", 600, 700, "kernel", 7)]
SPANS = [_x("dr.raycaster", 0, 500), _x("dr.view.batch", 10, 200),
         _x("dr.rays", 20, 50), _x("dr.rays.soa", 60, 80),
         _x("dr.grid", 90, 150), _x("dr.launch.cell_minmax", 95, 110),
         _x("dr.launch.march_nondiff", 160, 190), _x("dr.view", 300, 480),
         _x("dr.rays", 310, 330), _x("dr.fast.frame", 340, 400),
         _x("dr.fast.warp", 400, 440),
         _x("dr.launch.march_diff_fwd", 450, 470),
         _x("dr.loss", 540, 560), _x("dr.backward", 520, 650, tid=2),
         _x("dr.backward.tf_only", 530, 645, tid=2),
         _x("dr.launch.march_diff_bwd", 600, 640, tid=2),
         _x("dr.optim", 655, 695),
         _x("dr.view", -50, -30), _x("dr.sync", 980, 1020)]
OTHERS = [_x(tracing.WINDOW, 0, 1000), _x("dvrbench.step", 0, 990),
          _x("aten::add", 700, 800, "cpu_op")]
EXPECTED = {
    "view_host_ms.train": 0.185, "view_host_ms.viewer": 0.185,
    "rays_host_ms.train": 0.035, "rays_host_ms.viewer": 0.035,
    "launch_host_ms.train": 0.0525, "launch_host_ms.viewer": 0.0525,
    # Inside dr. spans: 100 of [0, 100], 180 of [400, 600], 20 of
    # [700, 1000].
    "program_idle_share.train": 50.0, "program_idle_share.viewer": 50.0,
    "grid_builds.train": 0.5, "view_batches.train": 0.5,
    "tf_only_bwd.tffit": 0.5, "optim_host_ms.tffit": 0.02,
    "slab_frame_host_ms.viewer_fast": 0.03, "warp_host_ms.viewer_fast": 0.02,
}


def test_every_program_span_metric_has_a_case():
    names = {m["name"] for m in harness.benchmark()["per_layer"]
             if m["source"] == "program_span"
             and m["name"] not in ("loss_optim_ms.train",
                                   "gt_render_ms.train")}
    assert names == set(EXPECTED)


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_on_known_spans(metric):
    trace = tracing.Trace(KERNELS + SPANS + OTHERS, units=2)
    got = harness.reader(metric)(trace)
    assert got == pytest.approx(EXPECTED[metric], rel=1e-12, abs=0)


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_without_program_spans(metric):
    trace = tracing.Trace(KERNELS + OTHERS, units=2)
    assert harness.reader(metric)(trace) is None


# -- on the card ------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels and their trace run on "
                    "the chip")


def _traced(units, run_unit, tmp_path):
    sync = torch.cuda.synchronize
    run_unit(-1)                    # builds the kernels, warms the shapes
    sync()
    P.reset_launch_counts()
    tr = tracing.profile_units(run_unit, units, sync,
                               str(tmp_path / "trace.json"))
    launched = sum(n for k, n in P.launch_counts().items() if "." not in k)
    spans = [h for h in tr.host_ops if h[3] == "user_annotation"
             and h[2].startswith("dr.")]
    return tr, spans, launched


@pytest.mark.card
def test_k3_starts_inside_its_launch_span_on_the_card(card, tmp_path):
    """A traced viewer frame: each K3 kernel begins after the
    ``dr.launch.march_nondiff`` span that launched it began (one clock),
    and the ``dr.launch.*`` spans are ``launch_counts()``'s launches."""
    cfg = dict(max_samples=64)
    rc = P.Raycaster((64, 64, 64), (128, 128), 64, device="cuda", **cfg)
    vol = torch.rand((1, 64, 64, 64), device="cuda")
    tf = P.get_tf_torch_layout("tf1", 64, device="cpu").cuda()
    lf = torch.tensor([1.5, 0.7, 2.0], device="cuda")
    tr, spans, launched = _traced(
        3, lambda i: rc.raycast_nondiff(vol, tf, lf), tmp_path)
    launch = [s for s in spans if s[2] == "dr.launch.march_nondiff"]
    k3 = [k for k in tr.kernels
          if tracing.kernel_matches(k[2], ("march_nondiff_kernel",))]
    assert len(launch) == len(k3) == 3
    for s, k in zip(launch, k3):
        assert k[0] >= s[0], (s, k)
    assert launched == sum(s[2].startswith("dr.launch.") for s in spans)
    assert sum(s[2] == "dr.grid" for s in spans) == 3


@pytest.mark.card
def test_backward_spans_on_the_autograd_thread_on_the_card(card, tmp_path):
    """A traced fitting step of 3 views of one volume: one batched render
    (``dr.view.batch``, one K1 launch) and one ``dr.backward`` holding its
    K2 launch spans, one a view, recorded from the autograd engine's
    thread."""
    rc = P.Raycaster((64, 64, 64), (128, 128), 64, max_samples=64,
                     device="cuda")
    vol = torch.rand((1, 1, 64, 64, 64), device="cuda", requires_grad=True)
    tf = P.get_tf_torch_layout("tf1", 64, device="cpu").cuda()
    lfs = LOOK.cuda()

    def step(i):
        img = rc(vol.expand(3, -1, -1, -1, -1), tf, lfs)
        P.dssim_mse_loss(img, torch.zeros_like(img)).backward()

    _, spans, launched = _traced(2, step, tmp_path)
    names = collections.Counter(s[2] for s in spans)
    assert names["dr.backward"] == 2
    assert names["dr.launch.march_diff_bwd"] == 6
    assert names["dr.launch.march_diff_fwd"] == 2
    assert names["dr.loss"] == 2 and names["dr.view.batch"] == 2
    assert names["dr.view"] == 0
    assert launched == sum(n for k, n in names.items()
                           if k.startswith("dr.launch."))
    bwd = [s for s in spans if s[2] == "dr.backward"]
    for s in spans:
        if s[2] == "dr.launch.march_diff_bwd":
            assert any(b[0] <= s[0] and s[1] <= b[1] for b in bwd), s
