"""The shear-warp viewer (the benchmark's ``viewer_fast.ct_head`` cell):
the port's ``render_fast`` and the JAX package's against the benchmark's
plain shear-warp reference (``dvrbench/reference/shearwarp.py``), the
reference's independence, K8's work count, and the cell run whole on the
CPU at a small size, sound, with its control and with each of its faults.

Tolerances, each with its readings on the six views below (every
principal axis, both sides) at 16^3 / 16^2 / O = 24 and 32^3 / 24^2 /
O = 36, 1 and 2 planes per voxel, on the cell's ``ct_head`` scene under
tf1 at 128 texels:

- the port (the plain march on CPU tensors) against the reference: the
  same f32 operations in another order (the reference divides by norms
  where the port multiplies by reciprocal square roots, and composites
  through ``where`` over every plane), readings 3.0e-8 to 1.5e-7; held to
  1e-6;
- the JAX package's ``render_fast`` against the reference: XLA rounds
  its program otherwise (reciprocal products, fused multiply-adds; it
  differs from its own functions run op by op by up to 6.1e-5, see
  tests/test_torch_port_fastpath.py), readings 3.2e-6 to 3.1e-5; held to
  1e-4, as the port is held to that program;
- the reference with the volume and the TF in bfloat16 reads 4.5e-3 and
  more, and the port at half the planes 0.54 and more: both fail each
  tolerance.
"""
import ast
import os

import jax
import numpy as np
import pytest
import torch

import differender_tpu.fastpath as JF
from differender_tpu import RenderConfig as JConfig
import differender_tpu_torch as P
from differender_tpu_torch import fastpath as F
from differender_tpu_torch.ops import shear_warp as SW
from dvrbench import calibrate, harness, inputs, run, work_fast
from dvrbench.reference import dvr, shearwarp

CELL = "viewer_fast.ct_head"
JOB = "viewer_fast"
PORT_TOL = 1e-6
JAX_TOL = 1e-4
VIEWS = {                       # principal axis and side of the camera
    "+z": (1.3, 0.7, 2.1), "-z": (-1.2, 0.6, -2.0),
    "+x": (2.3, 0.5, -0.8), "-x": (-2.3, 0.5, 0.8),
    "+y": (0.4, 2.4, 0.7), "-y": (0.4, -2.4, 0.7),
}
SIZES = {"16": (16, 16, 24), "32": (32, 24, 36)}   # volume, image, O
CFG = harness.config("viewer_800_fast")
OPTICS = dvr.Optics.from_config(CFG)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its plain marches are
    many small torch operations (see tests/test_torch_port_fastpath.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(D):
    """The cell's scene at D^3 (user layout) and tf1 (4, R)."""
    vol = inputs.volume(harness.traffic("ct_head"), D,
                        inputs.generator(2 ** 32 + 2301, 0, "cpu"))
    return vol, inputs.transfer_function("tf1", CFG["tf_resolution"], "cpu")


def _config(D, HW, cls=P.RenderConfig):
    return cls(volume_shape=(D, D, D), image_shape=(HW, HW),
               tf_resolution=CFG["tf_resolution"], fov=CFG["fov"],
               near=CFG["near"], ambient=CFG["ambient"],
               diffuse=CFG["diffuse"], specular=CFG["specular"],
               shininess=CFG["shininess"],
               ert_threshold=CFG["ert_threshold"])


def _port(vol_user, tf_user, lf, D, HW, O, ppv):
    """``render_fast`` as ``Raycaster.raycast_fast`` calls it, (4, H, W)."""
    img = P.render_fast(P.volume_to_internal(vol_user).contiguous(),
                        tf_user.t().contiguous(), lf, _config(D, HW),
                        intermediate=O, planes_per_voxel=ppv).image
    return img.permute(2, 0, 1)


def _reference(vol_user, tf_user, lf, HW, O, ppv):
    return shearwarp.render_views(vol_user, tf_user, lf[None], HW, HW, O,
                                  ppv, OPTICS)[0]


def _gap(a, b):
    return float((torch.as_tensor(np.array(a)) - b).abs().max())


@pytest.mark.parametrize("ppv", [1.0, 2.0])
@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("view", list(VIEWS))
def test_port_matches_the_reference(view, size, ppv):
    D, HW, O = SIZES[size]
    vol, tf = _scene(D)
    lf = torch.tensor(VIEWS[view])
    want = _reference(vol, tf, lf, HW, O, ppv)
    assert _gap(_port(vol, tf, lf, D, HW, O, ppv), want) <= PORT_TOL
    assert float(want[3].max()) > 0.3
    # Neither the reference in bfloat16 nor half the planes passes.
    control = _reference(calibrate.bf16(vol), calibrate.bf16(tf), lf, HW,
                         O, ppv)
    assert _gap(control, want) > JAX_TOL
    assert _gap(_port(vol, tf, lf, D, HW, O, ppv / 2), want) > JAX_TOL


@pytest.mark.parametrize("ppv", [1.0, 2.0])
@pytest.mark.parametrize("size", sorted(SIZES))
def test_jax_render_fast_matches_the_reference(size, ppv):
    D, HW, O = SIZES[size]
    vol, tf = _scene(D)
    vol_i = dvr.internal(vol).numpy()
    tf_i = tf.t().contiguous().numpy()
    jcfg = _config(D, HW, JConfig)
    for view, lf in VIEWS.items():
        lf = np.array(lf, np.float32)
        got = JF.render_fast(vol_i, tf_i, lf, jcfg, intermediate=O,
                             planes_per_voxel=ppv,
                             precision=jax.lax.Precision.HIGHEST).image
        want = _reference(vol, tf, torch.from_numpy(lf), HW, O, ppv)
        assert _gap(np.asarray(got).transpose(2, 0, 1), want) <= JAX_TOL, \
            view


def test_the_reference_imports_nothing_of_the_program():
    path = os.path.join(harness.HERE, "reference", "shearwarp.py")
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
            assert node.level == 0 or node.module == "dvr" or \
                [a.name for a in node.names] == ["dvr"], ast.dump(node)
        for n in names:
            assert n.split(".")[0] not in ("differender_tpu",
                                           "differender_tpu_torch", "jax"), n


@pytest.mark.parametrize("view", ["+z", "-x", "+y"])
def test_k8_work_counts_every_in_footprint_sample_without_the_gate(view):
    """With ``ert_threshold`` 1 no pixel stops, so K8's samples are every
    plane's in-footprint pixels: the port's ``footprint`` of its own
    geometry, counted here."""
    D, HW, O = SIZES["16"]
    vol, tf = _scene(D)
    lf = torch.tensor(VIEWS[view])
    cfg = dict(CFG, volume=[D] * 3, image=[HW, HW], intermediate=O,
               ert_threshold=1.0)
    ops, nbytes = work_fast.k8_launch_work(vol, tf, lf, cfg)
    ch, lf_f, light_f, _, _ = F._frame(P.volume_to_internal(vol), lf)
    _, geom, _ = F._slab_inputs(ch, lf_f, light_f, _config(D, HW), O, 2.0)
    x_in, y_in = SW.footprint(geom, D, D)
    samples = int((x_in.sum(1) * y_in.sum(1)).sum())
    zlerps = (ops - samples * work_fast.SAMPLE_OPS) / work_fast.ZLERP_OPS
    assert samples > 0 and zlerps == int(zlerps)
    assert 0 < zlerps <= geom.zws.numel() * D * D
    assert O * O * 20 < nbytes <= D ** 3 * 16 + O * O * 20 + 128 * 16
    _, gated = work_fast.k8_launch_work(vol, tf, lf, dict(cfg,
                                                          ert_threshold=0.99))
    assert gated <= nbytes


def test_the_cell_runs_correct_on_the_cpu():
    r = run.run_cell(CELL, 2 ** 33 + 2301, 0.3, False, "cpu",
                     overrides=harness.small(JOB))
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"frame_ms", "frame_p95_ms", "setup_s"}


FAULTS = harness.faults(JOB)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_faults_read_past_the_limits(fault):
    with FAULTS[fault]():
        r = run.run_cell(CELL, 2 ** 33 + 2302, 0.3, False, "cpu",
                         overrides=harness.small(JOB))
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values()), \
        r["checks"]


def test_the_control_reads_past_the_limits():
    w = harness.cell(CELL)
    cfg = dict(harness.config(w["config"]), **harness.small(JOB))
    job = harness.job(JOB).Job(cfg, harness.traffic(w["traffic"]),
                               2 ** 33 + 2303, "cpu")
    job.setup()
    job.window(0.3)
    job.release()
    got = job.compare(job.reference(calibrate.bf16), job.reference())
    assert any(got[k] > lim for k, lim in harness.limits(CELL).items()), got


def test_the_traced_cell_reads_its_span_metrics_on_the_cpu():
    r = run.run_cell(CELL, 2 ** 33 + 2304, 0.3, True, "cpu",
                     overrides=harness.small(JOB))
    assert r["correct"] is True, r["checks"]
    for m in ("slab_frame_host_ms.viewer_fast", "warp_host_ms.viewer_fast",
              "view_host_ms.viewer"):
        assert r["metrics"][m]["value"] > 0.0, m
    # No kernel on the CPU: the device readers read nothing.
    assert "k8_ms.viewer_fast" not in r["metrics"]
