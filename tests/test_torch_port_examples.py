"""The port's example scripts (``differender_tpu_torch/examples/``): each
runs with ``--cpu`` at a tiny size in a subprocess that loads no JAX, and
``render_nondiff.run``'s image equals the JAX package's
``render_nondiff_strips`` on the scene and camera that
``examples/render_nondiff.py`` builds, within PERF.md section 2's CPU limit
for images (2e-4).
"""
import importlib.util
import io
import json
import os
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from differender_tpu import RenderConfig as JConfig
from differender_tpu import get_tf as j_get_tf
from differender_tpu import render_nondiff_strips as j_strips
from differender_tpu.raycaster import volume_to_internal as j_to_internal
from differender_tpu_torch.examples import render_nondiff as ex_render
from differender_tpu_torch.io import load_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG_TOL = 2e-4
TINY = {
    "render_nondiff": ["--res", "16", "--shape", "16", "16", "16",
                       "--sampling-rate", "2"],
    "optimize_tf": ["backward", "--res", "16", "--vol-res", "16",
                    "--tf-res", "16", "--iterations", "3",
                    "--max-samples", "64", "--log-every", "2",
                    "--fw-sampling-rate", "2"],
    "optimize_tf_torch": ["--res", "16", "--vol-res", "16", "--tf-res", "16",
                          "--iterations", "3"],
    "optimize_volume": ["--res", "16", "--img-res", "16", "--tf-res", "16",
                        "--bs", "2", "--max-samples", "64",
                        "--gt-sampling-rate", "2", "--checkpoint-every", "2",
                        "--log-figures-every", "2"],
}


def _code(name, argv):
    """A program that runs the example as ``__main__`` with ``argv`` and
    then fails if JAX or the JAX package was loaded."""
    return ("import runpy, sys\n"
            f"sys.argv = {[name] + list(argv)!r}\n"
            f"runpy.run_module('differender_tpu_torch.examples.{name}', "
            "run_name='__main__')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'differender_tpu', 'experiments')]\n"
            "assert not bad, bad\n")


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"
    return env


def _run(name, argv, timeout=120):
    out = subprocess.run([sys.executable, "-c", _code(name, argv)],
                         cwd=ROOT, env=_env(), capture_output=True,
                         text=True, timeout=timeout)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def test_render_nondiff_script(tmp_path):
    out = str(tmp_path / "render.png")
    log = _run("render_nondiff", TINY["render_nondiff"] + ["--cpu", "--out",
                                                           out])
    assert "saved" in log
    assert np.asarray(Image.open(out)).shape[:2] == (16, 16)


def test_render_nondiff_run_matches_jax():
    """The script's render against JAX's render_nondiff_strips on the JAX
    script's own volume (its ``synthetic_volume``), TF and camera."""
    args = ex_render.parser().parse_args(TINY["render_nondiff"] + ["--cpu"])
    got = ex_render.run(args)["image"]
    spec = importlib.util.spec_from_file_location(
        "jax_render_nondiff_example",
        os.path.join(ROOT, "examples", "render_nondiff.py"))
    jex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jex)
    vol = j_to_internal(jnp.asarray(jex.synthetic_volume(16)))
    cfg = JConfig(volume_shape=vol.shape, image_shape=(16, 16),
                  tf_resolution=128, max_samples=1, jitter=False)
    want = j_strips(vol, j_get_tf("tf1", 128),
                    jnp.asarray(np.array([0.0, 1.0, -2.3], np.float32)), cfg,
                    sampling_rate=2.0, n_strips=4).image
    want = np.asarray(want)
    assert float(want[..., 3].max()) > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=IMG_TOL)


@pytest.mark.parametrize("task", ["backward", "forward"])
def test_optimize_tf_script(tmp_path, task):
    argv = TINY["optimize_tf"][1:] + ["--cpu", "--results", str(tmp_path)]
    log = _run("optimize_tf", [task] + argv)
    if task == "backward":
        assert "final TF L1" in log
        for name in ("optimization.avi", "temp_reference.npy",
                     "tf_comparison_000.png", "tf_comparison_002.png"):
            assert (tmp_path / name).exists(), name
    else:
        for name in ("orbit.gif", "orbit.avi", "frame0.png"):
            assert (tmp_path / name).exists(), name


def test_optimize_tf_torch_script(tmp_path):
    out = str(tmp_path / "tfs.png")
    log = _run("optimize_tf_torch", TINY["optimize_tf_torch"] + [
        "--cpu", "--out", out])
    assert "TorchRaycaster" in log and os.path.getsize(out) > 1000


def test_optimize_volume_checkpoint_and_resume(tmp_path):
    """Four steps write checkpoints at steps 2 and 4 (and the figures);
    ``--resume`` from the last continues at step 4 and runs steps 4 and 5,
    in the joint-graph view mode."""
    base = TINY["optimize_volume"] + ["--cpu", "--results", str(tmp_path)]
    log = _run("optimize_volume", base + ["--iterations", "4"])
    assert "Step 003" in log
    ckpt = str(tmp_path / "ckpt.pkl")
    state, step = load_checkpoint(ckpt)
    assert step == 4
    assert set(state) == {"volume", "opt_state", "generator"}
    assert isinstance(state["volume"], np.ndarray)
    for name in ("comparison_plot_000.png", "comparison_plot_002.png",
                 "hist_002.png"):
        assert (tmp_path / name).exists(), name
    log = _run("optimize_volume", base + ["--iterations", "6", "--resume",
                                          ckpt, "--view-mode", "vmap"])
    assert "at step 4" in log and "Step 004" in log and "Step 005" in log
    assert "Step 003" not in log
    assert load_checkpoint(ckpt)[1] == 6


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# No proxy: the requests go to the server on 127.0.0.1 and nowhere else.
_LOCAL = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _get(url, timeout=30.0):
    with _LOCAL.open(url, timeout=timeout) as r:
        return r.read()


def test_interactive_viewer_serves_frames_and_exits():
    """``--frames 2``: the server on 127.0.0.1 answers two frame requests,
    then exits 0."""
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-c", _code("interactive_viewer", [
            "--cpu", "--res", "16", "--vol-res", "16", "--frames", "2",
            "--port", str(port)])],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        base = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + 60
        while True:
            try:
                assert json.loads(_get(base + "/health", 1.0))["ok"]
                break
            except OSError:
                assert proc.poll() is None, proc.stdout.read()
                assert time.monotonic() < deadline, "no server"
                time.sleep(0.2)
        for angle in ("0", "0.15"):
            png = _get(f"{base}/frame?angle={angle}")
            assert np.asarray(Image.open(io.BytesIO(png))).shape == (16, 16,
                                                                     3)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    assert "served 2 frames" in out


def test_interactive_viewer_run_without_server():
    from differender_tpu_torch.examples import interactive_viewer as ex_view
    args = ex_view.parser().parse_args(["--cpu", "--res", "16", "--vol-res",
                                        "16", "--frames", "3"])
    frames = ex_view.run(args)["frames"]
    assert len(frames) == 3 and all(f.shape == (16, 16, 4) for f in frames)
    assert not torch.equal(frames[0], frames[1])
