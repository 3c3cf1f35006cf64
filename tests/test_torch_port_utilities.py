"""The port's utilities against the JAX package's: ``profiling``
(``march_stats``, ``trace``, ``annotate``, ``timed``), ``video`` (the AVI's
bytes), ``plotting`` (decoded pixels, figure sizes) and ``TorchRaycaster``
(the cases of ``tests/test_torch_interop.py``, run on both modules in one
torch loop at 16^3 and 16^2 with JAX's jitter draw injected).

Limits, PERF.md section 2's on the CPU: images 2e-4, gradients 2e-3 times
the largest, ``d_look_from`` 1e-3 of its norm.  AVI files, PNGs and GIFs
are compared exactly: the frames reach PIL as the same bytes.
"""
import glob
import os
import struct

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from conftest import make_sphere_volume
from differender_tpu import RenderConfig as JConfig
from differender_tpu import get_tf as j_get_tf
from differender_tpu import get_tf_torch_layout as j_tf_layout
from differender_tpu import render as j_render
from differender_tpu import plotting as JPL
from differender_tpu import profiling as JPR
from differender_tpu import video as JVID
from differender_tpu.torch_interop import TorchRaycaster as JTorchRaycaster
import differender_tpu_torch as P
from differender_tpu_torch import plotting as PPL
from differender_tpu_torch import profiling as PPR
from differender_tpu_torch import video as PVID

IMG_TOL = 2e-4
GRAD_TOL = 2e-3
CAMERA_TOL = 1e-3


# -- profiling ----------------------------------------------------------------

def test_march_stats_match_jax(shell_volume):
    """On JAX's render of tests/test_profiling.py: JAX's statistics of its
    output equal the port's of the same counts, and of the port's own
    render of the same scene (its valid_steps equal JAX's)."""
    cfg = dict(volume_shape=shell_volume.shape, image_shape=(8, 8),
               max_samples=48, block_size=8)
    tf = np.zeros((16, 4), np.float32)
    tf[8:] = 0.95
    lf = np.array([0.0, 0.5, 2.6], np.float32)
    out = j_render(shell_volume, tf, jnp.asarray(lf), JConfig(**cfg),
                   sampling_rate=1.0)
    want = JPR.march_stats(out)
    same = P.RenderOutput(*(torch.from_numpy(np.array(x)) for x in out))
    assert PPR.march_stats(same) == want
    mine = P.render(torch.from_numpy(shell_volume), torch.from_numpy(tf),
                    torch.from_numpy(lf), P.RenderConfig(**cfg), 1.0)
    assert PPR.march_stats(mine) == want
    assert want["terminated_early_fraction"] > 0


def test_trace_writes_a_cpu_trace(tmp_path):
    vol = torch.from_numpy(make_sphere_volume((16, 16, 16)))
    tf = P.get_tf("tf1", 16, device="cpu")
    cfg = P.RenderConfig(volume_shape=(16, 16, 16), image_shape=(8, 8),
                         tf_resolution=16, max_samples=32)
    with PPR.trace(str(tmp_path), device="cpu") as prof:
        with PPR.annotate("port-render"):
            P.render(vol, tf, torch.tensor([1.2, 0.8, 2.0]), cfg)
    files = glob.glob(os.path.join(str(tmp_path), "*.pt.trace.json"))
    assert len(files) == 1 and os.path.getsize(files[0]) > 0
    with open(files[0]) as f:
        assert "port-render" in f.read()
    assert any(e.key == "port-render" for e in prof.key_averages())


def test_trace_of_the_card_without_one_raises(tmp_path):
    """No quiet CPU trace where a card's was asked for."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        with PPR.trace(str(tmp_path)):
            pass


def test_annotate_and_timed():
    """As tests/test_profiling.py: the scope runs, ``timed`` records."""
    results = {}
    with PPR.annotate("test-scope"):
        with PPR.timed("block", results):
            _ = torch.ones(8).sum()
    assert "block" in results and results["block"] >= 0


# -- video and plotting ---------------------------------------------------------

def _frames(n=4, h=24, w=32):
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    return [np.stack([xx, yy, np.full_like(xx, i / n), 0.5 + 0 * xx], -1)
            .astype(np.float32) * 1.1 - 0.05 for i in range(n)]


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("kind", ["float", "uint8", "tensor"])
def test_avi_bytes_match_jax(tmp_path, kind):
    """The same frames (floats outside [0, 1] included; uint8; the floats as
    tensors) give the JAX writer's file byte for byte."""
    frames = _frames()
    if kind == "uint8":
        frames = [(np.clip(f, 0, 1) * 255).astype(np.uint8) for f in frames]
    want = JVID.save_video(frames, str(tmp_path / "jax.avi"), fps=12)
    port = [torch.from_numpy(f) for f in frames] if kind == "tensor" \
        else frames
    got = PVID.save_video(port, str(tmp_path / "port.avi"), fps=12)
    assert _read(got) == _read(want)
    data = _read(got)
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI "
    assert struct.unpack("<I", data[4:8])[0] == len(data) - 8


def test_video_writer_context_and_refusals(tmp_path):
    with PVID.VideoWriter(str(tmp_path / "clip"), fps=10) as vw:
        vw.write_frame(torch.zeros((16, 16, 4)))
        with pytest.raises(ValueError):
            vw.write_frame(np.zeros((8, 8, 3), np.float32))
        vw.write_frame(np.ones((16, 16, 3)) * 0.5)
    assert vw.path.endswith(".avi") and vw.n_frames == 0
    with open(vw.path, "rb") as f:
        assert f.read(4) == b"RIFF"
    with pytest.raises(ValueError):
        PVID.VideoWriter(str(tmp_path / "x.avi")).close()


def _pixels(path):
    return np.asarray(Image.open(path).convert("RGBA"))


@pytest.mark.parametrize("layout", ["hwc", "chw", "tensor"])
def test_save_image_matches_jax(tmp_path, layout):
    img = np.random.default_rng(0).random((16, 12, 4)).astype(np.float32)
    img[0, 0] = (-0.5, 1.5, 0.5, 1.0)
    arg = {"hwc": img, "chw": np.transpose(img, (2, 0, 1)),
           "tensor": torch.from_numpy(img).permute(2, 0, 1)}[layout]
    JPL.save_image(img, str(tmp_path / "jax.png"))
    PPL.save_image(arg, str(tmp_path / "port.png"))
    np.testing.assert_array_equal(_pixels(tmp_path / "port.png"),
                                  _pixels(tmp_path / "jax.png"))


def test_save_gif_matches_jax(tmp_path):
    frames = [np.random.default_rng(i).random((8, 8, 3)).astype(np.float32)
              for i in range(4)]
    JPL.save_gif(frames, str(tmp_path / "jax.gif"), fps=4)
    PPL.save_gif([torch.from_numpy(f) for f in frames],
                 str(tmp_path / "port.gif"), fps=4)
    a, b = Image.open(tmp_path / "jax.gif"), Image.open(tmp_path / "port.gif")
    assert a.n_frames == b.n_frames == 4
    for k in range(4):
        a.seek(k)
        b.seek(k)
        np.testing.assert_array_equal(np.asarray(b.convert("RGB")),
                                      np.asarray(a.convert("RGB")))


def test_figures_match_jax_sizes(tmp_path):
    """plot_tfs, plot_comp_render_tf and save_histogram write figures of
    JAX's sizes, from tensors."""
    tf = np.array(j_get_tf("tf1", 64))
    img = np.random.default_rng(0).random((4, 16, 16)).astype(np.float32)
    tf_t, img_t = torch.from_numpy(tf), torch.from_numpy(img)
    JPL.plot_tfs([(tf, "target"), (tf * 0.5, "pred")],
                 path=str(tmp_path / "jax_tfs.png"))
    PPL.plot_tfs([(tf_t, "target"), (tf_t * 0.5, "pred")],
                 path=str(tmp_path / "port_tfs.png"))
    JPL.plot_comp_render_tf([(img, tf, "Prediction"), (img, tf, "Target")],
                            path=str(tmp_path / "jax_comp.png"),
                            suptitle="step 1")
    PPL.plot_comp_render_tf([(img_t, tf_t, "Prediction"),
                             (img_t, tf_t, "Target")],
                            path=str(tmp_path / "port_comp.png"),
                            suptitle="step 1")
    JPL.save_histogram(img, str(tmp_path / "jax_hist.png"))
    PPL.save_histogram(img_t, str(tmp_path / "port_hist.png"))
    for name in ("tfs", "comp", "hist"):
        port, want = tmp_path / f"port_{name}.png", tmp_path / f"jax_{name}.png"
        assert port.stat().st_size > 1000
        assert Image.open(port).size == Image.open(want).size


# -- TorchRaycaster ----------------------------------------------------------------

LF = (1.2, 0.8, 2.0)


def _inputs():
    vol = np.transpose(make_sphere_volume((16, 16, 16)), (1, 2, 0))[None]
    return (torch.from_numpy(vol.copy()),
            torch.from_numpy(np.array(j_tf_layout("tf5", 16))),
            torch.tensor(LF))


def _modules(**kw):
    """The JAX bridge and the port's module, same arguments."""
    kw.setdefault("jitter", False)
    args = ((16, 16, 16), (16, 16), 16)
    kw = dict(sampling_rate=0.5, max_samples=64, block_size=8, **kw)
    return {"jax": JTorchRaycaster(*args, **kw),
            "port": P.TorchRaycaster(*args, device="cpu", **kw)}


def _close(got, want, tol, what):
    got, want = got.detach().numpy(), want.detach().numpy()
    scale = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, what


def test_torch_raycaster_forward_and_backward():
    out = {}
    for name, m in _modules().items():
        vol, tf, lf = _inputs()
        vol.requires_grad_(True)
        tf.requires_grad_(True)
        img = m(vol, tf, lf)
        assert img.shape == (4, 16, 16) and img.dtype == torch.float32
        assert img.is_contiguous()
        (img ** 2).mean().backward()
        assert lf.grad is None
        out[name] = (img.detach(), vol.grad, tf.grad)
    assert _modules()["port"]._last_u is None
    np.testing.assert_allclose(out["port"][0].numpy(), out["jax"][0].numpy(),
                               rtol=0, atol=IMG_TOL)
    _close(out["port"][1], out["jax"][1], GRAD_TOL, "d_volume")
    _close(out["port"][2], out["jax"][2], GRAD_TOL, "d_tf")


def test_torch_raycaster_camera_grads():
    grads = {}
    for name, m in _modules(camera_grads=True).items():
        vol, tf, lf = _inputs()
        lf.requires_grad_(True)
        (m(vol, tf, lf) ** 2).mean().backward()
        assert torch.isfinite(lf.grad).all()
        grads[name] = lf.grad.numpy()
    assert np.abs(grads["port"] - grads["jax"]).max() <= \
        CAMERA_TOL * np.linalg.norm(grads["jax"])


@pytest.mark.parametrize("impl", ["jax", "port"])
def test_torch_raycaster_refuses_tiled_camera_grads(impl):
    cls = JTorchRaycaster if impl == "jax" else P.TorchRaycaster
    kw = {} if impl == "jax" else {"device": "cpu"}
    with pytest.raises(ValueError, match="march_vjp"):
        cls((16, 16, 16), (16, 16), 16, jitter=False, camera_grads=True,
            march_vjp="tiled", march_table="super64", **kw)


def test_torch_raycaster_batched():
    """Anything batched makes everything batched; the unbatched volume's
    gradient sums its views'."""
    lfs = torch.tensor([[1.2, 0.8, 2.0], [-1.0, 0.4, 2.1]])
    out = {}
    for name, m in _modules().items():
        vol, tf, _ = _inputs()
        vol.requires_grad_(True)
        img = m(vol, tf, lfs)
        assert img.shape == (2, 4, 16, 16)
        img.square().mean().backward()
        assert vol.grad.shape == vol.shape
        out[name] = (img.detach(), vol.grad)
    np.testing.assert_allclose(out["port"][0].numpy(), out["jax"][0].numpy(),
                               rtol=0, atol=IMG_TOL)
    _close(out["port"][1], out["jax"][1], GRAD_TOL, "d_volume")


def test_torch_raycaster_jitter_draw_replay():
    """JAX's forward draws a key and its backward replays it; the port's
    forward, given that key's draw as u, matches both, and the port's own
    draw (``_last_u``) is the one its backward replays."""
    mods = _modules(jitter=True, seed=7)
    out = {}
    for name in ("jax", "port"):
        vol, tf, lf = _inputs()
        vol.requires_grad_(True)
        if name == "jax":
            img = mods["jax"](vol, tf, lf)
            key = mods["jax"]._last_key
            u = torch.from_numpy(np.array(jax.random.uniform(
                key, (16, 16), jnp.float32)))
        else:
            img = mods["port"](vol, tf, lf, u=u)
            assert torch.equal(mods["port"]._last_u, u)
        img.square().mean().backward()
        out[name] = (img.detach(), vol.grad)
    np.testing.assert_allclose(out["port"][0].numpy(), out["jax"][0].numpy(),
                               rtol=0, atol=IMG_TOL)
    _close(out["port"][1], out["jax"][1], GRAD_TOL, "d_volume")
    # The port's own draw, replayed by the backward.
    m = mods["port"]
    vol, tf, lf = _inputs()
    vol.requires_grad_(True)
    img = m(vol, tf, lf)
    u_own = m._last_u
    assert u_own is not None and not torch.equal(u_own, u)
    img.square().mean().backward()
    v2 = vol.detach().clone().requires_grad_(True)
    img2 = P.Raycaster((16, 16, 16), (16, 16), 16, sampling_rate=0.5,
                       max_samples=64, block_size=8, device="cpu")(
        v2, tf, lf, u=u_own)
    img2.square().mean().backward()
    assert torch.equal(img.detach(), img2.detach())
    assert torch.equal(vol.grad, v2.grad)


def test_torch_raycaster_nan_grads_scrubbed():
    """A NaN in the image cotangent reaches the inputs as 0, as the
    reference scrubs it."""
    m = _modules()["port"]
    vol, tf, lf = _inputs()
    vol.requires_grad_(True)
    img = m(vol, tf, lf)
    g = torch.zeros_like(img)
    g[0, 8, 8] = float("nan")
    img.backward(g)
    assert torch.isfinite(vol.grad).all()


def test_torch_raycaster_raycast_nondiff():
    out = {}
    for name, m in _modules().items():
        vol, tf, lf = _inputs()
        vol.requires_grad_(True)
        img = m.raycast_nondiff(vol, tf, lf, sampling_rate=2.0)
        assert img.shape == (4, 16, 16) and not img.requires_grad
        out[name] = img
    np.testing.assert_allclose(out["port"].numpy(), out["jax"].numpy(),
                               rtol=0, atol=IMG_TOL)
    fast = _modules()["port"].raycast_fast(*_inputs())
    assert fast.shape == (4, 16, 16) and not fast.requires_grad


def test_torch_raycaster_optimizer_step():
    """tests/test_torch_interop.py's torch Adam loop on each module, from a
    flat TF of 0.3: the loss falls on both.  Their losses are not compared:
    that TF is opaque where the volume is flat, where the normals are
    rounding noise that the two packages round apart."""
    for name, m in _modules().items():
        vol, tf, lf = _inputs()
        with torch.no_grad():
            target = m(vol, tf, lf)
        tf0 = torch.full_like(tf, 0.3).requires_grad_(True)
        opt = torch.optim.Adam([tf0], lr=0.05)
        losses = []
        for _ in range(5):
            opt.zero_grad()
            loss = torch.nn.functional.mse_loss(m(vol, tf0, lf), target)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
        assert losses[-1] < losses[0], (name, losses)
