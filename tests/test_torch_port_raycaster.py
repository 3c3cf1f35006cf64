"""The torch port's ``Raycaster`` against the JAX package's (CPU).

A ``(1, 20, 24, 28)`` volume and a non-square image make any D/H/W or
H/W mix-up fail.  Both raycasters are built without jitter: their random
generators differ, and jitter parity is covered in test_torch_port_render.
Tolerances as in test_torch_port_render (ERT knife edge on the forward).
"""
import numpy as np
import pytest
import torch

from differender_tpu import Raycaster as JRaycaster
import differender_tpu_torch as P

VOL_SHAPE = (20, 24, 28)       # (D, H, W)
OUT = (10, 12)                 # (W, H)
R = 16
KW = dict(sampling_rate=1.0, jitter=False, max_samples=32)
BS = 2


@pytest.fixture(scope="module")
def rcs():
    return (JRaycaster(VOL_SHAPE, OUT, R, **KW),
            P.Raycaster(VOL_SHAPE, OUT, R, device="cpu", **KW))


def _inputs(batched):
    rng = np.random.default_rng(11)
    vol = rng.random((BS, 1) + VOL_SHAPE, np.float32) * 0.5
    tf = np.stack([np.asarray(P.get_tf_torch_layout(t, R, device="cpu"))
                   for t in ("tf1", "tf2")])
    lf = np.array([[1.2, 0.8, 2.0], [-2.0, 0.3, -0.4]], np.float32)
    return (vol if batched == "volume" else vol[0],
            tf if batched == "tf" else tf[0],
            lf if batched == "camera" else lf[0])


def _check_image(got, want, ert):
    assert got.shape == want.shape
    err = np.abs(got - want)
    if ert:
        assert (err > 2e-4).mean() <= 1e-3 and err.max() < 0.08, err.max()
    else:
        assert err.max() <= 2e-4, err.max()


@pytest.mark.parametrize("batched", [None, "volume", "tf", "camera"])
def test_forward(rcs, batched):
    jr, pr = rcs
    vol, tf, lf = _inputs(batched)
    want = jr.forward_with_aux(vol, tf, lf)
    got = pr.forward_with_aux(*P.state_from_numpy(
        vol, tf, lf, layout="reference", device="cpu"))
    expect = (4, OUT[1], OUT[0]) if batched is None else (BS, 4, OUT[1],
                                                         OUT[0])
    assert tuple(got.image.shape) == expect
    _check_image(got.image.numpy(), np.asarray(want.image), ert=True)
    np.testing.assert_array_equal(got.n_samples.numpy(),
                                  np.asarray(want.n_samples))
    assert np.abs(got.valid_steps.numpy()
                  - np.asarray(want.valid_steps)).max() <= 1
    if batched is not None:       # the views really differ
        assert not torch.allclose(got.image[0], got.image[1])


@pytest.mark.parametrize("batched", [None, "volume", "tf", "camera"])
def test_raycast_nondiff(rcs, batched):
    jr, pr = rcs
    vol, tf, lf = _inputs(batched)
    want = np.asarray(jr.raycast_nondiff(vol, tf, lf, sampling_rate=2.0))
    got = pr.raycast_nondiff(vol, tf, lf, sampling_rate=2.0)
    _check_image(got.numpy(), want, ert=True)


def test_forward_is_module_call(rcs):
    _, pr = rcs
    vol, tf, lf = _inputs(None)
    assert isinstance(pr, torch.nn.Module)
    assert torch.equal(pr(vol, tf, lf), pr.forward(vol, tf, lf))


def test_jitter_draws_from_the_module_generator():
    vol, tf, lf = _inputs(None)
    a = P.Raycaster(VOL_SHAPE, OUT, R, jitter=True, seed=5, device="cpu")
    b = P.Raycaster(VOL_SHAPE, OUT, R, jitter=True, seed=5, device="cpu")
    assert torch.equal(a(vol, tf, lf), b(vol, tf, lf))
    assert not torch.equal(a(vol, tf, lf), b.forward(vol, tf, lf,
                                                     u=torch.zeros(12, 10)))


@pytest.mark.parametrize("bad", ["volume_axes", "tf_layout", "camera"])
def test_shape_errors_match(rcs, bad):
    jr, pr = rcs
    vol, tf, lf = _inputs(None)
    if bad == "volume_axes":
        vol = np.swapaxes(vol, 1, 2)
    elif bad == "tf_layout":
        tf = tf.T
    else:
        lf = lf[:2]
    with pytest.raises(ValueError):
        jr.forward(vol, tf, lf)
    with pytest.raises(ValueError):
        pr.forward(vol, tf, lf)
    with pytest.raises(ValueError):
        pr.raycast_nondiff(vol, tf, lf)


@pytest.mark.parametrize("entry", ["forward", "raycast_nondiff"])
def test_batch_is_a_loop_over_views(rcs, entry):
    _, pr = rcs
    vol, tf, lf = _inputs("volume")
    render = getattr(pr, entry)
    batch = render(vol, tf, lf)
    for i in range(BS):
        assert torch.equal(batch[i], render(vol[i], tf, lf))
