"""The port's TF lookup (K0's plain version) against the JAX package's
reference and its Pallas kernel in interpret mode (CPU)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from differender_tpu.ops import tf_lookup_pallas
from differender_tpu.ops import tf_lookup_reference as j_ref
import differender_tpu_torch as P

EDGES = np.array([-0.2, 0.0, 0.999999, 1.0, 1.3], np.float32)
ATOL = 1e-6


def _data(n, R, seed):
    rng = np.random.default_rng(seed)
    tf = rng.random((R, 4), dtype=np.float32)
    x = np.concatenate([rng.random(n - EDGES.size, dtype=np.float32), EDGES])
    return tf, x


@pytest.mark.parametrize("R", [32, 128])
def test_reference_matches_jax_reference(R):
    tf, x = _data(3000, R, R)
    got = P.tf_lookup_reference(torch.from_numpy(tf), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(j_ref(jnp.asarray(tf),
                                                jnp.asarray(x))), atol=ATOL)


@pytest.mark.parametrize("R", [32, 128])
def test_reference_matches_pallas_kernel(R):
    tf, x = _data(3000, R, R + 1)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(tf_lookup_pallas(jnp.asarray(tf), jnp.asarray(x)))
    got = P.tf_lookup(torch.from_numpy(tf), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_2d_shape():
    tf, x = _data(2048, 128, 7)
    x2 = x.reshape(32, 64)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(tf_lookup_pallas(jnp.asarray(tf), jnp.asarray(x2)))
    got = P.tf_lookup(torch.from_numpy(tf), torch.from_numpy(x2))
    assert got.shape == (32, 64, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_edges_clamp_to_end_texels():
    tf, _ = _data(16, 16, 9)
    got = P.tf_lookup(torch.from_numpy(tf), torch.from_numpy(EDGES)).numpy()
    np.testing.assert_allclose(got[0], tf[0], atol=ATOL)     # -0.2
    np.testing.assert_allclose(got[1], tf[0], atol=ATOL)     # 0
    np.testing.assert_allclose(got[3], tf[-1], atol=ATOL)    # 1
    np.testing.assert_allclose(got[4], tf[-1], atol=ATOL)    # 1.3


def test_cpu_lookup_does_not_launch():
    P.reset_launch_counts()
    tf, x = _data(64, 32, 2)
    P.tf_lookup(torch.from_numpy(tf), torch.from_numpy(x))
    assert P.launch_counts()["tf_lookup_fwd"] == 0


def _int_t_data(n, R, seed):
    """``_data`` plus intensities whose t = i*(R-1) is an exact integer in
    f32: where the Pallas mask and the march's ``frac > 0`` rule differ."""
    tf, x = _data(n, R, seed)
    k = np.arange(1, R - 1, dtype=np.float32) / np.float32(R - 1)
    k = k[(k * np.float32(R - 1)) == np.round(k * np.float32(R - 1))]
    return tf, np.concatenate([x, k])


@pytest.mark.parametrize("R", [32, 128])
def test_grads_match_pallas_kernel(R):
    """``tf_lookup``'s gradients against ``jax.grad`` of the Pallas kernel
    (interpret mode), every intensity included: the raw mask
    ``0 < i*(R-1) < R-1`` keeps the slope at interior integer t."""
    tf, x = _int_t_data(3000, R, R + 2)
    w = np.random.default_rng(R).random((x.size, 4), np.float32) - 0.5

    def loss(t, i):
        return jnp.sum(tf_lookup_pallas(t, i) * jnp.asarray(w))

    with pltpu.force_tpu_interpret_mode():
        want_tf, want_x = jax.grad(loss, argnums=(0, 1))(jnp.asarray(tf),
                                                          jnp.asarray(x))
    tt = torch.from_numpy(tf).requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    torch.sum(P.tf_lookup(tt, xt) * torch.from_numpy(w)).backward()
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(want_tf),
                               atol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x),
                               rtol=1e-5, atol=1e-4)
    t = x * np.float32(R - 1)
    at_int = (t == np.round(t)) & (t > 0) & (t < R - 1)
    assert at_int.any() and (xt.grad.numpy()[at_int] != 0).all()
    assert (xt.grad.numpy()[t <= 0] == 0).all()


def test_bwd_reference_is_the_cpu_backward():
    tf, x = _int_t_data(500, 64, 4)
    g = np.random.default_rng(5).random((x.size, 4), np.float32)
    d_tf, d_x = P.tf_lookup_bwd(torch.from_numpy(tf), torch.from_numpy(x),
                                torch.from_numpy(g))
    r_tf, r_x = P.tf_lookup_bwd_reference(
        torch.from_numpy(tf), torch.from_numpy(x), torch.from_numpy(g))
    assert torch.equal(d_tf, r_tf) and torch.equal(d_x, r_x)
    assert P.launch_counts()["tf_lookup_bwd"] == 0
