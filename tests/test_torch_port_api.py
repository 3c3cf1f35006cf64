"""The small API of the torch port against the JAX package: the random
peaked TF (``get_tf('generate')``, ``random_peaks_tf``), whose rasterizer
takes JAX's own draws here (torch cannot replay ``jax.random``), the
structure of a TF drawn by torch, ``premultiply_alpha``,
``value_and_clean_grad`` and the ``render_jit`` / ``render_nondiff_jit``
aliases.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from differender_tpu import get_tf as j_get_tf
from differender_tpu.optim import value_and_clean_grad as j_value_and_clean
from differender_tpu.shading import premultiply_alpha as j_premultiply
from differender_tpu.transfer import random_peaks_tf as j_random_peaks_tf
import differender_tpu_torch as P
from differender_tpu_torch.transfer import Peaks, draw_peaks, peaks_points


def _jax_draws(key, max_num_peaks=2):
    """The draws of JAX's ``random_peaks_tf`` for ``key``, in its order."""
    k1, k2, k3, k4, k5, k6 = jax.random.split(key, 6)
    n = int(jax.random.randint(k1, (), 1, max_num_peaks + 1))

    def uniform(k, shape, lo, hi):
        return np.asarray(jax.random.uniform(k, shape, minval=lo, maxval=hi))

    return Peaks(np.sort(uniform(k2, (n,), 0.08, 0.85)),
                 uniform(k3, (n,), 0.02, 0.15), uniform(k4, (n,), 0.1, 0.9),
                 uniform(k5, (n,), 0.15, 0.95),
                 uniform(k6, (n, 3), 0.05, 1.0))


@pytest.mark.parametrize("res", [32, 128])
@pytest.mark.parametrize("seed", [0, 2, 3, 18])
def test_generate_rasterizer_matches_jax(seed, res):
    """JAX's draws through the port's peaks -> control points -> texture
    give JAX's ``random_peaks_tf``, and ``get_tf('generate')`` is that
    function.  Seed 0 draws two peaks, the second swallowed by the first;
    seeds 2 and 18 keep two; seed 3 draws one."""
    key = jax.random.PRNGKey(seed)
    got = P.tex_from_pts(peaks_points(_jax_draws(key)), res, device="cpu")
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(j_random_peaks_tf(key, res)),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        np.asarray(j_get_tf("generate", res, key=key)),
        np.asarray(j_random_peaks_tf(key, res)))


def test_generated_tf_structure():
    """A TF drawn by torch has the structure tests/test_transfer.py checks
    for JAX's: (R, 4), a peak of alpha above 0.1, another draw differs;
    the draws lie in their ranges, centres sorted; 'generate' needs a
    generator."""
    gen = torch.Generator().manual_seed(2)
    t = P.get_tf("generate", 128, gen, device="cpu")
    assert t.shape == (128, 4) and t.dtype == torch.float32
    assert float(t[:, 3].max()) > 0.1
    t2 = P.random_peaks_tf(128, torch.Generator().manual_seed(3),
                           device="cpu")
    assert not torch.allclose(t, t2)
    again = P.get_tf("generate", 128, torch.Generator().manual_seed(2),
                     device="cpu")
    assert torch.equal(t, again)
    for seed in range(20):
        p = draw_peaks(torch.Generator().manual_seed(seed), max_num_peaks=3)
        assert 1 <= p.centers.size <= 3
        assert (np.diff(p.centers) >= 0).all()
        for arr, lo, hi in ((p.centers, 0.08, 0.85), (p.widths, 0.02, 0.15),
                            (p.top_frac, 0.1, 0.9), (p.heights, 0.15, 0.95),
                            (p.colors, 0.05, 1.0)):
            assert arr.dtype == np.float32
            assert (arr >= np.float32(lo)).all() and (arr < hi).all()
    with pytest.raises(ValueError, match="Generator"):
        P.get_tf("generate", 64, device="cpu")


def test_premultiply_alpha_matches_jax():
    rgba = np.random.default_rng(0).random((5, 7, 4), np.float32)
    np.testing.assert_array_equal(
        P.premultiply_alpha(torch.from_numpy(rgba)).numpy(),
        np.asarray(j_premultiply(jnp.asarray(rgba))))
    one = torch.tensor([[0.5, 1.0, 0.25, 0.5]])
    np.testing.assert_allclose(P.premultiply_alpha(one).numpy(),
                               [[0.25, 0.5, 0.125, 0.5]])


def test_value_and_clean_grad_matches_jax():
    """The value and the scrubbed gradients of a function whose raw
    gradient is infinite at 0, for one argument and for a tuple, with and
    without aux, as JAX's ``value_and_clean_grad`` gives them."""
    x = np.array([0.0, 0.25, 4.0], np.float32)
    y = np.array([1.0, -2.0, 0.5], np.float32)

    def f_t(a, b):
        return torch.sum(torch.sqrt(a) * b)

    def f_j(a, b):
        return jnp.sum(jnp.sqrt(a) * b)

    val, g = P.value_and_clean_grad(f_t)(torch.from_numpy(x),
                                         torch.from_numpy(y))
    want_val, want_g = j_value_and_clean(f_j)(x, y)
    np.testing.assert_allclose(float(val), float(want_val), rtol=1e-6)
    assert torch.isfinite(g).all() and not val.requires_grad
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), rtol=1e-6)
    (val, aux), (ga, gb) = P.value_and_clean_grad(
        lambda a, b: (f_t(a, b), a.detach() * 2), argnums=(0, 1),
        has_aux=True)(torch.from_numpy(x), torch.from_numpy(y))
    (_, want_aux), (wa, wb) = j_value_and_clean(
        lambda a, b: (f_j(a, b), a * 2), argnums=(0, 1), has_aux=True)(x, y)
    for got, want in ((ga, wa), (gb, wb), (aux, want_aux)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    raw = torch.from_numpy(x).requires_grad_()
    f_t(raw, torch.from_numpy(y)).backward()
    assert not torch.isfinite(raw.grad).all()


def test_jit_aliases_are_the_renderers():
    """PyTorch runs eagerly: the JAX package's jitted entry points are the
    renderers themselves."""
    assert P.render_jit is P.render
    assert P.render_nondiff_jit is P.render_nondiff
