"""The plain versions of kernels K4 ``brick_sums`` and K5 ``brick_rows``
against the Pallas kernels of ``experiments/exp_pallas_dma.py`` themselves,
run in interpret mode on the CPU.

Tolerance: the probe's own ``rtol=1e-5`` (XLA and torch add the 32^3 floats
in another order).
"""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import differender_tpu_torch as P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, B = 64, 32


@pytest.fixture(scope="module")
def probe():
    """The probe module with its kernels in interpret mode."""
    spec = importlib.util.spec_from_file_location(
        "exp_pallas_dma", os.path.join(ROOT, "experiments", "exp_pallas_dma.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.INTERPRET = True
    return mod


@pytest.fixture(scope="module")
def volume():
    return np.random.default_rng(0).random((V, V, V), np.float32)


def _origins(kind):
    rng = np.random.default_rng(1)
    if kind == "aligned":          # the probe's A1: multiples of 8 and 16
        o = rng.integers(0, (V - B) // 8 + 1, size=(6, 3)) * 8
        o[:, 2] = (o[:, 2] // 16) * 16
    else:                          # A2: any origin that keeps the brick in
        o = rng.integers(0, V - B + 1, size=(6, 3))
        o[0] = (V - B, V - B, V - B)
        o[1] = (1, 3, 5)
    return o.astype(np.int32)


@pytest.mark.parametrize("kind", ["aligned", "unaligned"])
def test_brick_sums_match_pallas(probe, volume, kind):
    origins = _origins(kind)
    want = np.asarray(probe.run_brick_sums(jnp.asarray(volume),
                                           jnp.asarray(origins)))
    got = P.brick_sums(torch.from_numpy(volume), torch.from_numpy(origins))
    assert got.shape == want.shape == (6, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    assert bool((got == got[:, :1]).all())


def test_brick_rows_match_pallas(probe):
    rng = np.random.default_rng(2)
    bricks = rng.random((8, B, B * B), np.float32)
    idx = np.array([0, 7, 3, 3, 5], np.int32)
    want = np.asarray(probe.run_brick_rows(jnp.asarray(bricks),
                                           jnp.asarray(idx)))
    got = P.brick_rows(torch.from_numpy(bricks), torch.from_numpy(idx))
    assert got.shape == want.shape == (5, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_out_of_range_gives_nan(volume):
    """A brick that leaves the volume (or an index outside the table) gives
    a NaN row; the rows around it are untouched."""
    vol = torch.from_numpy(volume)
    origins = torch.tensor([[0, 0, 0], [V - B + 1, 0, 0], [0, -1, 0],
                            [0, 0, V], [V - B, V - B, V - B]],
                           dtype=torch.int32)
    got = P.brick_sums(vol, origins)
    assert bool(torch.isnan(got[1:4]).all())
    assert float(got[0, 0]) == pytest.approx(float(vol[:B, :B, :B].sum()),
                                             rel=1e-5)
    assert float(got[4, 0]) == pytest.approx(
        float(vol[V - B:, V - B:, V - B:].sum()), rel=1e-5)
    bricks = torch.rand((4, 2, 8), generator=torch.Generator().manual_seed(0))
    rows = P.brick_rows(bricks, torch.tensor([1, 4, -1], dtype=torch.int32))
    assert bool(torch.isnan(rows[1:]).all())
    assert torch.allclose(rows[0], bricks[1].sum().expand(128))


def test_wrappers_check_their_operands():
    vol = torch.zeros((4, 4, 4), device="meta")
    with pytest.raises(ValueError, match="device"):
        P.brick_sums(vol, torch.zeros((1, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="device"):
        P.cell_minmax(vol, 2)
