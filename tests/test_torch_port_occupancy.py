"""The port's empty-space skip (``differender_tpu_torch.occupancy`` and the
plain inference march with a grid) against the JAX package's
``differender_tpu.occupancy`` on the same numpy inputs.

Tolerances: the grid, the TF range table and the jumps are equal (integer
results of the same f32 arithmetic; no case differs by one); the plain
march with the grid is bitwise the march without it; against JAX's
``render_nondiff`` the images agree within 2e-4, as in
tests/test_torch_port_render.py (JAX composites blocks in closed form, the
port ray by ray).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_shell_volume, make_sphere_volume
from differender_tpu import RenderConfig as JConfig
from differender_tpu import get_tf as j_get_tf
from differender_tpu import render_nondiff as j_render_nondiff
from differender_tpu.occupancy import _cell_minmax
from differender_tpu.occupancy import build_occupancy as j_build_occupancy
from differender_tpu.occupancy import jump_steps as j_jump_steps
from differender_tpu.occupancy import tf_alpha_range_max as j_range_max
import differender_tpu_torch as P

VOLUMES = {"sphere": make_sphere_volume, "shell": make_shell_volume}
LOOK_FROM = np.array([1.2, 0.8, 2.0], np.float32)


@pytest.fixture(scope="module")
def tf32():
    return np.array(j_get_tf("tf1", 32))


@pytest.mark.parametrize("R", [16, 128])
def test_tf_alpha_range_max_equals_jax(R):
    rng = np.random.default_rng(R)
    tf = rng.random((R, 4), np.float32)
    tf[R // 3, 3] = -0.25          # JAX's masked max takes in a 0
    tf[0, 3] = -0.5
    want = np.asarray(j_range_max(jnp.asarray(tf)))
    got = P.tf_alpha_range_max(torch.from_numpy(tf)).numpy()
    np.testing.assert_array_equal(got, want)
    for name in ("tf1", "tf5"):
        tf = np.array(j_get_tf(name, R))
        np.testing.assert_array_equal(
            P.tf_alpha_range_max(torch.from_numpy(tf)).numpy(),
            np.asarray(j_range_max(jnp.asarray(tf))))


@pytest.mark.parametrize("cell", [1, 2, 3, 8])
def test_cell_minmax_equals_jax(cell):
    """K6's plain version (replicate padding and max_pool3d) equals the JAX
    package's edge padding and reduce_window bit for bit."""
    vols = [make_sphere_volume(), make_shell_volume((24, 24, 24)),
            np.random.default_rng(3).random((20, 24, 28), np.float32)]
    for vol in vols:
        lo, hi, shape = _cell_minmax(jnp.asarray(vol), cell)
        lo_t, hi_t = P.cell_minmax(torch.from_numpy(vol), cell)
        assert tuple(lo_t.shape) == tuple(shape)
        np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo))
        np.testing.assert_array_equal(hi_t.numpy(), np.asarray(hi))


def _configs(vol, cell, md):
    kw = dict(volume_shape=vol.shape, image_shape=(12, 12),
              occupancy_cell=cell, occupancy_max_dist=md)
    return JConfig(**kw), P.RenderConfig(**kw)


@pytest.mark.parametrize("cell,md", [(0, 0), (8, 12), (4, 24), (2, 48)])
def test_build_occupancy_equals_jax(tf32, cell, md):
    for name, make in VOLUMES.items():
        vol = make()
        j_cfg, cfg = _configs(vol, cell, md)
        want = j_build_occupancy(vol, tf32, j_cfg)
        got = P.build_occupancy(torch.from_numpy(vol), torch.from_numpy(tf32),
                                cfg)
        assert got.shape == tuple(want.shape) and got.cell == want.cell
        assert got.cell_world == want.cell_world
        assert got.dist.dtype == torch.int32
        np.testing.assert_array_equal(got.dist.numpy(), np.asarray(want.dist))
        assert got.far.tolist() == [int(np.asarray(want.dist).max())]


def _chebyshev_brute(occ, max_dist):
    """min(L-inf distance to the nearest occupied cell, max_dist), by
    comparing every pair of cells."""
    cells = np.stack(np.meshgrid(*(np.arange(n) for n in occ.shape),
                                 indexing="ij"), -1).reshape(-1, 3)
    on = cells[occ.reshape(-1)]
    if not len(on):
        return np.full(occ.shape, max_dist, np.int32)
    d = np.abs(cells[:, None, :] - on[None, :, :]).max(-1).min(1)
    return np.minimum(d, max_dist).reshape(occ.shape).astype(np.int32)


def _separable(occ, max_dist):
    """Kernel K7's three passes (csrc/distance.cu) in numpy: along z, y, x,
    out(c) = min over |d| < max_dist of max(|d|, in(c + d)), cells outside
    the grid counting as max_dist."""
    f = np.where(occ, 0, max_dist).astype(np.int64)
    for axis in (2, 1, 0):
        n = f.shape[axis]
        pad = [(0, 0)] * 3
        pad[axis] = (max_dist, max_dist)
        g = np.pad(f, pad, constant_values=max_dist)
        out = np.minimum(f, max_dist)
        for d in range(1, max_dist):
            for sgn in (-1, 1):
                sl = [slice(None)] * 3
                sl[axis] = slice(max_dist + sgn * d, max_dist + sgn * d + n)
                out = np.minimum(out, np.maximum(d, g[tuple(sl)]))
        f = out
    return f.astype(np.int32)


@pytest.mark.parametrize("share", [0.0, 0.002, 0.03, 1.0])
@pytest.mark.parametrize("max_dist", [1, 3, 12])
def test_cell_distance_is_chebyshev(share, max_dist):
    """K7's plain version (JAX's dilation rounds) and the kernel's separable
    passes both give the saturated L-inf distance, on grids from empty to
    full, with sides that differ.  A two-texel TF, opaque at texel 1 only,
    marks the cells whose range reaches texel 1."""
    rng = np.random.default_rng(int(share * 1000) + max_dist)
    occ = rng.random((9, 13, 17)) < share
    want = _chebyshev_brute(occ, max_dist)
    hi = torch.from_numpy(occ.astype(np.float32))
    tf = torch.tensor([[0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0]])
    got, far = P.cell_distance(torch.zeros_like(hi), hi, tf, 0.5, max_dist)
    assert got.dtype == far.dtype == torch.int32
    assert tuple(got.shape) == occ.shape and far.tolist() == [want.max()]
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(_separable(occ, max_dist), want)
    if 0.0 < share < 1.0:
        assert want.min() == 0 < want.max()


@pytest.mark.parametrize("cell", [4, 2])
def test_jump_steps_equal_jax(tf32, cell):
    """The same advance on random heads, in and outside the box, with some
    zero steps."""
    vol = make_sphere_volume((24, 24, 24), radius=0.4)
    j_cfg, cfg = _configs(vol, cell, 0)
    j_grid = j_build_occupancy(vol, tf32, j_cfg)
    grid = P.build_occupancy(torch.from_numpy(vol), torch.from_numpy(tf32),
                             cfg)
    rng = np.random.default_rng(cell)
    p = rng.uniform(-1.2, 1.2, (2048, 3)).astype(np.float32)
    dt = rng.uniform(1e-4, 0.02, 2048).astype(np.float32)
    dt[:16] = 0.0
    want = np.asarray(j_jump_steps(j_grid, vol.shape,
                                   *(jnp.asarray(p[:, i]) for i in range(3)),
                                   jnp.asarray(dt)))
    got = P.jump_steps(grid, vol.shape,
                       *(torch.from_numpy(p[:, i]) for i in range(3)),
                       torch.from_numpy(dt))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).mean() > 0.05 and (want[:16] == 0).all()


def test_resolved_occupancy_auto():
    """JAX's own cases (tests/test_occupancy.py)."""
    cases = [((32,) * 3, 2, 48), ((256,) * 3, 2, 48),
             ((512,) * 3, 4, 24), ((1024,) * 3, 8, 12)]
    for shape, want_cell, want_md in cases:
        kw = dict(volume_shape=shape, image_shape=(8, 8))
        got = P.RenderConfig(**kw).resolved_occupancy()
        assert got == (want_cell, want_md) == JConfig(**kw).resolved_occupancy()
    kw = dict(volume_shape=(64,) * 3, image_shape=(8, 8), occupancy_cell=16,
              occupancy_max_dist=5)
    assert P.RenderConfig(**kw).resolved_occupancy() == (16, 5)


@pytest.mark.parametrize("cell,md", [(0, 0), (4, 24)])
@pytest.mark.parametrize("name", list(VOLUMES))
def test_plain_march_with_grid_is_exact(tf32, name, cell, md):
    """The plain inference march with the grid: the same image bit for bit
    and the same composited count on every ray as without it, fewer samples
    evaluated, and the same with every other lookup."""
    vol = VOLUMES[name]()
    _, cfg = _configs(vol, cell, md)
    v, t, lf = P.state_from_numpy(vol, tf32, LOOK_FROM, device="cpu")
    grid = P.build_occupancy(v, t, cfg)
    for sr in (1.0, 6.0):
        rays = P.make_rays(lf, cfg, sr)
        img, vis, comp = P.march_nondiff_plain(v, t, rays, cfg, sr)
        for c in (cfg, cfg.replace(occupancy_jump_every=2)):
            img_g, vis_g, comp_g = P.march_nondiff_plain(v, t, rays, c, sr,
                                                         grid)
            assert torch.equal(img_g, img) and torch.equal(comp_g, comp)
            assert bool((vis_g <= vis).all())
            assert int(vis_g.sum()) < int(vis.sum())
        on = P.render_nondiff(v, t, lf, cfg, sampling_rate=sr).image
        assert torch.equal(on, img)


@pytest.mark.parametrize("sr", [1.0, 6.0])
def test_render_nondiff_with_grid_matches_jax(tf32, sr):
    """Both packages build their grid by default (occupancy_skip)."""
    vol = make_shell_volume()
    j_cfg, cfg = _configs(vol, 0, 0)
    want = np.asarray(j_render_nondiff(vol, tf32, LOOK_FROM, j_cfg,
                                       sampling_rate=sr).image)
    got = P.render_nondiff(*P.state_from_numpy(vol, tf32, LOOK_FROM,
                                               device="cpu"),
                           cfg, sampling_rate=sr)
    err = np.abs(got.image.numpy() - want)
    assert err.max() <= 2e-4, err.max()


def test_march_on_a_jax_grid(tf32):
    """A grid the JAX package built, carried over by occupancy_from_numpy,
    drives the port's march exactly as the port's own grid does."""
    vol = make_shell_volume()
    j_cfg, cfg = _configs(vol, 4, 24)
    j_grid = j_build_occupancy(vol, tf32, j_cfg)
    grid = P.occupancy_from_numpy(np.asarray(j_grid.dist), j_grid.shape,
                                  j_grid.cell, j_grid.cell_world,
                                  device="cpu")
    assert grid.dist.dtype == torch.int32 and grid.shape == (8, 8, 8)
    v, t, lf = P.state_from_numpy(vol, tf32, LOOK_FROM, device="cpu")
    own = P.build_occupancy(v, t, cfg)
    rays = P.make_rays(lf, cfg, 6.0)
    a = P.march_nondiff(v, t, rays, cfg, 6.0, occupancy=grid)
    b = P.march_nondiff(v, t, rays, cfg, 6.0, occupancy=own)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="does not fit"):
        P.occupancy_from_numpy(np.zeros(7), (2, 2, 2), 4, 0.5, device="cpu")
    small = P.occupancy_from_numpy(np.zeros(8), (2, 2, 2), 4, 0.5,
                                   device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        P.march_nondiff(v, t, rays, cfg, 6.0, occupancy=small)
