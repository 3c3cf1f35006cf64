"""The port's X-sharded volume render (``differender_tpu_torch.parallel.
volume_sharding``) against the JAX package's, on gloo ranks.

The port's ranks are processes of ``torch_port_ranks`` (spawned once per
world size for this module, 2, 4 and 8 ranks of one gloo group); the JAX
package runs here on conftest's 8 CPU devices, from the same numpy inputs.
The scene is JAX's ``tests/test_parallel.py``: the 32^3 sphere, tf5 at
R = 16, 6x6 images, ``max_samples`` 48, sampling rate 0.6.

Limits: the shard samplers and the composition 1e-6 (the same f32
operations, the fold's association aside); images 1e-4 against JAX's
``render(ert=False)`` and its sharded render (JAX composites blocks in
closed form, the port sample by sample), ``valid_steps`` equal; the golden
``sharded`` fixture 1e-4; gradients 2e-3 * max|g|, the port's CPU gradient
limit.  The port's composed segments equal its own ``render(ert=False)``
within 1e-6 in one process.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P_

from conftest import make_sphere_volume
import torch_port_ranks as ranks
from differender_tpu import RenderConfig as JConfig
from differender_tpu import get_tf as j_get_tf
from differender_tpu import render as j_render
from differender_tpu.parallel import volume_sharding as JV
from differender_tpu import sampling as JS
import differender_tpu_torch as P
from differender_tpu_torch import sampling as S
from differender_tpu_torch.parallel import volume_sharding as V

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_renders.npz")
CFG = dict(image_shape=(6, 6), max_samples=48, block_size=8)
SR = 0.6
LF = (1.3, 0.7, 2.1)
VOL = make_sphere_volume()
TF = np.array(j_get_tf("tf5", 16))
IMG_TOL = 1e-4
GRAD_TOL = 2e-3
# The JAX package's camera of its golden fixtures (tests/test_golden.py).
GOLDEN_CFG = dict(image_shape=(16, 16), tf_resolution=32, max_samples=64,
                  block_size=16)
GOLDEN_LF = (1.2, 0.8, 2.0)
GRADS_CFG = dict(image_shape=(5, 5), max_samples=32, block_size=8)


def _case(lf, sr=SR, u=None, volume_shape=VOL.shape, **cfg):
    spec = dict(CFG, volume_shape=tuple(volume_shape))
    spec.update(cfg)
    return {"cfg": spec, "lf": np.asarray(lf, np.float32), "sr": sr, "u": u}


def _jcfg(spec):
    return JConfig(**spec)


def _jax_u(seed, shape):
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape))


CASES = {
    "sharded": _case(LF),
    "axis": _case((2.5, 0.05, 0.1)),
    "jitter": _case(LF, u=_jax_u(3, CFG["image_shape"])),
    "window": dict(_case((0.1, 0.4, 2.4)), segment_max_samples=16),
    "analytic": _case(LF, analytic_normals=True),
    "golden": dict(_case(GOLDEN_LF, sr=0.8, **GOLDEN_CFG), tf="tf1"),
}
WORLD_CASES = {2: ["sharded"], 4: ["sharded", "axis", "jitter", "analytic",
                                   "golden"], 8: ["sharded", "window"]}
GRADS = {"cfg": dict(GRADS_CFG, volume_shape=VOL.shape),
         "lf": np.asarray(LF, np.float32), "sr": SR,
         "w": np.random.default_rng(0).random((5, 5, 4), np.float32)}


def _halo_cot(world):
    xl = VOL.shape[0] // world
    return np.random.default_rng(world).random(
        (world, xl + 2 * V.HALO) + VOL.shape[1:], np.float32) - 0.5


def _inputs(world):
    inp = {"vol": VOL, "tf": TF, "tf1": np.array(j_get_tf("tf1", 32)),
           "sharded_cases": WORLD_CASES[world], "halo_cot": _halo_cot(world),
           "grads": GRADS}
    inp.update(CASES)
    return inp


_SCENARIOS = {2: ["sharded", "halos"], 4: ["sharded", "halos", "grads"],
              8: ["sharded"]}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each world size's ranks, spawned once: their results by rank."""
    return ranks.worlds(tmp_path_factory, _SCENARIOS, _inputs)


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("space",))


def _jax_sharded(case, n):
    cfg = _jcfg(case["cfg"])
    mesh = _mesh(n)
    tf = TF if case.get("tf") is None else np.asarray(
        j_get_tf(case["tf"], 32))
    key = None if case["u"] is None else jax.random.PRNGKey(3)
    out = JV.render_volume_sharded(
        JV.shard_volume(jnp.asarray(VOL), mesh), jnp.asarray(tf),
        jnp.asarray(case["lf"]), cfg, mesh, sampling_rate=case["sr"],
        key=key, segment_max_samples=case.get("segment_max_samples"))
    return np.asarray(out.image), np.asarray(out.valid_steps)


def _jax_unsharded(case):
    key = None if case["u"] is None else jax.random.PRNGKey(3)
    out = j_render(VOL, TF, case["lf"], _jcfg(case["cfg"]),
                   sampling_rate=case["sr"], ert=False, key=key)
    return np.asarray(out.image), np.asarray(out.valid_steps)


def _replicated(results, scenario, case):
    """The case's output, checked equal on every rank."""
    return ranks.same_on_ranks(results, scenario)[case]


# -- the plain pieces, one process ------------------------------------------

def _padded_np(k, n):
    xl = VOL.shape[0] // n
    return VOL[np.arange(k * xl - 2, (k + 1) * xl + 2) % VOL.shape[0]]


@pytest.mark.parametrize("n", [2, 4, 8])
def test_shard_samplers_match_jax(n):
    """trilinear_shard and sample_with_gradient_shard on every shard's
    padded block, at positions all over the box (outside the slab the
    localised index clamps, in both packages)."""
    pos = np.random.default_rng(n).uniform(-1.1, 1.1, (64, 3)).astype(
        np.float32)
    xl = VOL.shape[0] // n
    for k in range(n):
        padded = _padded_np(k, n)
        x0 = k * xl - 2
        want = np.asarray(JS.trilinear_shard(jnp.asarray(padded), pos,
                                             VOL.shape, x0))
        got = S.trilinear_shard(torch.from_numpy(padded),
                                torch.from_numpy(pos), VOL.shape, x0)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
        wi, wg = JS.sample_with_gradient_shard(jnp.asarray(padded), pos,
                                               VOL.shape, x0)
        gi, gg = S.sample_with_gradient_shard(torch.from_numpy(padded),
                                              torch.from_numpy(pos),
                                              VOL.shape, x0)
        np.testing.assert_allclose(gi.numpy(), np.asarray(wi), atol=1e-6)
        np.testing.assert_allclose(gg.numpy(), np.asarray(wg), atol=1e-6)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_pad_halos_matches_jax_exchange(n):
    """pad_halos is shard k's block of JAX's ppermute exchange, the
    circular wrap at the outer shards included."""
    import functools
    mesh = _mesh(n)

    @functools.partial(jax.shard_map, mesh=mesh, in_specs=P_("space"),
                       out_specs=P_("space"), check_vma=False)
    def exchange(v):
        return JV._exchange_halos(v, "space")

    blocks = np.asarray(exchange(jnp.asarray(VOL))).reshape(
        (n, -1) + VOL.shape[1:])
    for k in range(n):
        np.testing.assert_array_equal(
            V.pad_halos(torch.from_numpy(VOL), k, n).numpy(), blocks[k])


@pytest.mark.parametrize("n", [2, 4, 8])
def test_compose_segments_matches_jax(n):
    rng = np.random.default_rng(10 + n)
    segs = rng.random((n, 5, 7, 4), np.float32)
    segs[..., :3] *= segs[..., 3:]            # premultiplied
    counts = rng.integers(0, 9, (n, 5, 7)).astype(np.int32)
    dir_x = rng.uniform(-1, 1, (5, 7)).astype(np.float32)
    want, want_n = JV.compose_segments(jnp.asarray(segs),
                                       jnp.asarray(counts),
                                       jnp.asarray(dir_x))
    got, got_n = V.compose_segments(torch.from_numpy(segs),
                                    torch.from_numpy(counts),
                                    torch.from_numpy(dir_x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    assert got_n.dtype == torch.int32


@pytest.mark.parametrize("args", [
    (48, 0.6, 8, None, None), (48, 0.6, 32, None, None),
    (48, 0.6, 8, 16, None), (48, 0.6, 8, 13, None), (512, 1.0, 32, 100, 7),
    (200, 2.5, 32, None, 64), (16, 0.1, 32, None, None)])
def test_segment_length_matches_jax(args):
    """The window's length, rounded up to a multiple of the block."""
    max_samples, sr, block_size, seg_max, block = args
    spec = dict(volume_shape=(64, 48, 40), image_shape=(4, 4),
                max_samples=max_samples, block_size=block_size)
    assert V.segment_length(P.RenderConfig(**spec), sr, seg_max, block) == \
        JV.segment_length(JConfig(**spec), sr, seg_max, block)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_segments_compose_to_render(n):
    """pad_halos, segment_march_plain on every shard and compose_segments
    in one process give the port's render(ert=False): each sample has one
    owner, so valid_steps is equal, and the fold differs from one march
    only by its association."""
    vol, tf = torch.from_numpy(VOL), torch.from_numpy(TF)
    cfg = P.RenderConfig(volume_shape=VOL.shape, **CFG)
    lf = torch.tensor(LF)
    want = P.render(vol, tf, lf, cfg, SR, ert=False)
    rays = P.make_rays(lf, cfg, SR)
    length, _ = V.segment_length(cfg, SR)
    segs, cnts = zip(*[V.segment_march(V.pad_halos(vol, k, n), tf, rays, cfg,
                                       SR, k, n, length) for k in range(n)])
    img, valid = V.compose_segments(torch.stack(segs), torch.stack(cnts),
                                    rays.dirs[..., 0])
    np.testing.assert_allclose(img.numpy(), want.image.numpy(), rtol=0,
                               atol=1e-6)
    assert torch.equal(valid, want.valid_steps)


# -- gloo ranks ---------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_exchange_halos(worlds, n):
    """_exchange_halos on n ranks: each block equal to pad_halos, and each
    slab's gradient that of autograd through pad_halos on the global
    volume (the halo cotangents sent home)."""
    res = worlds(n)
    cot = _halo_cot(n)
    v = torch.from_numpy(VOL).requires_grad_(True)
    sum((V.pad_halos(v, k, n) * torch.from_numpy(cot[k])).sum()
        for k in range(n)).backward()
    xl = VOL.shape[0] // n
    for k, r in enumerate(res):
        np.testing.assert_array_equal(
            r["halos"]["padded"],
            V.pad_halos(torch.from_numpy(VOL), k, n).numpy())
        np.testing.assert_allclose(r["halos"]["d_local"],
                                   v.grad[k * xl:(k + 1) * xl].numpy(),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_matches_render(worlds, n):
    out = _replicated(worlds(n), "sharded", "sharded")
    want, want_valid = _jax_unsharded(CASES["sharded"])
    np.testing.assert_allclose(out["image"], want, rtol=0, atol=IMG_TOL)
    np.testing.assert_array_equal(out["valid"], want_valid)


def test_sharded_matches_jax_sharded(worlds):
    out = _replicated(worlds(4), "sharded", "sharded")
    want, want_valid = _jax_sharded(CASES["sharded"], 4)
    np.testing.assert_allclose(out["image"], want, rtol=0, atol=IMG_TOL)
    np.testing.assert_array_equal(out["valid"], want_valid)


@pytest.mark.parametrize("case", ["axis", "jitter"])
def test_sharded_view_cases(worlds, case):
    """A camera along the shard axis (every ray crosses every shard), and
    JAX's jitter draw."""
    out = _replicated(worlds(4), "sharded", case)
    want, want_valid = _jax_unsharded(CASES[case])
    np.testing.assert_allclose(out["image"], want, rtol=0, atol=IMG_TOL)
    np.testing.assert_array_equal(out["valid"], want_valid)


def test_sharded_reduced_window(worlds):
    """8 shards with a window of 16 steps, side-on: JAX's window start,
    step for step."""
    out = _replicated(worlds(8), "sharded", "window")
    want, want_valid = _jax_sharded(CASES["window"], 8)
    np.testing.assert_allclose(out["image"], want, rtol=0, atol=IMG_TOL)
    np.testing.assert_array_equal(out["valid"], want_valid)


def test_sharded_analytic_config(worlds):
    """JAX's segment takes the central-difference stencil whatever
    analytic_normals says; so does the port's (the image is the parity
    config's)."""
    out = _replicated(worlds(4), "sharded", "analytic")
    want, _ = _jax_sharded(CASES["analytic"], 4)
    np.testing.assert_allclose(out["image"], want, rtol=0, atol=IMG_TOL)
    parity = _replicated(worlds(4), "sharded", "sharded")
    np.testing.assert_array_equal(out["image"], parity["image"])


def test_golden_sharded(worlds):
    """The JAX package's golden fixture of its 4-device sharded render."""
    out = _replicated(worlds(4), "sharded", "golden")
    golden = np.load(GOLDEN)["sharded"]
    np.testing.assert_allclose(out["image"], golden, rtol=0, atol=IMG_TOL)


def test_sharded_grads_match_jax(worlds):
    """d_volume (the ranks' slabs joined) and d_tf (whole on each rank) of
    sum(image * w) against jax.grad through JAX's sharded render."""
    res = worlds(4)
    cfg = _jcfg(GRADS["cfg"])
    mesh = _mesh(4)
    w = jnp.asarray(GRADS["w"])

    def loss(v, t):
        img = JV.render_volume_sharded(v, t, jnp.asarray(GRADS["lf"]), cfg,
                                       mesh, sampling_rate=SR).image
        return jnp.sum(img * w)

    gv, gt = jax.grad(loss, argnums=(0, 1))(jnp.asarray(VOL),
                                            jnp.asarray(TF))
    gv, gt = np.asarray(gv), np.asarray(gt)
    got_v = np.concatenate([r["grads"]["d_local"] for r in res])
    np.testing.assert_allclose(got_v, gv, rtol=0,
                               atol=GRAD_TOL * np.abs(gv).max())
    for r in res:
        np.testing.assert_array_equal(r["grads"]["d_tf"],
                                      res[0]["grads"]["d_tf"])
    np.testing.assert_allclose(res[0]["grads"]["d_tf"], gt, rtol=0,
                               atol=GRAD_TOL * np.abs(gt).max())


def test_sharded_camera_gradient_refused(worlds):
    for r in worlds(4):
        assert "no camera gradient" in r["grads"]["camera_refused"]


def test_entry_points_need_a_process_group():
    """Without an initialised group the entry points raise; none quietly
    renders one shard."""
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        V.shard_volume(torch.from_numpy(VOL))


def _tf_rule_readings(monkeypatch):
    """max |d_volume - the segments'| / max |d_volume| of render's plain
    march with its own TF (the dot form) and with apply_tf in place of
    march_tf, on noise at 32^3 and 32^2 (2 segments)."""
    import sys
    R = 128
    vol = P.volume_to_internal(torch.from_numpy(P.noise_volume(32, seed=0))
                               ).contiguous()
    tf = P.tf_to_internal(P.get_tf_torch_layout("tf1", R, device="cpu"))
    cfg = P.RenderConfig(volume_shape=(32,) * 3, image_shape=(32, 32),
                         tf_resolution=R, max_samples=512)
    lf = torch.tensor([1.2, 0.8, 2.0])
    u = torch.rand((32, 32), generator=torch.Generator().manual_seed(1))
    g = torch.rand((32, 32, 4), generator=torch.Generator().manual_seed(2)) \
        - 0.3
    rays = P.make_rays(lf, cfg, 1.0, u=u)
    length, _ = V.segment_length(cfg, 1.0)

    def d_volume(march):
        v = vol.clone().requires_grad_(True)
        return torch.autograd.grad(march(v), v, g)[0]

    def segments(v):
        outs = [V.segment_march(V.pad_halos(v, k, 2), tf, rays, cfg, 1.0, k,
                                2, length) for k in range(2)]
        return V.compose_segments(torch.stack([o[0] for o in outs]),
                                  torch.stack([o[1] for o in outs]),
                                  rays.dirs[..., 0])[0]

    def whole(v):
        return P.march_diff_plain(v, tf, rays, cfg, 1.0, ert=False)[0]

    g_seg, g_dot = d_volume(segments), d_volume(whole)
    scale = float(g_dot.abs().max())
    monkeypatch.setattr(sys.modules["differender_tpu_torch.render"],
                        "march_tf", S.apply_tf)
    g_apply = d_volume(whole)
    return (float((g_dot - g_seg).abs().max()) / scale,
            float((g_apply - g_seg).abs().max()) / scale)


def test_segment_tf_gradient_is_apply_tf(monkeypatch):
    """The segments take the TF gradient of JAX's segment, apply_tf's
    (autograd of the gather-lerp: the slope at every t), where render takes
    the JAX march's dot form (none at an integer t = i * (R - 1)).  On
    noise at 32^3 and 32^2 one sample lands on t = 23 exactly: render's
    d_volume parts from the segments' there, and render with apply_tf in
    place of march_tf gives the segments' (``PYTHONPATH=.:tests python
    tests/test_torch_port_sharded.py`` prints both readings)."""
    dot, apply_tf = _tf_rule_readings(monkeypatch)
    assert dot > 1e-2
    assert apply_tf <= 1e-5


if __name__ == "__main__":
    with pytest.MonkeyPatch.context() as mp:
        print("d_volume, max |render - segments| / max |render|: dot form "
              "%.3g, apply_tf %.3g" % _tf_rule_readings(mp))
