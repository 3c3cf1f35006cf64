"""The inputs repeat for a seed and change with it."""
import pytest
import torch

from dvrbench import harness, inputs


@pytest.mark.parametrize("traffic", ["ct_head", "dense_sim"])
def test_scenes_repeat_per_seed(traffic):
    t = harness.traffic(traffic)
    big = 2 ** 31 + 12345
    a = inputs.volume(t, 24, inputs.generator(big, 0, "cpu"))
    b = inputs.volume(t, 24, inputs.generator(big, 0, "cpu"))
    c = inputs.volume(t, 24, inputs.generator(big + 1, 0, "cpu"))
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert a.shape == (24, 24, 24) and float(a.min()) >= 0.0
    assert float(a.max()) <= 1.0


def test_dense_scene_stays_in_the_visible_band():
    t = harness.traffic("dense_sim")
    v = inputs.volume(t, 32, inputs.generator(7, 0, "cpu"))
    lo, hi = t["layers"][0]["low"], t["layers"][0]["high"]
    assert float(v.min()) >= lo and float(v.max()) <= hi + 1e-6


def test_ct_head_keeps_its_sizes_and_densities_for_every_seed():
    t = harness.traffic("ct_head")
    for seed in (1, 2, 3):
        v = inputs.volume(t, 48, inputs.generator(seed, 0, "cpu"))
        for d in t["layers"][2]["densities"]:
            assert bool((v == d).any()), (seed, d)


def test_poses_and_corruption_repeat():
    g1, g2 = (inputs.generator(99, 1, "cpu") for _ in range(2))
    assert torch.equal(inputs.random_poses(g1, 7, 2.7),
                       inputs.random_poses(g2, 7, 2.7))
    v = torch.zeros(32, 32, 32)
    c = inputs.corrupt(v, 0.05, inputs.generator(4, 0, "cpu"))
    share = float((c != 0).float().mean())
    assert 0.03 < share < 0.07
    tf = inputs.transfer_function("tf1", 128, "cpu")
    assert tf.shape == (4, 128) and float(tf[3].max()) > 0.39
