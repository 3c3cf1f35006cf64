"""Rank processes of the port's parallel tests.

:func:`run` spawns ``world`` processes (``torch.multiprocessing``, spawn
context) that join one gloo group through a ``file://`` store in a
directory of the caller's, each on one intra-op thread, and run the named
scenarios of :data:`SCENARIOS` on numpy inputs; it returns each rank's
results.  A rank that raises fails the run with its traceback, and a run
that outlasts its timeout is terminated and fails.  This module imports
only torch, numpy and the port, so that no rank imports JAX (or the tests'
``conftest.py``).
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import differender_tpu_torch as P
from differender_tpu_torch import parallel as PP


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(t):
    return t.detach().numpy().copy()


def _cfg(spec):
    return P.RenderConfig(**spec)


def _error(fn):
    """The message of the ValueError that ``fn`` raises (else None)."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


# ---------------------------------------------------------------------------
# Scenarios: fn(rank, world, inputs) -> dict of numpy arrays or strings
# ---------------------------------------------------------------------------

def _sharded(rank, world, inp, key="sharded"):
    """render_volume_sharded of the rank's slab."""
    case = inp[key]
    cfg = _cfg(case["cfg"])
    vol = PP.shard_volume(_t(inp["vol"]))
    out = PP.render_volume_sharded(
        vol, _t(inp[case.get("tf", "tf")]), _t(case["lf"]), cfg,
        sampling_rate=case["sr"],
        u=None if case.get("u") is None else _t(case["u"]),
        segment_max_samples=case.get("segment_max_samples"))
    return {"image": _np(out.image), "valid": _np(out.valid_steps)}


def _sharded_cases(rank, world, inp):
    return {name: _sharded(rank, world, inp, name)
            for name in inp["sharded_cases"]}


def _halos(rank, world, inp):
    """_exchange_halos of the rank's slab: forward and, for the rank's
    cotangent of its padded block, its slab's gradient."""
    vol = PP.shard_volume(_t(inp["vol"])).requires_grad_(True)
    padded = PP.volume_sharding._exchange_halos(vol, None)
    (padded * _t(inp["halo_cot"][rank])).sum().backward()
    return {"padded": _np(padded), "d_local": _np(vol.grad)}


def _grads(rank, world, inp):
    """d_volume (the rank's slab) and d_tf of sum(image * w); a camera that
    requires grad is refused."""
    case = inp["grads"]
    cfg = _cfg(case["cfg"])
    vol = PP.shard_volume(_t(inp["vol"])).requires_grad_(True)
    tf = _t(inp["tf"]).requires_grad_(True)
    img = PP.render_volume_sharded(vol, tf, _t(case["lf"]), cfg,
                                   sampling_rate=case["sr"]).image
    (img * _t(case["w"])).sum().backward()
    refused = _error(lambda: PP.render_volume_sharded(
        vol, tf, _t(case["lf"]).requires_grad_(True), cfg,
        sampling_rate=case["sr"]))
    return {"d_local": _np(vol.grad), "d_tf": _np(tf.grad),
            "camera_refused": refused}


def _views(rank, world, inp):
    case = inp["views"]
    imgs = PP.render_views(_t(inp["vol"]), _t(inp["tf"]), _t(case["lfs"]),
                           _cfg(case["cfg"]), sampling_rate=case["sr"])
    return {"images": _np(imgs)}


def _view_grads(rank, world, inp):
    case = inp["views"]
    loss, (gv, gt) = PP.view_parallel_grads(
        P.mse_loss, _t(inp["vol"]), _t(inp["tf"]), _t(case["lfs"]),
        _t(case["targets"]), _cfg(case["cfg"]), sampling_rate=case["sr"])
    return {"loss": float(loss), "d_volume": _np(gv), "d_tf": _np(gt)}


def _train(rank, world, inp):
    """train_step_views in mode "shard_map" (the default with a group),
    without and with draws."""
    case = inp["train"]
    out = {}
    for name, u in (("plain", None), ("draws", case["u"])):
        loss, (gv, gt) = PP.train_step_views(
            P.mse_loss, _t(inp["vol"]), _t(inp["tf"]), _t(case["lfs"]),
            _t(case["targets"]), _cfg(case["cfg"]),
            sampling_rate=case["sr"], u=None if u is None else _t(u),
            group=dist.group.WORLD)
        out[name] = {"loss": float(loss), "d_volume": _np(gv),
                     "d_tf": _np(gt)}
    return out


def _fast(rank, world, inp):
    """render_fast_sharded at each camera; at the gradient case, d_volume
    and d_tf of sum(image * w)."""
    case = inp["fast"]
    cfg = _cfg(case["cfg"])
    out = {}
    for i, lf in enumerate(case["lfs"]):
        o = P.render_fast_sharded(_t(inp["vol"]), _t(inp["tf"]), _t(lf), cfg,
                                  intermediate=case["intermediate"],
                                  planes_per_voxel=case["ppv"])
        out[f"image{i}"], out[f"hit{i}"] = _np(o.image), _np(o.hit)
    if "w" in case:
        vol = _t(inp["vol"]).requires_grad_(True)
        tf = _t(inp["tf"]).requires_grad_(True)
        img = P.render_fast_sharded(vol, tf, _t(case["lfs"][0]), cfg,
                                    intermediate=case["intermediate"],
                                    planes_per_voxel=case["ppv"]).image
        (img * _t(case["w"])).sum().backward()
        out["d_volume"], out["d_tf"] = _np(vol.grad), _np(tf.grad)
    return out


def _refusals(rank, world, inp):
    """The group-dependent refusals, each entry point's ValueError
    message."""
    vol, tf = _t(inp["vol"]), _t(inp["tf"])
    lf = torch.tensor([1.3, 0.7, 2.1])
    X = vol.shape[0] - 2                       # not a multiple of world
    odd = vol[:X].contiguous()
    cfg = P.RenderConfig(volume_shape=tuple(odd.shape), image_shape=(6, 6),
                         max_samples=48, block_size=8)
    cfg_ok = cfg.replace(volume_shape=tuple(vol.shape))
    lfs6 = lf.repeat(6, 1)
    tgts6 = torch.zeros((6, 6, 6, 4))
    return {
        "shard_volume_X": _error(lambda: PP.shard_volume(odd)),
        "render_volume_sharded_X": _error(lambda: PP.render_volume_sharded(
            odd[:1], tf, lf, cfg)),
        "render_fast_sharded_O": _error(lambda: P.render_fast_sharded(
            vol, tf, lf, cfg_ok, intermediate=4 * world + 2)),
        "render_views_B": _error(lambda: PP.render_views(
            vol, tf, lfs6, cfg_ok)),
        "train_step_views_B": _error(lambda: PP.train_step_views(
            P.mse_loss, vol, tf, lfs6, tgts6, cfg_ok,
            group=dist.group.WORLD)),
    }


SCENARIOS = {"sharded": _sharded_cases, "halos": _halos, "grads": _grads,
             "views": _views, "view_grads": _view_grads, "train": _train,
             "fast": _fast, "refusals": _refusals}


# ---------------------------------------------------------------------------
# Spawning
# ---------------------------------------------------------------------------

def _rank_main(rank, world, names, inputs, directory):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(directory, "store"),
        rank=rank, world_size=world)
    try:
        out = {name: SCENARIOS[name](rank, world, inputs) for name in names}
        torch.save(out, os.path.join(directory, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run(world: int, names, inputs, directory, timeout: float = 240.0):
    """Run the scenarios ``names`` on ``world`` gloo ranks; returns the list
    of the ranks' results (dicts by scenario)."""
    os.makedirs(directory, exist_ok=True)
    ctx = mp.start_processes(_rank_main,
                             args=(world, list(names), inputs, directory),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise RuntimeError(f"{world} ranks did not finish within "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    return [torch.load(os.path.join(directory, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def worlds(tmp_path_factory, scenarios, inputs):
    """A function of the world size that spawns that many ranks once (for
    the caller's module), running ``scenarios[world]`` on ``inputs(world)``,
    and returns their results."""
    cache = {}

    def get(world):
        if world not in cache:
            d = tmp_path_factory.mktemp(f"gloo{world}")
            cache[world] = run(world, scenarios[world], inputs(world), str(d))
        return cache[world]
    return get


def same_on_ranks(results, scenario):
    """The scenario's result, checked equal on every rank (two levels of
    dicts of arrays)."""
    out = [r[scenario] for r in results]
    for o in out[1:]:
        assert o.keys() == out[0].keys()
        for k, v in o.items():
            if isinstance(v, dict):
                for kk in v:
                    np.testing.assert_array_equal(v[kk], out[0][k][kk])
            else:
                np.testing.assert_array_equal(v, out[0][k])
    return out[0]
