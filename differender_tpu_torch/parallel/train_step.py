"""The multi-view training step (counterpart of
``differender_tpu/parallel/train_step.py``).

The reference's training loop renders a batch of 8 poses per step and
back-propagates the joint loss.  :func:`train_step_views` takes the two
forms of the JAX package, which never build one graph over all views:

* ``"accum"``: the views one after another, each its own forward and
  backward, the gradients summed;
* ``"shard_map"``: the views split over the ranks of a process group, each
  rank looping over its own views as ``"accum"`` does, then one sum-reduce
  of the loss and the gradients over the group, divided by B.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import RenderConfig
from ..fastpath import render_fast
from ..render import render
from .data_parallel import _views_of_rank


def _render_exact(vol, tf, lf, config, sampling_rate, u):
    return render(vol, tf, lf, config, sampling_rate, u=u).image


def _render_shearwarp(vol, tf, lf, config, sampling_rate, u):
    """The shear-warp renderer: ``planes_per_voxel`` is the sampling rate
    (2 by default, at least 0.25); the draw is ignored (slab quadrature has
    no per-ray jitter)."""
    ppv = 2.0 if sampling_rate is None else max(float(sampling_rate), 0.25)
    return render_fast(vol, tf, lf, config, planes_per_voxel=ppv).image


_RENDERERS = {"exact": _render_exact, "shearwarp": _render_shearwarp}


def _views_value_grad(loss_fn, volume, tf, look_froms, targets, config,
                      sampling_rate, u, renderer, views):
    """The summed loss of ``views`` and its gradients, view by view."""
    draw = _RENDERERS[renderer]
    loss = torch.zeros((), dtype=torch.float32, device=volume.device)
    gv, gt = torch.zeros_like(volume), torch.zeros_like(tf)
    for i in views:
        v = volume.detach().requires_grad_(True)
        t = tf.detach().requires_grad_(True)
        li = loss_fn(draw(v, t, look_froms[i], config, sampling_rate,
                          None if u is None else u[i]), targets[i])
        gvi, gti = torch.autograd.grad(li, (v, t))
        loss = loss + li.detach()
        gv += gvi
        gt += gti
    return loss, gv, gt


def train_step_views(loss_fn: Callable, volume: torch.Tensor,
                     tf: torch.Tensor, look_froms: torch.Tensor,
                     targets: torch.Tensor, config: RenderConfig,
                     sampling_rate: Optional[float] = None,
                     u: Optional[torch.Tensor] = None, group=None,
                     mode: str = "auto", renderer: str = "exact"):
    """One multi-view forward and backward of ``mean_i loss_fn(render(vol,
    tf, look_froms[i]), targets[i])``; returns ``(loss, (d_volume,
    d_tf))``.

    Args:
        loss_fn: ``((H, W, 4) image, target) -> scalar``.
        u: optional (B, H, W) per-view jitter draws (the JAX package's
            keys).
        group: the process group of mode ``"shard_map"``, whose size must
            divide B; every rank calls the step with the same inputs and
            gets the same result.
        mode: ``"accum"`` (the views in turn, gradients summed),
            ``"shard_map"`` (the views over ``group``'s ranks) or
            ``"auto"`` (``"shard_map"`` iff a group is given).
        renderer: ``"exact"`` (:func:`~differender_tpu_torch.render.render`)
            or ``"shearwarp"`` (:func:`~differender_tpu_torch.fastpath.
            render_fast`).
    """
    if mode == "auto":
        mode = "shard_map" if group is not None else "accum"
    if mode not in ("accum", "shard_map"):
        raise ValueError(f"unknown mode {mode!r}")
    if renderer not in _RENDERERS:
        raise ValueError(f"unknown renderer {renderer!r}")
    B = look_froms.shape[0]
    volume = volume.detach().to(torch.float32)
    tf = tf.detach().to(torch.float32)
    if mode == "accum":
        loss, gv, gt = _views_value_grad(loss_fn, volume, tf, look_froms,
                                         targets, config, sampling_rate, u,
                                         renderer, range(B))
        inv = float(np.float32(1.0 / B))
        return loss * inv, (gv * inv, gt * inv)

    if group is None:
        raise ValueError("mode='shard_map' requires a group")
    loss, gv, gt = _views_value_grad(loss_fn, volume, tf, look_froms,
                                     targets, config, sampling_rate, u,
                                     renderer, _views_of_rank(B, group,
                                                              volume))
    for x in (loss, gv, gt):
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return loss / B, (gv / B, gt / B)


__all__ = ["train_step_views"]
