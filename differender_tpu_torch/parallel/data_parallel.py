"""Multi-view data parallelism (counterpart of
``differender_tpu/parallel/data_parallel.py``).

The reference renders a batch of views in a serial host loop.  Here the B
views are split evenly over the ranks of a process group, rank ``r``
rendering views ``[r*B/K, (r+1)*B/K)`` through :func:`~differender_tpu_torch.
render.render`; the images are all-gathered, and the volume and the TF are
replicated, so a loss that every rank computes alike from the whole batch
back-propagates to the whole gradient on every rank (the convention of
:mod:`._collectives`).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..config import RenderConfig
from ..render import render
from ._collectives import gather, group_rank, replicated


def _views_of_rank(B: int, group, like: torch.Tensor) -> range:
    """The views of this rank of ``group`` when B views are split evenly
    over its ranks."""
    k, n = group_rank(group, like)
    if B % n:
        raise ValueError(f"mesh axis views={n} must divide the view batch "
                         f"{B}")
    b = B // n
    return range(k * b, (k + 1) * b)


def render_views(volume: torch.Tensor, tf: torch.Tensor,
                 look_froms: torch.Tensor, config: RenderConfig, group=None,
                 sampling_rate: Optional[float] = None,
                 u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Render B views (``look_froms`` (B, 3)) split over ``group``'s ranks;
    returns the (B, H, W, 4) images on every rank.  ``u`` (B, H, W) holds
    each view's jitter draw (the JAX package's per-view keys); B must be a
    multiple of the group size.  Every rank calls it with the same inputs.
    Differentiable in ``volume`` and ``tf`` (whole gradients on every rank
    for a loss that every rank computes from the whole batch)."""
    views = _views_of_rank(look_froms.shape[0], group, volume)
    volume, tf = replicated(volume, group), replicated(tf, group)
    imgs = torch.stack([
        render(volume, tf, look_froms[i], config, sampling_rate,
               u=None if u is None else u[i]).image for i in views])
    return gather(imgs, group, 0)


def view_parallel_grads(loss_fn, volume: torch.Tensor, tf: torch.Tensor,
                        look_froms: torch.Tensor, targets: torch.Tensor,
                        config: RenderConfig, group=None,
                        sampling_rate: Optional[float] = None,
                        u: Optional[torch.Tensor] = None):
    """One data-parallel forward and backward of the mean over the B views
    of ``loss_fn(image, target)`` (``((H, W, 4), target) -> scalar``).
    Returns ``(loss, (d_volume, d_tf))``, the same on every rank."""
    v = volume.detach().to(torch.float32).requires_grad_(True)
    t = tf.detach().to(torch.float32).requires_grad_(True)
    imgs = render_views(v, t, look_froms, config, group, sampling_rate, u)
    loss = torch.stack([loss_fn(imgs[i], targets[i])
                        for i in range(imgs.shape[0])]).mean()
    d_v, d_t = torch.autograd.grad(loss, (v, t))
    return loss.detach(), (d_v, d_t)


__all__ = ["render_views", "view_parallel_grads"]
