"""The collectives of the parallel layer and its gradient convention.

The JAX package's ``mesh`` and ``axis`` become a ``torch.distributed``
process group (``None``: the default group), which the caller initialises
(``torchrun`` or ``init_process_group``).  Tensors stay on their device:
CUDA tensors need an NCCL group, CPU tensors a gloo group; anything else
raises.  Only all-gather and all-reduce are used, which both backends
support at every world size, one included.

The gradient convention: every rank holds the replicated output and
computes the same loss from it.  Two autograd Functions carry it:

* :func:`gather`, an all-gather along a dimension, whose backward keeps the
  rank's own slice of the cotangent (every rank already holds the whole
  cotangent: a reduce-scatter would count it once per rank, the over-count
  the JAX package warns about for gradients taken inside ``shard_map``);
* :func:`replicated`, the identity on an input every rank holds alike,
  whose backward sums the ranks' partial gradients.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.distributed as dist

from .. import _build


def group_rank(group, like: torch.Tensor) -> Tuple[int, int]:
    """``(rank, world size)`` in ``group`` after checking that it exists and
    that its backend serves ``like``'s device."""
    _build.uses_plain(like)      # CPU or CUDA, else raises
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "differender_tpu_torch.parallel needs an initialised process "
            "group: call torch.distributed.init_process_group (torchrun "
            "gives it its address, world size and rank)")
    backend = str(dist.get_backend(group)).lower()
    want = "nccl" if like.is_cuda else "gloo"
    if want not in backend:
        raise ValueError(f"the process group's backend is {backend!r}; "
                         f"tensors on {like.device} need {want!r}")
    return dist.get_rank(group), dist.get_world_size(group)


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``t`` (all of one shape), in rank order."""
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return out


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        ctx.rank, ctx.size = dist.get_rank(group), x.shape[dim]
        return torch.cat(all_gather(x, group), dim)

    @staticmethod
    def backward(ctx, g):
        own = g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size)
        return own.contiguous(), None, None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order, on every
    rank; the backward keeps this rank's slice of the cotangent."""
    return _Gather.apply(x, group, dim)


def replicated(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself, held alike by every rank; the backward sums the ranks'
    gradients (so each rank gets the whole gradient).  Collective-free
    unless a gradient flows."""
    if not x.requires_grad:
        return x
    return _Replicated.apply(x, group)
