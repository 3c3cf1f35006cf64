"""Multi-card parallelism over ``torch.distributed`` (counterpart of
``differender_tpu/parallel/``).

* :mod:`.data_parallel`: multi-view data parallelism, the views split over
  the ranks, the volume and the TF replicated;
* :mod:`.train_step`: the multi-view training step, views accumulated one
  after another or split over the ranks;
* :mod:`.volume_sharding`: a volume sharded along X over the ranks, each
  marching its slab's segment of every ray (kernels K1 and K2 in their
  segment instantiations), 2-plane halos exchanged, the segments composed
  in camera order.

JAX's ``mesh``/``axis`` become a process group (``None``: the default
group), which the caller initialises; every rank calls an entry point with
the same replicated inputs and gets the same replicated output, and the
gradients follow that convention (``_collectives``).  Launch one process
per card, e.g. ``torchrun --nproc-per-node N``; CUDA tensors need NCCL, CPU
tensors gloo.
"""
from .data_parallel import render_views, view_parallel_grads
from .train_step import train_step_views
from .volume_sharding import (HALO, compose_segments, pad_halos,
                              render_volume_sharded, segment_length,
                              segment_march, segment_render, shard_volume)

__all__ = [
    "render_views", "view_parallel_grads", "train_step_views",
    "render_volume_sharded", "shard_volume", "HALO", "compose_segments",
    "segment_render", "segment_length", "pad_halos", "segment_march",
]
