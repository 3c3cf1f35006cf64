"""Spatially sharded volume rendering with halo exchange (counterpart of
``differender_tpu/parallel/volume_sharding.py``).

For a volume too large for one card the grid is sharded along X over the
ranks of a process group, rank ``k`` holding the planes ``[k*xl,
(k+1)*xl)``.  Each shard owns a convex slab, so every ray crosses it in one
run of samples, and:

  1. each rank exchanges 2-plane boundary halos with its neighbours
     (:func:`_exchange_halos`: the trilinear and central-difference stencil
     reaches at most ``floor(c)+2`` / ``floor(c)-1`` for a normal delta
     below a voxel), with the JAX package's circular wrap at the outer
     shards, whose wrapped halos are never read;
  2. each rank marches only the window of sample indices that can fall in
     its slab (:func:`_segment_window`) and composites the samples it owns,
     by the exact test ``k*xl <= c_x < (k+1)*xl`` on the voxel coordinate
     that every rank computes alike (:func:`segment_march`: kernel K1's
     segment instantiation on CUDA, :func:`segment_march_plain` on the
     CPU);
  3. the segments are all-gathered and folded with the front-to-back "over"
     operator in per-pixel camera order (:func:`compose_segments`).

Semantics: those of ``render(..., ert=False)``: early ray termination is
sequential across shards and is not applied, as in the JAX package.  The
segment march takes the central-difference stencil and the TF of JAX's
``apply_tf`` whatever ``config.analytic_normals`` says, as JAX's segment
does.  Gradients flow to the volume (each rank gets its own slab's, the
halo cotangents sent home), to the TF and to a camera that requires grad
(both whole on every rank), by the convention of :mod:`._collectives`:
every rank builds the rays from the camera, as JAX builds them outside its
``shard_map``, and its segment's cotangents of the ray tensors (kernel K2's
segment camera instantiation on CUDA, autograd of the plain march on the
CPU) cover its own samples; the ranks' parts are summed.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import _build
from ..config import RenderConfig
from ..geometry import RayBundle, make_rays, march_params
from ..profiling import span
from ..render import (RaySoA, RenderOutput, SampleCotangents, Segment,
                      _inputs, _launch_k2, _launch_march, _ray_soa, _tap,
                      ray_cotangents, tap_cotangents)
from ..sampling import apply_tf, sample_with_gradient_shard, voxel_scale
from ..shading import shade
from ._collectives import (all_gather, gather, group_rank, replicated,
                           same_grad_flags)

HALO = 2   # planes: trilinear (+1) and the normal stencil (+-delta < 1 voxel)


def _slab_width(X: int, n_shards: int) -> int:
    if X % n_shards:
        raise ValueError(f"volume X axis must divide the mesh axis: X = {X} "
                         f"over {n_shards} ranks")
    xl = X // n_shards
    if xl < HALO:
        raise ValueError(f"each shard needs at least {HALO} planes for the "
                         f"halos; X = {X} over {n_shards} ranks gives {xl}")
    return xl


def shard_volume(volume: torch.Tensor, group=None, device=None
                 ) -> torch.Tensor:
    """This rank's contiguous X-slab ``volume[k*xl:(k+1)*xl]`` of a global
    (X, Y, Z) volume (the JAX package's ``device_put`` with ``P(axis)``),
    on ``device`` (default: the volume's)."""
    if device is not None:
        volume = volume.to(device)
    k, n = group_rank(group, volume)
    xl = _slab_width(volume.shape[0], n)
    return volume[k * xl:(k + 1) * xl].contiguous()


def pad_halos(volume: torch.Tensor, k: int, n_shards: int) -> torch.Tensor:
    """Shard ``k``'s padded block of a global volume in one process: the
    global planes ``[k*xl - HALO, (k+1)*xl + HALO)``, wrapped circularly at
    the outer shards as the JAX package's halo exchange wraps them; what
    :func:`_exchange_halos` builds on rank ``k``.  Differentiable."""
    X = volume.shape[0]
    xl = _slab_width(X, n_shards)
    planes = torch.arange(k * xl - HALO, (k + 1) * xl + HALO,
                          device=volume.device) % X
    return volume.index_select(0, planes)


class _ExchangeHalos(torch.autograd.Function):
    """``[left halo | local | right halo]``: the forward all-gathers every
    rank's first and last ``HALO`` planes and takes its neighbours'; the
    backward all-gathers each rank's halo cotangents and adds them to the
    edge planes of the ranks that own those planes."""

    @staticmethod
    def forward(ctx, vol_local, group):
        k, n = dist.get_rank(group), dist.get_world_size(group)
        ctx.group, ctx.k, ctx.n = group, k, n
        edges = all_gather(torch.cat([vol_local[:HALO], vol_local[-HALO:]]),
                           group)
        return torch.cat([edges[(k - 1) % n][HALO:], vol_local,
                          edges[(k + 1) % n][:HALO]])

    @staticmethod
    def backward(ctx, g):
        k, n = ctx.k, ctx.n
        d_local = g[HALO:-HALO].clone()
        halos = all_gather(torch.cat([g[:HALO], g[-HALO:]]), ctx.group)
        # Rank k+1's left halo is this rank's last planes, rank k-1's right
        # halo its first planes.
        d_local[-HALO:] += halos[(k + 1) % n][:HALO]
        d_local[:HALO] += halos[(k - 1) % n][HALO:]
        return d_local, None


def _exchange_halos(vol_local: torch.Tensor, group) -> torch.Tensor:
    """The padded block (xl + 2*HALO, Y, Z) of this rank's slab, the
    halos from its neighbours (see :class:`_ExchangeHalos`)."""
    return _ExchangeHalos.apply(vol_local, group)


def _segment_window(rays: RayBundle, k: int, xl: int, scale_x, n_shards: int,
                    length: int) -> torch.Tensor:
    """Per ray, the first step ``s_lo`` (H, W) int32 of the window of
    ``length`` steps that can meet shard ``k``'s slab, in the JAX package's
    f32 operations: which samples a shortened window covers depends on
    ``s_lo`` to the ulp.  The slab's world-x extent is ``[2*x_lo/scale - 1,
    2*x_hi/scale - 1]``, unbounded at the outer shards (the coordinate clamp
    folds everything outside onto them); the window only needs to be
    conservative, the exact ownership test does the rest."""
    f32 = np.float32
    dev = rays.dirs.device
    big = f32(3.0e38)
    wx = [f32(2.0) * f32(k * xl) / scale_x - f32(1.0),
          f32(2.0) * f32((k + 1) * xl) / scale_x - f32(1.0)]
    if k == 0:
        wx[0] = -big
    if k == n_shards - 1:
        wx[1] = big
    with span("dr.sync"):
        wx_lo = torch.tensor(wx[0], dtype=torch.float32, device=dev)
    with span("dr.sync"):
        wx_hi = torch.tensor(wx[1], dtype=torch.float32, device=dev)
    params = march_params(rays)
    ox = rays.origin[0]
    dx = rays.dirs[..., 0]
    one = torch.ones((), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    safe_dx = torch.where(torch.abs(dx) > 1e-12, dx, one)
    t_in = torch.minimum((wx_lo - ox) / safe_dx, (wx_hi - ox) / safe_dx)
    degenerate = torch.abs(dx) <= 1e-12                       # ray || slab
    safe_dt = torch.where(params.dt > 0, params.dt, one)
    s_lo = torch.floor((t_in - params.t0) / safe_dt) - 1.0
    s_lo = torch.where(degenerate | (params.dt <= 0), zero, s_lo)
    # Keep the window inside [0, n]: short rays re-scan masked tail steps.
    top = torch.maximum(rays.n_samples.to(torch.float32) - float(length),
                        zero)
    return torch.minimum(torch.maximum(s_lo, zero), top).to(torch.int32)


def _segment(rays: RayBundle, config: RenderConfig, k: int, n_shards: int,
             length: int) -> Segment:
    X = config.volume_shape[0]
    xl = _slab_width(X, n_shards)
    scale_x = voxel_scale(config.volume_shape)[0]
    s_lo = _segment_window(rays, k, xl, scale_x, n_shards, length)
    return Segment(s_lo.reshape(-1), int(length), k * xl - HALO,
                   float(np.float32(k * xl)), float(np.float32((k + 1) * xl)))


def segment_march_plain(padded: torch.Tensor, tf: torch.Tensor,
                        rays: RayBundle, config: RenderConfig, sampling_rate,
                        k: int, n_shards: int, length: int, taps=None):
    """Plain torch march of shard ``k``'s segment (the local part of the
    JAX package's ``segment_render``): over the window's steps, the samples
    that are in range (``s < min(n, max_samples)``) and owned; per sample
    the stencil of :func:`~differender_tpu_torch.sampling.
    sample_with_gradient_shard` on the padded block, the TF of
    :func:`~differender_tpu_torch.sampling.apply_tf`, the clamped headlight
    and the composite, front to back without ERT.  Returns ``(acc (H, W, 4),
    cnt (H, W) int32)``: the premultiplied ``(r, g, b, 1 - T)`` of the
    owned samples and their count.  Differentiable by autograd in
    ``padded``, ``tf`` and the ray bundle's tensors; kernel K1's segment
    instantiation is held to it.  ``taps`` (a list) receives the owned
    samples' taps, as ``render._plain_march`` records them."""
    H, W = config.image_shape
    seg = _segment(rays, config, k, n_shards, length)
    origin, dirs, t0, dt, n = _ray_soa(rays)
    dev = padded.device
    N = dirs.shape[0]
    limit = torch.clamp(n, max=config.max_samples)
    scale = torch.as_tensor(voxel_scale(config.volume_shape), device=dev)
    # A zero in the graph of every input: a shard that owns no sample still
    # returns a composite that autograd traces back to them, so that its
    # rank's backward runs the same collectives as the others'.
    zero = sum(x[:0].sum() for x in (padded, tf, origin, dirs, t0, dt))
    T = torch.ones(N, dtype=torch.float32, device=dev) + zero
    rgb = torch.zeros((N, 3), dtype=torch.float32, device=dev)
    cnt = torch.zeros(N, dtype=torch.int32, device=dev)
    for j in range(length):
        s = seg.s_lo + j
        with span("dr.sync"):
            idx = torch.nonzero(s < limit).reshape(-1)
        if idx.numel() == 0:
            break
        t = t0[idx] + s[idx].to(torch.float32) * dt[idx]
        pos = origin + t[:, None] * dirs[idx]
        c_x = torch.clamp(0.5 * pos[:, 0] + 0.5, 0.0, 1.0) * scale[0]
        own = (c_x >= seg.x_lo) & (c_x < seg.x_hi)
        on, pos = idx[own], pos[own]
        if on.numel() == 0:
            continue
        view = dirs[on]
        if taps is not None:
            pos, view, z = _tap(taps, on, s[on], pos, view)
        intensity, grad = sample_with_gradient_shard(
            padded, pos, config.volume_shape, seg.x_start,
            config.normal_delta)
        light_pos = pos
        if taps is not None:
            intensity, grad, light_pos = (intensity + z[0], grad + z[1],
                                          pos + z[2])
        shaded = shade(light_pos, grad, apply_tf(tf, intensity), view,
                       origin, sampling_rate, config, clamp_light=True)
        Ti = T[on]
        rgb = rgb.index_add(0, on, Ti[:, None] * shaded[:, :3])
        T = T.index_copy(0, on, Ti * (1.0 - shaded[:, 3]))
        cnt[on] += 1
    acc = torch.cat([rgb, (1.0 - T)[:, None]], -1).reshape(H, W, 4)
    return acc, cnt.reshape(H, W)


def segment_cotangents_plain(padded: torch.Tensor, tf: torch.Tensor,
                             rays: RayBundle, config: RenderConfig,
                             sampling_rate, k: int, n_shards: int,
                             length: int, grad: torch.Tensor
                             ) -> SampleCotangents:
    """Autograd of :func:`segment_march_plain` for the cotangent ``grad``
    (H, W, 4) of its composite, taken at each owned sample: the plain
    version of K2's segment camera sums (``render.ray_sums``).  Not
    exported: ``chip_smoke.py`` and the tests hold K2 to it."""
    taps = []
    with torch.enable_grad():
        acc, _ = segment_march_plain(padded, tf, rays, config, sampling_rate,
                                     k, n_shards, length, taps)
        return tap_cotangents(acc.reshape(-1, 4), taps, grad)


def march_segment_fwd(padded: torch.Tensor, tf: torch.Tensor,
                      rays: RayBundle, config: RenderConfig, sampling_rate,
                      k: int, n_shards: int, length: int):
    """Kernel K1's segment instantiation on CUDA tensors (one launch),
    :func:`segment_march_plain` on CPU tensors.  Returns ``(acc (H, W, 4),
    cnt (H, W))``; no autograd."""
    if _build.uses_plain(padded):
        with torch.no_grad():
            return segment_march_plain(padded, tf, rays, config,
                                       sampling_rate, k, n_shards, length)
    soa = _ray_soa(rays)
    seg = _segment(rays, config, k, n_shards, length)
    with _build.launch("march_segment_fwd"):
        return _launch_march(padded, tf, soa, config, sampling_rate, False,
                             segment=seg)


def march_segment_bwd(padded: torch.Tensor, tf: torch.Tensor,
                      rays: RayBundle, config: RenderConfig, sampling_rate,
                      k: int, n_shards: int, length: int, acc: torch.Tensor,
                      grad: torch.Tensor, *,
                      sums: Optional[torch.Tensor] = None):
    """Backward of shard ``k``'s segment for the cotangent ``grad``
    (H, W, 4) of its composite ``acc`` (:func:`march_segment_fwd`'s):
    kernel K2's segment instantiation on CUDA tensors (one launch),
    autograd of
    :func:`segment_march_plain` on CPU tensors.  Returns ``(d_padded,
    d_tf, cnt)``; ``d_padded`` holds the halo planes' cotangents too.
    ``sums``, an (H, W, 12) f32 tensor beside the block, receives the
    segment's per-ray position sums over its owned samples (K2's segment
    camera instantiation, tallied as ``march_segment_bwd.camera``;
    ``render.ray_cotangents`` maps
    them onto the ray tensors), the plain version of which is
    :func:`segment_cotangents_plain`."""
    if _build.uses_plain(padded):
        if sums is not None:
            raise ValueError("sums are taken by kernel K2 only; the block "
                             "is on the CPU")
        with torch.enable_grad():
            v = padded.detach().requires_grad_(True)
            t = tf.detach().requires_grad_(True)
            out, cnt = segment_march_plain(v, t, rays, config, sampling_rate,
                                           k, n_shards, length)
            d_v, d_t = torch.autograd.grad(out, (v, t), grad,
                                           allow_unused=True)
        return (torch.zeros_like(padded) if d_v is None else d_v,
                torch.zeros_like(tf) if d_t is None else d_t, cnt)
    H, W = config.image_shape
    soa = _ray_soa(rays)
    seg = _segment(rays, config, k, n_shards, length)
    with _build.launch("march_segment_bwd", camera=sums is not None):
        sums = _build.output("sums", sums, padded.device, (H, W, 12),
                             torch.float32)
        return _launch_k2(padded, tf, soa, config, sampling_rate, acc, grad,
                          False, sums=sums, segment=seg)


class _MarchSegment(torch.autograd.Function):
    """K1 segment forward, K2 segment backward, differentiable in the
    padded block, the TF and the ray tensors of :class:`RaySoA`.  Saves the
    inputs and the composite.  Where a ray tensor needs a gradient, K2's
    segment camera instantiation sums the owned samples' position
    cotangents per ray, and :func:`~differender_tpu_torch.render.
    ray_cotangents` maps them onto the ray tensors."""

    @staticmethod
    def forward(ctx, padded, tf, origin, dirs, t0, dt, n, s_lo, config,
                sampling_rate, seg_args):
        soa = RaySoA(origin, dirs, t0, dt, n)
        seg = Segment(s_lo, *seg_args)
        with _build.launch("march_segment_fwd"):
            acc, cnt = _launch_march(padded, tf, soa, config, sampling_rate,
                                     False, segment=seg)
        ctx.save_for_backward(padded, tf, origin, dirs, t0, dt, n, s_lo, acc)
        ctx.march = (config, sampling_rate, seg_args)
        ctx.mark_non_differentiable(cnt)
        return acc, cnt

    @staticmethod
    def backward(ctx, g_acc, _g_cnt):
        padded, tf, origin, dirs, t0, dt, n, s_lo, acc = ctx.saved_tensors
        config, sampling_rate, seg_args = ctx.march
        need = ctx.needs_input_grad
        camera = any(need[2:6])
        with span("dr.backward"):
            sums = (torch.empty(config.image_shape + (12,),
                                dtype=torch.float32, device=padded.device)
                    if camera else None)
            with _build.launch("march_segment_bwd", camera=camera):
                d_padded, d_tf, _ = _launch_k2(
                    padded, tf, RaySoA(origin, dirs, t0, dt, n), config,
                    sampling_rate, acc, g_acc, False, sums=sums,
                    segment=Segment(s_lo, *seg_args))
            d_rays = (ray_cotangents(sums, dirs, t0, dt) if camera
                      else (None,) * 4)
        grads = (d_padded, d_tf) + d_rays
        return tuple(g if k else None for g, k in zip(grads, need[:6])) + \
            (None,) * 5


def segment_march(padded: torch.Tensor, tf: torch.Tensor, rays: RayBundle,
                  config: RenderConfig, sampling_rate, k: int, n_shards: int,
                  length: int):
    """Shard ``k``'s segment of ``n_shards``, the local part of
    :func:`segment_render`: ``(acc (H, W, 4), cnt (H, W))``, differentiable
    in ``padded`` (the shard's block with its halos, :func:`pad_halos` or
    :func:`_exchange_halos`), ``tf`` and the ray bundle (so in the camera
    that built it): kernels K1 and K2 in their segment instantiations on
    CUDA tensors, :func:`segment_march_plain` (autograd) on CPU tensors.
    The ray tensors' cotangents cover this segment's samples only."""
    if _build.uses_plain(padded):
        return segment_march_plain(padded, tf, rays, config, sampling_rate,
                                   k, n_shards, length)
    seg = _segment(rays, config, k, n_shards, length)
    soa = _ray_soa(rays)
    return _MarchSegment.apply(padded, tf, *soa, seg.s_lo, config,
                               sampling_rate, tuple(seg[1:]))


def _over(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The front-to-back "over" operator on premultiplied RGBA,
    ``a + (1 - a.alpha) * b``; associative, which makes the per-shard
    composition exact."""
    return a + (1.0 - a[..., 3:4]) * b


def compose_segments(segments: torch.Tensor, counts: torch.Tensor,
                     dir_x: torch.Tensor):
    """Fold per-shard composites ``segments`` (K, H, W, 4) in per-pixel
    camera order: ascending shard index where the ray's ``dir_x > 0``,
    descending elsewhere (a ray parallel to the slabs lies in one shard).
    Returns ``(image (H, W, 4), valid (H, W) int32)`` with ``valid = 1 +
    sum(counts)``, as ``render``'s ``valid_steps``."""
    n = segments.shape[0]
    fwd, bwd = segments[0], segments[n - 1]
    for i in range(1, n):
        fwd = _over(fwd, segments[i])
        bwd = _over(bwd, segments[n - 1 - i])
    image = torch.where((dir_x > 0)[..., None], fwd, bwd)
    return image, (1 + counts.sum(0)).to(torch.int32)


def segment_render(vol_local: torch.Tensor, tf: torch.Tensor,
                   rays: RayBundle, config: RenderConfig, sampling_rate,
                   group, length: int, block: Optional[int] = None):
    """Render this rank's segment of an X-sharded volume and compose
    globally: halo exchange, the local march (:func:`segment_march`), the
    all-gather of the segments and :func:`compose_segments`.  Every rank
    must call it; each returns the composed ``(image (H, W, 4),
    valid_steps (H, W))``.  ``length`` is the window's (from
    :func:`segment_length`); ``block`` is accepted for the JAX package's
    signature (its march runs in blocks, the kernels per ray)."""
    k, n = group_rank(group, vol_local)
    padded = _exchange_halos(vol_local, group)
    acc, cnt = segment_march(padded, replicated(tf, group), rays, config,
                             sampling_rate, k, n, length)
    segments = gather(acc[None], group, 0)
    counts = torch.stack(all_gather(cnt, group))
    return compose_segments(segments, counts, rays.dirs[..., 0])


def segment_length(config: RenderConfig, sampling_rate: float,
                   segment_max_samples: Optional[int] = None,
                   block: Optional[int] = None):
    """``(length, block)`` of a segment's window: the differentiable
    march's step bound (or ``segment_max_samples`` if smaller), rounded up
    to a multiple of ``block`` (default ``config.block_size``), as in the
    JAX package, whose march runs in blocks.  The length decides the clip
    of the window's start to ``n - length``."""
    full = config.diff_march_steps(float(sampling_rate))
    length = full if segment_max_samples is None else min(
        segment_max_samples, full)
    b = max(1, min(config.block_size if block is None else block, length))
    return -(-length // b) * b, b


def render_volume_sharded(vol_local: torch.Tensor, tf: torch.Tensor,
                          look_from, config: RenderConfig, group=None,
                          sampling_rate: Optional[float] = None,
                          u: Optional[torch.Tensor] = None,
                          segment_max_samples: Optional[int] = None
                          ) -> RenderOutput:
    """Differentiable render of an X-sharded volume (see the module
    docstring); every rank of ``group`` calls it with its slab
    ``vol_local`` (:func:`shard_volume`) and the same TF, camera and draw
    ``u`` (H, W), and gets the whole image, the same on every rank.

    ``segment_max_samples`` bounds each shard's window (default: the whole
    step bound, always exact; smaller windows cost ~``max_samples / K``
    steps per shard and can miss samples of oblique rays).  Gradients: the
    rank's slab's ``d_volume``, the whole ``d_tf`` and, for a ``look_from``
    that requires grad, the whole ``d_look_from``, the same on every rank
    (the ranks' parts summed, as JAX's ``jax.grad`` sums them through its
    ``shard_map``).  Every rank must ask for the same gradients: where
    ``vol_local``, ``tf`` or ``look_from`` requires grad on some ranks and
    not on others, every rank raises ``ValueError`` (a backward that only
    some ranks entered would hang in its collectives)."""
    sr = config.sampling_rate if sampling_rate is None else sampling_rate
    k, n = group_rank(group, vol_local)
    X, Y, Z = config.volume_shape
    xl = _slab_width(X, n)
    if tuple(vol_local.shape) != (xl, Y, Z):
        raise ValueError(f"rank {k}'s slab must have shape {(xl, Y, Z)}; "
                         f"got {tuple(vol_local.shape)}")
    vol_local, tf, look_from = _inputs(vol_local, tf, look_from)
    same_grad_flags(group, vol_local, vol_local=vol_local, tf=tf,
                    look_from=look_from)
    length, block = segment_length(config, float(sr), segment_max_samples)
    with span("dr.view"):
        rays = make_rays(replicated(look_from, group), config, sr, u=u)
        image, valid = segment_render(vol_local, tf, rays, config, sr, group,
                                      length, block)
    return RenderOutput(image=image, valid_steps=valid,
                        n_samples=rays.n_samples)


__all__ = ["HALO", "shard_volume", "pad_halos", "compose_segments",
           "segment_march", "segment_march_plain", "march_segment_fwd",
           "march_segment_bwd", "segment_render", "segment_length",
           "render_volume_sharded"]
