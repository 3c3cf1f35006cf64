"""Plain PyTorch reference of the transfer-function fit.

A fit renders its target once: the inference march of the volume under the
target TF at ``fw_sampling_rate``.  Each step then renders the
differentiable march of the volume under the fitted TF at
``bw_sampling_rate`` (no jitter), takes the mean squared error over the
image's pixels and channels, and updates the TF by the momentum rule of the
upstream example's ``apply_grad``: ``mom <- gamma mom + lr_k clamp(g,
-clip, clip)``, ``tf <- max(tf - mom, 0)``, with ``lr_k = f32(lr)
f32(decay)^k`` at step ``k``.  The TF's gradient is autograd's of
:func:`dvr.march` in the TF alone (the volume needs none), one block of
rays at a time.  float32, with TF32 off, but for one sum: autograd's
backward of the lookup's gather adds a texel's terms one after another in
float32, and at the fit's black start millions of samples (the air's) fall
on one texel, so that sum would be off by about 1% of itself.  Here the
lookup's backward takes each sample's terms in float32 and sums them per
texel in float64 (:class:`_Lookup`).  Imports nothing of the program under
test.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import numpy as np
import torch

from . import dvr


def mse64(pred: torch.Tensor, target: torch.Tensor) -> float:
    """The mean squared error of an image, evaluated in float64."""
    return float(((pred.double() - target.double()) ** 2).mean())


def rate(k: int, lr: float, decay: float) -> float:
    """The momentum rule's rate at step ``k``, in float32."""
    return float(np.float32(lr) * np.power(np.float32(decay), np.float32(k)))


@contextlib.contextmanager
def _no_tf32():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


class _Lookup(torch.autograd.Function):
    """:func:`dvr.tf_lookup` of a TF held in float64 and read in float32:
    the lerp in float32; its backward forms each sample's two texels'
    terms in float32 and sums them per texel in float64."""

    @staticmethod
    def forward(ctx, tf64, x):
        tf = tf64.float()
        R = tf.shape[0]
        t = torch.maximum(x * float(R - 1), torch.zeros_like(x))
        low_f = torch.floor(t)
        frac = (t - low_f)[..., None]
        low = torch.clamp(low_f, max=float(R - 1)).long()
        high = torch.clamp(low + 1, max=R - 1)
        ctx.save_for_backward(low, high, frac)
        ctx.R = R
        return tf[low] * (1.0 - frac) + tf[high] * frac

    @staticmethod
    def backward(ctx, g):
        low, high, frac = ctx.saved_tensors
        C = g.shape[-1]
        acc = torch.zeros((ctx.R, C), dtype=torch.float64, device=g.device)
        acc.index_add_(0, low.reshape(-1),
                       ((1.0 - frac) * g).reshape(-1, C).double())
        acc.index_add_(0, high.reshape(-1), (frac * g).reshape(-1, C).double())
        return acc, None


@contextlib.contextmanager
def _lookup_summed_in_f64():
    """:func:`dvr.march` takes its TF lookup from :mod:`dvr`'s globals:
    :class:`_Lookup` stands in for it while the TF's gradient is taken."""
    orig = dvr.tf_lookup
    dvr.tf_lookup = _Lookup.apply
    try:
        yield
    finally:
        dvr.tf_lookup = orig


def image_and_tf_grad(volume: torch.Tensor, tf: torch.Tensor, rays: dvr.Rays,
                      target: torch.Tensor, sampling_rate: float,
                      optics: dvr.Optics, max_samples: int,
                      rays_per_block: int = 1 << 14):
    """The differentiable march's flat image (N, 4) of ``rays`` through
    ``volume`` (X, Y, Z) under ``tf`` (R, 4), and the gradient in ``tf`` of
    its mean squared error to ``target`` (N, 4), summed in float64 and
    returned in float32.  A pixel's share of the loss depends on that pixel
    alone, so each block of rays is marched once under autograd and takes
    its own cotangent."""
    tf = tf.detach().double().requires_grad_(True)
    N = rays.n.shape[0]
    image = torch.empty((N, 4), dtype=torch.float32, device=volume.device)
    scale = 2.0 / float(N * 4)
    with torch.enable_grad(), _lookup_summed_in_f64():
        for b in range(0, N, rays_per_block):
            sl = slice(b, min(N, b + rays_per_block))
            out = dvr.march(volume, tf, rays.rows(sl), sampling_rate, optics,
                            diff=True, max_samples=max_samples,
                            chunk_samples=1 << 22)
            image[sl] = out.detach()
            torch.autograd.backward(out, scale * (out.detach() - target[sl]))
    return image, tf.grad.float()


def fit_steps(volume_user: torch.Tensor, tf_target_user: torch.Tensor,
              tf0_user: torch.Tensor, look_from: torch.Tensor, cfg: dict,
              steps: int, store: Optional[Callable] = None,
              late_tf: Optional[torch.Tensor] = None) -> dict:
    """Follows the first ``steps`` steps of a fit from ``tf0_user`` (4, R)
    toward the image of ``tf_target_user`` (4, R), the volume ``(D, H, W)``
    seen from ``look_from`` (3,).  ``store`` (identity by default) is
    applied to the volume and the TFs where they are held, and to the TF
    after each update.  Returns each step's loss (:func:`mse64` of its
    image and the target), the first gradient and the TF after the last
    step, both ``(R, 4)``; with ``late_tf`` (R, 4), a TF met later in the
    fit, also the gradient there (``late_grad``)."""
    store = store or (lambda x: x)
    optics = dvr.Optics.from_config(cfg)
    H, W = cfg["image"]
    with _no_tf32(), torch.no_grad():
        vol_user = store(volume_user)
        target = dvr.render_views(vol_user, store(tf_target_user),
                                  look_from[None], H, W,
                                  cfg["fw_sampling_rate"], optics,
                                  diff=False)[0]
        target = target.permute(1, 2, 0).reshape(-1, 4)
        vol = dvr.internal(vol_user)
        rays = dvr.camera_rays(look_from, H, W, tuple(vol.shape),
                               cfg["bw_sampling_rate"], optics)
        tf = store(tf0_user.t().contiguous())
        mom = torch.zeros_like(tf)
        losses, grad1 = [], None
        for k in range(steps):
            image, grad = image_and_tf_grad(
                vol, tf, rays, target, cfg["bw_sampling_rate"], optics,
                cfg["max_samples"])
            if grad1 is None:
                grad1 = grad
            lr = rate(k, cfg["lr"], cfg["lr_decay"])
            clip = cfg["clip_grads"]
            mom = cfg["mom"] * mom + lr * torch.clamp(grad, -clip, clip)
            tf = store(torch.clamp(tf - mom, min=0.0))
            losses.append(mse64(image, target))
        out = {"losses": losses, "grad1": grad1, "tf": tf}
        if late_tf is not None:
            out["late_grad"] = image_and_tf_grad(
                vol, store(late_tf.to(vol.device)), rays, target,
                cfg["bw_sampling_rate"], optics, cfg["max_samples"])[1]
    return out
