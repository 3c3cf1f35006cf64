"""Image losses of the reference training loops (counterpart of
``differender_tpu/losses.py``): MSE, SSIM with an 11x11 Gaussian window
(sigma 1.5, pytorch_msssim semantics) and ``(1 - SSIM) + MSE``.

The Gaussian window is applied as two 1-D passes of shifted, weighted
slices: plain f32 elementwise work, so neither cuDNN nor TF32 touches the
moment arithmetic, forward or backward.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .profiling import span


def _mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    with span("dr.loss"):
        return _mse(pred, target)


@functools.lru_cache(maxsize=None)
def _gaussian_taps(size: int, sigma: float):
    """The 1-D factor of the JAX package's window ``outer(g, g)``."""
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    g /= g.sum()
    return tuple(float(v) for v in g.astype(np.float32))


def _filter2d(img: torch.Tensor, taps) -> torch.Tensor:
    """'Valid' Gaussian filtering of (N, C, H, W), one axis at a time."""
    k = len(taps)
    h, w = img.shape[-2:]
    rows = sum(t * img[..., i:i + h - k + 1, :] for i, t in enumerate(taps))
    return sum(t * rows[..., i:i + w - k + 1] for i, t in enumerate(taps))


def ssim(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0,
         win_size: int = 11, win_sigma: float = 1.5, k1: float = 0.01,
         k2: float = 0.03, size_average: bool = True,
         nonnegative_ssim: bool = False) -> torch.Tensor:
    """SSIM over (..., C, H, W) images (pytorch_msssim-compatible
    semantics).  Second moments are taken about the target's mean (no
    gradient), as in the JAX package, so ``E[x^2] - mu^2`` does not cancel."""
    pred = pred.to(torch.float32)
    target = target.to(torch.float32)
    if pred.ndim == 3:
        pred, target = pred[None], target[None]
    lead = pred.shape[:-3]
    pred = pred.reshape((-1,) + tuple(pred.shape[-3:]))
    target = target.reshape((-1,) + tuple(target.shape[-3:]))

    taps = _gaussian_taps(win_size, win_sigma)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    mu_x = _filter2d(pred, taps)
    mu_y = _filter2d(target, taps)
    mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y

    shift = torch.mean(target).detach()
    predc = pred - shift
    targetc = target - shift
    mu_xc = mu_x - shift
    mu_yc = mu_y - shift
    zero = pred.new_zeros(())
    sigma_xx = torch.maximum(_filter2d(predc * predc, taps) - mu_xc * mu_xc,
                             zero)
    sigma_yy = torch.maximum(
        _filter2d(targetc * targetc, taps) - mu_yc * mu_yc, zero)
    sigma_xy = _filter2d(predc * targetc, taps) - mu_xc * mu_yc

    cs = (2.0 * sigma_xy + c2) / (sigma_xx + sigma_yy + c2)
    ssim_map = ((2.0 * mu_xy + c1) / (mu_xx + mu_yy + c1)) * cs
    if nonnegative_ssim:
        ssim_map = torch.relu(ssim_map)
    per_image = torch.mean(ssim_map, dim=(1, 2, 3)).reshape(lead)
    return torch.mean(per_image) if size_average else per_image


def dssim_mse_loss(pred: torch.Tensor, target: torch.Tensor,
                   data_range: float = 1.0) -> torch.Tensor:
    """``(1 - SSIM) + MSE`` with the SSIM term NaN-scrubbed: the loss of the
    volume inverse-rendering example."""
    with span("dr.loss"):
        dssim = 1.0 - ssim(pred, target, data_range=data_range,
                           nonnegative_ssim=True)
        return torch.nan_to_num(dssim) + _mse(pred, target)


__all__ = ["mse_loss", "ssim", "dssim_mse_loss"]
