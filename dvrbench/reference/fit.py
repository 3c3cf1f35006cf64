"""Plain PyTorch reference of the volume-fitting step.

The loss is ``(1 - SSIM) + MSE`` over a batch of ``(4, H, W)`` views: SSIM
with an 11 x 11 Gaussian window of sigma 1.5 applied without padding
(k1 = 0.01, k2 = 0.03, data range 1), its map clipped at 0, averaged per
view and then over the views; second moments are taken about the target's
mean, which changes no value; a NaN SSIM term counts 0.  The optimizer is
AdamW (betas 0.9 and 0.999, eps 1e-8) under a cosine one-cycle schedule
(from ``max_lr / div`` up to ``max_lr`` over ``pct_start`` of the steps,
then down to ``max_lr / div / final_div``), and the volume is clamped to
[0, 1] after each step.  The ground truth of each step is the inference
render of the clean volume.  Imports nothing of the program under test.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional

import numpy as np
import torch

from . import dvr


def _window(size: int = 11, sigma: float = 1.5):
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return [float(v) for v in (g / g.sum()).astype(np.float32)]


def _blur(x: torch.Tensor, taps) -> torch.Tensor:
    """Separable Gaussian filter of (N, C, H, W), 'valid' on both axes, as
    weighted sums of shifted slices."""
    k = len(taps)
    h, w = x.shape[-2:]
    rows = sum(t * x[..., i:i + h - k + 1, :] for i, t in enumerate(taps))
    return sum(t * rows[..., i:i + w - k + 1] for i, t in enumerate(taps))


def ssim(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    g = _window()
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mx, my = _blur(pred, g), _blur(target, g)
    shift = target.mean().detach()
    x, y = pred - shift, target - shift
    mxc, myc = mx - shift, my - shift
    zero = pred.new_zeros(())
    sxx = torch.maximum(_blur(x * x, g) - mxc * mxc, zero)
    syy = torch.maximum(_blur(y * y, g) - myc * myc, zero)
    sxy = _blur(x * y, g) - mxc * myc
    smap = ((2.0 * mx * my + c1) / (mx * mx + my * my + c1)
            * ((2.0 * sxy + c2) / (sxx + syy + c2)))
    return torch.relu(smap).mean(dim=(1, 2, 3)).mean()


def dssim_mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (torch.nan_to_num(1.0 - ssim(pred, target))
            + ((pred - target) ** 2).mean())


def loss64(pred: torch.Tensor, target: torch.Tensor) -> float:
    """The loss of rendered views, evaluated in float64: in float32 the
    SSIM's second moments cancel on flat backgrounds, and the rounding
    moves with the target's mean, by about 1e-5 of the loss."""
    return float(dssim_mse(pred.double(), target.double()))


def one_cycle_lr(k: int, max_lr: float, total_steps: int,
                 pct_start: float, div: float, final_div: float) -> float:
    """The rate of optimizer step ``k`` (0-based) of a cosine one-cycle
    schedule restarted every ``total_steps``."""
    k %= total_steps
    lo = max_lr / div
    up_end = float(pct_start * total_steps) - 1.0
    if k <= up_end:
        start, end, pct = lo, max_lr, k / up_end
    else:
        start, end = max_lr, lo / final_div
        pct = (k - up_end) / (total_steps - 1 - up_end)
    return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)


class AdamW:
    """AdamW on one tensor, in plain tensor arithmetic."""

    def __init__(self, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0):
        self.b1, self.b2 = betas
        self.eps, self.wd = eps, weight_decay
        self.m = self.v = None
        self.t = 0

    @torch.no_grad()
    def step(self, p: torch.Tensor, g: torch.Tensor, lr: float) -> None:
        if self.m is None:
            self.m, self.v = torch.zeros_like(p), torch.zeros_like(p)
        self.t += 1
        p.mul_(1.0 - lr * self.wd)
        self.m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
        self.v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
        m_hat = self.m / (1.0 - self.b1 ** self.t)
        v_hat = self.v / (1.0 - self.b2 ** self.t)
        p.sub_(lr * m_hat / (v_hat.sqrt() + self.eps))


def fit_steps(volume0: torch.Tensor, volume_gt: torch.Tensor,
              tf: torch.Tensor, poses: List[torch.Tensor],
              jitters: List[torch.Tensor], cfg: dict,
              store: Optional[Callable] = None) -> dict:
    """Follows ``len(poses)`` fitting steps from ``volume0`` (D, H, W):
    step ``i`` renders the views ``poses[i]`` (V, 3) with the jitter
    ``jitters[i]`` (V, H, W).  ``store`` (identity by default) is applied to
    the volumes and the TF where they are held, and to the volume after
    each update.  Returns the losses (:func:`loss64` of each step's
    views), the first gradient and the volume after the last step."""
    store = store or (lambda x: x)
    optics = dvr.Optics.from_config(cfg)
    H, W = cfg["image"]
    opt = AdamW(weight_decay=cfg["weight_decay"])
    vol = store(volume0.clone())
    gt_vol, tf = store(volume_gt), store(tf)
    losses, grad1 = [], None
    for i, (lfs, u) in enumerate(zip(poses, jitters)):
        gts = dvr.render_views(gt_vol, tf, lfs, H, W, cfg["gt_sampling_rate"],
                               optics, diff=False)
        imgs = dvr.render_views(vol, tf, lfs, H, W, cfg["sampling_rate"],
                                optics, diff=True,
                                max_samples=cfg["max_samples"], u=u)
        imgs.requires_grad_(True)
        with torch.enable_grad():
            loss = dssim_mse(imgs, gts)
            cot, = torch.autograd.grad(loss, imgs)
        grad = dvr.volume_vjp(vol, tf, lfs, H, W, cfg["sampling_rate"], optics,
                              cfg["max_samples"], u, cot)
        if grad1 is None:
            grad1 = grad
        lr = one_cycle_lr(i, cfg["max_lr"], cfg["total_steps"],
                          cfg["pct_start"], cfg["div_factor"],
                          cfg["final_div_factor"])
        opt.step(vol, grad, lr)
        vol.clamp_(0.0, 1.0)
        vol = store(vol)
        losses.append(loss64(imgs.detach(), gts))
    return {"losses": losses, "grad1": grad1, "volume": vol}
