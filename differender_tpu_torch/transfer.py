"""Transfer-function presets and rasterization (counterpart of
``differender_tpu/transfer.py``).

Textures use the renderer's ``(R, 4)`` layout; :func:`get_tf_torch_layout`
gives the reference's channel-major ``(4, R)``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

# Control points of the reference presets: rows of (position, r, g, b, alpha).
_TF_POINTS = {
    "tf1": [
        [0.0000, 0.0000, 0.0000, 0.0000, 0.0000],
        [0.0840, 0.8510, 0.7230, 0.4672, 0.0000],
        [0.0850, 0.8510, 0.7230, 0.4672, 0.0831],
        [0.1844, 0.8510, 0.7230, 0.4672, 0.0801],
        [0.1890, 0.8510, 0.7230, 0.4672, 0.0000],
        [0.2444, 0.8667, 0.5166, 0.6566, 0.0000],
        [0.2528, 0.7176, 0.0675, 0.3276, 0.0782],
        [0.2621, 0.8667, 0.5166, 0.6566, 0.0000],
        [0.3407, 0.9843, 0.9843, 0.9843, 0.0000],
        [0.3601, 0.9843, 0.9843, 0.9843, 0.3904],
        [0.4475, 0.9843, 0.9843, 0.9843, 0.3917],
        [0.4655, 0.9843, 0.9843, 0.9843, 0.0000],
        [1.0000, 0.0000, 0.0000, 0.0000, 0.0000],
    ],
    "tf2": [
        [0.0000, 0.0000, 0.0000, 0.0000, 0.0000],
        [0.0178, 0.5333, 0.3597, 0.1861, 0.0000],
        [0.0206, 0.5333, 0.3597, 0.1861, 0.1834],
        [0.0361, 0.5333, 0.3597, 0.1861, 0.1804],
        [0.0388, 0.5333, 0.3597, 0.1861, 0.0000],
        [0.2224, 0.6902, 0.0839, 0.1951, 0.0000],
        [0.2274, 0.6902, 0.0839, 0.1951, 0.0880],
        [0.2479, 0.6902, 0.0839, 0.1951, 0.0831],
        [0.2515, 0.6902, 0.0839, 0.1951, 0.0000],
        [0.2857, 0.9843, 0.9843, 0.9843, 0.0000],
        [0.3042, 0.9843, 0.9843, 0.9843, 0.8240],
        [0.4540, 0.9843, 0.9843, 0.9843, 0.8172],
        [0.4916, 0.9843, 0.9843, 0.9843, 0.0000],
        [1.0000, 0.0000, 0.0000, 0.0000, 0.0000],
    ],
    "tf3": [
        [0.0000, 0.0000, 0.0000, 0.0000, 0.0000],
        [0.0279, 0.5991, 0.6235, 0.1345, 0.0000],
        [0.0477, 0.5991, 0.6235, 0.1345, 0.1736],
        [0.1090, 0.5991, 0.6235, 0.1345, 0.1779],
        [0.1304, 0.5991, 0.6235, 0.1345, 0.0000],
        [0.3654, 0.9843, 0.9843, 0.9843, 0.0000],
        [0.3991, 0.9843, 0.9843, 0.9843, 0.3912],
        [0.7440, 0.9843, 0.9843, 0.9843, 0.3893],
        [0.7850, 0.9843, 0.9843, 0.9843, 0.0000],
        [1.0000, 0.0000, 0.0000, 0.0000, 0.0000],
    ],
    "tf4": [
        [0.0000, 0.0000, 0.0000, 0.0000, 0.0000],
        [0.0916, 0.5059, 0.1627, 0.1627, 0.0000],
        [0.1204, 0.5059, 0.1627, 0.1627, 0.1932],
        [0.1865, 0.5059, 0.1627, 0.1627, 0.1956],
        [0.2120, 0.5059, 0.1627, 0.1627, 0.0000],
        [0.4841, 0.9176, 0.9176, 0.9176, 0.0000],
        [0.5195, 0.9176, 0.9176, 0.9176, 0.6406],
        [0.6609, 0.9176, 0.9176, 0.9176, 0.6362],
        [0.6968, 0.9176, 0.9176, 0.9176, 0.0000],
        [1.0000, 0.0000, 0.0000, 0.0000, 0.0000],
    ],
    "tf5": [
        [0.0000, 0.0000, 0.0000, 0.0000, 0.0000],
        [0.1300, 0.5000, 0.5000, 0.5000, 0.0000],
        [0.1350, 0.5000, 0.5000, 0.5000, 0.7500],
        [0.1600, 0.5000, 0.5000, 0.5000, 0.7500],
        [0.1700, 0.5000, 0.5000, 0.5000, 0.0000],
        [1.0000, 0.0000, 0.0000, 0.0000, 0.0000],
    ],
}


def _interp_f32(x, xp, fp):
    """``np.interp`` evaluated in f32, rounding as ``jnp.interp`` does."""
    i = np.clip(np.searchsorted(xp, x, side="right"), 1, len(xp) - 1)
    dx = xp[i] - xp[i - 1]
    flat = np.abs(dx) <= np.spacing(np.finfo(np.float32).eps)
    f = fp[i - 1] + ((x - xp[i - 1]) / np.where(flat, np.float32(1), dx)
                     ) * (fp[i] - fp[i - 1])
    f = np.where(flat, fp[i - 1], f)
    f = np.where(x < xp[0], fp[0], f)
    return np.where(x > xp[-1], fp[-1], f)


def tex_from_pts(pts, res: int, device="cuda") -> torch.Tensor:
    """Rasterize piecewise-linear control points (rows of pos, r, g, b, a)
    to an ``(res, 4)`` f32 texture sampled at ``linspace(0, 1, res)``."""
    pts = np.asarray(pts, np.float32)
    # f32 linspace as i * (1 / (res - 1)) with an exact endpoint, rounded as
    # XLA rounds jnp.linspace.
    if res == 1:
        xs = np.zeros(1, np.float32)
    else:
        xs = np.append(np.arange(res - 1, dtype=np.float32)
                       * (np.float32(1) / np.float32(res - 1)),
                       np.float32(1))
    tex = np.stack([_interp_f32(xs, pts[:, 0], pts[:, 1 + c])
                    for c in range(4)], axis=-1).astype(np.float32)
    return torch.as_tensor(tex, device=device)


class Peaks(NamedTuple):
    """The draws of a random peaked TF, f32 numpy arrays of one row per
    peak, centres sorted."""
    centers: np.ndarray    # (n,) in [0.08, 0.85)
    widths: np.ndarray     # (n,) half-widths in [0.02, 0.15)
    top_frac: np.ndarray   # (n,) flat-top share of the half-width [0.1, 0.9)
    heights: np.ndarray    # (n,) plateau alpha in [0.15, 0.95)
    colors: np.ndarray     # (n, 3) rgb in [0.05, 1.0)


def draw_peaks(generator: torch.Generator, max_num_peaks: int = 2) -> Peaks:
    """The draws of :func:`random_peaks_tf` from ``generator``, in the
    ranges of the JAX package's ``transfer.py::random_peaks_tf`` (torch
    cannot replay its ``jax.random`` bits): a count uniform in
    ``1..max_num_peaks``, then per peak a centre, a half-width, a flat-top
    share, a height and a colour, each uniform."""
    dev = generator.device

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, dtype=torch.float32,
                       device=dev).cpu().numpy()
        return (u * np.float32(hi - lo) + np.float32(lo)).astype(np.float32)

    n = int(torch.randint(1, max_num_peaks + 1, (1,), generator=generator,
                          device=dev))
    return Peaks(np.sort(uniform((n,), 0.08, 0.85)),
                 uniform((n,), 0.02, 0.15), uniform((n,), 0.1, 0.9),
                 uniform((n,), 0.15, 0.95), uniform((n, 3), 0.05, 1.0))


def peaks_points(peaks: Peaks) -> np.ndarray:
    """Control points (rows of pos, r, g, b, a) of flat-top trapezoids, one
    per peak, as the JAX package's ``random_peaks_tf`` lays them out: a
    peak that its left neighbour swallows is left out."""
    pts = [[0.0, 0.0, 0.0, 0.0, 0.0]]
    prev_end = 0.0
    for c, w, tfr, h, (r, g, b) in zip(*peaks):
        t = w * tfr
        lo, hi = max(c - w, prev_end + 1e-4), min(c + w, 1.0 - 1e-4)
        ti, to = max(c - t, lo), min(c + t, hi)
        if not (lo < ti <= to < hi):
            continue
        pts += [[lo, r, g, b, 0.0], [ti, r, g, b, h],
                [to, r, g, b, h], [hi, r, g, b, 0.0]]
        prev_end = hi
    pts += [[1.0, 0.0, 0.0, 0.0, 0.0]]
    return np.asarray(pts, np.float32)


def random_peaks_tf(res: int, generator: torch.Generator,
                    max_num_peaks: int = 2, device="cuda") -> torch.Tensor:
    """A random TF of trapezoidal peaks, ``(res, 4)``: the draws of
    :func:`draw_peaks` rasterized by :func:`peaks_points` and
    :func:`tex_from_pts`."""
    return tex_from_pts(peaks_points(draw_peaks(generator, max_num_peaks)),
                        res, device=device)


def get_tf(tf_id: str, res: int,
           generator: Optional[torch.Generator] = None,
           device="cuda") -> torch.Tensor:
    """Named presets in the renderer layout ``(res, 4)``: ``tf1..tf5``,
    ``black`` (1e-2 everywhere), ``gray`` (0.5 colour, 0.02 alpha),
    ``rand`` (uniform noise) and ``generate`` (:func:`random_peaks_tf`),
    the last two drawn from ``generator``."""
    if tf_id in _TF_POINTS:
        return tex_from_pts(_TF_POINTS[tf_id], res, device=device)
    if tf_id == "black":
        return torch.full((res, 4), 1e-2, dtype=torch.float32, device=device)
    if tf_id == "gray":
        t = torch.full((res, 4), 0.5, dtype=torch.float32, device=device)
        t[:, 3] = 0.02
        return t
    if tf_id == "rand":
        if generator is None:
            raise ValueError("get_tf('rand', ...) requires a torch.Generator.")
        return torch.rand((res, 4), generator=generator, dtype=torch.float32,
                          device=device)
    if tf_id == "generate":
        if generator is None:
            raise ValueError("get_tf('generate', ...) requires a "
                             "torch.Generator.")
        return random_peaks_tf(res, generator, device=device)
    raise ValueError(f"Invalid Transfer function identifier given ({tf_id}).")


def get_tf_torch_layout(tf_id: str, res: int,
                        generator: Optional[torch.Generator] = None,
                        device="cuda") -> torch.Tensor:
    """Preset in the reference's channel-major ``(4, res)`` layout."""
    return get_tf(tf_id, res, generator, device).T.contiguous()
