"""Transfer-function presets and rasterization (counterpart of
``differender_tpu/transfer.py``).

Textures use the renderer's ``(R, 4)`` layout; :func:`get_tf_torch_layout`
gives the reference's channel-major ``(4, R)``.
"""
from __future__ import annotations

from typing import Optional

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


def get_tf(tf_id: str, res: int,
           generator: Optional[torch.Generator] = None,
           device="cuda") -> torch.Tensor:
    """Named presets in the renderer layout ``(res, 4)``: ``tf1..tf5``,
    ``black`` (1e-2 everywhere), ``gray`` (0.5 colour, 0.02 alpha) and
    ``rand`` (uniform noise, drawn from ``generator``)."""
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
    raise ValueError(f"Invalid Transfer function identifier given ({tf_id}).")


def get_tf_torch_layout(tf_id: str, res: int,
                        generator: Optional[torch.Generator] = None,
                        device="cuda") -> torch.Tensor:
    """Preset in the reference's channel-major ``(4, res)`` layout."""
    return get_tf(tf_id, res, generator, device).T.contiguous()
