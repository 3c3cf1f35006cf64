"""Synthetic scenes (numpy copies of ``differender_tpu/utils/scenes.py`` and
of the volume of ``examples/render_nondiff.py``, kept here so the port never
imports the JAX package)."""
from __future__ import annotations

import numpy as np


def ct_phantom(res: int) -> np.ndarray:
    """CT-like structured phantom: soft body, a bone-like shell and an
    off-center inclusion, in ``(res,)*3`` f32 within [0, 1]."""
    xs = np.linspace(-1, 1, res, dtype=np.float32)
    gx, gy, gz = np.meshgrid(xs, xs, xs, indexing="ij")
    rr = np.sqrt(gx * gx + gy * gy + gz * gz)
    p = (0.8 / (1.0 + np.exp((rr - 0.55) * 40.0))
         + 0.2 * ((rr > 0.62) & (rr < 0.68))
         + 0.5 * (np.sqrt((gx - 0.2) ** 2 + gy ** 2 + (gz + 0.1) ** 2)
                  < 0.15)).astype(np.float32)
    return np.clip(p, 0.0, 1.0)


def synthetic_volume(n: int = 128) -> np.ndarray:
    """The skull-like shell with a soft core that the inference example of
    the JAX package renders by default (``examples/render_nondiff.py``), in
    ``(n,)*3`` f32."""
    xs = np.linspace(-1, 1, n, dtype=np.float32)
    g = np.meshgrid(xs, xs, xs, indexing="ij")
    r = np.sqrt(sum(x * x for x in g))
    shell = np.exp(-((r - 0.6) ** 2) / 0.004) * 0.6
    core = 1.0 / (1.0 + np.exp((r - 0.25) * 30.0)) * 0.35
    return (shell + core).astype(np.float32)


def noise_volume(res: int, seed: int = 0, scale: float = 0.5) -> np.ndarray:
    """The adversarial timing scene: uniform noise in [0, scale), with no
    empty space and no coherent structure."""
    return (np.random.default_rng(seed)
            .random((res,) * 3, np.float32) * scale)
