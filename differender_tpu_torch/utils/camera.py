"""Camera-path helpers (counterpart of ``differender_tpu/utils/camera.py``)."""
from __future__ import annotations

from typing import Optional

import torch


def in_circles(i, y: float = 0.7, dist: float = 2.5, device=None
               ) -> torch.Tensor:
    """Camera position on a horizontal orbit, ``(cos(i)*dist, y,
    sin(i)*dist)``; ``(..., 3)`` f32 for an angle (or angles) ``i``."""
    i = torch.as_tensor(i, dtype=torch.float32, device=device)
    return torch.stack([torch.cos(i) * dist, torch.full_like(i, y),
                        torch.sin(i) * dist], dim=-1)


def get_rand_pos(generator: torch.Generator, bs: Optional[int] = None,
                 dist: float = 2.7) -> torch.Tensor:
    """Random camera position(s), uniform on the sphere of radius ``dist``
    (normalized Gaussians), drawn from ``generator`` on its device.  Shape
    (3,) or (bs, 3).  Not bitwise the JAX package's ``jax.random`` draw."""
    shape = (3,) if bs is None else (bs, 3)
    v = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True) * dist


__all__ = ["in_circles", "get_rand_pos"]
