"""Headlight shading and opacity correction (counterpart of
``differender_tpu/shading.py``).

The light sits at ``look_from + (0, 1, 0)`` and ``light_dir`` points from
the light to the sample.  Sums over the three axes are written out
component by component, in the order the march kernels use.

Gradients follow the JAX package's conventions, which the backward march
kernel K2 (``csrc/march_bwd.cu``) repeats: ``max``/``min`` give half the
cotangent to each side at a tie (``torch.maximum``/``torch.minimum`` do,
``torch.clamp`` does not), and :func:`unit_normal` has the clamped VJP.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import RenderConfig

# The unit-normal VJP divides by max(|g|, eps): exact for any gradient above
# it, bounded (never NaN) at a zero gradient.
NORMAL_BWD_EPS = 1e-6


def opacity_correction(alpha: torch.Tensor, sampling_rate) -> torch.Tensor:
    """``1 - max(1 - a, 0) ** (1 / sampling_rate)``, the exponent an f32."""
    inv_sr = float(np.float32(1.0) / np.float32(sampling_rate))
    return 1.0 - torch.pow(torch.maximum(1.0 - alpha, alpha.new_zeros(())),
                           inv_sr)


def _unit_normal_value(grad: torch.Tensor) -> torch.Tensor:
    gx, gy, gz = grad.unbind(-1)
    g2 = gx * gx + gy * gy + gz * gz
    has_n = g2 > 0.0
    inv = torch.rsqrt(torch.where(has_n, g2, torch.ones_like(g2)))
    m = torch.where(has_n, inv, torch.zeros_like(inv))
    return grad * m[..., None]


class _UnitNormal(torch.autograd.Function):
    """``g / |g|`` with the JAX package's clamped VJP
    ``(v - (v.n) n) / max(|g|, 1e-6)`` (``differender_tpu/shading.py:84``)."""

    @staticmethod
    def forward(ctx, grad):
        n = _unit_normal_value(grad)
        ctx.save_for_backward(grad, n)
        return n

    @staticmethod
    def backward(ctx, v):
        grad, n = ctx.saved_tensors
        gx, gy, gz = grad.unbind(-1)
        mag = torch.sqrt(gx * gx + gy * gy + gz * gz)
        inv = 1.0 / torch.clamp(mag, min=NORMAL_BWD_EPS)
        vx, vy, vz = v.unbind(-1)
        nx, ny, nz = n.unbind(-1)
        dot = vx * nx + vy * ny + vz * nz
        return (v - dot[..., None] * n) * inv[..., None]


def unit_normal(grad: torch.Tensor) -> torch.Tensor:
    """``g * rsqrt(|g|^2)`` where ``|g|^2 > 0``, else 0; clamped VJP."""
    return _UnitNormal.apply(grad)


def shade(pos: torch.Tensor, grad: torch.Tensor, sample_rgba: torch.Tensor,
          view_dir: torch.Tensor, look_from: torch.Tensor, sampling_rate,
          config: RenderConfig, clamp_light: bool = True) -> torch.Tensor:
    """Shade samples; returns premultiplied ``(rgb * light * alpha, alpha)``
    ``(..., 4)``.  A zero gradient gives ambient light only;
    ``clamp_light`` applies ``min(1, light)`` (differentiable path only)."""
    alpha = opacity_correction(sample_rgba[..., 3], sampling_rate)
    zero = alpha.new_zeros(())

    gx, gy, gz = grad.unbind(-1)
    has_n = (gx * gx + gy * gy + gz * gz) > 0.0
    nx, ny, nz = unit_normal(grad).unbind(-1)

    px, py, pz = pos.unbind(-1)
    ldx = px - look_from[0]
    ldy = py - (look_from[1] + 1.0)
    ldz = pz - look_from[2]
    lmag = torch.sqrt(ldx * ldx + ldy * ldy + ldz * ldz)
    inv = 1.0 / torch.where(lmag > 0.0, lmag, torch.ones_like(lmag))
    ldx, ldy, ldz = ldx * inv, ldy * inv, ldz * inv

    dot = nx * ldx + ny * ldy + nz * ldz
    diffuse = config.diffuse * torch.where(has_n, torch.maximum(dot, zero),
                                           zero)
    # GLSL reflect(I, N) = I - 2*dot(N, I)*N
    rx = ldx - 2.0 * dot * nx
    ry = ldy - 2.0 * dot * ny
    rz = ldz - 2.0 * dot * nz
    vdx, vdy, vdz = view_dir.unbind(-1)
    r_dot_v = torch.maximum(-(rx * vdx + ry * vdy + rz * vdz), zero)
    specular = config.specular * torch.where(
        has_n, torch.pow(r_dot_v, float(config.shininess)), zero)

    light = diffuse + specular + config.ambient
    if clamp_light:
        light = torch.minimum(light, light.new_ones(()))

    la = light * alpha
    lc = config.light_color
    return torch.stack([sample_rgba[..., 0] * la * lc[0],
                        sample_rgba[..., 1] * la * lc[1],
                        sample_rgba[..., 2] * la * lc[2],
                        alpha], dim=-1)


__all__ = ["opacity_correction", "unit_normal", "shade", "NORMAL_BWD_EPS"]
