"""The JAX package's torch bridge, ``TorchRaycaster`` (counterpart of
``differender_tpu/torch_interop.py``), over the port's own ``nn.Module``.

In the JAX package :class:`TorchRaycaster` carries torch tensors across to
the JAX renderer and back; in the port :class:`~differender_tpu_torch.
raycaster.Raycaster` already renders torch tensors with autograd, so
``TorchRaycaster`` is a thin module over it that keeps the bridge's
constructor and contract:

* the reference's layouts: volume ``([BS,] 1, D, H, W)``, TF
  ``([BS,] 4, R)``, camera ``([BS,] 3)``, image ``([BS,] 4, H, W)``,
  contiguous; inputs cast to f32;
* gradients scrubbed by ``nan_to_num``, as the reference scrubs them;
* the jitter draw of ``forward`` replayed by its backward (kernel K2
  recomputes the march with the saved draw), kept as ``_last_u``, the
  counterpart of the bridge's ``_last_key``;
* ``look_from`` gets no gradient unless built with ``camera_grads=True``,
  which ``march_vjp="tiled"`` refuses;
* ``raycast_nondiff`` and ``raycast_fast`` run under ``no_grad``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .raycaster import Raycaster


class _NanToNumGrad(torch.autograd.Function):
    """The identity, whose backward passes the gradient through
    ``torch.nan_to_num``."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.nan_to_num(g)


def _scrubbed(x):
    x = torch.as_tensor(x)
    return _NanToNumGrad.apply(x) if x.requires_grad else x


class TorchRaycaster(nn.Module):
    """Torch module with the reference ``Raycaster`` contract, rendered by
    the port's kernels (on ``device``, the card by default; "cpu" renders
    with the plain torch versions).

    Args:
        volume_shape: user-convention ``(D, H, W)``.
        output_shape: ``(W, H)`` render resolution.
        tf_shape: transfer-function resolution R.
        sampling_rate / jitter / max_samples / fov / near / far: as in the
            reference.
        seed: seed of the jitter draws' ``torch.Generator``.
        camera_grads: also return a ``look_from`` gradient; needs
            ``march_vjp="ad"`` (default) or ``"sorted"``.
        device: where the module renders (beyond the JAX bridge's
            arguments: JAX picks its backend globally).
        **config_kwargs: further :class:`RenderConfig` fields.
    """

    def __init__(self, volume_shape, output_shape, tf_shape: int,
                 sampling_rate: float = 1.0, jitter: bool = True,
                 max_samples: int = 512, fov: float = 30.0,
                 near: float = 0.1, far: float = 100.0, seed: int = 0,
                 camera_grads: bool = False, device="cuda",
                 **config_kwargs):
        super().__init__()
        self._rc = Raycaster(volume_shape, output_shape, tf_shape,
                             sampling_rate=sampling_rate, jitter=jitter,
                             max_samples=max_samples, fov=fov, near=near,
                             far=far, seed=seed, device=device,
                             camera_grads=camera_grads, **config_kwargs)
        if camera_grads and self._rc.config.march_vjp not in ("ad",
                                                              "sorted"):
            raise ValueError(
                "camera_grads=True needs march_vjp='ad' or 'sorted' (the "
                "'tiled' VJP drops camera terms); got "
                f"{self._rc.config.march_vjp!r}")
        self.camera_grads = camera_grads
        self.jitter = jitter
        self.sampling_rate = sampling_rate
        self.volume_shape = self._rc.volume_shape
        self.output_shape = self._rc.output_shape
        self.tf_shape = tf_shape

    @property
    def _last_u(self) -> Optional[torch.Tensor]:
        """The jitter draw of the last ``forward`` (the counterpart of the
        JAX module's ``_last_key``), which its backward replays."""
        return self._rc._last_u

    def forward(self, volume, tf, look_from,
                u: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Differentiable render: ``([BS,] 1, D, H, W) x ([BS,] 4, R) x
        ([BS,] 3) -> ([BS,] 4, H, W)``.  ``u`` ((H, W), or (BS, H, W) for a
        batch) is the jitter draw; by default the module draws one."""
        return self._rc(_scrubbed(volume), _scrubbed(tf),
                        _scrubbed(look_from), u=u).contiguous()

    def raycast_nondiff(self, volume, tf, look_from,
                        sampling_rate: Optional[float] = None
                        ) -> torch.Tensor:
        """Inference render, default rate ``4 * sampling_rate``, no
        jitter."""
        with torch.no_grad():
            return self._rc.raycast_nondiff(
                volume, tf, look_from, sampling_rate=sampling_rate
            ).contiguous()

    def raycast_fast(self, volume, tf, look_from,
                     intermediate: Optional[int] = None,
                     planes_per_voxel: float = 2.0) -> torch.Tensor:
        """Shear-warp approximate render, no gradients (use
        :func:`~differender_tpu_torch.fastpath.render_fast` for the
        differentiable fast path)."""
        with torch.no_grad():
            return self._rc.raycast_fast(
                volume, tf, look_from, intermediate=intermediate,
                planes_per_voxel=planes_per_voxel).contiguous()

    def extra_repr(self) -> str:
        return self._rc.extra_repr()


__all__ = ["TorchRaycaster"]
