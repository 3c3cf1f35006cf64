"""User-facing ``Raycaster`` ``nn.Module`` with the reference's conventions
(counterpart of ``differender_tpu/raycaster.py``).

Inputs: volume ``([BS,] 1, D, H, W)``, transfer function ``([BS,] 4, R)``,
camera ``([BS,] 3)``; if any of them is batched, all are broadcast to the
batch.  Output ``([BS,] 4, H, W)``.  A batch is a Python loop over views.
``raycast_fast`` renders through the shear-warp fast path.
``forward`` is differentiable with respect to the volume and the TF (an
unbatched input broadcast over a batch gets the sum of its views'
gradients); the camera gets no gradient, as in the reference, unless the
module is built with ``camera_grads=True``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .config import RenderConfig
from .fastpath import render_fast
from .render import RenderOutput, render, render_nondiff


def volume_to_internal(volume: torch.Tensor) -> torch.Tensor:
    """User ``(D, H, W)`` to internal ``(X, Y, Z) = (W, D, H)``."""
    return volume.permute(2, 0, 1)


def volume_from_internal(volume: torch.Tensor) -> torch.Tensor:
    """Internal ``(W, D, H)`` to user ``(D, H, W)``."""
    return volume.permute(1, 2, 0)


def tf_to_internal(tf: torch.Tensor) -> torch.Tensor:
    """User channel-major ``(4, R)`` to internal ``(R, 4)``."""
    return tf.permute(1, 0)


def tf_from_internal(tf: torch.Tensor) -> torch.Tensor:
    return tf.permute(1, 0)


class Raycaster(nn.Module):
    """Volume raycaster.

    Args:
        volume_shape: user-convention ``(D, H, W)``.
        output_shape: render resolution ``(W, H)``.
        tf_shape: transfer-function resolution R.
        sampling_rate: default Nyquist multiplier.
        jitter: jitter ray starts by default, drawing from the module's own
            ``torch.Generator`` (seeded with ``seed``) on ``device``.
        max_samples: cap on the differentiable march depth.
        fov / near / far: perspective camera parameters.
        device: where the module renders; inputs are moved there.  Pass
            "cpu" to render with the plain torch versions.
        camera_grads: ``forward`` also differentiates ``look_from`` (as
            ``torch_interop.TorchRaycaster(camera_grads=True)`` does);
            without it ``look_from.grad`` stays None, the reference's
            contract.
        **config_kwargs: further :class:`RenderConfig` fields, such as
            ``analytic_normals``.
    """

    def __init__(self, volume_shape, output_shape, tf_shape: int,
                 sampling_rate: float = 1.0, jitter: bool = True,
                 max_samples: int = 512, fov: float = 30.0,
                 near: float = 0.1, far: float = 100.0, seed: int = 0,
                 device="cuda", camera_grads: bool = False,
                 **config_kwargs):
        super().__init__()
        d, h, w = volume_shape
        internal_shape = (w, d, h)
        self.config = RenderConfig(
            volume_shape=internal_shape,
            image_shape=(output_shape[1], output_shape[0]),
            tf_resolution=tf_shape, sampling_rate=sampling_rate,
            max_samples=max_samples, fov=fov, near=near, far=far,
            jitter=jitter, camera_grads=camera_grads, **config_kwargs)
        self.volume_shape = internal_shape
        self.output_shape = tuple(output_shape)
        self.tf_shape = tf_shape
        self.sampling_rate = sampling_rate
        self.jitter = jitter
        self.camera_grads = camera_grads
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def _as_input(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _determine_batch(self, volume, tf, look_from):
        """Validate shapes and broadcast; returns (batched, bs, volume
        (BS?, X, Y, Z), tf (BS?, R, 4), look_from (BS?, 3)) in internal
        layouts."""
        v_b, t_b, l_b = volume.ndim == 5, tf.ndim == 3, look_from.ndim == 2
        batched = v_b or t_b or l_b
        d, h, w = (self.volume_shape[1], self.volume_shape[2],
                   self.volume_shape[0])
        if tuple(volume.shape[-4:]) != (1, d, h, w):
            raise ValueError(
                f"volume must have shape ([BS,] 1, D, H, W) = (1, {d}, {h}, "
                f"{w}); got {tuple(volume.shape)}")
        if tuple(tf.shape[-2:]) != (4, self.tf_shape):
            raise ValueError(
                f"tf must have shape ([BS,] 4, R={self.tf_shape}) "
                f"(channel-major, reference convention); got "
                f"{tuple(tf.shape)}")
        if look_from.shape[-1] != 3:
            raise ValueError(f"look_from must have shape ([BS,] 3); got "
                             f"{tuple(look_from.shape)}")
        if not batched:
            return (False, 0, volume_to_internal(volume[0]).contiguous(),
                    tf_to_internal(tf).contiguous(), look_from)
        bs = (volume.shape[0] if v_b else tf.shape[0] if t_b
              else look_from.shape[0])
        vol = (volume[:, 0].permute(0, 3, 1, 2).contiguous() if v_b
               else volume_to_internal(volume[0]).contiguous()
               .expand((bs,) + self.volume_shape))
        tf_i = (tf.permute(0, 2, 1).contiguous() if t_b
                else tf_to_internal(tf).contiguous()
                .expand(bs, self.tf_shape, 4))
        lf = look_from if l_b else look_from.expand(bs, 3)
        return True, bs, vol, tf_i, lf

    def forward(self, volume, tf, look_from, u: Optional[torch.Tensor] = None,
                sampling_rate: Optional[float] = None) -> torch.Tensor:
        """Differentiable-path render; returns ``([BS,] 4, H, W)``,
        differentiable with respect to ``volume`` and ``tf``, and to
        ``look_from`` with ``camera_grads`` (a camera broadcast over a batch
        gets the sum of its views' gradients).  ``u``
        ((H, W), or (BS, H, W) for a batch) jitters ray starts with the
        given draw."""
        return self.forward_with_aux(volume, tf, look_from, u,
                                     sampling_rate).image

    def forward_with_aux(self, volume, tf, look_from,
                         u: Optional[torch.Tensor] = None,
                         sampling_rate: Optional[float] = None
                         ) -> RenderOutput:
        volume, tf, look_from = (self._as_input(volume), self._as_input(tf),
                                 self._as_input(look_from))
        if not self.camera_grads:
            look_from = look_from.detach()
        sr = self.sampling_rate if sampling_rate is None else sampling_rate
        batched, bs, vol, tf_i, lf = self._determine_batch(volume, tf,
                                                           look_from)
        H, W = self.config.image_shape
        want_u = (bs, H, W) if batched else (H, W)
        if u is not None:
            u = self._as_input(u)
            if tuple(u.shape) != want_u:
                raise ValueError(f"u must have shape {want_u}; got "
                                 f"{tuple(u.shape)}")
        elif self.jitter:
            u = torch.rand(want_u, generator=self.generator,
                           dtype=torch.float32, device=self.device)
        if not batched:
            out = render(vol, tf_i, lf, self.config, sr, u=u)
            return out._replace(image=out.image.permute(2, 0, 1))
        outs = [render(vol[i], tf_i[i], lf[i], self.config, sr,
                       u=None if u is None else u[i]) for i in range(bs)]
        return RenderOutput(
            image=torch.stack([o.image for o in outs]).permute(0, 3, 1, 2),
            valid_steps=torch.stack([o.valid_steps for o in outs]),
            n_samples=torch.stack([o.n_samples for o in outs]))

    @torch.no_grad()
    def raycast_nondiff(self, volume, tf, look_from,
                        sampling_rate: Optional[float] = None
                        ) -> torch.Tensor:
        """Inference render; default sampling rate ``4 * sampling_rate``,
        no jitter.  Returns ``([BS,] 4, H, W)``."""
        volume, tf, look_from = (self._as_input(volume), self._as_input(tf),
                                 self._as_input(look_from))
        sr = 4.0 * self.sampling_rate if sampling_rate is None \
            else sampling_rate
        batched, bs, vol, tf_i, lf = self._determine_batch(volume, tf,
                                                           look_from)
        if not batched:
            img = render_nondiff(vol, tf_i, lf, self.config, sr).image
            return img.permute(2, 0, 1)
        imgs = [render_nondiff(vol[i], tf_i[i], lf[i], self.config, sr).image
                for i in range(bs)]
        return torch.stack(imgs).permute(0, 3, 1, 2)

    def raycast_fast(self, volume, tf, look_from,
                     intermediate: Optional[int] = None,
                     planes_per_voxel: float = 2.0) -> torch.Tensor:
        """Shear-warp fast render
        (:func:`~differender_tpu_torch.fastpath.render_fast`: slab
        quadrature, not bit-exact with the exact renderer); returns
        ``([BS,] 4, H, W)``, differentiable in the volume and the TF."""
        volume, tf, look_from = (self._as_input(volume), self._as_input(tf),
                                 self._as_input(look_from))
        batched, bs, vol, tf_i, lf = self._determine_batch(volume, tf,
                                                           look_from)
        if not batched:
            return render_fast(vol, tf_i, lf, self.config, intermediate,
                               planes_per_voxel).image.permute(2, 0, 1)
        imgs = [render_fast(vol[i], tf_i[i], lf[i], self.config,
                            intermediate, planes_per_voxel).image
                for i in range(bs)]
        return torch.stack(imgs).permute(0, 3, 1, 2)

    def extra_repr(self) -> str:
        return (f"Volume ({self.volume_shape}), Output Render "
                f"({self.output_shape}), TF ({self.tf_shape}), "
                f"Max Samples = {self.config.max_samples}")


__all__ = ["Raycaster", "volume_to_internal", "volume_from_internal",
           "tf_to_internal", "tf_from_internal"]
