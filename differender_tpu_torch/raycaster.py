"""User-facing ``Raycaster`` ``nn.Module`` with the reference's conventions
(counterpart of ``differender_tpu/raycaster.py``).

Inputs: volume ``([BS,] 1, D, H, W)``, transfer function ``([BS,] 4, R)``,
camera ``([BS,] 3)``; if any of them is batched, all are broadcast to the
batch (a volume or TF batched with stride 0 on the batch axis, or a batch
of one, counts as one broadcast).  Output ``([BS,] 4, H, W)``.  A batch of
views of one volume and TF is one batched render:
:func:`~differender_tpu_torch.render.render_batch` in ``forward`` and
:func:`~differender_tpu_torch.render.render_nondiff_batch` in
``raycast_nondiff``; distinct volumes or TFs, and ``raycast_fast``, loop
over the views.
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
from .profiling import span
from .render import (RenderOutput, render, render_batch, render_nondiff,
                     render_nondiff_batch)


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


def _one_row(x: torch.Tensor) -> bool:
    """Whether every row of ``x``'s batch axis is one tensor: a batch of
    one, or rows broadcast with stride 0."""
    return x.shape[0] == 1 or x.stride(0) == 0


def _row(x: torch.Tensor, i: int, ndim: int) -> torch.Tensor:
    """View ``i``'s input: row ``i`` of a batched ``x``, or ``x`` itself
    where it has ``ndim`` dimensions (one input shared by the batch)."""
    return x if x.ndim == ndim else x[i]


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
        self._last_u = None     # the jitter draw of the last forward

    def _as_input(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _determine_batch(self, volume, tf, look_from):
        """Validate shapes and broadcast; returns (batched, bs, volume
        (BS?, X, Y, Z), tf (BS?, R, 4), look_from (BS?, 3)) in internal
        layouts.  A volume or TF shared by the batch (unbatched, a batch of
        one, or batched with stride 0) comes back as one tensor without the
        batch axis, so that each view's gradient adds into one tensor of
        its size (not into a zero tensor of the whole batch's)."""
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
        if v_b and _one_row(volume):
            volume, v_b = volume[0], False
        if t_b and _one_row(tf):
            tf, t_b = tf[0], False
        vol = (volume[:, 0].permute(0, 3, 1, 2).contiguous() if v_b
               else volume_to_internal(volume[0]).contiguous())
        tf_i = (tf.permute(0, 2, 1).contiguous() if t_b
                else tf_to_internal(tf).contiguous())
        lf = look_from if l_b else look_from.expand(bs, 3)
        return True, bs, vol, tf_i, lf

    def forward(self, volume, tf, look_from, u: Optional[torch.Tensor] = None,
                sampling_rate: Optional[float] = None) -> torch.Tensor:
        """Differentiable-path render; returns ``([BS,] 4, H, W)``,
        differentiable with respect to ``volume`` and ``tf``, and to
        ``look_from`` with ``camera_grads`` (a camera broadcast over a batch
        gets the sum of its views' gradients).  ``u``
        ((H, W), or (BS, H, W) for a batch) jitters ray starts with the
        given draw.  A batch of views of one volume and TF (each
        unbatched, a batch of one or batched with stride 0) is one
        :func:`~differender_tpu_torch.render.render_batch`: one K1 launch,
        and a K2 launch a view adding into one gradient; distinct volumes
        or TFs are rendered view by view."""
        return self.forward_with_aux(volume, tf, look_from, u,
                                     sampling_rate).image

    def forward_with_aux(self, volume, tf, look_from,
                         u: Optional[torch.Tensor] = None,
                         sampling_rate: Optional[float] = None
                         ) -> RenderOutput:
        with span("dr.raycaster"):
            volume, tf, look_from = (self._as_input(volume),
                                     self._as_input(tf),
                                     self._as_input(look_from))
            if not self.camera_grads:
                look_from = look_from.detach()
            sr = (self.sampling_rate if sampling_rate is None
                  else sampling_rate)
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
            self._last_u = u        # the draw of this call (None: no jitter)
            if not batched:
                out = render(vol, tf_i, lf, self.config, sr, u=u)
                return out._replace(image=out.image.permute(2, 0, 1))
            if vol.ndim == 3 and tf_i.ndim == 2 and lf.shape[0] == bs:
                out = render_batch(vol, tf_i, lf, self.config, sr, u=u)
                return out._replace(image=out.image.permute(0, 3, 1, 2))
            outs = [render(_row(vol, i, 3), _row(tf_i, i, 2), lf[i],
                           self.config, sr, u=None if u is None else u[i])
                    for i in range(bs)]
            images = torch.stack([o.image for o in outs])
            return RenderOutput(
                image=images.permute(0, 3, 1, 2),
                valid_steps=torch.stack([o.valid_steps for o in outs]),
                n_samples=torch.stack([o.n_samples for o in outs]))

    @torch.no_grad()
    def raycast_nondiff(self, volume, tf, look_from,
                        sampling_rate: Optional[float] = None
                        ) -> torch.Tensor:
        """Inference render; default sampling rate ``4 * sampling_rate``,
        no jitter.  Returns ``([BS,] 4, H, W)``.  A batch of views of one
        volume and TF (each unbatched, a batch of one or batched with
        stride 0) is one
        :func:`~differender_tpu_torch.render.render_nondiff_batch`: one
        occupancy grid and one K3 launch; distinct volumes or TFs are
        rendered view by view."""
        with span("dr.raycaster"):
            volume, tf, look_from = (self._as_input(volume),
                                     self._as_input(tf),
                                     self._as_input(look_from))
            sr = 4.0 * self.sampling_rate if sampling_rate is None \
                else sampling_rate
            batched, bs, vol, tf_i, lf = self._determine_batch(volume, tf,
                                                               look_from)
            if not batched:
                img = render_nondiff(vol, tf_i, lf, self.config, sr).image
                return img.permute(2, 0, 1)
            if vol.ndim == 3 and tf_i.ndim == 2 and lf.shape[0] == bs:
                img = render_nondiff_batch(vol, tf_i, lf, self.config,
                                           sr).image
                return img.permute(0, 3, 1, 2)
            imgs = [render_nondiff(_row(vol, i, 3), _row(tf_i, i, 2), lf[i],
                                   self.config, sr).image
                    for i in range(bs)]
            return torch.stack(imgs).permute(0, 3, 1, 2)

    def raycast_fast(self, volume, tf, look_from,
                     intermediate: Optional[int] = None,
                     planes_per_voxel: float = 2.0) -> torch.Tensor:
        """Shear-warp fast render
        (:func:`~differender_tpu_torch.fastpath.render_fast`: slab
        quadrature, not bit-exact with the exact renderer); returns
        ``([BS,] 4, H, W)``, differentiable in the volume and the TF."""
        with span("dr.raycaster"):
            volume, tf, look_from = (self._as_input(volume),
                                     self._as_input(tf),
                                     self._as_input(look_from))
            batched, bs, vol, tf_i, lf = self._determine_batch(volume, tf,
                                                               look_from)
            if not batched:
                return render_fast(vol, tf_i, lf, self.config, intermediate,
                                   planes_per_voxel).image.permute(2, 0, 1)
            imgs = [render_fast(_row(vol, i, 3), _row(tf_i, i, 2), lf[i],
                                self.config, intermediate,
                                planes_per_voxel).image
                    for i in range(bs)]
            return torch.stack(imgs).permute(0, 3, 1, 2)

    def extra_repr(self) -> str:
        return (f"Volume ({self.volume_shape}), Output Render "
                f"({self.output_shape}), TF ({self.tf_shape}), "
                f"Max Samples = {self.config.max_samples}")


__all__ = ["Raycaster", "volume_to_internal", "volume_from_internal",
           "tf_to_internal", "tf_from_internal"]
