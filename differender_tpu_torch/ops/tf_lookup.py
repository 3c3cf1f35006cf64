"""Transfer-function lookup: kernel K0 ``tf_lookup_fwd`` (counterpart of
``differender_tpu/ops/tf_lookup.py``, forward only).

``tf_lookup`` launches the CUDA kernel in ``csrc/tf_lookup.cu`` on a CUDA
tensor and takes the plain version on a CPU tensor.  The march kernels K1
and K3 use the same lerp (``csrc/tf_lerp.cuh``) at every sample.
"""
from __future__ import annotations

import torch

from .. import _build
from ..sampling import apply_tf


def tf_lookup_reference(tf: torch.Tensor,
                        intensity: torch.Tensor) -> torch.Tensor:
    """Plain torch version: ``t = max(i*(R-1), 0)``,
    ``low = min(floor t, R-1)``, ``high = min(low+1, R-1)``; ``(..., 4)``."""
    return apply_tf(tf, intensity)


def tf_lookup(tf: torch.Tensor, intensity: torch.Tensor) -> torch.Tensor:
    """RGBA lookup of ``intensity`` (any shape) in ``tf`` (R, 4) f32.

    On CUDA tensors this launches K0 on PyTorch's current stream and counts
    the launch in ``tf_lookup.launches``; on CPU tensors it returns
    :func:`tf_lookup_reference`.
    """
    if _build.uses_plain(intensity):
        return tf_lookup_reference(tf, intensity)
    if tf.device != intensity.device:
        raise ValueError(f"tf on {tf.device}, intensity on {intensity.device}")
    if tf.dtype != torch.float32 or intensity.dtype != torch.float32:
        raise TypeError("tf_lookup takes float32 tf and intensity")
    if tf.ndim != 2 or tf.shape[1] != 4 or tf.shape[0] < 1:
        raise ValueError(f"tf must be (R, 4); got {tuple(tf.shape)}")
    tf = tf.contiguous()
    if tf.data_ptr() % 16:
        tf = tf.clone()          # float4 loads need 16-byte alignment
    flat = intensity.contiguous().reshape(-1)
    out = torch.empty(flat.shape + (4,), dtype=torch.float32,
                      device=flat.device)
    _build.check(_build.library().dr_tf_lookup_fwd(
        flat.data_ptr(), tf.data_ptr(), out.data_ptr(), flat.numel(),
        tf.shape[0], flat.device.index, _build.stream_of(flat)),
        "tf_lookup_fwd")
    tf_lookup.launches += 1
    return out.reshape(tuple(intensity.shape) + (4,))


tf_lookup.launches = 0
