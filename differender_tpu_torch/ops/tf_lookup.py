"""Transfer-function lookup with its gradient: kernels K0 ``tf_lookup_fwd``
and K0b ``tf_lookup_bwd`` (counterpart of
``differender_tpu/ops/tf_lookup.py``).

``tf_lookup`` is a ``torch.autograd.Function``.  On CUDA tensors its forward
launches K0 and its backward K0b, both in ``csrc/tf_lookup.cu``; on CPU
tensors they take the plain versions :func:`tf_lookup_reference` and
:func:`tf_lookup_bwd_reference`.  The gradient's ``mask`` says where
``d_intensity`` keeps the lerp's slope (``sampling.tf_lerp_bwd``): by default
(``"pallas"``) the Pallas kernel's rule (``_bwd_kernel``), where
``0 < i*(R-1) < R-1`` on the raw t, which keeps the slope at interior integer
t; with ``"dot"`` the JAX package's dot-form TF's (``_apply_tf_dot_bwd``),
only where ``frac > 0``, which the shear-warp path
(:mod:`~differender_tpu_torch.fastpath`) classifies with.  The march
kernels K1, K2 and K3 use the same lerp (``csrc/tf_lerp.cuh``) per sample;
K2 has the lerp's backward there too.

K0b sums ``d_tf`` without global atomics up to R = 14336: every block of a
grid sized to the card scatters its lookups' terms into a copy of ``d_tf``
in shared memory (up to R = 256 one column per lane of a warp beside the
TF, so the lanes of a warp never meet on an address; above that one copy
per block, the TF read through the cache), writes it as a partial to
scratch, and a second launch sums the partials in a fixed order.  Above
R = 14336 (more than the 227 KB a block may hold) every term is a global
atomic.  Bound: bytes, 24 B per lookup and 32R B; 0.060 ms at 2^23 lookups
on an H100 (3.35 TB/s).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..sampling import apply_tf, tf_lerp_bwd


def tf_lookup_reference(tf: torch.Tensor,
                        intensity: torch.Tensor) -> torch.Tensor:
    """Plain torch version: ``t = max(i*(R-1), 0)``,
    ``low = min(floor t, R-1)``, ``high = min(low+1, R-1)``; ``(..., 4)``."""
    return apply_tf(tf, intensity)


def tf_lookup_bwd_reference(tf: torch.Tensor, intensity: torch.Tensor,
                            g: torch.Tensor, mask: str = "pallas"):
    """Plain torch version of the backward: ``(d_tf (R, 4), d_intensity)``
    for the output cotangent ``g`` (..., 4), with ``d_intensity`` under
    ``mask`` (``"pallas"`` or ``"dot"``, as in ``sampling.tf_lerp_bwd``)."""
    return tf_lerp_bwd(tf, intensity, g, mask)


_MASKS = {"pallas": 0, "dot": 1}


def _check(tf, intensity):
    if tf.device != intensity.device:
        raise ValueError(f"tf on {tf.device}, intensity on {intensity.device}")
    if tf.dtype != torch.float32 or intensity.dtype != torch.float32:
        raise TypeError("tf_lookup takes float32 tf and intensity")
    if tf.ndim != 2 or tf.shape[1] != 4 or tf.shape[0] < 1:
        raise ValueError(f"tf must be (R, 4); got {tuple(tf.shape)}")
    tf = tf.detach().contiguous()
    if tf.data_ptr() % 16:
        tf = tf.clone()          # float4 loads need 16-byte alignment
    return tf, intensity.detach().contiguous().reshape(-1)


def tf_lookup_fwd(tf: torch.Tensor, intensity: torch.Tensor) -> torch.Tensor:
    """The forward: K0 on CUDA tensors (counted in
    ``tf_lookup_fwd.launches``), :func:`tf_lookup_reference` on CPU."""
    if _build.uses_plain(intensity):
        return tf_lookup_reference(tf, intensity)
    tf, flat = _check(tf, intensity)
    out = torch.empty(flat.shape + (4,), dtype=torch.float32,
                      device=flat.device)
    _build.check(_build.library().dr_tf_lookup_fwd(
        flat.data_ptr(), tf.data_ptr(), out.data_ptr(), flat.numel(),
        tf.shape[0], flat.device.index, _build.stream_of(flat)),
        "tf_lookup_fwd")
    tf_lookup_fwd.launches += 1
    return out.reshape(tuple(intensity.shape) + (4,))


tf_lookup_fwd.launches = 0


def tf_lookup_bwd(tf: torch.Tensor, intensity: torch.Tensor,
                  g: torch.Tensor, mask: str = "pallas"):
    """The backward: K0b on CUDA tensors (counted in
    ``tf_lookup_bwd.launches``, once per call of its two launches),
    :func:`tf_lookup_bwd_reference` on CPU; ``d_intensity`` under ``mask``
    (``"pallas"`` or ``"dot"``).
    Returns ``(d_tf (R, 4), d_intensity)``.  ``d_tf``'s sum across blocks
    runs in a fixed order, but each block sums its lookups with f32
    shared-memory atomics (global ones above R = 14336), so its last bits
    vary from run to run."""
    if mask not in _MASKS:
        raise ValueError(f"mask must be 'pallas' or 'dot'; got {mask!r}")
    if _build.uses_plain(intensity):
        return tf_lookup_bwd_reference(tf, intensity, g, mask)
    tf, flat = _check(tf, intensity)
    if g.device != flat.device or g.dtype != torch.float32:
        raise TypeError(f"g must be float32 on {flat.device}")
    if tuple(g.shape) != tuple(intensity.shape) + (4,):
        raise ValueError(f"g must have shape {tuple(intensity.shape) + (4,)};"
                         f" got {tuple(g.shape)}")
    g = g.detach().contiguous()
    if g.data_ptr() % 16:
        g = g.clone()            # float4 loads need 16-byte alignment
    n, R, dev = flat.numel(), tf.shape[0], flat.device
    lib = _build.library()
    blocks, partials = ctypes.c_int(0), ctypes.c_longlong(0)
    _build.check(lib.dr_tf_lookup_bwd_plan(n, R, dev.index,
                                           ctypes.byref(blocks),
                                           ctypes.byref(partials)),
                 "tf_lookup_bwd")
    d_int = torch.empty_like(flat)
    # The partials' sum writes every entry of d_tf; the global atomics
    # above R = 14336 (partials == 0) add into zeros.
    d_tf = (torch.empty_like(tf) if partials.value
            else torch.zeros_like(tf))
    scratch = torch.empty(partials.value, dtype=torch.float32, device=dev)
    _build.check(lib.dr_tf_lookup_bwd(
        flat.data_ptr(), tf.data_ptr(), g.data_ptr(), d_int.data_ptr(),
        d_tf.data_ptr(), scratch.data_ptr(), blocks.value, n, R,
        _MASKS[mask], dev.index, _build.stream_of(flat)), "tf_lookup_bwd")
    tf_lookup_bwd.launches += 1
    return d_tf, d_int.reshape(intensity.shape)


tf_lookup_bwd.launches = 0


class _TfLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tf, intensity, mask):
        ctx.save_for_backward(tf, intensity)
        ctx.mask = mask
        return tf_lookup_fwd(tf, intensity)

    @staticmethod
    def backward(ctx, g):
        tf, intensity = ctx.saved_tensors
        d_tf, d_int = tf_lookup_bwd(tf, intensity, g, ctx.mask)
        need_tf, need_int, _ = ctx.needs_input_grad
        return (d_tf if need_tf else None), (d_int if need_int else None), \
            None


def tf_lookup(tf: torch.Tensor, intensity: torch.Tensor,
              mask: str = "pallas") -> torch.Tensor:
    """RGBA lookup of ``intensity`` (any shape) in ``tf`` (R, 4) f32,
    differentiable in both.  K0 forward and K0b backward on CUDA tensors, on
    PyTorch's current stream; the plain versions on CPU tensors.  ``mask``
    is the backward's rule for ``d_intensity``: ``"pallas"`` (the Pallas
    kernel's) or ``"dot"`` (the dot-form TF's, ``frac > 0``)."""
    if mask not in _MASKS:
        raise ValueError(f"mask must be 'pallas' or 'dot'; got {mask!r}")
    return _TfLookup.apply(tf, intensity, mask)


__all__ = ["tf_lookup", "tf_lookup_fwd", "tf_lookup_bwd",
           "tf_lookup_reference", "tf_lookup_bwd_reference"]
