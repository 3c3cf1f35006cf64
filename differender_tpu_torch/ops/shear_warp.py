"""The shear-warp slab march: kernels K8 ``shear_warp_fwd`` and K9
``shear_warp_bwd`` in ``csrc/shear_warp.cu`` (counterpart of the slab scan
in ``differender_tpu/fastpath.py::_core``).

The march takes the volume's voxel layers ``(Z, X, Y, 4)`` along the
principal axis (intensity and gradient, channels last) and the TF, with the
geometry of :class:`SlabGeometry`, and returns the intermediate image
``(rows, O, 4)``: per pixel, front to back over the planes, the plane's
z-lerp of its two layers, the separable 2-tap resample, the TF lookup, the
headlight shading with the per-pixel opacity correction, the footprint
coverage and the composite under the early-ray-termination gate.
:func:`shear_warp_march` is differentiable in the layers and the TF (the
geometry is the camera's, held fixed).  On CUDA tensors its forward is one
K8 launch and its backward one K9 launch, which recomputes the march, keeps
no tape and returns the layers' gradient directly; both march only the
planes where each pixel's ray crosses the volume's footprint
(:func:`footprint`).  On CPU tensors it is :func:`shear_warp_march_plain`,
the same arithmetic as chunks of torch operations over every plane, under
autograd.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import _build
from ..sampling import apply_tf_dot
from ..shading import unit_normal
from .tf_lookup import tf_lookup


class SlabGeometry(NamedTuple):
    """The march's geometry in the slab frame (the camera on the negative
    side of the last axis), none of it differentiated.  Plane ``s`` is the
    lerp ``layers[zlo[s]] * (1 - fz[s]) + layers[zhi[s]] * fz[s]``."""
    ga: torch.Tensor        # (rows,) the intermediate grid's x of each row
    gb: torch.Tensor        # (O,) its y of each column
    zws: torch.Tensor       # (S,) each plane's z
    zlo: torch.Tensor       # (S,) int32: each plane's lower voxel layer
    zhi: torch.Tensor       # (S,) int32: its upper layer, min(zlo + 1, Z - 1)
    fz: torch.Tensor        # (S,) the upper layer's lerp weight
    exponent: torch.Tensor  # (rows, O) the opacity correction's exponent
    lf: torch.Tensor        # (3,) the camera
    light: torch.Tensor     # (3,) the headlight
    xsc: float              # f32(0.5 (X - 1)): x voxel coordinate per unit
    ysc: float              # f32(0.5 (Y - 1))
    thr: float              # f32(1 - ert_threshold): the gate T > thr
    ambient: float
    diffuse: float
    specular: float
    shininess: float


def _sources(geom: SlabGeometry, zw: torch.Tensor):
    """The planes ``zw`` ``(B,)``: their scale about the camera ``sz`` and
    the voxel coordinates of each row's and each column's crossing,
    ``(B, rows)`` and ``(B, O)``, each operation rounded once as the
    kernels round it."""
    lx, ly, lz = geom.lf.unbind(0)
    sz = (zw - lz) / (0.0 - lz)
    src_x = (lx + sz[:, None] * (geom.ga[None] - lx) + 1.0) * geom.xsc
    src_y = (ly + sz[:, None] * (geom.gb[None] - ly) + 1.0) * geom.ysc
    return sz, src_x, src_y


def _inside(src: torch.Tensor, size: int) -> torch.Tensor:
    return (src >= 0.0) & (src <= size - 1.0)


def footprint(geom: SlabGeometry, X: int, Y: int):
    """Where the samples have coverage: ``(x_in (S, rows), y_in (S, O))``,
    bool, each row's and each column's crossing of each plane inside ``[0,
    X - 1]`` and ``[0, Y - 1]`` (the weights of :func:`_lerp_taps` not 0).
    Pixel ``(r, o)`` has a non-zero coverage on plane ``s`` exactly where
    ``x_in[s, r] & y_in[s, o]``; every other sample is an exact no-op.
    Each column of ``x_in`` and ``y_in`` is one run of planes, which the
    kernels find by binary search."""
    _, src_x, src_y = _sources(geom, geom.zws)
    return _inside(src_x, X), _inside(src_y, Y)


def _lerp_taps(src: torch.Tensor, size: int):
    """The two taps of a 1-D linear resample at positions ``src`` (voxel
    coordinates) along an axis of ``size`` voxels: indices ``lo``,
    ``hi = min(lo + 1, size - 1)`` and weights ``1 - frac``, ``frac``, both
    weights 0 where ``src`` lies outside ``[0, size - 1]`` (the rows of the
    JAX package's ``_interp_matrix``)."""
    lo_f = torch.floor(src)
    frac = src - lo_f
    inside = _inside(src, size)
    lo = torch.clamp(lo_f, 0.0, size - 1.0).to(torch.int64)
    hi = torch.clamp(lo + 1, max=size - 1)
    zero = src.new_zeros(())
    return lo, hi, torch.where(inside, 1.0 - frac, zero), \
        torch.where(inside, frac, zero)


def _resample(slab: torch.Tensor, taps_x, taps_y) -> torch.Tensor:
    """``(B, C, X, Y)`` slabs at the ``(B, R)`` x taps and the ``(B, O)`` y
    taps: ``(B, C, R, O)``, along x first and then along y."""
    B, C, X, Y = slab.shape
    lo, hi, w_lo, w_hi = taps_x
    R = lo.shape[1]
    ix = (B, C, R, Y)
    tmp = (torch.gather(slab, 2, lo[:, None, :, None].expand(ix))
           * w_lo[:, None, :, None]
           + torch.gather(slab, 2, hi[:, None, :, None].expand(ix))
           * w_hi[:, None, :, None])
    lo, hi, w_lo, w_hi = taps_y
    iy = (B, C, R, lo.shape[1])
    return (torch.gather(tmp, 3, lo[:, None, None, :].expand(iy))
            * w_lo[:, None, None, :]
            + torch.gather(tmp, 3, hi[:, None, None, :].expand(iy))
            * w_hi[:, None, None, :])


class _Pow(torch.autograd.Function):
    """``x ** e`` for a constant exponent ``e``, with the VJP
    ``g * (e * x ** (e - 1))`` (0 where ``e == 0``) taken as 0 wherever
    ``g == 0``, so that an infinite slope meets a zero cotangent as 0."""

    @staticmethod
    def forward(ctx, x, e):
        ctx.save_for_backward(x, e)
        return torch.pow(x, e)

    @staticmethod
    def backward(ctx, g):
        x, e = ctx.saved_tensors
        jac = torch.where(e == 0.0, torch.zeros_like(e),
                          e * torch.pow(x, e - 1.0))
        return torch.where(g == 0.0, torch.zeros_like(g), g * jac), None


def _shade(rgba, g, px, py, pz, lf, light, exponent, shininess, coverage,
           geom: SlabGeometry):
    """Headlight shading and opacity correction of classified slab samples
    ``rgba`` (..., 4) with gradients ``g`` (3, ...) at positions
    ``(px, py, pz)``; returns the premultiplied colour and the alpha.
    ``shininess`` is ``geom.shininess`` as a 0-d tensor on the device."""
    lx, ly, lz = lf
    zero = px.new_zeros(())
    gx, gy, gz = g
    g2 = gx * gx + gy * gy + gz * gz
    nx, ny, nz = unit_normal(torch.stack([gx, gy, gz], -1)).unbind(-1)
    lxr, lyr, lzr = px - light[0], py - light[1], pz - light[2]
    lm = torch.rsqrt(torch.clamp(lxr * lxr + lyr * lyr + lzr * lzr,
                                 min=1e-30))
    lxr, lyr, lzr = lxr * lm, lyr * lm, lzr * lm
    ndl = torch.maximum(nx * lxr + ny * lyr + nz * lzr, zero)
    has_n = g2 > 0
    diffuse = geom.diffuse * torch.where(has_n, ndl, zero)
    dot2 = nx * lxr + ny * lyr + nz * lzr
    rx = lxr - 2 * dot2 * nx
    ry = lyr - 2 * dot2 * ny
    rz = lzr - 2 * dot2 * nz
    vx, vy, vz = px - lx, py - ly, pz - lz
    vim = torch.rsqrt(torch.clamp(vx * vx + vy * vy + vz * vz, min=1e-30))
    vdx, vdy, vdz = vx * vim, vy * vim, vz * vim
    rdv = torch.maximum(-(rx * vdx + ry * vdy + rz * vdz), zero)
    specular = geom.specular * torch.where(
        has_n, _Pow.apply(rdv, shininess), zero)
    lightf = torch.minimum(diffuse + specular + geom.ambient,
                           px.new_ones(()))
    alpha = (1.0 - _Pow.apply(torch.maximum(1.0 - rgba[..., 3], zero),
                              exponent)) * coverage
    rgb = lightf[..., None] * rgba[..., :3] * alpha[..., None]
    return rgb, alpha


def shear_warp_march_plain(layers: torch.Tensor, tf: torch.Tensor,
                           geom: SlabGeometry, classify=apply_tf_dot,
                           slab_batch: int = 32) -> torch.Tensor:
    """Plain torch version of K8 (and, under autograd, of K9): the
    intermediate image ``(rows, O, 4)`` of the voxel layers ``layers``
    ``(Z, X, Y, 4)``, classified by ``classify(tf, intensity)``.

    The planes go ``slab_batch`` at a time ("chunks"): per chunk the
    z-lerp of each plane from its two layers, the resample, classify and
    shading are batched torch operations and the composite a loop over the
    chunk's planes; it marches every plane, in the footprint or not.  The
    march stops at the first chunk where no pixel passes the gate (a host
    sync on the card).  Under autograd each chunk runs inside
    ``torch.utils.checkpoint``, z-lerp included, so the backward holds one
    chunk's tensors at a time.  The image does not depend on
    ``slab_batch``."""
    _, X, Y, _ = layers.shape
    S = geom.zws.numel()
    dev = layers.device
    lx, ly, lz = geom.lf.unbind(0)
    ga, gb, exponent = geom.ga, geom.gb, geom.exponent
    rows, O = ga.shape[0], gb.shape[0]
    B = max(1, int(slab_batch))
    n_chunks = -(-S // B)
    pad = n_chunks * B - S

    def chunks(t, fill):
        return torch.cat([t, t.new_full((pad,), fill)]).reshape(n_chunks, B)

    # The padding planes take layer 0 and a coverage of 0: no-ops.
    zws_c, zlo_c, zhi_c, fz_c = (chunks(geom.zws, 1.0), chunks(geom.zlo, 0),
                                 chunks(geom.zhi, 0), chunks(geom.fz, 0.0))
    valid_c = chunks(geom.zws.new_ones(S), 0.0)
    # Made once: a host-to-device copy waits for the stream.
    shininess = torch.tensor(float(geom.shininess), device=dev)
    thr = geom.thr

    def chunk(acc, T, layers, zlo, zhi, fz, zw, vmask):
        fz4 = fz[:, None, None, None]
        slab = (torch.index_select(layers, 0, zlo) * (1.0 - fz4)
                + torch.index_select(layers, 0, zhi) * fz4)    # (B, X, Y, 4)
        sz, src_x, src_y = _sources(geom, zw)
        taps_x = _lerp_taps(src_x, X)
        taps_y = _lerp_taps(src_y, Y)
        res = _resample(slab.permute(0, 3, 1, 2), taps_x, taps_y)
        # In-footprint coverage: each axis's two weights sum to 1 inside
        # [0, size - 1] and to 0 outside, and the resample is separable.
        coverage = ((taps_x[2] + taps_x[3])[:, :, None]
                    * (taps_y[2] + taps_y[3])[:, None, :]) \
            * vmask[:, None, None]
        rgba = classify(tf, res[:, 0])                          # (B, R, O, 4)
        px = lx + sz[:, None, None] * (ga[None, :, None] - lx)
        py = ly + sz[:, None, None] * (gb[None, None, :] - ly)
        shape = coverage.shape
        rgb, alpha = _shade(
            rgba, res[:, 1:4].unbind(1), px.expand(shape), py.expand(shape),
            zw[:, None, None].expand(shape), (lx, ly, lz), geom.light,
            exponent, shininess, coverage, geom)
        for m in range(zw.shape[0]):
            active = T > thr
            acc = acc + torch.where(active, T, T.new_zeros(()))[..., None] \
                * rgb[m]
            T = torch.where(active, T * (1.0 - alpha[m]), T)
        return acc, T

    grad = torch.is_grad_enabled() and (layers.requires_grad
                                        or tf.requires_grad)
    acc = torch.zeros((rows, O, 3), dtype=torch.float32, device=dev)
    T = torch.ones((rows, O), dtype=torch.float32, device=dev)
    for c in range(n_chunks):
        if c and not bool((T > thr).any()):
            break
        args = (acc, T, layers, zlo_c[c], zhi_c[c], fz_c[c], zws_c[c],
                valid_c[c])
        if grad:
            acc, T = checkpoint(chunk, *args, use_reentrant=False)
        else:
            acc, T = chunk(*args)
    return torch.cat([acc, (1.0 - T)[..., None]], -1)


def shear_warp_bwd_plain(layers: torch.Tensor, tf: torch.Tensor,
                         geom: SlabGeometry, grad: torch.Tensor,
                         classify=apply_tf_dot):
    """Plain torch version of K9: ``(d_layers, d_tf)``, autograd of
    :func:`shear_warp_march_plain` for the image cotangent ``grad``."""
    with torch.enable_grad():
        lay = layers.detach().requires_grad_(True)
        t = tf.detach().requires_grad_(True)
        inter = shear_warp_march_plain(lay, t, geom, classify)
        return torch.autograd.grad(inter, (lay, t), grad, allow_unused=True)


def _classify_dot(tf, intensity):
    """The CPU march's classify: :func:`~differender_tpu_torch.ops.
    tf_lookup.tf_lookup` with ``mask="dot"`` (its plain versions there)."""
    return tf_lookup(tf, intensity, mask="dot")


class _ShearWarpArgs(ctypes.Structure):
    """Mirror of ``struct ShearWarpArgs`` in ``csrc/shear_warp.cu``."""
    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "layers", "tf", "ga", "gb", "zws", "zlo", "zhi", "fz", "exponent",
        "lf", "light", "inter", "steps", "taken", "restarts", "grad",
        "d_layers", "d_tf")]
        + [(f, ctypes.c_int) for f in ("S", "X", "Y", "rows", "O", "R")]
        + [(f, ctypes.c_float) for f in (
            "xsc", "ysc", "thr", "ambient", "diffuse", "specular",
            "shininess")])


def _on(name, t, dev, shape, dtype=torch.float32, aligned=False):
    if t.device != dev or t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype} on {dev}; got {t.dtype} on "
                        f"{t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}; got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned (float4 loads)")
    return t.detach()


def _args(layers, tf, geom: SlabGeometry) -> _ShearWarpArgs:
    """The kernels' argument struct, after the wrapper's checks."""
    dev = layers.device
    if layers.ndim != 4 or layers.shape[3] != 4 or layers.shape[0] < 1:
        raise ValueError(f"layers must be (Z, X, Y, 4); got "
                         f"{tuple(layers.shape)}")
    if tf.ndim != 2 or tf.shape[1] != 4 or tf.shape[0] < 1:
        raise ValueError(f"tf must be (R, 4); got {tuple(tf.shape)}")
    _, X, Y, _ = layers.shape
    S = geom.zws.numel()
    rows, O = geom.ga.numel(), geom.gb.numel()
    if S < 1:
        raise ValueError("the march needs at least one plane")
    a = _ShearWarpArgs()
    i32 = torch.int32
    for name, t, shape, dtype, aligned in (
            ("layers", layers, layers.shape, torch.float32, True),
            ("tf", tf, tf.shape, torch.float32, True),
            ("ga", geom.ga, (rows,), torch.float32, False),
            ("gb", geom.gb, (O,), torch.float32, False),
            ("zws", geom.zws, (S,), torch.float32, False),
            ("zlo", geom.zlo, (S,), i32, False),
            ("zhi", geom.zhi, (S,), i32, False),
            ("fz", geom.fz, (S,), torch.float32, False),
            ("exponent", geom.exponent, (rows, O), torch.float32, False),
            ("lf", geom.lf, (3,), torch.float32, False),
            ("light", geom.light, (3,), torch.float32, False)):
        setattr(a, name, _on(name, t, dev, shape, dtype, aligned).data_ptr())
    a.S, a.X, a.Y, a.rows, a.O, a.R = S, X, Y, rows, O, tf.shape[0]
    for f in ("xsc", "ysc", "thr", "ambient", "diffuse", "specular",
              "shininess"):
        setattr(a, f, float(getattr(geom, f)))
    return a


def shear_warp_fwd(layers: torch.Tensor, tf: torch.Tensor,
                   geom: SlabGeometry) -> torch.Tensor:
    """The forward: K8 on CUDA tensors (counted in
    ``shear_warp_fwd.launches``), :func:`shear_warp_march_plain` with
    :func:`_classify_dot` on CPU tensors.  Returns the intermediate image
    ``(rows, O, 4)``."""
    if _build.uses_plain(layers):
        with torch.no_grad():
            return shear_warp_march_plain(layers, tf, geom, _classify_dot)
    a = _args(layers, tf, geom)
    inter = torch.empty((a.rows, a.O, 4), dtype=torch.float32,
                        device=layers.device)
    a.inter = inter.data_ptr()
    _build.check(_build.library().dr_shear_warp_fwd(
        ctypes.byref(a), layers.device.index, _build.stream_of(layers)),
        "shear_warp_fwd")
    shear_warp_fwd.launches += 1
    return inter


shear_warp_fwd.launches = 0


def shear_warp_bwd(layers: torch.Tensor, tf: torch.Tensor,
                   geom: SlabGeometry, inter: torch.Tensor,
                   grad: torch.Tensor):
    """The backward for the cotangent ``grad`` of the intermediate image
    ``inter`` (K8's output on these inputs): K9 on CUDA tensors (counted in
    ``shear_warp_bwd.launches``), :func:`shear_warp_bwd_plain` with
    :func:`_classify_dot` on CPU tensors.  Returns ``(d_layers, d_tf)``.
    Both are summed with f32 atomics, so their last bits vary from run to
    run."""
    if _build.uses_plain(layers):
        return shear_warp_bwd_plain(layers, tf, geom, grad, _classify_dot)
    a = _args(layers, tf, geom)
    shape = (a.rows, a.O, 4)
    a.inter = _on("inter", inter, layers.device, shape,
                  aligned=True).data_ptr()
    a.grad = _on("grad", grad, layers.device, shape, aligned=True).data_ptr()
    d_layers = torch.zeros_like(layers)
    d_tf = torch.zeros_like(tf)
    a.d_layers, a.d_tf = d_layers.data_ptr(), d_tf.data_ptr()
    _build.check(_build.library().dr_shear_warp_bwd(
        ctypes.byref(a), layers.device.index, _build.stream_of(layers)),
        "shear_warp_bwd")
    shear_warp_bwd.launches += 1
    return d_layers, d_tf


shear_warp_bwd.launches = 0


class _ShearWarpMarch(torch.autograd.Function):
    """K8 forward, K9 backward; saves the layers, the TF and the image, and
    no per-sample tape."""

    @staticmethod
    def forward(ctx, layers, tf, geom):
        inter = shear_warp_fwd(layers, tf, geom)
        ctx.save_for_backward(layers, tf, inter)
        ctx.geom = geom
        return inter

    @staticmethod
    def backward(ctx, g):
        layers, tf, inter = ctx.saved_tensors
        d_layers, d_tf = shear_warp_bwd(layers, tf, ctx.geom, inter,
                                        g.contiguous())
        need_layers, need_tf, _ = ctx.needs_input_grad
        return (d_layers if need_layers else None), \
            (d_tf if need_tf else None), None


def shear_warp_march(layers: torch.Tensor, tf: torch.Tensor,
                     geom: SlabGeometry, slab_batch: int = 32
                     ) -> torch.Tensor:
    """The intermediate image ``(rows, O, 4)`` of the voxel layers
    ``layers`` ``(Z, X, Y, 4)`` f32 under ``tf`` ``(R, 4)``,
    differentiable in both.  On CUDA tensors one K8 launch forward and one
    K9 launch backward, on PyTorch's current stream, with no host sync and
    no slab stack; ``slab_batch`` is ignored there.  On CPU tensors
    :func:`shear_warp_march_plain`, classified by :func:`_classify_dot`, in
    chunks of ``slab_batch``."""
    if _build.uses_plain(layers):
        return shear_warp_march_plain(layers, tf, geom, _classify_dot,
                                      slab_batch)
    tf = tf.contiguous()
    if tf.data_ptr() % 16:
        tf = tf.clone()          # float4 loads need 16-byte alignment
    return _ShearWarpMarch.apply(layers.contiguous(), tf, geom)


__all__ = ["SlabGeometry", "shear_warp_march", "shear_warp_march_plain",
           "shear_warp_bwd_plain", "shear_warp_fwd", "shear_warp_bwd",
           "footprint"]
