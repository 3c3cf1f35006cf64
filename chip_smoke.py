#!/usr/bin/env python3
"""Drive the renderer's main path on one CUDA card and check every kernel.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine with
an NVIDIA H100 (sm_90a), the CUDA toolkit and PyTorch built for CUDA.

Phases (one JSON line each):
  1. device: card name and power limit, build time and the ``-Xptxas -v``
     report of each kernel (the kernels are built here from ``csrc/``);
     resources: the registers, spills and shared memory of K6 and K0b.
  2. tf_lookup_fwd (K0) through ``tf_lookup`` at 2^23 intensities, R = 128
     and 4096, against ``tf_lookup_reference``, timed beside ``grid_sample``.
  2b. tf_lookup_bwd (K0b) through ``tf_lookup`` and ``torch.autograd.grad``
     at the same sizes and at R = 16384 (above the shared-memory limit:
     global atomics), against ``tf_lookup_bwd_reference``, timed beside the
     gradient of ``grid_sample``.
  3. march_diff_fwd (K1) through ``Raycaster.forward`` at the bench workload
     (256^3 volume, tf1 at R = 128, 512^2 image, max_samples 512, sr 1,
     jittered), on a noise volume and on a CT phantom, against
     ``march_diff_plain``; K1's zero-opacity skips and the distinct voxels
     of its samples' stencils (``stencil_footprint``).
  3b. march_diff_bwd (K2) through ``Raycaster.forward`` and
     ``mean(img^2).backward()`` on both scenes: one K1 and one K2 launch
     per step, K2's per-ray counts equal to K1's, finite gradients; both
     gradients against autograd of ``march_diff_plain`` at 512^2 with ERT
     (summed over 16 tiles of 128^2 rays) and at a 128^2 image with ERT off
     and on, also at normal_delta 6e-3 (0.765 voxel), where most samples
     take the stencil's general branch (K1 there without ERT against the
     plain march); K2's atomics; ``grad_step_ms``.
  4. march_nondiff (K3) through ``Raycaster.raycast_nondiff`` (sr 4) on both
     scenes: one K6 and one K7 launch (the occupancy grid's build) and one
     K3 launch that jumps over empty space; K3 without the grid against
     ``march_nondiff_plain`` without it, K3 with the grid bitwise equal to
     K3 without it (image and composited counts on every ray), and against
     ``march_nondiff_plain`` with the grid; K3's per-ray counts (cell loads,
     extra-layer loads, grid reads), its cell loads equal to the plain
     march's count of centre-cell changes on every ray outside the ERT knife
     edge, with and without the grid; ``raycast_ms`` with the grid and
     without it (``occupancy_skip=False``), timed alternately.
  5. profile: device time by kernel and the busy share of the forward, the
     gradient step and the inference render on the noise scene, the last
     with the occupancy grid and without it (torch.profiler).
  5b. train: 5 steps of the volume-fitting loop of
     ``examples/optimize_volume.py`` at 256^3 and 512^2, 2 views.
  6. golden: the card's renders of the sphere fixtures of
     ``tests/golden_renders.npz``, and K2 on that sphere at sampling rate
     0.8 against the plain march and through ``value_and_grad_render``.
  7. bricks: brick_sums (K4) and brick_rows (K5), the three variants of the
     TPU DMA probe ``experiments/exp_pallas_dma.py`` at its sizes and seeds
     (256^3 volume, 32^3 bricks, 2048 origins aligned and unaligned, a
     4096-brick table), against their plain versions at ``rtol=1e-5``, and
     origins out of range giving NaN rows.
  8. occupancy: cell_minmax (K6), cell_distance (K7) and ``build_occupancy``
     at 256^3 on noise and ct_phantom, auto cell (2, max_dist 48) and cell 8
     (max_dist 12): K6 and K7 equal to their plain versions (K7 also at
     R = 4096), the card's grid equal to the whole build on CPU copies of
     the volume and the TF; K6's and K7's device time and launches per call
     (CUDA events around back-to-back calls of their C entries: a wrapper
     call's host work outlasts K7 on the device), K6
     beside its library form (two ``max_pool3d`` calls); K6 also on a
     250x256x243 volume at cells 2, 3, 8 and 48 (sides the cell does not
     divide; at 48 a tile's voxels are taken in bands) equal to its plain
     version and to the CPU build.
  9. viewer: the JAX package's inference example at full width (800^2,
     sampling rate 16, tf1, camera (0, 1, -2.3)) on its synthetic volume and
     ct_phantom at 256^3: K3 with the grid bitwise equal to K3 without it,
     and against the plain march with the grid on the same 800^2 rays
     (with K3's cell loads against its count); samples visited, K3's counts
     and ``raycast_ms`` with and without the grid.
  10. the ``kernels`` line, then the contract line as the last line.
Launch counts are reset just before each entry point is driven and read just
after; launches made to compare or time a kernel do not count.  Any failed
check raises, so the script exits non-zero and prints no result.  It also
exits non-zero where ``torch.cuda.is_available()`` is false.

Bounds use the H100 SXM's published peaks: 3.35 TB/s of HBM and 67 TFLOP/s
of f32 outside the tensor cores.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# f32 operations per unit of work that the function needs (transcendentals
# count as one).  A sample's 7 trilinear points share their voxel
# coordinates: each of the 6 gradient points differs from the centre on one
# axis only, so a sample computes 3 + 6 axes, not 21.  The weight of a corner
# is a pair product of two axes' weights times the third's; the centre makes
# the xy, yz and xz pair products once and every point reuses them.
AXIS_OPS = 7 + 1                   # clamp, scale, floor, frac; 1 - frac
PAIR_OPS = 4                       # one axis pair's 4 weight products
POINT_OPS = 8 + 15                 # 8 corner weights, weighted sum
CENTRE_OPS = 3 * AXIS_OPS + PAIR_OPS + POINT_OPS
GRADIENT_POINTS_OPS = 2 * PAIR_OPS + 6 * (AXIS_OPS + POINT_OPS)
POSITION_OPS = 8                   # t = t0 + s*dt, p = o + t*d
STENCIL_OPS = 6 + 3                # +-delta offsets, gradient differences
TF_LERP_OPS = 18
OPACITY_OPS = 4
SHADE_OPS = 59                     # normal, light dir, diffuse, reflect,
                                   # specular, light sum and clamp, rgb
COMPOSITE_OPS = 9                  # rgb += T*c, T *= 1-a, the ERT gate
DIFF_SAMPLE_OPS = (POSITION_OPS + CENTRE_OPS + GRADIENT_POINTS_OPS
                   + STENCIL_OPS + TF_LERP_OPS + OPACITY_OPS + SHADE_OPS
                   + COMPOSITE_OPS)
NONDIFF_VISIT_OPS = POSITION_OPS + CENTRE_OPS + TF_LERP_OPS + 2
NONDIFF_SHADE_OPS = (GRADIENT_POINTS_OPS + STENCIL_OPS + OPACITY_OPS
                     + SHADE_OPS - 1 + COMPOSITE_OPS - 1)
TF_LOOKUP_OPS = TF_LERP_OPS
# K3's occupancy lookup at a head sample: its position, the macrocell index
# on 3 axes (scale, offset, clamp, multiply, divide, truncate, clamp), the
# flat index, and the jump (d - 1, multiply, divide, cap, compare).
JUMP_OPS = POSITION_OPS + 3 * 8 + 4 + 6
# The backward of a TF lerp: t, max, floor, frac, the low/high clamps and
# 1 - frac (7); 8 weight products and 8 accumulations into d_tf; the slope
# (4 differences, 4 products, 3 sums), times R - 1, and the mask (3).
TF_LERP_BWD_OPS = 7 + 16 + 11 + 1 + 3
TF_LOOKUP_BWD_OPS = TF_LERP_BWD_OPS
# K2, per composited sample: the forward recompute (DIFF_SAMPLE_OPS), then
# the backward chain, each step once.  Composite: the colour cotangent T*g,
# g.c, the prefix, U - P, T_b/f and the product (13).  Shading: d of the TF
# colour and of light*alpha (14), of alpha through the opacity correction
# (8), of the light clamp (2), the specular power (3), r.v (3), the
# reflection (3), n.l (9), the normal (12) and the unit-normal VJP (17).
# The TF lerp backward (TF_LERP_BWD_OPS minus the 7 shared with the
# forward).  The scatter: 7 points x 8 corners, a product and an
# accumulation each, weights shared with the forward, and 3 negations.
COMPOSITE_BWD_OPS = 13
SHADE_BWD_OPS = 14 + 8 + 2 + 3 + 3 + 3 + 9 + 12 + 17
SCATTER_OPS = 7 * 8 * 2 + 3
BWD_SAMPLE_OPS = (DIFF_SAMPLE_OPS + COMPOSITE_BWD_OPS + SHADE_BWD_OPS
                  + TF_LERP_BWD_OPS - 7 + SCATTER_OPS)
# A composited sample whose volume cotangent is exactly 0 (K2 counts the
# others: on these scenes, samples whose two TF texels both have alpha 0,
# such as ct_phantom's empty space and tf1's transparent bands on noise; the
# opacity is 0 there and stays 0 as the intensity moves, so the shaded
# colour is 0 whatever the normal) needs no scatter: its value, TF colour,
# opacity and composite, the composite's backward, alpha's through the
# opacity correction (8) and the TF lerp's (d_tf).  Its d_tf also needs the
# light, so the gradient points and the shading (QUIET_LIGHT_OPS), wherever
# its TF colour and colour cotangent are not 0 (d_alpha = d_la * light +
# d_sh.a with d_la = T g.rgb . c.rgb; K2 counts those samples too).  The
# phase also prints the bound that charges no quiet sample the light.
QUIET_SAMPLE_OPS = (POSITION_OPS + CENTRE_OPS + TF_LERP_OPS + OPACITY_OPS
                    + COMPOSITE_OPS + COMPOSITE_BWD_OPS + 8
                    + TF_LERP_BWD_OPS - 7)
QUIET_LIGHT_OPS = GRADIENT_POINTS_OPS + STENCIL_OPS + SHADE_OPS
# A sample of opacity exactly 0 shades to 0 whatever the normal, so K1's
# forward needs of it only the position, the centre, the TF lerp, the
# opacity and the composite (K1 counts them).  The phase also prints the
# bound that charges every sample DIFF_SAMPLE_OPS.
ZERO_OPACITY_OPS = (POSITION_OPS + CENTRE_OPS + TF_LERP_OPS + OPACITY_OPS
                    + COMPOSITE_OPS)
# K2 against autograd of the plain march, per gradient tensor, times its
# max |g|.  Both run the same f32 arithmetic per sample (the kernels round
# the trilinear sum and the TF lerp as the plain march does); only the order
# of the atomic adds differs, which has stayed below 1e-5 * max |g|.
K2_GRAD_TOL = 1e-4

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE_MS_IS = ("CUDA events around 20 back-to-back calls of the C entry, "
                "median of 10")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond, msg) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def bound(nbytes: float, nops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; the port's "
              "kernels need a CUDA card", file=sys.stderr)
        return 1
    import numpy as np
    import torch.nn.functional as F

    import differender_tpu_torch as P
    from differender_tpu_torch import _build

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def sync():
        torch.cuda.synchronize(dev)

    def cuda_ms(fn, reps, warm=2, per_pair=1):
        """Device time of one call of ``fn`` by CUDA events, after ``warm``:
        the median over ``reps`` event pairs, each around ``per_pair`` calls
        and divided by them.  Many calls per pair keep the device queue ahead
        of the host, so a short kernel's time is not its enqueue time."""
        for _ in range(warm):
            fn()
        sync()
        pairs = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(per_pair):
                fn()
            b.record()
            pairs.append((a, b))
        sync()
        return statistics.median(a.elapsed_time(b) / per_pair
                                 for a, b in pairs)

    def host_ms(fn, reps, warm=1):
        """Median host time of ``fn`` ending in a synchronize."""
        for _ in range(warm):
            fn()
        sync()
        ts = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            sync()
            ts.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ts)

    def host_ms_ab(fa, fb, reps, warm=1):
        """Median host times of ``fa`` and ``fb``, each ending in a
        synchronize, called in turn so that the host's drifts hit both."""
        for _ in range(warm):
            fa()
            fb()
        sync()
        ts = ([], [])
        for _ in range(reps):
            for fn, out in zip((fa, fb), ts):
                t = time.perf_counter()
                fn()
                sync()
                out.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ts[0]), statistics.median(ts[1])

    def timed_once(fn):
        """``fn()`` and its device time by one pair of CUDA events."""
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        sync()
        return out, a.elapsed_time(b)

    def profile(fn, reps=3):
        """Device time by kernel over ``reps`` calls of ``fn``, per call,
        beside the wall time: where an entry point's time goes."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity
        fn()
        sync()
        with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for _ in range(reps):
                fn()
            sync()
            wall = (time.perf_counter() - t) * 1e3 / reps
        kern = sorted(((e.key, e.self_device_time_total / 1e3 / reps)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and e.self_device_time_total > 0),
                      key=lambda kv: -kv[1])
        dev_ms = sum(ms for _, ms in kern)
        launches = sum(e.count for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and e.self_device_time_total > 0) / reps
        return {"wall_ms": wall, "device_ms": dev_ms if kern else None,
                "busy_share": dev_ms / wall if kern else None,
                "host_gap_share": 1.0 - dev_ms / wall if kern else None,
                "n_kernels": len(kern), "launches": launches,
                "top": [[k[:60], ms] for k, ms in kern[:5]]}

    def launch_ms(call, reps=10, per_pair=20):
        """Device time of one call of a C entry (``call`` returns its
        ``cudaError_t``) by CUDA events around ``per_pair`` back-to-back
        calls: a ctypes call takes less host time than the kernels it
        launches, so the device queue stays ahead."""
        return cuda_ms(lambda: _build.check(call(), "launch_ms"), reps,
                       per_pair=per_pair)

    def device_kernels(fn, reps=5):
        """Per call of ``fn``, the launches and device time (ms) of each
        kernel, memset and copy it runs (torch.profiler), by name; tried
        three times while the profiler sees none, then {}."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity
        for _ in range(3):
            fn()
            sync()
            with torch.profiler.profile(activities=[
                    ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                sync()
            got = {e.key[:60]: {"launches": e.count / reps,
                                "ms": e.self_device_time_total / 1e3 / reps}
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA}
            if got:
                return got
        return {}

    def minmax_pools(vol, cell):
        """K6's function in library calls: the volume padded by
        replication to whole windows, then F.max_pool3d of it (the max) and
        of its negation (the min)."""
        shape = [-(-s // cell) for s in vol.shape]
        pad = []
        for size, n_cells in zip(reversed(vol.shape), reversed(shape)):
            pad += [1, n_cells * cell - size + 1]
        v = F.pad(vol[None, None], pad, mode="replicate")
        return (-F.max_pool3d(-v, cell + 2, cell)[0, 0],
                F.max_pool3d(v, cell + 2, cell)[0, 0])

    # -- 1. device and build -------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    info = _build.build()
    _build.library()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "build_s": info.seconds, "build_cached": info.cached,
          "library": os.path.relpath(info.path, ROOT),
          "ptxas": info.ptxas})

    def ptxas_of(src, names):
        """The ptxas report of each kernel of ``src`` whose mangled name
        holds one of ``names``."""
        out, cur = {}, None
        for ln in info.ptxas.get(src, []):
            if "Compiling entry function" in ln:
                cur = next((n for n in names if n in ln), None)
                key = ln.split("'")[1] if cur else None
            elif cur and ("Used" in ln or "spill" in ln):
                out.setdefault(key, []).append(ln)
        return out

    emit({"phase": "resources",
          "cell_minmax": ptxas_of("bricks.cu", ["cell_minmax_kernel"]),
          "tf_lookup_bwd": ptxas_of("tf_lookup.cu", ["tf_lookup_bwd_kernel",
                                                     "tf_grad_sum_kernel"]),
          "nvidia_smi": smi})

    kernels = {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    # The phases added with the backward draw from their own generator, so
    # the forward phases see the same data as before.
    gen_b = torch.Generator(device=dev)
    gen_b.manual_seed(1)
    gen_c = torch.Generator(device=dev)     # K2's 512^2 cotangents
    gen_c.manual_seed(2)

    # -- 2. K0 tf_lookup_fwd -------------------------------------------------
    n = 1 << 23
    inten = torch.rand(n, generator=gen, device=dev)
    inten[:5] = torch.tensor([-0.2, 0.0, 0.999999, 1.0, 1.3], device=dev)
    k0_launches, k0_err, k0 = 0, 0.0, None
    for R in (128, 4096):
        tf = torch.rand((R, 4), generator=gen, device=dev)
        P.reset_launch_counts()
        out = P.tf_lookup(tf, inten)
        sync()
        launches = P.launch_counts()["tf_lookup_fwd"]
        require(launches == 1, f"tf_lookup launched K0 {launches} times")
        require(out.shape == (n, 4) and bool(torch.isfinite(out).all()),
                "K0 output shape or finiteness")
        ref = P.tf_lookup_reference(tf, inten)
        err = float((out - ref).abs().max())
        require(err <= 1e-6, f"K0 max |diff| {err} > 1e-6 at R={R}")
        # K0 is shorter than the host's work per call: time it in runs of
        # 40 calls per event pair, and beside that by the profiler's device
        # time and by one call per event pair (which includes enqueue gaps).
        ms = cuda_ms(lambda: P.tf_lookup(tf, inten), 5, per_pair=40)
        profiler_ms = profile(lambda: P.tf_lookup(tf, inten), 40)["device_ms"]
        one_call_ms = cuda_ms(lambda: P.tf_lookup(tf, inten), 25)
        plain_ms = cuda_ms(lambda: P.tf_lookup_reference(tf, inten), 5,
                           per_pair=10)
        tex = tf.t().reshape(1, 4, 1, R).contiguous()
        grid = torch.stack([inten * 2.0 - 1.0, torch.zeros_like(inten)],
                           -1).reshape(1, 1, n, 2)

        def lib():
            return F.grid_sample(tex, grid, mode="bilinear",
                                 padding_mode="border", align_corners=True)

        lib_err = float((lib()[0, :, 0].t() - ref).abs().max())
        library_ms = cuda_ms(lib, 5, per_pair=40)
        b_ms, b_by = bound(n * 4 + R * 16 + n * 16, n * TF_LOOKUP_OPS)
        emit({"phase": "tf_lookup_fwd", "R": R, "n": n,
              "launches": launches, "max_abs_err": err, "ms": ms,
              "profiler_ms": profiler_ms, "one_call_event_ms": one_call_ms,
              "plain_ms": plain_ms, "library_ms": library_ms,
              "library_max_abs_diff": lib_err, "bound_ms": b_ms,
              "bound_by": b_by, "nvidia_smi": smi})
        k0_launches += launches
        k0_err = max(k0_err, err)
        if R == 128:
            k0 = dict(ms=ms, profiler_ms=profiler_ms, plain_ms=plain_ms,
                      library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)
    kernels["tf_lookup_fwd"] = dict(
        route="cuda", source="differender_tpu_torch/csrc/tf_lookup.cu",
        replaces="differender_tpu/ops/tf_lookup.py:66",
        launches=k0_launches, max_abs_err=k0_err, **k0)

    # -- 2b. K0b tf_lookup_bwd ------------------------------------------------
    cot = torch.rand((n, 4), generator=gen_b, device=dev) - 0.5
    k0b_launches, k0b_err, k0b_err_tf, k0b, k0b_ms = 0, 0.0, 0.0, None, {}
    # R = 16384 lies above K0b's shared-memory limit (14336): global atomics.
    for R in (128, 4096, 16384):
        tf = torch.rand((R, 4), generator=gen_b, device=dev)
        tf_leaf = tf.clone().requires_grad_()
        x_leaf = inten.clone().requires_grad_()
        P.reset_launch_counts()
        d_tf, d_x = torch.autograd.grad(P.tf_lookup(tf_leaf, x_leaf),
                                        (tf_leaf, x_leaf), cot)
        sync()
        launches = P.launch_counts()["tf_lookup_bwd"]
        require(launches == 1, f"tf_lookup's backward launched K0b "
                               f"{launches} times")
        require(bool(torch.isfinite(d_tf).all() & torch.isfinite(d_x).all()),
                "K0b gradients finite")
        ref_tf, ref_x = P.tf_lookup_bwd_reference(tf, inten, cot)
        err_x = float((d_x - ref_x).abs().max())
        scale = float(ref_tf.abs().max())
        err_tf = float((d_tf - ref_tf).abs().max())
        require(err_x <= 1e-5 and err_tf <= 1e-4 * scale,
                f"K0b at R={R}: d_intensity {err_x} > 1e-5 or d_tf {err_tf}"
                f" > 1e-4 * {scale}")
        ms = cuda_ms(lambda: P.tf_lookup_bwd(tf, inten, cot), 5, per_pair=40)
        profiler_ms = profile(lambda: P.tf_lookup_bwd(tf, inten, cot),
                              40)["device_ms"]
        plain_ms = cuda_ms(lambda: P.tf_lookup_bwd_reference(tf, inten, cot),
                           5, per_pair=10)
        tex = tf.t().reshape(1, 4, 1, R).contiguous().requires_grad_()
        grid = torch.stack([inten * 2.0 - 1.0, torch.zeros_like(inten)],
                           -1).reshape(1, 1, n, 2).requires_grad_()
        lib_cot = cot.t().reshape(1, 4, 1, n).contiguous()

        def lib():
            out = F.grid_sample(tex, grid, mode="bilinear",
                                padding_mode="border", align_corners=True)
            return torch.autograd.grad(out, (tex, grid), lib_cot)

        library_ms = cuda_ms(lib, 5, per_pair=10)
        b_ms, b_by = bound(n * 4 + n * 16 + R * 16 + n * 4 + R * 16,
                           n * TF_LOOKUP_BWD_OPS)
        emit({"phase": "tf_lookup_bwd", "R": R, "n": n,
              "launches": launches, "max_abs_err_d_intensity": err_x,
              "max_abs_err_d_tf": err_tf, "max_abs_d_tf": scale, "ms": ms,
              "profiler_ms": profiler_ms, "plain_ms": plain_ms,
              "library_ms": library_ms,
              "library": "autograd.grad of F.grid_sample w.r.t. texture "
                         "and grid, forward included",
              "bound_ms": b_ms, "bound_by": b_by, "nvidia_smi": smi})
        k0b_launches += launches
        k0b_err = max(k0b_err, err_x)
        k0b_err_tf = max(k0b_err_tf, err_tf / scale)
        k0b_ms[f"R{R}"] = {"ms": ms, "profiler_ms": profiler_ms,
                           "library_ms": library_ms, "bound_ms": b_ms}
        if R == 128:
            k0b = dict(ms=ms, profiler_ms=profiler_ms, plain_ms=plain_ms,
                       library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)
        del tf_leaf, x_leaf, d_tf, d_x, ref_tf, ref_x, tex, grid, lib_cot
    kernels["tf_lookup_bwd"] = dict(
        route="cuda", source="differender_tpu_torch/csrc/tf_lookup.cu",
        replaces="differender_tpu/ops/tf_lookup.py:72",
        launches=k0b_launches, max_abs_err=k0b_err,
        max_rel_err_d_tf=k0b_err_tf, by_R=k0b_ms, **k0b)
    del cot, inten

    # -- 3./4. K1 and K3 through the Raycaster ---------------------------------
    res, img, R = 256, 512, 128
    rc = P.Raycaster((res, res, res), (img, img), R, sampling_rate=1.0,
                     jitter=True, max_samples=512, seed=0)
    rc_off = P.Raycaster((res, res, res), (img, img), R, sampling_rate=1.0,
                         jitter=True, max_samples=512, seed=0,
                         occupancy_skip=False)
    cfg = rc.config
    tf_user = P.get_tf_torch_layout("tf1", R, device=dev)
    tf_i = P.tf_to_internal(tf_user).contiguous()
    lf = torch.tensor([1.2, 0.8, 2.0], device=dev)
    scenes = {"noise": lambda: P.noise_volume(res, seed=0),
              "ct_phantom": lambda: P.ct_phantom(res)}
    for name, src, replaces in (
            ("march_diff_fwd", "march.cu", "differender_tpu/render.py:395"),
            ("march_diff_bwd", "march_bwd.cu",
             "differender_tpu/render.py:395"),
            ("march_nondiff", "march.cu", "differender_tpu/render.py:642")):
        kernels[name] = dict(
            route="cuda", source=f"differender_tpu_torch/csrc/{src}",
            replaces=replaces, launches=0, max_abs_err=0.0, library_ms=None)
    kernels["march_diff_bwd"]["replaces_note"] = (
        "the XLA VJP of march_diff (march_vjp='ad'): no Pallas kernel")
    for name, src, replaces in (
            ("brick_sums", "bricks.cu", "experiments/exp_pallas_dma.py:41"),
            ("brick_rows", "bricks.cu", "experiments/exp_pallas_dma.py:72"),
            ("cell_minmax", "bricks.cu", "differender_tpu/occupancy.py:88"),
            ("cell_distance", "distance.cu",
             "differender_tpu/occupancy.py:144")):
        kernels[name] = dict(
            route="cuda", source=f"differender_tpu_torch/csrc/{src}",
            replaces=replaces, launches=0, max_abs_err=0.0)
    kernels["cell_minmax"]["replaces_note"] = (
        "the reduce_window pair of _cell_minmax: XLA, no Pallas kernel")
    kernels["cell_distance"]["replaces_note"] = (
        "the dilation rounds of build_occupancy: XLA, no Pallas kernel")

    def record(name, scene, launches, max_err, k_ms, p_ms, b_ms, b_by):
        k = kernels[name]
        k["launches"] += launches
        k["max_abs_err"] = max(k["max_abs_err"], max_err)
        if scene == "noise":    # the bench scene is the one reported
            k.update(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)

    vol_bytes = res ** 3 * 4
    ray_bytes = img * img * (5 * 4 + 4)

    def image_check(name, got, want):
        err = (got - want).abs()
        frac_over = float((err > 2e-4).float().mean())
        max_err = float(err.max())
        require(frac_over <= 1e-3 and max_err <= 0.08,
                f"{name}: {frac_over:.5f} of pixels over 2e-4, max {max_err}")
        return max_err, frac_over, int((err > 2e-4).sum())

    def count_check(name, got, want):
        """Every ray's sample count within 1 of the plain version's."""
        diff = int((got - want).abs().max())
        require(diff <= 1, f"{name}: a ray differs by {diff} samples")
        return diff

    def cell_load_check(name, counts, plain_loads, vis, want_vis):
        """K3's cell loads on every ray against the plain march's count of
        changes of the centre cell, but on the rays whose visited counts
        differ (the ERT knife edge, at most 0.1% of them).  Returns the
        number of such rays."""
        same = vis == want_vis
        n_knife = int((~same).sum())
        require(n_knife <= 1e-3 * same.numel(),
                f"{name}: {n_knife} rays with other visited counts")
        bad = int(((counts[..., 0] != plain_loads) & same).sum())
        require(bad == 0, f"{name}: {bad} rays' cell loads differ from the "
                          f"plain march's count")
        return n_knife

    def k3_counts(counts, visited, composited, n_knife):
        """K3's per-ray counts, summed: cell loads, the voxels composited
        samples loaded beyond their cell, grid reads.  n_knife: the rays
        left out of cell_load_check, or None where it was not run."""
        loads, extra, reads = (int(counts[..., i].sum()) for i in range(3))
        return {"cell_loads": loads,
                "cell_loads_per_visited": loads / max(visited, 1),
                "extra_loads": extra,
                "extra_loads_per_composited": extra / max(composited, 1),
                "grid_reads": reads,
                "grid_reads_per_visited": reads / max(visited, 1),
                "cell_loads_equal_plain": n_knife is not None,
                "rays_other_visited_count": n_knife}

    def grid_jumps(grid):
        """Whether any cell lies at distance 2 or more: else K3 looks up
        nothing (it reads the field's largest value on the device)."""
        return int(grid.dist.max()) >= 2

    def grid_read_bytes(grid):
        """The distance field, if K3 reads it."""
        return grid.dist.numel() * 4 if grid_jumps(grid) else 0

    def lookups(grid, visited, composited):
        """K3's grid lookups: one before each sample that follows one that
        did not composite (within one per ray: the first sample has one, a
        ray's last has none after it); none without a jump in the grid."""
        return visited - composited if grid_jumps(grid) else 0

    def count_build(counts, what):
        """One K6 and one K7 launch per grid build."""
        require(counts["cell_minmax"] == 1 and counts["cell_distance"] == 1,
                f"{what} launched K6 {counts['cell_minmax']}x and K7 "
                f"{counts['cell_distance']}x")
        for name in ("cell_minmax", "cell_distance"):
            kernels[name]["launches"] += counts[name]

    def k2_grad_errs(got_pair, want_pair, label):
        """max |K2 - plain| / max |plain| of d_volume and d_tf, each held
        to K2_GRAD_TOL."""
        errs = []
        for got, want, what in zip(got_pair, want_pair,
                                   ("d_volume", "d_tf")):
            e = float((got - want).abs().max())
            m = float(want.abs().max())
            require(bool(torch.isfinite(got).all()) and m > 0
                    and e <= K2_GRAD_TOL * m,
                    f"K2 {what} on {label}: max |diff| {e} > "
                    f"{K2_GRAD_TOL} * {m}")
            errs.append(e / m)
        return errs

    def knife_mask(steps_k, steps_p, label):
        """Rays that K1 and the plain march end at the same sample.  A ray
        on the ERT knife edge gets no cotangent in either backward."""
        agree = steps_k == steps_p
        n_knife = int((~agree).sum())
        require(n_knife <= 0.001 * agree.numel(),
                f"{n_knife} knife-edge rays on {label}")
        return agree, n_knife

    def k2_vs_plain(vol_i, tf_c, rays_s, cfg_s, g_s, ert, label, sr=1.0):
        """K2 against autograd of the plain march for the cotangent g_s."""
        label = f"{label} ({cfg_s.image_shape}, ert={ert})"
        img_s, steps_s = P.march_diff_fwd(vol_i, tf_c, rays_s, cfg_s, sr,
                                          ert=ert)
        with torch.no_grad():
            _, steps_p = P.march_diff_plain(vol_i, tf_c, rays_s, cfg_s, sr,
                                            ert=ert)
        agree, n_knife = knife_mask(steps_s, steps_p, label)
        g_m = g_s * agree[..., None]
        got = P.march_diff_bwd(vol_i, tf_c, rays_s, cfg_s, sr, img_s, g_m,
                               ert=ert)[:2]
        want = P.march_diff_bwd_plain(vol_i, tf_c, rays_s, cfg_s, sr, g_m,
                                      ert=ert)[:2]
        return k2_grad_errs(got, want, label), n_knife, img_s, g_m

    def plain_bwd_tiled(vol_i, tf_c, rays_f, cfg_f, g_f, tile):
        """Autograd of the plain march (sampling rate 1) for the cotangent
        g_f, summed over tile x tile blocks of the same rays: rays are
        independent and the gradient is linear in the cotangent, so the
        blocks add up to the whole image's gradient in a fraction of its
        autograd memory."""
        H, W = cfg_f.image_shape
        d_v, d_t = torch.zeros_like(vol_i), torch.zeros_like(tf_c)
        for r in range(0, H, tile):
            for c in range(0, W, tile):
                blk = (slice(r, r + tile), slice(c, c + tile))
                rays_b = rays_f._replace(
                    dirs=rays_f.dirs[blk], entry=rays_f.entry[blk],
                    exit=rays_f.exit[blk], n_samples=rays_f.n_samples[blk])
                cfg_b = cfg_f.replace(image_shape=tuple(
                    rays_b.n_samples.shape))
                dv_b, dt_b, _ = P.march_diff_bwd_plain(
                    vol_i, tf_c, rays_b, cfg_b, 1.0, g_f[blk])
                d_v += dv_b
                d_t += dt_b
        return d_v, d_t

    def stencil_voxels(rays_f, steps_f, cfg_f, stride=2, chunk=4096):
        """Distinct voxels of the 7-point stencil per sample
        (``stencil_footprint``) over K1's samples on every stride-th ray in
        each image direction: their mean, the largest and the samples
        counted."""
        prm = P.march_params(rays_f)
        sel = (slice(None, None, stride), slice(None, None, stride))
        dirs = rays_f.dirs[sel].reshape(-1, 3)
        t0, dt = prm.t0[sel].reshape(-1), prm.dt[sel].reshape(-1)
        n = (steps_f[sel] - 1).reshape(-1).long()
        total, count, top = 0, 0, 0
        for r0 in range(0, n.numel(), chunk):
            nn = n[r0:r0 + chunk]
            ray = torch.repeat_interleave(
                torch.arange(nn.numel(), device=dev), nn)
            if ray.numel() == 0:
                continue
            first = torch.cumsum(nn, 0) - nn
            s = (torch.arange(ray.numel(), device=dev) - first[ray]).float()
            t = t0[r0:][ray] + s * dt[r0:][ray]
            pos = rays_f.origin + t[:, None] * dirs[r0:][ray]
            fp = P.sampling.stencil_footprint(pos, cfg_f.volume_shape,
                                              cfg_f.normal_delta)
            per = torch.bincount(fp.sample, minlength=pos.shape[0])
            total += int(per.sum())
            count += per.numel()
            top = max(top, int(per.max()))
            del fp, pos, t, s, ray
        return total / max(count, 1), top, count

    for scene, make in scenes.items():
        vol_user = torch.from_numpy(make()).to(dev)[None]
        vol_i = P.volume_to_internal(vol_user[0]).contiguous()
        u = torch.rand((img, img), generator=gen, device=dev)

        # K1: the differentiable path.
        P.reset_launch_counts()
        out = rc.forward_with_aux(vol_user, tf_user, lf, u=u)
        sync()
        launches = P.launch_counts()["march_diff_fwd"]
        require(launches == 1, f"Raycaster.forward launched K1 {launches}x")
        require(out.image.shape == (4, img, img)
                and bool(torch.isfinite(out.image).all())
                and float(out.image.min()) >= 0.0
                and float(out.image[3].max()) <= 1.0,
                f"K1 image shape/range on {scene}")
        rays = P.make_rays(lf, cfg, 1.0, u=u)
        want, want_steps = P.march_diff_plain(vol_i, tf_i, rays, cfg, 1.0)
        max_err, frac_over, n_over = image_check(
            f"K1 {scene}", out.image.permute(1, 2, 0), want)
        steps_diff = count_check(f"K1 {scene} valid_steps", out.valid_steps,
                                 want_steps)
        samples = int((out.valid_steps - 1).sum())
        # Without ERT there is no knife edge: every pixel within 2e-4.
        got_ne, steps_ne = P.march_diff(vol_i, tf_i, rays, cfg, 1.0,
                                        ert=False)
        want_ne, want_steps_ne = P.march_diff_plain(vol_i, tf_i, rays, cfg,
                                                    1.0, ert=False)
        noert_err = float((got_ne - want_ne).abs().max())
        require(noert_err <= 2e-4 and bool((steps_ne == want_steps_ne).all()),
                f"K1 {scene} without ERT: max |diff| {noert_err}")
        # K1's own counts on the same rays: the samples of opacity 0 that it
        # composited without their gradient, and those of the stencil's
        # general branch; the footprint of its samples.
        k1_counts = torch.zeros((img, img, 2), dtype=torch.int32, device=dev)
        image_c, _ = P.march_diff_fwd(vol_i, tf_i, rays, cfg, 1.0,
                                      counts=k1_counts)
        require(torch.equal(image_c, out.image.permute(1, 2, 0)),
                f"K1 with counts differs from Raycaster.forward on {scene}")
        n_skipped = int(k1_counts[..., 0].sum())
        n_general = int(k1_counts[..., 1].sum())
        vox_mean, vox_max, vox_n = stencil_voxels(rays, out.valid_steps, cfg)
        del image_c, k1_counts
        fwd_ms = host_ms(lambda: rc.forward(vol_user, tf_user, lf, u=u), 7)
        k_ms = cuda_ms(lambda: P.march_diff(vol_i, tf_i, rays, cfg, 1.0), 10)
        p_ms = cuda_ms(lambda: P.march_diff_plain(vol_i, tf_i, rays, cfg,
                                                  1.0), 2, warm=0)
        k1_bytes = vol_bytes + R * 16 + ray_bytes + img * img * 20
        b_ms_uncorrected, _ = bound(k1_bytes, samples * DIFF_SAMPLE_OPS)
        b_ms, b_by = bound(k1_bytes,
                           (samples - n_skipped) * DIFF_SAMPLE_OPS
                           + n_skipped * ZERO_OPACITY_OPS)
        emit({"phase": "march_diff_fwd", "scene": scene, "image": img,
              "launches": launches, "max_abs_err": max_err,
              "pixels_over_2e-4": n_over, "frac_over_2e-4": frac_over,
              "valid_steps_max_diff": steps_diff,
              "noert_max_abs_err": noert_err, "samples": samples,
              "samples_zero_opacity_skipped": n_skipped,
              "skip_share": n_skipped / max(samples, 1),
              "samples_general_branch": n_general,
              "stencil_voxels_per_sample": vox_mean,
              "stencil_voxels_max": vox_max,
              "stencil_voxels_samples_counted": vox_n,
              "forward_ms": fwd_ms, "ms": k_ms, "plain_ms": p_ms,
              "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
              "bound_ms_uncorrected": b_ms_uncorrected,
              "ptxas": [ln for ln in info.ptxas.get("march.cu", [])
                        if "Used" in ln or "spill" in ln],
              "nvidia_smi": smi})
        record("march_diff_fwd", scene, launches, max_err, k_ms, p_ms, b_ms,
               b_by)
        if scene == "noise":
            kernels["march_diff_fwd"]["bound_ms_uncorrected"] = \
                b_ms_uncorrected

        # K2: the gradient step, forward and backward through the Raycaster.
        v_leaf = vol_user.clone().requires_grad_()
        t_leaf = tf_user.clone().requires_grad_()

        def grad_step():
            v_leaf.grad = t_leaf.grad = None
            img_ = rc.forward(v_leaf, t_leaf, lf, u=u)
            img_.square().mean().backward()
            return img_

        P.reset_launch_counts()
        img_g = grad_step()
        sync()
        counts = P.launch_counts()
        require(counts["march_diff_fwd"] == 1
                and counts["march_diff_bwd"] == 1,
                f"a gradient step launched K1 {counts['march_diff_fwd']}x "
                f"and K2 {counts['march_diff_bwd']}x on {scene}")
        launches = counts["march_diff_bwd"]
        require(bool(torch.isfinite(v_leaf.grad).all()
                     & torch.isfinite(t_leaf.grad).all()),
                f"K2 gradients finite on {scene}")
        # The same step by the wrappers: K2's own per-ray counts against
        # K1's, and its gradients against the Raycaster's.
        rays = P.make_rays(lf, cfg, 1.0, u=u)
        image, steps = P.march_diff_fwd(vol_i, tf_i, rays, cfg, 1.0)
        require(torch.equal(image, img_g.detach().permute(1, 2, 0)),
                f"K1 image differs between two calls on {scene}")
        g_img = 2.0 * image / image.numel()
        d_v, d_t, steps_bwd = P.march_diff_bwd(vol_i, tf_i, rays, cfg, 1.0,
                                               image, g_img)
        sync()
        require(torch.equal(steps_bwd, steps),
                f"K2's per-ray counts differ from K1's on "
                f"{int((steps_bwd != steps).sum())} rays ({scene})")
        same_v = float((P.volume_from_internal(d_v) - v_leaf.grad[0])
                       .abs().max()) / float(d_v.abs().max())
        same_t = float((d_t.t() - t_leaf.grad).abs().max()) / float(
            d_t.abs().max())
        require(same_v <= 1e-4 and same_t <= 1e-4,
                f"K2 by the wrapper and by autograd differ: {same_v}, "
                f"{same_t} ({scene})")
        bwd_samples = int((steps_bwd - 1).sum())
        k2_counts = torch.zeros((img, img, 4), dtype=torch.int32, device=dev)
        P.march_diff_bwd(vol_i, tf_i, rays, cfg, 1.0, image, g_img,
                         counts=k2_counts)
        n_scattered, n_quiet_light, n_atomics, n_general_bwd = (
            int(k2_counts[..., i].sum()) for i in range(4))
        del k2_counts
        k2_ms = cuda_ms(lambda: P.march_diff_bwd(vol_i, tf_i, rays, cfg, 1.0,
                                                 image, g_img), 10)
        step_ms = host_ms(grad_step, 7)
        k2_bytes = 3 * vol_bytes + R * 32 + ray_bytes + img * img * 36
        k2_ops = (n_scattered * BWD_SAMPLE_OPS
                  + (bwd_samples - n_scattered) * QUIET_SAMPLE_OPS)
        b_ms_uncorrected, _ = bound(k2_bytes, k2_ops)
        b_ms, b_by = bound(k2_bytes, k2_ops + n_quiet_light * QUIET_LIGHT_OPS)
        # K2 at the main path's own shape, ERT on, against autograd of the
        # plain march summed over 16 tiles of 128^2 rays (one 512^2 autograd
        # march would take tens of GB on ct_phantom), for a cotangent with
        # both signs.  The rays K1 ends elsewhere than the plain march (K1's
        # check above) get none.
        agree, n_knife_full = knife_mask(steps, want_steps,
                                         f"{scene} (512, 512)")
        g_full = (torch.rand((img, img, 4), generator=gen_c, device=dev)
                  - 0.3) * agree[..., None]
        got_full = P.march_diff_bwd(vol_i, tf_i, rays, cfg, 1.0, image,
                                    g_full)[:2]
        sync()
        t_plain = time.perf_counter()
        want_full = plain_bwd_tiled(vol_i, tf_i, rays, cfg, g_full, 128)
        sync()
        plain_full_ms = (time.perf_counter() - t_plain) * 1e3
        full_errs = k2_grad_errs(got_full, want_full,
                                 f"{scene} (512, 512), ert=True")
        del got_full, want_full, g_full
        # Against autograd of the plain march at a 128^2 image: ERT off and
        # on, and on noise the TF-gradient rule of R > 1024 and an opaque TF.
        cfg_s = cfg.replace(image_shape=(128, 128))
        u_s = torch.rand((128, 128), generator=gen_b, device=dev)
        rays_s = P.make_rays(lf, cfg_s, 1.0, u=u_s)
        g_s = torch.rand((128, 128, 4), generator=gen_b, device=dev) - 0.3
        small = {}
        # normal_delta 6e-3 is 0.765 voxel at 256^3: most samples need both
        # extra layers of an axis and take the stencil's general branch.
        cfg_wide = cfg_s.replace(normal_delta=6e-3)
        cases = [("tf1", tf_i, False, cfg_s), ("tf1", tf_i, True, cfg_s),
                 ("tf1_delta6e-3", tf_i, False, cfg_wide),
                 ("tf1_delta6e-3", tf_i, True, cfg_wide)]
        if scene == "noise":
            # The TF-gradient rule of R > 1024 (K2's global-memory TF), and
            # a TF alpha of exactly 1 (K2's exact last sample, its restart
            # and its stop at T = 0).
            opaque = tf_i.clone()
            opaque[40:, 3] = 1.0
            cases += [("tf1_R2048", P.get_tf("tf1", 2048, device=dev), True,
                       cfg_s),
                      ("opaque", opaque, False, cfg_s),
                      ("opaque", opaque, True, cfg_s)]
        for label, tf_c, ert, cfg_c in cases:
            errs, n_knife, img_s, g_m = k2_vs_plain(vol_i, tf_c, rays_s,
                                                    cfg_c, g_s, ert,
                                                    f"{scene} {label}")
            small[f"{label}_ert_{ert}"] = {"rel_err_d_volume": errs[0],
                                          "rel_err_d_tf": errs[1],
                                          "knife_edge_rays": n_knife}
        # K1 and K2 in both branches of the stencil at delta 6e-3: K1
        # without ERT against the plain march, and each kernel's count of
        # general-branch samples.
        c1 = torch.zeros((128, 128, 2), dtype=torch.int32, device=dev)
        img_w, steps_w = P.march_diff_fwd(vol_i, tf_i, rays_s, cfg_wide, 1.0,
                                          ert=False, counts=c1)
        want_w, want_steps_w = P.march_diff_plain(vol_i, tf_i, rays_s,
                                                  cfg_wide, 1.0, ert=False)
        wide_err = float((img_w - want_w).abs().max())
        require(wide_err <= 2e-4 and torch.equal(steps_w, want_steps_w),
                f"K1 at delta 6e-3 on {scene} without ERT: max |diff| "
                f"{wide_err}")
        c2 = torch.zeros((128, 128, 4), dtype=torch.int32, device=dev)
        P.march_diff_bwd(vol_i, tf_i, rays_s, cfg_wide, 1.0, img_w, g_s,
                         ert=False, counts=c2)
        wide_samples = int((steps_w - 1).sum())
        wide_general = [int(c1[..., 1].sum()), int(c2[..., 3].sum())]
        # K2 recomputes K1's samples but stops once T is exactly 0.
        require(0 < wide_general[0] < wide_samples
                and 0 < wide_general[1] <= wide_general[0],
                f"delta 6e-3 on {scene}: {wide_general} of {wide_samples} "
                f"samples in the general branch (K1, K2)")
        wide = {"k1_noert_max_abs_err": wide_err, "samples": wide_samples,
                "general_branch_k1_k2": wide_general}
        del c1, c2, img_w, want_w
        img_s, _ = P.march_diff_fwd(vol_i, tf_i, rays_s, cfg_s, 1.0)
        g_m = g_s
        k2_small_ms = cuda_ms(lambda: P.march_diff_bwd(
            vol_i, tf_i, rays_s, cfg_s, 1.0, img_s, g_m), 10)
        plain_small_ms = cuda_ms(lambda: P.march_diff_bwd_plain(
            vol_i, tf_i, rays_s, cfg_s, 1.0, g_m), 1, warm=0)
        torch.cuda.empty_cache()
        k2_err = max(max(max(v["rel_err_d_volume"], v["rel_err_d_tf"])
                         for v in small.values()), *full_errs)
        emit({"phase": "march_diff_bwd", "scene": scene, "image": img,
              "launches": launches, "k1_launches": counts["march_diff_fwd"],
              "counts_equal_k1": True, "samples": bwd_samples,
              "samples_scattering": n_scattered,
              "samples_quiet_needing_light": n_quiet_light,
              "atomics": n_atomics,
              "atomics_per_scattering_sample":
                  n_atomics / max(n_scattered, 1),
              "samples_general_branch": n_general_bwd,
              "delta6e-3_128": wide,
              "wrapper_vs_autograd_rel": [same_v, same_t],
              "vs_plain_512_ert_True": {"rel_err_d_volume": full_errs[0],
                                        "rel_err_d_tf": full_errs[1],
                                        "knife_edge_rays": n_knife_full},
              "vs_plain_128": small, "tolerance": K2_GRAD_TOL,
              "ms": k2_ms, "grad_step_ms": step_ms,
              "plain_ms": plain_full_ms, "ms_128": k2_small_ms,
              "plain_ms_128": plain_small_ms,
              "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
              "bound_ms_uncorrected": b_ms_uncorrected,
              "ptxas": [ln for ln in info.ptxas.get("march_bwd.cu", [])
                        if "Used" in ln or "spill" in ln],
              "nvidia_smi": smi})
        k = kernels["march_diff_bwd"]
        k["launches"] += launches
        k["max_abs_err"] = max(k["max_abs_err"], k2_err)
        k["max_abs_err_is"] = "max |diff| / max |g| per gradient tensor"
        if scene == "noise":
            k.update(ms=k2_ms, plain_ms=plain_full_ms,
                     plain_ms_note="autograd of march_diff_plain over 16 "
                                   "tiles of 128^2, host clock",
                     bound_ms=b_ms, bound_by=b_by,
                     bound_ms_uncorrected=b_ms_uncorrected,
                     grad_step_ms=step_ms)
            grad_step_profile = profile(grad_step)
        del v_leaf, t_leaf, img_g, d_v, d_t, image, g_img

        # K3: the inference path, through the occupancy grid (K6).
        P.reset_launch_counts()
        nd = rc.raycast_nondiff(vol_user, tf_user, lf)
        sync()
        counts = P.launch_counts()
        launches = counts["march_nondiff"]
        require(launches == 1, f"raycast_nondiff launched K3 {launches}x")
        count_build(counts, "raycast_nondiff")
        require(nd.shape == (4, img, img) and bool(torch.isfinite(nd).all())
                and float(nd.min()) >= 0.0 and float(nd.max()) <= 1.0,
                f"K3 image shape/range on {scene}")
        sr = 4.0
        rays = P.make_rays(lf, cfg, sr)
        # Without the grid, against the plain march without it.
        loads_p = torch.zeros((img, img), dtype=torch.int32, device=dev)
        want, want_vis, want_comp = P.march_nondiff_plain(
            vol_i, tf_i, rays, cfg, sr, cell_loads=loads_p)
        max_err, frac_over, n_over = image_check(
            f"K3 {scene}", nd.permute(1, 2, 0), want)
        k3_n = torch.zeros((img, img, 3), dtype=torch.int32, device=dev)
        img_n, vis, comp = P.march_nondiff(vol_i, tf_i, rays, cfg, sr,
                                           counts=k3_n)
        vis_diff = count_check(f"K3 {scene} visited", vis, want_vis)
        comp_diff = count_check(f"K3 {scene} composited", comp, want_comp)
        loads_n = cell_load_check(f"K3 {scene}", k3_n, loads_p, vis,
                                  want_vis)
        visited, composited = int(vis.sum()), int(comp.sum())
        # With the grid: bitwise K3 without it, and the plain march with it.
        grid = P.build_occupancy(vol_i, tf_i, cfg)
        k3_g = torch.zeros((img, img, 3), dtype=torch.int32, device=dev)
        img_g, vis_g, comp_g = P.march_nondiff(vol_i, tf_i, rays, cfg, sr,
                                               grid, counts=k3_g)
        sync()
        require(torch.equal(img_g, nd.permute(1, 2, 0)),
                f"K3 by the wrapper differs from raycast_nondiff on {scene}")
        require(torch.equal(img_g, img_n) and torch.equal(comp_g, comp),
                f"K3 with the grid differs from K3 without it on {scene}: "
                f"{int((img_g != img_n).any(-1).sum())} pixels, "
                f"{int((comp_g != comp).sum())} composited counts")
        (want_g, want_vis_g, want_comp_g), p_ms = timed_once(
            lambda: P.march_nondiff_plain(vol_i, tf_i, rays, cfg, sr, grid,
                                          cell_loads=loads_p))
        max_err_g, _, n_over_g = image_check(f"K3 {scene} with the grid",
                                             img_g, want_g)
        comp_diff_g = count_check(f"K3 {scene} composited with the grid",
                                  comp_g, want_comp_g)
        loads_g = cell_load_check(f"K3 {scene} with the grid", k3_g,
                                  loads_p, vis_g, want_vis_g)
        visited_g = int(vis_g.sum())
        fwd_ms, fwd_ms_no_grid = host_ms_ab(
            lambda: rc.raycast_nondiff(vol_user, tf_user, lf),
            lambda: rc_off.raycast_nondiff(vol_user, tf_user, lf), 9)
        k_ms = cuda_ms(lambda: P.march_nondiff(vol_i, tf_i, rays, cfg, sr,
                                               grid), 10)
        k_ms_no_grid = cuda_ms(lambda: P.march_nondiff(vol_i, tf_i, rays,
                                                       cfg, sr), 10)
        p_ms_no_grid = cuda_ms(lambda: P.march_nondiff_plain(
            vol_i, tf_i, rays, cfg, sr), 1, warm=0)
        b_ms, b_by = bound(vol_bytes + grid_read_bytes(grid) + R * 16
                           + ray_bytes + img * img * 24,
                           visited_g * NONDIFF_VISIT_OPS
                           + composited * NONDIFF_SHADE_OPS
                           + lookups(grid, visited_g, composited) * JUMP_OPS)
        b_ms_no_grid, _ = bound(vol_bytes + R * 16 + ray_bytes
                                + img * img * 24,
                                visited * NONDIFF_VISIT_OPS
                                + composited * NONDIFF_SHADE_OPS)
        emit({"phase": "march_nondiff", "scene": scene, "image": img,
              "sampling_rate": sr, "launches": launches,
              "build_launches": [counts["cell_minmax"],
                                 counts["cell_distance"]],
              "max_abs_err": max_err, "pixels_over_2e-4": n_over,
              "frac_over_2e-4": frac_over, "visited_max_diff": vis_diff,
              "composited_max_diff": comp_diff,
              "grid": {"shape": grid.shape, "cell": grid.cell,
                       "jumps": grid_jumps(grid), "equal_to_no_grid": True,
                       "max_abs_err_vs_plain": max_err_g,
                       "pixels_over_2e-4_vs_plain": n_over_g,
                       "composited_max_diff_vs_plain": comp_diff_g},
              "samples_visited": visited_g,
              "samples_visited_no_grid": visited,
              "samples_composited": composited,
              "k3_counts": k3_counts(k3_g, visited_g, composited, loads_g),
              "k3_counts_no_grid": k3_counts(k3_n, visited, composited,
                                             loads_n),
              "raycast_ms": fwd_ms,
              "raycast_ms_no_grid": fwd_ms_no_grid, "ms": k_ms, "ms_no_grid": k_ms_no_grid, "plain_ms": p_ms,
              "plain_ms_no_grid": p_ms_no_grid, "library_ms": None,
              "bound_ms": b_ms, "bound_by": b_by,
              "bound_ms_no_grid": b_ms_no_grid, "nvidia_smi": smi})
        record("march_nondiff", scene, launches, max(max_err, max_err_g),
               k_ms, p_ms, b_ms, b_by)
        if scene == "noise":
            kernels["march_nondiff"]["ms_no_grid"] = k_ms_no_grid
            kernels["march_nondiff"]["cell_loads_per_visited"] = (
                int(k3_g[..., 0].sum()) / max(visited_g, 1))
        del grid, img_g, img_n, want, want_g, k3_n, k3_g, loads_p
        if scene == "noise":
            emit({"phase": "profile", "scene": scene,
                  "forward": profile(
                      lambda: rc.forward(vol_user, tf_user, lf, u=u)),
                  "grad_step": grad_step_profile,
                  "raycast_nondiff": profile(
                      lambda: rc.raycast_nondiff(vol_user, tf_user, lf)),
                  "raycast_nondiff_no_grid": profile(
                      lambda: rc_off.raycast_nondiff(vol_user, tf_user, lf)),
                  "nvidia_smi": smi})
        del vol_user, vol_i

    # -- 5b. train: volume fitting (examples/optimize_volume.py) ---------------
    clean = torch.from_numpy(P.ct_phantom(res)).to(dev)
    corrupt = torch.rand(clean.shape, generator=gen_b, device=dev) < 0.05
    start = torch.where(corrupt, torch.rand(clean.shape, generator=gen_b,
                                            device=dev), clean)
    views = torch.stack([P.in_circles(0.0, device=dev),
                         P.get_rand_pos(gen_b)])
    targets = rc.raycast_nondiff(clean[None, None].expand(2, 1, res, res, res),
                                 tf_user, views)
    v_fit = start[None].clone().requires_grad_()
    opt, sched = P.adamw_onecycle([v_fit], 0.05, 5)
    losses, step_times, grad_max = [], [], []
    P.reset_launch_counts()
    for _ in range(5):
        sync()
        t_step = time.perf_counter()
        opt.zero_grad()
        loss = P.dssim_mse_loss(
            rc(v_fit.expand(2, 1, res, res, res), tf_user, views), targets)
        loss.backward()
        opt.step()
        sched.step()
        P.project_unit(v_fit)
        sync()
        step_times.append((time.perf_counter() - t_step) * 1e3)
        losses.append(float(loss.detach()))
        grad_max.append(float(v_fit.grad.abs().max()))
        require(math.isfinite(losses[-1]) and math.isfinite(grad_max[-1]),
                f"train: non-finite loss or gradient {losses[-1]}, "
                f"{grad_max[-1]}")
    counts = P.launch_counts()
    require(losses[-1] < losses[0], f"train: loss did not fall: {losses}")
    require(counts["march_diff_fwd"] == 10 and counts["march_diff_bwd"] == 10,
            f"train: 5 steps of 2 views launched {counts}")
    emit({"phase": "train", "volume": res, "image": img, "views": 2,
          "steps": 5, "loss": losses, "grad_abs_max": grad_max,
          "step_ms": step_times,
          "vol_l1_to_clean": [float((start - clean).abs().mean()),
                              float((v_fit.detach()[0] - clean).abs()
                                    .mean())],
          "launches": counts, "nvidia_smi": smi})
    del clean, corrupt, start, targets, v_fit, opt, sched

    # -- 6. golden fixtures ----------------------------------------------------
    golden = np.load(os.path.join(ROOT, "tests", "golden_renders.npz"))
    xs = [np.linspace(-1, 1, 32, dtype=np.float32)] * 3
    g = np.meshgrid(*xs, indexing="ij")
    r = np.sqrt(sum(x * x for x in g))
    sphere = torch.from_numpy(
        (1.0 / (1.0 + np.exp(6.0 * (r - 0.6) * 8.0))).astype(np.float32)
    ).to(dev)
    gcfg = P.RenderConfig(volume_shape=(32, 32, 32), image_shape=(16, 16),
                          tf_resolution=32, max_samples=64)
    gtf = P.get_tf("tf1", 32, device=dev)
    glf = torch.tensor([1.2, 0.8, 2.0], device=dev)
    d_err = float(np.abs(P.render(sphere, gtf, glf, gcfg, 0.8).image.cpu()
                         .numpy() - golden["diff"]).max())
    n_err = float(np.abs(P.render_nondiff(sphere, gtf, glf, gcfg, 1.5).image
                         .cpu().numpy() - golden["nondiff"]).max())
    require(d_err <= 1e-4 and n_err <= 1e-4,
            f"golden fixtures: diff {d_err}, nondiff {n_err}")
    # K2 at the sphere's sampling rate 0.8 (opacity exponent 1.25; the bench
    # runs at 1), against the plain march and through value_and_grad_render.
    g_w = torch.rand((16, 16, 4), generator=gen_b, device=dev) - 0.3
    g_rays = P.make_rays(glf, gcfg, 0.8)
    sphere_grads = {}
    for ert in (False, True):
        errs, _, _, _ = k2_vs_plain(sphere, gtf, g_rays, gcfg, g_w, ert,
                                    "sphere", sr=0.8)
        P.reset_launch_counts()
        _, (dv_e, dt_e) = P.value_and_grad_render(
            sphere, gtf, glf, gcfg, lambda o: torch.sum(o.image * g_w), 0.8,
            ert=ert)
        counts = P.launch_counts()
        require(counts["march_diff_fwd"] == 1
                and counts["march_diff_bwd"] == 1,
                f"value_and_grad_render launched {counts}")
        img_k, _ = P.march_diff_fwd(sphere, gtf, g_rays, gcfg, 0.8, ert=ert)
        dv_w, dt_w, _ = P.march_diff_bwd(sphere, gtf, g_rays, gcfg, 0.8,
                                         img_k, g_w, ert=ert)
        same = max(float((dv_e - dv_w).abs().max() / dv_w.abs().max()),
                   float((dt_e - dt_w).abs().max() / dt_w.abs().max()))
        require(same <= 1e-4, f"value_and_grad_render against K2: {same}")
        sphere_grads[f"ert_{ert}"] = {"rel_err_d_volume": errs[0],
                                      "rel_err_d_tf": errs[1],
                                      "value_and_grad_rel": same}
        k = kernels["march_diff_bwd"]
        k["max_abs_err"] = max(k["max_abs_err"], *errs)
    emit({"phase": "golden", "diff_max_abs_err": d_err,
          "nondiff_max_abs_err": n_err, "k2_sphere_sr0.8": sphere_grads})

    # -- 7. bricks: K4 and K5 on the TPU DMA probe's variants ------------------
    # experiments/exp_pallas_dma.py's sizes, and its draws in its order.
    V, B, n_b, NB = 256, 32, 2048, 4096
    rng = np.random.default_rng(0)
    vol_b = torch.from_numpy(rng.random((V, V, V), np.float32)).to(dev)
    al = rng.integers(0, (V - B) // 8, size=(n_b, 3)) * 8
    al[:, 2] = (al[:, 2] // 16) * 16
    un = rng.integers(0, V - B, size=(n_b, 3))
    table = torch.from_numpy(rng.random((NB, B, B * B), np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, NB, size=(n_b,))
                           .astype(np.int32)).to(dev)
    origins = {"A1_aligned": torch.from_numpy(al.astype(np.int32)).to(dev),
               "A2_unaligned": torch.from_numpy(un.astype(np.int32)).to(dev)}
    P.reset_launch_counts()
    outs = {k: P.brick_sums(vol_b, o) for k, o in origins.items()}
    outs["A3_bricked_rows"] = P.brick_rows(table, idx)
    sync()
    counts = P.launch_counts()
    require(counts["brick_sums"] == 2 and counts["brick_rows"] == 1,
            f"the probe's variants launched {counts}")

    def sums_check(label, got, want):
        """Every row within rtol 1e-5 of the plain version, lanes equal."""
        require(got.shape == want.shape and bool((got == got[:, :1]).all()),
                f"{label}: shape {tuple(got.shape)} or lanes differ")
        err = (got - want).abs()
        rel = float((err / want.abs()).max())
        require(rel <= 1e-5, f"{label}: max relative error {rel} > 1e-5")
        return float(err.max()), rel

    def union_voxels(o, b):
        """Voxels inside at least one b^3 brick at the origins o."""
        diff = torch.zeros((V + 1,) * 3, dtype=torch.int32, device=dev)
        o = o.long()
        for cx in (0, 1):
            for cy in (0, 1):
                for cz in (0, 1):
                    diff.index_put_(
                        (o[:, 0] + cx * b, o[:, 1] + cy * b, o[:, 2] + cz * b),
                        torch.full((o.shape[0],), (-1) ** (cx + cy + cz),
                                   dtype=torch.int32, device=dev),
                        accumulate=True)
        cover = diff.cumsum(0).cumsum(1).cumsum(2)[:V, :V, :V]
        return int((cover > 0).sum())

    brick_bytes = B ** 3 * 4
    out_bytes = n_b * 128 * 4
    bricks_out = {}
    for label, o in origins.items():
        want = P.brick_sums_reference(vol_b, o)
        err, rel = sums_check(label, outs[label], want)
        # A brick partly or wholly outside the volume gives a NaN row.
        bad = torch.cat([o[:2], torch.tensor(
            [[V - B + 1, 0, 0], [0, -1, 0], [0, 0, V]], dtype=torch.int32,
            device=dev)])
        got_bad = P.brick_sums(vol_b, bad)
        require(torch.equal(got_bad[:2], outs[label][:2])
                and bool(torch.isnan(got_bad[2:]).all())
                and bool(torch.isnan(P.brick_sums_reference(vol_b, bad)[2:])
                         .all()),
                f"{label}: out-of-range origins do not give NaN rows")
        ms = cuda_ms(lambda: P.brick_sums(vol_b, o), 10, per_pair=10)
        plain_ms = cuda_ms(lambda: P.brick_sums_reference(vol_b, o), 5)
        union = union_voxels(o, B)
        b_ms, b_by = bound(union * 4 + n_b * 12 + out_bytes, n_b * B ** 3)
        bricks_out[label] = dict(
            launches=1, max_abs_err=err, max_rel_err=rel, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            union_voxels=union,
            bound_ms_each_brick_from_hbm=bound(n_b * brick_bytes + out_bytes,
                                               0)[0],
            library_ms=None)
    want = P.brick_rows_reference(table, idx)
    err, rel = sums_check("A3_bricked_rows", outs["A3_bricked_rows"], want)
    bad = torch.tensor([int(idx[0]), NB, -1], dtype=torch.int32, device=dev)
    got_bad = P.brick_rows(table, bad)
    require(torch.equal(got_bad[0], outs["A3_bricked_rows"][0])
            and bool(torch.isnan(got_bad[1:]).all()),
            "A3: indices out of range do not give NaN rows")
    ms = cuda_ms(lambda: P.brick_rows(table, idx), 10, per_pair=10)
    plain_ms = cuda_ms(lambda: P.brick_rows_reference(table, idx), 5)

    def lib_rows():
        return table.index_select(0, idx).sum((1, 2))

    lib_err = float((lib_rows() - want[:, 0]).abs().max())
    library_ms = cuda_ms(lib_rows, 5, per_pair=2)
    distinct = int(torch.unique(idx).numel())
    b_ms, b_by = bound(distinct * brick_bytes + n_b * 4 + out_bytes,
                       n_b * B ** 3)
    bricks_out["A3_bricked_rows"] = dict(
        launches=1, max_abs_err=err, max_rel_err=rel, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        distinct_bricks=distinct,
        bound_ms_each_brick_from_hbm=bound(n_b * brick_bytes + out_bytes,
                                           0)[0],
        library_ms=library_ms,
        library="table.index_select(0, idx).sum((1, 2))",
        library_max_abs_diff=lib_err)
    emit({"phase": "bricks", "V": V, "B": B, "n": n_b, "NB": NB,
          "tolerance_rtol": 1e-5, "variants": bricks_out,
          "nvidia_smi": smi})
    a2 = bricks_out["A2_unaligned"]
    kernels["brick_sums"].update(
        launches=counts["brick_sums"],
        max_abs_err=max(bricks_out[k]["max_abs_err"]
                        for k in origins),
        max_rel_err=max(bricks_out[k]["max_rel_err"] for k in origins),
        ms=a2["ms"], ms_A1_aligned=bricks_out["A1_aligned"]["ms"],
        plain_ms=a2["plain_ms"], bound_ms=a2["bound_ms"],
        bound_by=a2["bound_by"], library_ms=None,
        library_note="none: no single call gathers bricks at arbitrary "
                     "origins")
    a3 = bricks_out["A3_bricked_rows"]
    kernels["brick_rows"].update(
        launches=counts["brick_rows"], max_abs_err=a3["max_abs_err"],
        max_rel_err=a3["max_rel_err"], ms=a3["ms"],
        plain_ms=a3["plain_ms"], bound_ms=a3["bound_ms"],
        bound_by=a3["bound_by"], library_ms=a3["library_ms"])
    del vol_b, table, idx, origins, outs, want, got_bad
    torch.cuda.empty_cache()

    # -- 8. occupancy: K6, K7 and the grid's build ---------------------------
    tf_cpu = tf_i.cpu()
    lib = _build.library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dev_index = torch.cuda.current_device()

    def stream():
        return torch.cuda.current_stream().cuda_stream

    for scene, make in scenes.items():
        vol_i = P.volume_to_internal(torch.from_numpy(make()).to(dev))
        vol_i = vol_i.contiguous()
        vol_cpu = vol_i.cpu()
        for cell_arg, md_arg in ((None, None), (8, 12)):
            cell, md = cfg.resolved_occupancy()
            if cell_arg is not None:
                cell, md = cell_arg, md_arg
            P.reset_launch_counts()
            grid = P.build_occupancy(vol_i, tf_i, cfg, cell_arg, md_arg)
            sync()
            count_build(P.launch_counts(), "build_occupancy")
            # The whole build on CPU copies runs the plain versions only.
            cpu = P.build_occupancy(vol_cpu, tf_cpu, cfg, cell_arg, md_arg)
            require(grid.shape == cpu.shape and grid.cell == cell
                    and grid.cell_world == cpu.cell_world
                    and torch.equal(grid.dist.cpu(), cpu.dist),
                    f"build_occupancy on the card differs from the CPU build "
                    f"on {scene} at cell {cell}")
            lo, hi = P.cell_minmax(vol_i, cell)
            lo_p, hi_p = P.cell_minmax_reference(vol_i, cell)
            require(torch.equal(lo, lo_p) and torch.equal(hi, hi_p),
                    f"K6 differs from its plain version on {scene} at cell "
                    f"{cell}")
            k7_args = (lo, hi, tf_i, cfg.alpha_skip, md)
            dist, far = P.cell_distance(*k7_args)
            dist_p, far_p = P.cell_distance_reference(*k7_args)
            require(torch.equal(dist, dist_p) and torch.equal(far, far_p)
                    and torch.equal(dist.reshape(-1), grid.dist)
                    and torch.equal(grid.far, far_p),
                    f"K7 differs from its plain version on {scene} at cell "
                    f"{cell}")
            # Device time by CUDA events around back-to-back calls of the C
            # entries: one call of a wrapper spends longer on the host than
            # K7 on the device, so events around wrapper calls time the
            # host, and the profiler does not always record these ctypes
            # launches.
            lo_t, hi_t = torch.empty_like(lo), torch.empty_like(hi)
            plan6 = P.ops.bricks.k6_plan(vol_i.shape, cell, sms)
            k6_dev_ms = launch_ms(lambda: lib.dr_cell_minmax(
                vol_i.data_ptr(), *vol_i.shape, cell, *plan6,
                lo_t.data_ptr(), hi_t.data_ptr(), dev_index, stream()))
            out7, tmp7 = torch.empty_like(dist), torch.empty_like(dist)
            far7 = torch.empty_like(far)
            k7_dev_ms = launch_ms(lambda: lib.dr_cell_distance(
                lo.data_ptr(), hi.data_ptr(), tf_i.data_ptr(), R,
                float(np.float32(cfg.alpha_skip)), *lo.shape, md,
                tmp7.data_ptr(), out7.data_ptr(), far7.data_ptr(), dev_index,
                stream()))
            require(torch.equal(lo_t, lo) and torch.equal(hi_t, hi)
                    and torch.equal(out7, dist) and torch.equal(far7, far),
                    f"K6/K7 by their C entries differ on {scene} at cell "
                    f"{cell}")
            # K7's texel groups at R = 4096 (its sparse table over groups of
            # 8 texels, the spans' ends from the TF).
            tf_big = P.get_tf("tf1", 4096, device=dev)
            big = (lo, hi, tf_big, cfg.alpha_skip, md)
            dist_b, far_b = P.cell_distance(*big)
            dist_bp, far_bp = P.cell_distance_reference(*big)
            require(torch.equal(dist_b, dist_bp)
                    and torch.equal(far_b, far_bp),
                    f"K7 at R = 4096 differs from its plain version on "
                    f"{scene} at cell {cell}")
            del tf_big, big, dist_b, dist_bp
            ms = cuda_ms(lambda: P.cell_minmax(vol_i, cell), 10, per_pair=5)
            plain_ms = cuda_ms(lambda: P.cell_minmax_reference(vol_i, cell), 5)
            lib_lo, lib_hi = minmax_pools(vol_i, cell)
            require(torch.equal(lib_lo, lo) and torch.equal(lib_hi, hi),
                    f"the max_pool3d pair differs from K6 on {scene} at cell "
                    f"{cell}")
            library_ms = cuda_ms(lambda: minmax_pools(vol_i, cell), 10,
                                 per_pair=5)
            lib_dev = device_kernels(lambda: minmax_pools(vol_i, cell))
            lib_dev_ms = sum(v["ms"] for v in lib_dev.values()) or None
            ms7 = cuda_ms(lambda: P.cell_distance(*k7_args), 10, per_pair=5)
            plain7 = cuda_ms(lambda: P.cell_distance_reference(*k7_args), 3)
            build_ms = host_ms(lambda: P.build_occupancy(
                vol_i, tf_i, cfg, cell_arg, md_arg), 7)
            build_dev_ms = cuda_ms(lambda: P.build_occupancy(
                vol_i, tf_i, cfg, cell_arg, md_arg), 7)
            n_cells = lo.numel()
            b_ms, b_by = bound(vol_bytes + 2 * n_cells * 4,
                               2 * n_cells * (cell + 2) ** 3)
            # K7 reads (lo, hi) and the TF and writes an int per cell and
            # the largest; its table takes R^2 / 2 maxima, the
            # classification 8 operations per cell (2 products, floor, ceil,
            # 4 clamps), and each of the three passes at least one
            # comparison per cell.
            b7_ms, b7_by = bound(n_cells * 12 + R * 16 + 4,
                                 R * R / 2 + n_cells * (8 + 3))
            emit({"phase": "occupancy", "scene": scene, "cell": cell,
                  "max_dist": md, "grid": grid.shape,
                  "minmax_equal": True, "distance_equal": True,
                  "equal_to_cpu_build": True,
                  "empty_share": float((grid.dist >= 2).float().mean()),
                  "cell_minmax": {"ms": ms, "device_ms": k6_dev_ms,
                                  "plain_ms": plain_ms,
                                  "library_ms": library_ms,
                                  "library_device_ms": lib_dev_ms,
                                  "bound_ms": b_ms, "bound_by": b_by},
                  "cell_distance": {"ms": k7_dev_ms, "event_ms": ms7,
                                    "plain_ms": plain7, "bound_ms": b7_ms,
                                    "bound_by": b7_by,
                                    "equal_at_R4096": True},
                  "build_ms": build_ms, "build_device_ms": build_dev_ms,
                  "nvidia_smi": smi})
            if scene == "ct_phantom" and cell_arg is None:
                kernels["cell_minmax"].update(
                    ms=k6_dev_ms, ms_is=DEVICE_MS_IS, wrapper_event_ms=ms,
                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    build_ms=build_ms, library_ms=library_ms,
                    library_device_ms=lib_dev_ms,
                    library_note="two calls: F.max_pool3d of the "
                                 "replicate-padded volume and of its "
                                 "negation (the max and the min)")
                kernels["cell_distance"].update(
                    ms=k7_dev_ms, ms_is=DEVICE_MS_IS, wrapper_event_ms=ms7,
                    plain_ms=plain7, bound_ms=b7_ms,
                    bound_by=b7_by,
                    library_ms=None,
                    library_note="none: no single call gives a distance "
                                 "transform")
            if scene == "ct_phantom" and cell_arg is not None:
                kernels["cell_minmax"].update(
                    ms_cell8=k6_dev_ms, bound_ms_cell8=b_ms,
                    library_ms_cell8=library_ms)
            del grid, cpu, lo, hi, lo_p, hi_p, k7_args, dist, dist_p
        del vol_i, vol_cpu

    # K6 where the cell divides no side (the far faces clamp) and, at cell
    # 48, a tile's voxels are taken in bands: bitwise its plain version on
    # the card and the CPU build.
    odd = torch.rand((250, 256, 243), generator=gen_b, device=dev)
    odd_cpu = odd.cpu()
    P.reset_launch_counts()
    odd_cells = {}
    for cell in (2, 3, 8, 48):
        lo, hi = P.cell_minmax(odd, cell)
        lo_p, hi_p = P.cell_minmax_reference(odd, cell)
        lo_c, hi_c = P.cell_minmax(odd_cpu, cell)
        require(torch.equal(lo, lo_p) and torch.equal(hi, hi_p)
                and torch.equal(lo.cpu(), lo_c)
                and torch.equal(hi.cpu(), hi_c),
                f"K6 on 250x256x243 at cell {cell} differs from its plain "
                f"version or the CPU build")
        odd_cells[cell] = {"grid": list(lo.shape), "equal": True,
                           "plan": list(P.ops.bricks.k6_plan(odd.shape, cell,
                                                             sms))}
    require(P.launch_counts()["cell_minmax"] == 4, "K6 launches on 250x256x243")
    emit({"phase": "occupancy_odd", "volume": [250, 256, 243],
          "cells": odd_cells, "nvidia_smi": smi})
    del odd, odd_cpu, lo, hi, lo_p, hi_p, lo_c, hi_c

    # -- 9. viewer: the inference example at full width ---------------------
    v_img, v_sr = 800, 16.0
    rc_v = P.Raycaster((res, res, res), (v_img, v_img), R, jitter=False)
    rc_v_off = P.Raycaster((res, res, res), (v_img, v_img), R, jitter=False,
                           occupancy_skip=False)
    cfg_v = rc_v.config
    lf_v = torch.tensor([0.0, 1.0, -2.3], device=dev)
    for scene, make in (("synthetic", lambda: P.synthetic_volume(res)),
                        ("ct_phantom", lambda: P.ct_phantom(res))):
        vol_user = torch.from_numpy(make()).to(dev)[None]
        vol_i = P.volume_to_internal(vol_user[0]).contiguous()
        P.reset_launch_counts()
        nd = rc_v.raycast_nondiff(vol_user, tf_user, lf_v, sampling_rate=v_sr)
        sync()
        counts = P.launch_counts()
        require(counts["march_nondiff"] == 1,
                f"the viewer's raycast_nondiff launched {counts}")
        count_build(counts, "the viewer's raycast_nondiff")
        kernels["march_nondiff"]["launches"] += counts["march_nondiff"]
        require(nd.shape == (4, v_img, v_img)
                and bool(torch.isfinite(nd).all())
                and float(nd.min()) >= 0.0 and float(nd.max()) <= 1.0,
                f"viewer image shape/range on {scene}")
        rays = P.make_rays(lf_v, cfg_v, v_sr)
        grid = P.build_occupancy(vol_i, tf_i, cfg_v)
        k3_g = torch.zeros((v_img, v_img, 3), dtype=torch.int32, device=dev)
        k3_n = torch.zeros_like(k3_g)
        img_g, vis_g, comp_g = P.march_nondiff(vol_i, tf_i, rays, cfg_v,
                                               v_sr, grid, counts=k3_g)
        img_n, vis_n, comp_n = P.march_nondiff(vol_i, tf_i, rays, cfg_v,
                                               v_sr, counts=k3_n)
        sync()
        require(torch.equal(img_g, nd.permute(1, 2, 0)),
                f"viewer: K3 by the wrapper differs from raycast_nondiff on "
                f"{scene}")
        require(torch.equal(img_g, img_n) and torch.equal(comp_g, comp_n),
                f"viewer: K3 with the grid differs from K3 without it on "
                f"{scene}: {int((img_g != img_n).any(-1).sum())} pixels, "
                f"{int((comp_g != comp_n).sum())} composited counts")
        # K3 with the grid against the plain march with it, on the same
        # 800^2 rays.
        loads_p = torch.zeros((v_img, v_img), dtype=torch.int32, device=dev)
        (want, want_vis, want_comp), plain_ms = timed_once(
            lambda: P.march_nondiff_plain(vol_i, tf_i, rays, cfg_v, v_sr,
                                          grid, cell_loads=loads_p))
        max_err, frac_over, n_over = image_check(f"viewer {scene}", img_g,
                                                 want)
        comp_diff = count_check(f"viewer {scene} composited", comp_g,
                                want_comp)
        vis_diff = int((vis_g - want_vis).abs().max())
        n_knife = cell_load_check(f"viewer {scene}", k3_g, loads_p, vis_g,
                                  want_vis)
        raycast_ms, raycast_ms_no_grid = host_ms_ab(
            lambda: rc_v.raycast_nondiff(vol_user, tf_user, lf_v,
                                         sampling_rate=v_sr),
            lambda: rc_v_off.raycast_nondiff(vol_user, tf_user, lf_v,
                                             sampling_rate=v_sr), 5)
        k_ms = cuda_ms(lambda: P.march_nondiff(vol_i, tf_i, rays, cfg_v,
                                               v_sr, grid), 5)
        k_ms_no_grid = cuda_ms(lambda: P.march_nondiff(vol_i, tf_i, rays,
                                                       cfg_v, v_sr), 5)
        visited_g, visited_n = int(vis_g.sum()), int(vis_n.sum())
        composited = int(comp_g.sum())
        b_ms, b_by = bound(vol_bytes + grid_read_bytes(grid) + R * 16
                           + v_img * v_img * 48,
                           visited_g * NONDIFF_VISIT_OPS
                           + composited * NONDIFF_SHADE_OPS
                           + lookups(grid, visited_g, composited) * JUMP_OPS)
        emit({"phase": "viewer", "scene": scene, "image": v_img,
              "sampling_rate": v_sr, "camera": [0.0, 1.0, -2.3],
              "grid": {"shape": grid.shape, "cell": grid.cell},
              "launches": counts, "equal_to_no_grid": True,
              "samples_visited": visited_g,
              "samples_visited_no_grid": visited_n,
              "visited_ratio": visited_n / max(visited_g, 1),
              "samples_composited": composited,
              "k3_counts": k3_counts(k3_g, visited_g, composited, n_knife),
              "k3_counts_no_grid": k3_counts(k3_n, visited_n, composited,
                                             None),
              "max_n_samples": int(rays.n_samples.max()),
              "raycast_ms": raycast_ms,
              "raycast_ms_no_grid": raycast_ms_no_grid, "ms": k_ms,
              "ms_no_grid": k_ms_no_grid, "bound_ms": b_ms,
              "bound_by": b_by,
              "vs_plain": {"max_abs_err": max_err,
                           "pixels_over_2e-4": n_over,
                           "frac_over_2e-4": frac_over,
                           "composited_max_diff": comp_diff,
                           "visited_max_diff": vis_diff,
                           "plain_ms": plain_ms},
              "nvidia_smi": smi})
        kernels["march_nondiff"]["max_abs_err"] = max(
            kernels["march_nondiff"]["max_abs_err"], max_err)
        del vol_user, vol_i, grid, img_g, img_n, nd, want, want_vis
        del want_comp, k3_g, k3_n, loads_p
        torch.cuda.empty_cache()

    # -- 10. kernels line and the contract line ---------------------------------
    for name, k in kernels.items():
        require(k["launches"] > 0, f"{name} was never launched on its path")
    emit({"kernels": [dict(name=name, max_abs_diff=k["max_abs_err"], **k)
                      for name, k in kernels.items()],
          "nvidia_smi": smi})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
