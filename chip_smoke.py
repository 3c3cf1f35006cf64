#!/usr/bin/env python3
"""Drive the renderer's main path on one CUDA card and check every kernel.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine with
an NVIDIA H100 (sm_90a), the CUDA toolkit and PyTorch built for CUDA.

Phases (one JSON line each):
  1. device: card name and power limit, build time and the ``-Xptxas -v``
     report of each kernel (the kernels are built here from ``csrc/``).
  2. tf_lookup_fwd (K0) through ``tf_lookup`` at 2^23 intensities, R = 128
     and 4096, against ``tf_lookup_reference``, timed beside ``grid_sample``.
  3. march_diff_fwd (K1) through ``Raycaster.forward`` at the bench workload
     (256^3 volume, tf1 at R = 128, 512^2 image, max_samples 512, sr 1,
     jittered), on a noise volume and on a CT phantom, against
     ``march_diff_plain``.
  4. march_nondiff (K3) through ``Raycaster.raycast_nondiff`` (sr 4) on both
     scenes against ``march_nondiff_plain``.
  5. profile: device time by kernel and the busy share of both entry
     points on the noise scene (torch.profiler).
  6. golden: the card's renders of the sphere fixtures of
     ``tests/golden_renders.npz``.
  7. the ``kernels`` line, then the contract line as the last line.
Launch counts are reset just before each entry point is driven and read just
after; launches made to compare or time a kernel do not count.  Any failed
check raises, so the script exits non-zero and prints no result.  It also
exits non-zero where ``torch.cuda.is_available()`` is false.

Bounds use the H100 SXM's published peaks: 3.35 TB/s of HBM and 67 TFLOP/s
of f32 outside the tensor cores.
"""
from __future__ import annotations

import json
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

ROOT = os.path.dirname(os.path.abspath(__file__))


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
        return {"wall_ms": wall, "device_ms": dev_ms if kern else None,
                "busy_share": dev_ms / wall if kern else None,
                "n_kernels": len(kern),
                "top": [[k[:60], ms] for k, ms in kern[:5]]}

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

    kernels = {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

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

    # -- 3./4. K1 and K3 through the Raycaster ---------------------------------
    res, img, R = 256, 512, 128
    rc = P.Raycaster((res, res, res), (img, img), R, sampling_rate=1.0,
                     jitter=True, max_samples=512, seed=0)
    cfg = rc.config
    tf_user = P.get_tf_torch_layout("tf1", R, device=dev)
    tf_i = P.tf_to_internal(tf_user).contiguous()
    lf = torch.tensor([1.2, 0.8, 2.0], device=dev)
    scenes = {"noise": lambda: P.noise_volume(res, seed=0),
              "ct_phantom": lambda: P.ct_phantom(res)}
    for name, replaces in (("march_diff_fwd", "differender_tpu/render.py:395"),
                           ("march_nondiff", "differender_tpu/render.py:642")):
        kernels[name] = dict(
            route="cuda", source="differender_tpu_torch/csrc/march.cu",
            replaces=replaces, launches=0, max_abs_err=0.0, library_ms=None)

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
        fwd_ms = host_ms(lambda: rc.forward(vol_user, tf_user, lf, u=u), 7)
        k_ms = cuda_ms(lambda: P.march_diff(vol_i, tf_i, rays, cfg, 1.0), 10)
        p_ms = cuda_ms(lambda: P.march_diff_plain(vol_i, tf_i, rays, cfg,
                                                  1.0), 2, warm=0)
        b_ms, b_by = bound(vol_bytes + R * 16 + ray_bytes + img * img * 20,
                           samples * DIFF_SAMPLE_OPS)
        emit({"phase": "march_diff_fwd", "scene": scene, "image": img,
              "launches": launches, "max_abs_err": max_err,
              "pixels_over_2e-4": n_over, "frac_over_2e-4": frac_over,
              "valid_steps_max_diff": steps_diff,
              "noert_max_abs_err": noert_err, "samples": samples,
              "forward_ms": fwd_ms, "ms": k_ms, "plain_ms": p_ms,
              "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
              "nvidia_smi": smi})
        record("march_diff_fwd", scene, launches, max_err, k_ms, p_ms, b_ms,
               b_by)

        # K3: the inference path.
        P.reset_launch_counts()
        nd = rc.raycast_nondiff(vol_user, tf_user, lf)
        sync()
        launches = P.launch_counts()["march_nondiff"]
        require(launches == 1, f"raycast_nondiff launched K3 {launches}x")
        require(nd.shape == (4, img, img) and bool(torch.isfinite(nd).all())
                and float(nd.min()) >= 0.0 and float(nd.max()) <= 1.0,
                f"K3 image shape/range on {scene}")
        sr = 4.0
        rays = P.make_rays(lf, cfg, sr)
        want, want_vis, want_comp = P.march_nondiff_plain(vol_i, tf_i, rays,
                                                          cfg, sr)
        max_err, frac_over, n_over = image_check(
            f"K3 {scene}", nd.permute(1, 2, 0), want)
        _, vis, comp = P.march_nondiff(vol_i, tf_i, rays, cfg, sr)
        vis_diff = count_check(f"K3 {scene} visited", vis, want_vis)
        comp_diff = count_check(f"K3 {scene} composited", comp, want_comp)
        visited, composited = int(vis.sum()), int(comp.sum())
        fwd_ms = host_ms(lambda: rc.raycast_nondiff(vol_user, tf_user, lf), 7)
        k_ms = cuda_ms(lambda: P.march_nondiff(vol_i, tf_i, rays, cfg, sr), 10)
        p_ms = cuda_ms(lambda: P.march_nondiff_plain(vol_i, tf_i, rays, cfg,
                                                     sr), 1, warm=0)
        b_ms, b_by = bound(vol_bytes + R * 16 + ray_bytes + img * img * 24,
                           visited * NONDIFF_VISIT_OPS
                           + composited * NONDIFF_SHADE_OPS)
        emit({"phase": "march_nondiff", "scene": scene, "image": img,
              "sampling_rate": sr, "launches": launches,
              "max_abs_err": max_err, "pixels_over_2e-4": n_over,
              "frac_over_2e-4": frac_over, "visited_max_diff": vis_diff,
              "composited_max_diff": comp_diff,
              "samples_visited": visited,
              "samples_composited": composited, "raycast_ms": fwd_ms,
              "ms": k_ms, "plain_ms": p_ms, "library_ms": None,
              "bound_ms": b_ms, "bound_by": b_by, "nvidia_smi": smi})
        record("march_nondiff", scene, launches, max_err, k_ms, p_ms, b_ms,
               b_by)
        if scene == "noise":
            emit({"phase": "profile", "scene": scene,
                  "forward": profile(
                      lambda: rc.forward(vol_user, tf_user, lf, u=u)),
                  "raycast_nondiff": profile(
                      lambda: rc.raycast_nondiff(vol_user, tf_user, lf)),
                  "nvidia_smi": smi})
        del vol_user, vol_i

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
    emit({"phase": "golden", "diff_max_abs_err": d_err,
          "nondiff_max_abs_err": n_err})

    # -- 7. kernels line and the contract line ----------------------------------
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
