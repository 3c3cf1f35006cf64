#!/usr/bin/env python3
"""Time variants of the shear-warp kernels K8 and K9 against each other on
one CUDA card.

Usage, from the repository root, on a machine with an sm_90a card, nvcc and
PyTorch built for CUDA::

    python3 tools/shear_warp_variants.py [NAME=DIR ...]

Each DIR holds a ``shear_warp.cu`` and the ``tf_lerp.cuh`` it includes,
for example a commit's kernels unpacked with ``git archive <commit>
differender_tpu_torch/csrc | tar -x -C <dir>`` (then DIR is
``<dir>/differender_tpu_torch/csrc``).  The repository's own kernels are
the variant ``repo``.  Each source is built with nvcc for sm_90a into a
library of its own; the argument struct is read from the source, so a
variant that takes the slab stack ``(S, X, Y, 4)`` (field ``slabs``, as
the kernels did before the z-lerp moved into them) runs beside one that
takes the voxel layers ``(Z, X, Y, 4)`` (field ``layers``).

Views: the bench (256^3 noise and ct_phantom, 512^2, O = 576, 2 planes
per voxel, camera (1.2, 0.8, 2.0)) and the viewer (the synthetic volume
and ct_phantom at 256^3, 800^2, O = 1024, camera (0, 1, -2.3)).  At each
view every variant's K8 is timed by CUDA events around 10 back-to-back
calls of its C entry (median of 10 such pairs, after 2 warm calls), and at
the bench also its K9 on the cotangent of mean(image^2)'s step (4 calls a
pair, 5 pairs); the variants take turns, first in the order given and then
reversed, and each variant's time is the median over both turns.  Each
variant's image must equal the repository's bit for bit and its gradients
must lie within 1e-4 * max|g| of the repository's (a stack variant's
gradient pulled through the z-lerp).  One JSON line per view, then the
card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_TOL = 1e-4


def parse_struct(src: str):
    """The fields of ``struct ShearWarpArgs`` in order, as (name, ctype)."""
    body = re.search(r"struct ShearWarpArgs \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        m = re.match(r"(const\s+)?(float|int)\s*(\*?)\s*(.*)", decl, re.S)
        kind = (ctypes.c_void_p if m.group(3)
                else ctypes.c_float if m.group(2) == "float"
                else ctypes.c_int)
        fields += [(n.strip(), kind) for n in m.group(4).split(",")]
    return fields


class Variant:
    """One build of shear_warp.cu, its C entries and its argument struct."""

    def __init__(self, name, csrc, lib):
        with open(os.path.join(csrc, "shear_warp.cu")) as f:
            fields = parse_struct(f.read())
        self.name = name
        self.names = [n for n, _ in fields]
        self.Args = type("Args_" + name, (ctypes.Structure,),
                         {"_fields_": fields})
        self.lib = ctypes.CDLL(lib)
        for fn in (self.lib.dr_shear_warp_fwd, self.lib.dr_shear_warp_bwd):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int

    def args(self, values):
        a = self.Args()
        for n, kind in self.Args._fields_:
            v = values.get(n)
            if kind is ctypes.c_void_p:
                setattr(a, n, None if v is None else v.data_ptr())
            else:
                setattr(a, n, v)
        return a


def build(variants, out_dir):
    """nvcc for every variant at once: {name: library path}."""
    from differender_tpu_torch import _build
    procs = {}
    for name, csrc in variants.items():
        lib = os.path.join(out_dir, f"{name}.so")
        cmd = [_build._nvcc(), *_build.ARCH, "-std=c++17", "-O3",
               "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v",
               os.path.join(csrc, "shear_warp.cu"), "-o", lib]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs, ptxas = {}, {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        libs[name] = lib
        ptxas[name] = [ln.strip() for ln in out.splitlines()
                       if "registers" in ln or "spill" in ln]
    return libs, ptxas


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("shear_warp_variants: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import differender_tpu_torch as P
    from differender_tpu_torch import fastpath as PF

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    variants = {"repo": os.path.join(ROOT, "differender_tpu_torch", "csrc")}
    for arg in argv:
        name, _, d = arg.partition("=")
        variants[name] = os.path.abspath(d)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="sw_variants_",
                               dir=os.path.join(ROOT, "build"))
    libs, ptxas = build(variants, out_dir)
    vs = [Variant(n, variants[n], libs[n]) for n in variants]
    print(json.dumps({"ptxas": ptxas}), flush=True)

    def sync():
        torch.cuda.synchronize(dev)

    def timed(calls, reps, per_pair):
        """{variant: ms} of one call, the variants in turns, both orders."""
        for fn in calls.values():
            for _ in range(2):
                fn()
        sync()
        times = {n: [] for n in calls}
        for order in (list(calls), list(reversed(list(calls)))):
            for n in order:
                pairs = []
                for _ in range(reps):
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    for _ in range(per_pair):
                        calls[n]()
                    b.record()
                    pairs.append((a, b))
                sync()
                times[n] += [a.elapsed_time(b) / per_pair for a, b in pairs]
        return {n: statistics.median(t) for n, t in times.items()}

    def check(code, what):
        if code:
            raise RuntimeError(f"{what}: CUDA error {code}")

    res = 256
    R = 128
    tf = P.tf_to_internal(P.get_tf_torch_layout("tf1", R, device=dev))
    tf = tf.contiguous()
    views = [("bench", "noise", lambda: P.noise_volume(res, seed=0),
              (1.2, 0.8, 2.0), (512, 512), 576, True),
             ("bench", "ct_phantom", lambda: P.ct_phantom(res),
              (1.2, 0.8, 2.0), (512, 512), 576, True),
             ("viewer", "synthetic", lambda: P.synthetic_volume(res),
              (0.0, 1.0, -2.3), (800, 800), 1024, False),
             ("viewer", "ct_phantom", lambda: P.ct_phantom(res),
              (0.0, 1.0, -2.3), (800, 800), 1024, False)]
    for view, scene, make, cam, hw, O, bwd in views:
        vol = P.volume_to_internal(
            torch.from_numpy(make()).to(dev)).contiguous()
        lf = torch.tensor(cam, device=dev)
        cfg = P.RenderConfig(volume_shape=(res,) * 3, image_shape=hw,
                             tf_resolution=R, jitter=False)
        ch, lf_f, light_f, perm, sign = PF._frame(vol, lf)
        layers, geom, ext = PF._slab_inputs(ch, lf_f, light_f, cfg, O, 2.0)
        del ch
        Z, X, Y, _ = layers.shape
        values = dict(geom._asdict(), layers=layers, tf=tf, S=geom.zws.numel(),
                      X=X, Y=Y, rows=O, O=O, R=R)
        if any("slabs" in v.names for v in vs):
            fz = geom.fz[:, None, None, None]
            values["slabs"] = (
                torch.index_select(layers, 0, geom.zlo.long()) * (1.0 - fz)
                + torch.index_select(layers, 0, geom.zhi.long()) * fz)
        outs, calls = {}, {}
        for v in vs:
            inter = torch.empty((O, O, 4), device=dev)
            a = v.args(dict(values, inter=inter))
            check(v.lib.dr_shear_warp_fwd(ctypes.byref(a), dev.index or 0,
                                          None), v.name)
            outs[v.name] = inter
            calls[v.name] = (lambda v=v, a=a: check(v.lib.dr_shear_warp_fwd(
                ctypes.byref(a), dev.index or 0, None), v.name))
        sync()
        ref = outs["repo"]
        line = {"view": view, "scene": scene, "intermediate": O,
                "planes": geom.zws.numel(),
                "image_bitwise_repo": {n: bool(torch.equal(o, ref))
                                       for n, o in outs.items()},
                "k8_ms": timed(calls, 10, 10)}
        if bwd:
            leaf = ref.clone().requires_grad_(True)
            img, _ = PF._warp_to_image(leaf, ext, lf, cfg, perm, sign)
            g, = torch.autograd.grad(torch.mean(img ** 2), leaf)
            g = g.contiguous()
            grads, calls = {}, {}
            for v in vs:
                d_tf = torch.zeros_like(tf)
                d_out = torch.zeros_like(
                    values["slabs"] if "slabs" in v.names else layers)
                a = v.args(dict(values, inter=ref, grad=g, d_tf=d_tf,
                                d_slabs=d_out, d_layers=d_out))
                check(v.lib.dr_shear_warp_bwd(ctypes.byref(a),
                                              dev.index or 0, None), v.name)
                sync()
                if "slabs" in v.names:
                    d_l = torch.zeros_like(layers)
                    d_l.index_add_(0, geom.zlo.long(),
                                   d_out * (1.0 - geom.fz[:, None, None,
                                                          None]))
                    d_l.index_add_(0, geom.zhi.long(),
                                   d_out * geom.fz[:, None, None, None])
                    d_out = d_l
                grads[v.name] = (d_out, d_tf.clone())
                calls[v.name] = (
                    lambda v=v, a=a: check(v.lib.dr_shear_warp_bwd(
                        ctypes.byref(a), dev.index or 0, None), v.name))
            errs = {}
            for n, got in grads.items():
                errs[n] = []
                for x, y in zip(got, grads["repo"]):
                    m = float(y.abs().max())
                    errs[n].append(float((x - y).abs().max()) / m)
            line["grad_rel_err_vs_repo_d_layers_d_tf"] = errs
            line["k9_ms"] = timed(calls, 5, 4)
            bad = [n for n, e in errs.items() if max(e) > GRAD_TOL]
            if bad:
                print(json.dumps(line), flush=True)
                raise RuntimeError(f"gradients of {bad} differ from repo's")
            del grads, d_out, d_tf
        print(json.dumps(line), flush=True)
        if not all(line["image_bitwise_repo"].values()):
            raise RuntimeError(f"{view} {scene}: an image differs")
        del layers, geom, values, outs, calls, vol
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"nvidia_smi": smi,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
