"""Lazy build and ctypes binding of the CUDA kernels in ``csrc/``.

The ``.cu`` sources have a plain C interface.  At first use they are compiled
for ``sm_90a`` with ``nvcc`` (one process per source, all started together)
and linked into ``build/torch_kernels/<hash>/libdifferender_kernels.so`` at
the repository root, keyed on a hash of the sources and flags, then loaded
with ``ctypes``.  Importing this module needs neither ``nvcc`` nor a GPU.
No ``--use_fast_math``: the parity with the JAX package relies on IEEE
``powf``, ``sqrtf`` and division.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from typing import Dict, List, Tuple

_PKG = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG, "csrc")
_SOURCES = ("tf_lookup.cu", "march.cu", "march_bwd.cu", "bricks.cu",
            "distance.cu", "shear_warp.cu")
_HEADERS = ("tf_lerp.cuh", "march_common.cuh")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
LIB_NAME = "libdifferender_kernels.so"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: str
    seconds: float        # wall time of this build; 0.0 if it was cached
    cached: bool
    ptxas: Dict[str, List[str]]   # source -> ptxas report lines


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "differender_tpu_torch are built at first use on a "
                       "machine with the CUDA toolkit")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES + _HEADERS:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _ptxas_lines(text: str) -> List[str]:
    return [ln.strip() for ln in text.splitlines()
            if re.search(r"ptxas info\s*:\s*(Function properties|Used|"
                         r"Compiling entry)", ln)
            or "spill" in ln]


def build() -> BuildInfo:
    """Compile and link the kernels unless a build of these sources exists."""
    out_dir = os.path.join(BUILD_ROOT, source_hash())
    lib = os.path.join(out_dir, LIB_NAME)
    report = os.path.join(out_dir, "ptxas.txt")
    if os.path.isfile(lib):
        ptxas = {}
        if os.path.isfile(report):
            with open(report) as f:
                for ln in f:
                    src, _, msg = ln.rstrip("\n").partition("\t")
                    ptxas.setdefault(src, []).append(msg)
        return BuildInfo(lib, 0.0, True, ptxas)

    nvcc = _nvcc()
    os.makedirs(BUILD_ROOT, exist_ok=True)
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="build-", dir=BUILD_ROOT)
    try:
        procs: List[Tuple[str, str, subprocess.Popen]] = []
        for src in _SOURCES:
            obj = os.path.join(tmp, src + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", os.path.join(_CSRC, src),
                   "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        ptxas, objs, failed = {}, [], []
        for src, obj, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src}:\n{out}")
            ptxas[src] = _ptxas_lines(out)
            objs.append(obj)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", os.path.join(tmp, LIB_NAME),
             *objs], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        with open(os.path.join(tmp, "ptxas.txt"), "w") as f:
            for src, lines in ptxas.items():
                for ln in lines:
                    f.write(f"{src}\t{ln}\n")
        for obj in objs:
            os.remove(obj)
        try:
            os.replace(tmp, out_dir)
        except OSError:
            # Another process finished the same build first.
            if not os.path.isfile(lib):
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return BuildInfo(lib, time.perf_counter() - t0, False, ptxas)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(build().path)
    i32, i64, ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    lib.dr_tf_lookup_fwd.argtypes = [ptr, ptr, ptr, i64, i32, i32, ptr]
    lib.dr_tf_lookup_fwd.restype = i32
    lib.dr_tf_lookup_bwd_plan.argtypes = [i64, i32, i32,
                                          ctypes.POINTER(i32),
                                          ctypes.POINTER(i64)]
    lib.dr_tf_lookup_bwd_plan.restype = i32
    lib.dr_tf_lookup_bwd.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32, i64,
                                     i32, i32, i32, ptr]
    lib.dr_tf_lookup_bwd.restype = i32
    for name in ("dr_march_diff_fwd", "dr_march_diff_bwd",
                 "dr_march_nondiff", "dr_shear_warp_fwd",
                 "dr_shear_warp_bwd"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, i32, ptr]
        fn.restype = i32
    lib.dr_brick_sums.argtypes = [ptr, i32, i32, i32, ptr, i32, ptr, i64,
                                  ptr, i32, ptr]
    lib.dr_brick_rows.argtypes = [ptr, i32, i64, ptr, i32, ptr, i64, ptr,
                                  i32, ptr]
    lib.dr_cell_minmax.argtypes = [ptr, i32, i32, i32, i32, i32, i32, i32,
                                   i32, ptr, ptr, i32, ptr]
    lib.dr_cell_distance.argtypes = [ptr, ptr, ptr, i32, ctypes.c_float,
                                     i32, i32, i32, i32, ptr, ptr, ptr, i32,
                                     ptr]
    for fn in (lib.dr_brick_sums, lib.dr_brick_rows, lib.dr_cell_minmax,
               lib.dr_cell_distance):
        fn.restype = i32
    lib.dr_error_string.argtypes = [i32]
    lib.dr_error_string.restype = ctypes.c_char_p
    return lib


def uses_plain(t) -> bool:
    """The device rule: a CPU tensor goes to the plain torch version, a CUDA
    tensor to the kernel; any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"differender_tpu_torch runs on CUDA (or, through the "
                     f"plain versions, on the CPU); got device {t.device}")


def stream_of(t) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def check(code: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry."""
    if code != 0:
        msg = library().dr_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} at launch: {msg}")
