"""The traced run: a ``torch.profiler`` window over a fixed number of steps
or frames, read back from its Chrome trace, and host spans closed by a sync.

Device kernels are told apart by name: the program's own kernels are plain
global functions (``march_diff_bwd_kernel<...>(...)``), PyTorch's live in
its namespaces (``at::native::...``, CUB, cuBLAS, cuDNN).  Each unit (a
step or a frame) runs inside a host range of its own, and a kernel belongs
to the unit whose range made its launch: the runtime's launch call, which
the profiler joins to the kernel by its ``correlation`` id.  So a kernel's
time per unit reads the same however many launches carry its work.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import time
from typing import Callable, Dict, List, Optional, Sequence

LIBRARY_KERNEL = re.compile(
    r"\b(at|c10|at_cuda_detail|cub|thrust|cutlass|cudnn|cublas\w*)::"
    r"|^(sm\d+_|cutlass|nvjet|cudnn|ampere_|cublas)")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "dvrbench.window"
UNIT = "dvrbench.unit"


def is_library_kernel(name: str) -> bool:
    return bool(LIBRARY_KERNEL.search(name))


def kernel_matches(name: str, idents: Sequence[str]) -> bool:
    """Whether a kernel's demangled name names one of ``idents``."""
    return any(re.search(rf"\b{re.escape(k)}\b", name) for k in idents)


class Trace:
    """The device activity of a traced window of ``units`` steps or
    frames, and what the harness adds to it: host spans (seconds per span
    name, summed over ``span_units`` units) and work (by kernel: the units
    whose work the job counted, ``steps``, and its least time,
    ``least_s``)."""

    def __init__(self, events: List[dict], units: int):
        self.units = units
        win = [e for e in events if e.get("name") == WINDOW
               and e.get("ph") == "X"]
        if not win:
            raise RuntimeError("the trace holds no window annotation")
        self.t0 = float(win[0]["ts"])
        self.t1 = self.t0 + float(win[0]["dur"])
        self.device = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
             e.get("name", ""), e.get("cat"))
            for e in events if e.get("ph") == "X"
            and e.get("cat") in DEVICE_CATS)
        self.unit_ranges = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
            for e in events if e.get("name") == UNIT and e.get("ph") == "X"
            and e.get("cat") == "user_annotation")
        launched = {e["args"]["correlation"]: float(e["ts"])
                    for e in events if e.get("ph") == "X"
                    and e.get("cat") in LAUNCH_CATS
                    and "correlation" in (e.get("args") or {})}
        kernels = sorted((
            (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
             e.get("name", ""), e.get("cat"),
             launched.get((e.get("args") or {}).get("correlation")))
            for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"
        ), key=lambda k: k[:4])
        self.kernels = [k[:4] for k in kernels]
        # The unit whose host range made each kernel's launch, or None.
        self.kernel_units = [self._unit_at(k[4]) for k in kernels]
        self.host_ops = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
             e.get("name", ""), e.get("cat"))
            for e in events if e.get("ph") == "X"
            and e.get("cat") in ("cpu_op", "user_annotation"))
        self.spans: Dict[str, float] = {}
        self.span_units = 0
        self.work: Dict[str, dict] = {}

    def _unit_at(self, ts: Optional[float]) -> Optional[int]:
        if ts is None:
            return None
        i = bisect.bisect_right(self.unit_ranges, (ts, float("inf"))) - 1
        if i >= 0 and ts <= self.unit_ranges[i][1]:
            return i
        return None

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def _intervals(self):
        """The union of device activity within the window, in us."""
        out = []
        for a, b, _, _ in self.device:
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self._intervals()) * 1e-6

    def kernel_ms_per_unit(self, idents: Optional[Sequence[str]] = None,
                           library: Optional[bool] = None
                           ) -> Optional[float]:
        """Device ms a unit of the kernels named ``idents`` (or, with
        ``library``, of PyTorch's kernels or of the others); None where the
        trace holds none."""
        sel = [k for k in self.kernels
               if (idents is None or kernel_matches(k[2], idents))
               and (library is None or is_library_kernel(k[2]) == library)]
        if not sel:
            return None
        return sum(b - a for a, b, _, _ in sel) * 1e-3 / self.units

    def launches_per_unit(self) -> Optional[float]:
        if not self.kernels:
            return None
        return len(self.kernels) / self.units

    def kernel_s_per_unit(self, idents: Sequence[str]) -> List[float]:
        """Device seconds of the kernels named ``idents`` that each unit
        launched, one entry a unit in the order they ran; a kernel launched
        outside every unit counts in none."""
        out = [0.0] * len(self.unit_ranges)
        for (a, b, name, _), u in zip(self.kernels, self.kernel_units):
            if u is not None and kernel_matches(name, idents):
                out[u] += (b - a) * 1e-6
        return out

    def roofline(self, work: str, idents: Sequence[str]) -> Optional[float]:
        """The share (%) of their roofline that the kernels named
        ``idents`` reach: the least time of the work the job counted
        (``self.work[work]``) over their device time in the units it
        counted.  None where it counted nothing, or where one of those
        units launched none of the kernels."""
        w = self.work.get(work)
        if not w or not w["steps"]:
            return None
        per = self.kernel_s_per_unit(idents)
        if max(w["steps"]) >= len(per):
            return None
        times = [per[s] for s in w["steps"]]
        if min(times) <= 0:
            return None
        return 100.0 * w["least_s"] / sum(times)

    def top_device_ops(self, count: int = 10):
        tot: Dict[str, float] = {}
        for a, b, name, _ in self.device:
            tot[name] = tot.get(name, 0.0) + (b - a) * 1e-6
        return [[k[:120], v] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:count]]

    def idle_gaps(self, count: int = 10):
        """The longest idle gaps of the device in the window, each labelled
        by the benchmark span and the outermost host op under way as it
        began."""
        iv = self._intervals()
        edges = [self.t0] + [x for ab in iv for x in ab] + [self.t1]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                       for i in range(0, len(edges) - 1, 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:count]
        out = []
        for dur, at in gaps:
            span, op = "", ""
            for a, b, name, cat in self.host_ops:
                if a > at:
                    break
                if b < at:
                    continue
                if cat == "user_annotation" and name.startswith("dvrbench.") \
                        and name not in (WINDOW, UNIT):
                    span = name[len("dvrbench."):]
                elif cat == "cpu_op" and not op:
                    op = name
            out.append([f"{span or 'loop'}:{op or 'python'}", dur * 1e-6])
        return out


def profile_units(run_unit: Callable[[int], None], units: int, sync,
                  path: str) -> Trace:
    """Runs ``run_unit(i)`` for ``i < units``, each in a unit annotation of
    its own, under the profiler (CPU and CUDA activity) inside a window
    annotation that ends after a sync, and reads the trace back."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            for i in range(units):
                with record_function(UNIT):
                    run_unit(i)
            sync()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    del prof
    sync()
    return Trace(events, units)


def annotate(name: str):
    """A named host range that shows in the trace."""
    from torch.profiler import record_function
    return record_function("dvrbench." + name)


class Spans:
    """Host time of named spans, each closed by a device sync."""

    def __init__(self, sync):
        self.sync = sync
        self.seconds: Dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.sync()
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t)
