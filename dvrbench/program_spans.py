"""The program's own host spans in a traced window: the ``dr.`` ranges that
``differender_tpu_torch.profiling.span`` opens while a profiler records,
taken from ``Trace.host_ops`` (the ``user_annotation`` events, on any
thread) and read against the device's activity on the same clock.

Host times here are read under the profiler, which inflates them: they
compare across commits, not with the untraced ``step_ms`` or ``frame_ms``.
Each function returns None where the window holds no span it reads (a
program without the spans).
"""
from __future__ import annotations

from typing import List, Optional

PREFIX = "dr."


def _union(ranges) -> List[List[float]]:
    """The union of ``(a, b)`` ranges, sorted and disjoint."""
    out: List[List[float]] = []
    for a, b in sorted(ranges):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _spans(trace, prefix: str):
    return [(a, b, name) for a, b, name, cat in trace.host_ops
            if cat == "user_annotation" and name.startswith(prefix)
            and trace.t0 <= a < trace.t1]


def intervals(trace, prefix: str = PREFIX) -> List[List[float]]:
    """The union, in us, of the spans named ``prefix...`` that begin in
    the window, each clipped to it."""
    return _union((a, min(b, trace.t1)) for a, b, _ in _spans(trace, prefix))


def host_ms_per_unit(trace, prefix: str) -> Optional[float]:
    """Host ms a unit inside the spans named ``prefix...`` (their union,
    so nested and concurrent spans count once)."""
    iv = intervals(trace, prefix)
    if not iv:
        return None
    return sum(b - a for a, b in iv) * 1e-3 / trace.units


def count_per_unit(trace, name: str) -> Optional[float]:
    """Spans named exactly ``name`` a unit."""
    n = sum(1 for _, _, s in _spans(trace, name) if s == name)
    return n / trace.units if n else None


def idle_share(trace) -> Optional[float]:
    """Of the device's idle time in the window, the share (%) during which
    the host was inside some ``dr.`` span; the rest is the caller's (the
    job, the autograd engine, the optimizer)."""
    spans = intervals(trace)
    if not spans:
        return None
    edges = ([trace.t0] + [x for ab in trace._intervals() for x in ab]
             + [trace.t1])
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    total = sum(b - a for a, b in idle)
    if total <= 0:
        return None
    inside, j = 0.0, 0
    for a, b in idle:
        while j < len(spans) and spans[j][1] <= a:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < b:
            inside += min(b, spans[k][1]) - max(a, spans[k][0])
            k += 1
    return 100.0 * inside / total
