"""Tracing and profiling utilities (counterpart of
``differender_tpu/profiling.py``).

The JAX package's XLA device traces become ``torch.profiler`` traces: CPU
activity, and the card's kernels for a CUDA device, written into a
directory as a Chrome trace (viewable in ``chrome://tracing``, Perfetto or
TensorBoard).  The reference's march-length diagnostics live on as
``RenderOutput.valid_steps`` and :func:`march_stats`.
"""
from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str, device="cuda") -> Iterator[torch.profiler.profile]:
    """Trace the block into ``log_dir``: CPU activity and, for a CUDA
    ``device``, the card's (a missing card raises)::

        with profiling.trace("traces"):
            render(...).image
            torch.cuda.synchronize()

    Yields the profiler, whose ``key_averages()`` sums the block by name;
    the trace file (``*.pt.trace.json``) is written when the block ends."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("profiling.trace: no CUDA card to trace; "
                               "pass device='cpu' for a CPU trace")
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof


def annotate(name: str):
    """Named scope that shows up in profiler timelines (host and card)."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def timed(name: str, results: Optional[dict] = None) -> Iterator[None]:
    """Wall-clock a block.  Measures host wall time only: callers must
    ``torch.cuda.synchronize()`` inside the block to include the card's
    work."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if results is not None:
            results[name] = dt
        else:
            print(f"[timed] {name}: {dt * 1e3:.2f} ms")


def march_stats(render_output) -> dict:
    """Reference-style march diagnostics of a ``RenderOutput``
    (``valid_sample_step_count`` semantics)."""
    valid = render_output.valid_steps.detach().cpu().numpy() - 1
    n = render_output.n_samples.detach().cpu().numpy()
    return {
        "max_valid_steps": int(valid.max()),
        "mean_valid_steps": float(valid.mean()),
        "max_samples_requested": int(n.max()),
        "hit_fraction": float((n > 0).mean()),
        "terminated_early_fraction": float(((valid < n) & (n > 0)).mean()),
    }


__all__ = ["trace", "annotate", "timed", "march_stats"]
