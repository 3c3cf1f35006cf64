"""Tracing and profiling utilities (counterpart of
``differender_tpu/profiling.py``).

The JAX package's XLA device traces become ``torch.profiler`` traces: CPU
activity, and the card's kernels for a CUDA device, written into a
directory as a Chrome trace (viewable in ``chrome://tracing``, Perfetto or
TensorBoard).  The reference's march-length diagnostics live on as
``RenderOutput.valid_steps`` and :func:`march_stats`.

:func:`span` is the program's one host range: a ``record_function`` while
a ``torch.profiler`` session records (so it lies on the clock of the card's
kernels in the same trace), else a shared null context that costs a check
of the profiler's state.  The package opens these spans:

- ``dr.raycaster``: the body of ``Raycaster.forward_with_aux``,
  ``raycast_nondiff`` and ``raycast_fast`` (input conversion, broadcast
  copies, the loop over views, stack and permute);
- ``dr.view``: one single-view render (``render``, ``render_nondiff``,
  ``render_fast`` and their strip, depth-sorted and sharded forms);
  ``dr.view.batch``: one ``render_nondiff_batch``, the inference render of
  a batch of views of one volume and TF (one grid, one K3 launch), or one
  ``render_batch``, their differentiable render (one K1 launch);
- ``dr.fast.frame``: inside a shear-warp ``dr.view`` (``render_fast``,
  its plain and sharded forms), the slab frame before the march: the
  gradient volume, the principal axis's permute and flip, the voxel
  layers' copy, the grid, the plane tables and the exponent
  (``fastpath._frame``, ``fastpath._slab_inputs``); ``dr.fast.warp``: the
  bilinear warp of the intermediate image onto the pixels
  (``fastpath._warp_to_image``);
- ``dr.rays``: ``geometry.make_rays``; ``dr.rays.soa``: a march's flat ray
  state (``render._ray_soa``);
- ``dr.grid``: ``occupancy.build_occupancy``;
- ``dr.launch.<kernel>``: the host side of one kernel wrapper's call on
  the card, from its operand checks to the C call's return, ``<kernel>``
  its name in ``_build.KERNELS`` (``_build.launch`` opens the span and
  counts the launch, so each span is one count of
  :func:`~differender_tpu_torch.launch_counts`);
- ``dr.backward``: the backward of each autograd Function that launches a
  kernel (the march, one for a batch of views with a K2 launch a view
  inside, its segment, the shear-warp march, the TF lookup);
  ``dr.backward.tf_only``: inside the march's, the launch of K2's TF-only
  instantiation (the volume and the camera need no gradient);
- ``dr.loss``: ``losses.dssim_mse_loss`` and ``losses.mse_loss``;
- ``dr.optim``: the body of ``optim.TFMomentum.step``;
- ``dr.sync``: each host-device sync that the package makes on its own:
  a tensor made from host data on the card (a copy that waits for the
  stream; ``geometry.make_rays`` makes its four constant vectors once per
  device and values, then reuses them), a camera read on the host, a
  policy's statistic, a collective's flags, a plain march's ``nonzero``.

Counted per step or frame in a trace, ``dr.view``, ``dr.view.batch``,
``dr.grid``, ``dr.launch.*``, ``dr.backward.tf_only`` and ``dr.sync`` are
the views rendered one by one, the batches of views, the grids built, the
program's launches, K2's TF-only launches and its syncs.
"""
from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import torch
from torch.profiler import record_function


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


_NULL = contextlib.nullcontext()
_recording = torch.autograd._profiler_enabled


def span(name: str):
    """A named host range (``with span("dr.view"): ...``) that shows in a
    ``torch.profiler`` trace beside the card's kernels; outside a profiler
    session a shared null context."""
    if _recording():
        return record_function(name)
    return _NULL


annotate = span


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


__all__ = ["trace", "span", "annotate", "timed", "march_stats"]
