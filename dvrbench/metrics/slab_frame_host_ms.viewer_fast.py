"""Host ms a frame inside the program's ``dr.fast.frame`` spans: the
shear-warp's slab frame before the march (the gradient volume, the
principal axis's permute and flip, the layers' copy, the grid and the
plane tables), under the profiler."""
from dvrbench import program_spans


def read(trace):
    return program_spans.host_ms_per_unit(trace, "dr.fast.frame")
