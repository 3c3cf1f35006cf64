"""Host ms a frame inside the program's ``dr.fast.warp`` spans: the
bilinear warp of the intermediate image onto the pixels, its ray
directions included (under the profiler)."""
from dvrbench import program_spans


def read(trace):
    return program_spans.host_ms_per_unit(trace, "dr.fast.warp")
