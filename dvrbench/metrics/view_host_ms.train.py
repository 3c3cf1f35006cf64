"""Host ms a step inside the program's ``dr.view`` spans: each single-view
render, its ray setup, grid and launches included (under the profiler)."""
from dvrbench import program_spans


def read(trace):
    return program_spans.host_ms_per_unit(trace, "dr.view")
