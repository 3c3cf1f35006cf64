"""Host ms a frame inside the program's ``dr.launch.*`` spans: each kernel
wrapper's operand checks, allocations and C call (under the profiler)."""
from dvrbench import program_spans


def read(trace):
    return program_spans.host_ms_per_unit(trace, "dr.launch.")
