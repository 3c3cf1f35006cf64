"""Host ms a step inside the program's ``dr.optim`` spans: the body of
``TFMomentum.step`` (under the profiler)."""
from dvrbench import program_spans


def read(trace):
    return program_spans.host_ms_per_unit(trace, "dr.optim")
