"""Host ms a step inside the program's ray setup: its ``dr.rays``
(``geometry.make_rays``) and ``dr.rays.soa`` (a march's flat ray state)
spans (under the profiler)."""
from dvrbench import program_spans


def read(trace):
    return program_spans.host_ms_per_unit(trace, "dr.rays")
