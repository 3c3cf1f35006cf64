"""Device ms a frame of K3 (``march_nondiff``)."""


def read(trace):
    return trace.kernel_ms_per_unit(("march_nondiff_kernel",))
