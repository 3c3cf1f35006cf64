"""Device kernels launched a unit (step or frame), of every kind: the count
the host pays a launch for."""


def read(trace):
    return trace.launches_per_unit()
