"""Device ms a unit (step or frame) of PyTorch's kernels, those that are
not the program's own: ray setup, permutes, the loss, the optimizer."""


def read(trace):
    return trace.kernel_ms_per_unit(library=True)
