"""Device ms a frame of K8 (``shear_warp_fwd``)."""


def read(trace):
    return trace.kernel_ms_per_unit(("shear_warp_fwd_kernel",))
