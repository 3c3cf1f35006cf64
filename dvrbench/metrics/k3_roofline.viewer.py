"""K3's share of its roofline over the traced window's first frames: the
least time of the samples those frames composite (``work.k3_launch_work``)
over the device time of the K3 launches those frames made, in %."""


def read(trace):
    return trace.roofline("k3", ("march_nondiff_kernel",))
