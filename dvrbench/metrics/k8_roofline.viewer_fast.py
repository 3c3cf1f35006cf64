"""K8's share of its roofline over the traced window's first frames: the
least time of the work those frames' slab marches need
(``work_fast.k8_launch_work``) over the device time of the K8 launches
those frames made, in %."""


def read(trace):
    return trace.roofline("k8", ("shear_warp_fwd_kernel",))
