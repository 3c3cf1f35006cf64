"""K2's share of its roofline over the traced window's first steps: the
least time of the work those steps' views need (counted by the benchmark's
own pass, ``work.k2_launch_work``) over the device time of the K2 launches
those steps made, in %."""


def read(trace):
    return trace.roofline("k2", ("march_diff_bwd_kernel",))
