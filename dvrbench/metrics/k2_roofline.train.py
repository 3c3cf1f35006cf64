"""K2's share of its roofline over the traced window's first steps: the
least time of the work those steps' views need (counted by the benchmark's
own pass, ``work.k2_launch_work``) over K2's device time in them, in %."""


def read(trace):
    w = trace.work.get("k2")
    if not w:
        return None
    times = trace.first_kernels(("march_diff_bwd_kernel",), w["launches"])
    if len(times) < w["launches"] or sum(times) <= 0:
        return None
    return 100.0 * w["least_s"] / sum(times)
