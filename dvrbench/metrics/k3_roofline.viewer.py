"""K3's share of its roofline over the traced window's first frames: the
least time of the samples those frames composite (``work.k3_launch_work``)
over K3's device time in them, in %."""


def read(trace):
    w = trace.work.get("k3")
    if not w:
        return None
    times = trace.first_kernels(("march_nondiff_kernel",), w["launches"])
    if len(times) < w["launches"] or sum(times) <= 0:
        return None
    return 100.0 * w["least_s"] / sum(times)
