"""K2's share of its roofline in the traced fit: the least time of the work
a TF gradient needs at the fit's counted steps (``work_tf.k2_tf_launch_work``,
one K2 launch a step) over K2's device time at those steps, in %."""


def read(trace):
    w = trace.work.get("k2_tf")
    if not w:
        return None
    times = trace.first_kernels(("march_diff_bwd_kernel",), trace.units)
    if len(times) < trace.units:
        return None
    t = sum(times[s] for s in w["steps"])
    if t <= 0:
        return None
    return 100.0 * w["least_s"] / t
