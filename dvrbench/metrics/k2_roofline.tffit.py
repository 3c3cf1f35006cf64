"""K2's share of its roofline in the traced fit: the least time of the work
a TF gradient needs at the fit's counted steps (``work_tf.k2_tf_launch_work``)
over the device time of the K2 launches those steps made, in %."""


def read(trace):
    return trace.roofline("k2_tf", ("march_diff_bwd_kernel",))
