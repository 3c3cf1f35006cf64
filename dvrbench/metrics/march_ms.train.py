"""Device ms a fitting step of K1 (``march_diff_fwd``) and K2
(``march_diff_bwd``)."""


def read(trace):
    return trace.kernel_ms_per_unit(("march_diff_fwd_kernel",
                                     "march_diff_bwd_kernel"))
