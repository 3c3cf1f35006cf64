"""Device ms a frame of the occupancy grid's build: K6 (``cell_minmax``)
and K7 (``cell_distance``: its z and line passes)."""


def read(trace):
    return trace.kernel_ms_per_unit(("cell_minmax_kernel", "z_pass",
                                     "line_pass"))
