"""Of the device's idle time in the traced window, the share (%) during
which the host was inside one of the program's ``dr.`` spans; the rest
is the caller's."""
from dvrbench import program_spans


def read(trace):
    return program_spans.idle_share(trace)
