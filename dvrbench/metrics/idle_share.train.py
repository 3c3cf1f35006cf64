"""The share of the traced window in which no operation ran on the device,
in %."""


def read(trace):
    if trace.window_s <= 0 or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
