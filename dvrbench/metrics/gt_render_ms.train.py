"""Host ms a step of the ground truth's render (``raycast_nondiff`` of the
clean volume: the occupancy grid and K3 for each view), the span closed by
a device sync, over steps run after the profiled ones."""


def read(trace):
    if not trace.span_units or "gt_render" not in trace.spans:
        return None
    return trace.spans["gt_render"] / trace.span_units * 1e3
