"""Batched inference renders a step: the program's ``dr.view.batch``
spans (``render_nondiff_batch``: the ground truth's views of one volume
and TF through one occupancy grid and one K3 launch)."""
from dvrbench import program_spans


def read(trace):
    return program_spans.count_per_unit(trace, "dr.view.batch")
