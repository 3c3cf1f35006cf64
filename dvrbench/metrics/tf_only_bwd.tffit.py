"""Launches a step of K2's TF-only instantiation: the program's
``dr.backward.tf_only`` spans."""
from dvrbench import program_spans


def read(trace):
    return program_spans.count_per_unit(trace, "dr.backward.tf_only")
