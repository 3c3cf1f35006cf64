"""Occupancy grids built a step: the program's ``dr.grid`` spans
(``build_occupancy``)."""
from dvrbench import program_spans


def read(trace):
    return program_spans.count_per_unit(trace, "dr.grid")
