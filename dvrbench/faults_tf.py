"""The TF fit's faults and its size on the CPU, keyed by job, for callers
that import them from here.  The tables are ``FAULTS`` and ``SMALL`` of
``jobs/tffit.py``, which :func:`dvrbench.harness.faults` and
:func:`dvrbench.harness.small` read; this module only repeats them.
"""
from __future__ import annotations

from . import harness

FAULTS = {"tffit": harness.faults("tffit")}
SMALL = {"tffit": harness.small("tffit")}
