"""Adds the jobs whose faults and small sizes live beside their job
(:mod:`dvrbench.faults_tf`) to the tables that the harness's tests in
``dvrbench/tests`` index by every cell's job: ``faults.FAULTS`` here, and
the tests' ``SMALL`` as their own ``conftest.py`` registers."""
from dvrbench import faults, faults_tf

for _job, _faults in faults_tf.FAULTS.items():
    faults.FAULTS.setdefault(_job, _faults)


def pytest_plugin_registered(plugin, manager):
    small = getattr(plugin, "SMALL", None)
    if isinstance(small, dict):
        for job, overrides in faults_tf.SMALL.items():
            small.setdefault(job, overrides)
