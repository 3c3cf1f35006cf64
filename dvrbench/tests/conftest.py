"""Tests of the benchmark's harness.  Run from the repository's root:

    python -m pytest dvrbench/tests -q

On a machine without a CUDA card the tests marked ``card`` skip; on the
chip they run the control at the cells' own sizes.
"""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none")


@pytest.fixture
def card():
    """Skips the test where no CUDA card is present (decided when the test
    runs, never when the module is imported)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells' own sizes run on the chip")


@pytest.fixture(autouse=True)
def _threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
