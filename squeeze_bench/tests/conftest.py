"""Tests of the benchmark.  Those that need a CUDA card carry the ``card``
marker and skip elsewhere; whether there is a card is decided inside the
``card`` fixture, never while a module is imported."""
import os
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; run on the chip with "
        "`python -m pytest -q -m card squeeze_bench/tests`")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")
