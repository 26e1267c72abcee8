"""Tests of the benchmark's harness, on the CPU at tiny sizes.

``chip`` marks a test that needs a CUDA card: it skips here, decided
inside its fixture (never while a module is imported).  Run them on the
card with ``python -m pytest portbench/tests -m chip``.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skipped without one")


@pytest.fixture
def cuda_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark's cells run on the card")
    return torch.cuda.get_device_name(0)
