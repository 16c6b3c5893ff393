"""Tests of the benchmark's harness, on the CPU at small sizes. Those marked
``card`` need a CUDA GPU and skip without one; the decision is made in the
``card`` fixture, when a test runs, never at import."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA GPU (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda", 0)
