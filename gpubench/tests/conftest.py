"""The benchmark's tests: its layout and rules, its references against
the port's plain path at small sizes on the CPU, and its controls and
planted faults, which must come out not correct. Tests that need an
NVIDIA card carry the ``card`` marker and the ``cuda_card`` fixture,
which skips them where there is none; run them on the card with

    python3 -m pytest gpubench/tests -q -m card
"""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA CUDA card (skips without one)")


@pytest.fixture
def cuda_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card; this machine has none")
    return torch.device("cuda")
