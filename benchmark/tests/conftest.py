"""The benchmark's own CPU checks: ``python -m pytest benchmark/tests -q``
from the root of the checkout. They run the harness on the CPU at tiny
sizes, the kernels' plain versions standing in for the card's."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)


@pytest.fixture(scope="session")
def rt():
    import torch

    import port

    torch.set_num_threads(1)
    return port.load(os.path.dirname(BENCH))
