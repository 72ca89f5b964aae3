"""Tests of the benchmark harness, on the CPU at small sizes; those marked
`card` need a CUDA device and skip here.  Run from the repository root:

    python -m pytest perfbench/tests -q -p no:cacheprovider

No JAX is imported: the benchmark never loads it."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    import torch

    config.addinivalue_line("markers", "card: needs a CUDA device (skips inside the test without one)")
    # Several workers share the host's cores.
    torch.set_num_threads(2)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
