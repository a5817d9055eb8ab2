"""The benchmark's own tests: CPU tests at small sizes, and tests marked
`card` that need an NVIDIA card and skip without one (decided in the
`card` fixture, never while a module is imported).

    python -m pytest benchmark/tests -q
"""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: this test runs on the card")
    return "cuda:0"
