"""Test settings of the benchmark's own tests (`python -m pytest gpbench/tests`):
the `card` marker and the fixture that skips a card-only test where there
is no CUDA device, decided when the test runs, never at import."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (runs on the chip)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the program's TF32 path and its kernels run only "
                    "on the card")
    return torch.device("cuda", 0)
