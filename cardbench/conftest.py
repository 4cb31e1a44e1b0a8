"""pytest settings of the benchmark's own tests (python -m pytest
cardbench/tests -q). Tests that need a CUDA card take the `card` fixture,
which decides at run time, never at import, whether to skip."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture(scope="session", autouse=True)
def run_environment():
    from cardbench.environment import prepare
    prepare()


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
