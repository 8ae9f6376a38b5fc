"""The benchmark's own tests: ``python -m pytest h100_bench/tests -q`` from
the root of the repository.  Tests marked ``card`` need an NVIDIA GPU and
skip elsewhere; whether there is one is decided inside the ``card`` fixture,
never while a module is imported."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU (skipped without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the card's tests run on the H100")
    return torch.device("cuda")
