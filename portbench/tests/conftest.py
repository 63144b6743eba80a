"""The benchmark's own tests: ``python -m pytest portbench/tests -q``.

Tests marked ``card`` need an NVIDIA card and skip here with a reason;
on the card's machine they run with the same command."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the chip's machine)")
    return torch.device("cuda:0")
