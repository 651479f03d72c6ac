"""The ``cuda`` marker, and the fixture that decides whether a card is
there (inside the test run, never at import)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one "
                   "(select with -m cuda)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: torch.cuda.is_available() is false")
    return torch.device("cuda:0")
