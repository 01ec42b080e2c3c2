"""The benchmark's tests.  Tests that need a CUDA card take the ``card``
fixture, which skips them where there is none; whether there is a card is
decided inside the fixture, never while a module is imported.  On the card:
``python3 -m pytest bench_port/tests -m card``."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (runs the cells' sizes)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")
