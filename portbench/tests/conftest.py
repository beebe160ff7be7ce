"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` from
the root of a checkout; on a machine with a CUDA card the tests marked
``card`` run too."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is present (decided here, when the
    test runs, never while a module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    return torch.device("cuda")
