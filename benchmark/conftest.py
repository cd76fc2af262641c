"""pytest settings of the benchmark's own tests (``pytest benchmark/tests``).

Tests that need the card carry the ``card`` marker and take the ``card``
fixture, which skips them when no CUDA device is present; whether there is
one is decided there, when a test runs, never when a module is imported.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU; skipped on the CPU by the card fixture")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python3 -m pytest benchmark/tests -m card)")
    return torch.device("cuda")
