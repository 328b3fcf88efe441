"""pytest settings of the benchmark's own tests (python3 -m pytest
portbench/tests).  Tests that need a CUDA card carry the `chip` marker and
take the `cuda_card` fixture, which skips them where torch sees none."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card (skips where torch sees none)")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is false")
    return torch.device("cuda")
