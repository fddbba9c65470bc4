"""The benchmark's own tests: `python -m pytest benchmark -q` on the CPU;
the tests marked `gpu` run where a CUDA card is (`-m gpu`)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; the test skips itself where there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
