"""pytest settings of the benchmark's own tests (``python -m pytest
benchmark/tests -q``). Tests marked ``card`` need a CUDA device: they skip
elsewhere, decided inside the ``card`` fixture, never at import."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (runs on the H100)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return torch.device("cuda", 0)
