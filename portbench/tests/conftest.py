"""The benchmark's tests. Tests marked ``card`` need a CUDA card and
skip without one (the ``card`` fixture decides, at run time); run them
on the card with ``python -m pytest portbench/tests -m card``."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the port "
                    "on the card only")
    return torch.device("cuda", 0)
