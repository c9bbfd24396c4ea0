"""Tests of the benchmark (``pytest portbench/``). Tests that need an NVIDIA
card carry the ``card`` marker and take the ``card`` fixture, which skips
them where no card is present; the rest run on the CPU at small sizes."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided when the test
    runs, never at collection)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return "cuda"
