"""The benchmark's own tests (python -m pytest cardbench/tests -q).

Tests that need an NVIDIA card carry the ``card`` marker and take the
``card`` fixture, which skips them without one; whether there is a card
is decided inside the fixture, never while a module is imported."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'card: needs an NVIDIA card (skipped without one)')


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card; this machine has none')
    return torch.device('cuda')
