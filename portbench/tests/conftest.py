"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` from
the root of the repository. Tests that need a CUDA card carry the ``card``
marker and skip without one; on the card's machine run them with
``python -m pytest portbench/tests -q -m card``."""

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
for p in (REPO, os.path.dirname(os.path.abspath(__file__))):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
