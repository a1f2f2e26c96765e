"""Test set-up for portbench: its folder and the program's ``src/`` on the
path, the ``card`` marker, and the fixture that skips a card test where no
CUDA card is visible (decided when the test runs, never at import)."""
import os
import sys

import pytest

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PORTBENCH)
for p in (os.path.join(ROOT, "src"), PORTBENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; run on a machine with one: "
                                       "`python -m pytest portbench/tests -m card`")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
