"""The benchmark's own tests: on the CPU at tiny sizes, with one PyTorch
thread.  A test that needs the card takes the ``card`` fixture, which
skips it (with the reason) where there is none; the ``chip`` marker names
such tests:

    python -m pytest benchmark/tests -q            # here
    python -m pytest benchmark/tests -q -m chip    # on the card
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this host has none")
    return torch.device("cuda")
