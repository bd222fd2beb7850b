"""One PyTorch intra-op thread for the port's tests on the CPU.

The suite runs in several worker processes at once (pytest-xdist), and each
PyTorch process starts one intra-op thread per core.  The port's tests run
many small tensor operations, and with every worker's threads competing for
the same cores they spend most of their time waiting.  A test module that
imports `one_torch_thread` runs its tests on one thread and restores the
count after them; what the tests compute and check is unchanged.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
