"""One intra-op thread for the port's CPU tests.

The ``tests/test_torch_*.py`` modules import ``one_torch_thread``, a
module-scoped autouse fixture. Their tensors are small (~1k points, smoke
LM configs), too small for PyTorch to split an op across threads, while
the test run's workers share the host's cores: with every worker's OpenMP
threads on every core they spin against each other, and a 0.2 s smoke
decode loop took 10-20 s. The fixture restores the thread count when the
module ends.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
