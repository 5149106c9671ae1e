"""Shared fixture for the port's CPU tests (tests/test_torch_*.py).

The tier-1 suite runs in several worker processes at once.  PyTorch's
intra-op pool defaults to one thread per core in every worker, and its
threads spin while waiting, which oversubscribes the cores and slows
every worker.  The port's tests work on tiny tensors, so one thread
loses nothing.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
