"""``one_torch_thread``: a module-scoped autouse fixture for the port's CPU
test files.  A file that imports it runs its tests with one intra-op torch
thread: the reduced models' tensors are tiny, so one thread is faster than
a pool, and a pool per test worker oversubscribes the host's cores when the
suite runs its files in parallel (the port's steps then wait on spinning
threads)."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
