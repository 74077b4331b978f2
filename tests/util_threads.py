"""A fixture for the CPU tests that emulate the tensor-core kernels'
arithmetic (tc_pack.mm_3xtf32 and the sweeps built on it): thousands of
small products and roundings, each a parallel region of every core's
thread by default.  The test runner's workers share the host's cores, so
those regions wait on threads that other workers hold: a case that takes
seconds alone took minutes among six workers.  On one thread each small
step runs without waiting; the computations are the same."""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    """Each test of a module that imports this runs its torch operations
    on one thread; the thread count is restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
