"""``one_torch_thread``: an autouse fixture that runs a test module on one
torch thread (import it into the module).  The port's CPU tests run small
ops, far too small to gain from threads, and a worker of the parallel
suite whose ops wait on eight threads runs them tens of times slower than
one thread does; the count is restored for the worker's next module."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
