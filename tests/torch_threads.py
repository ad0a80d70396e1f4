"""A fixture for the port's CPU test files: torch on one intra-op thread
while a module's tests run.

The port's tests run tiny shapes, many JAX compiles among them, in six
pytest-xdist workers on one host.  Torch's default intra-op pool (one
thread a core in every worker) then oversubscribes the cores: its threads
wait spinning on the cores the other workers' compiles need, and a file's
tests take about twice their single-threaded time.  Each port test file
imports :func:`one_torch_thread`, which pytest applies to every test of
the module; the thread count is restored after the module."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
