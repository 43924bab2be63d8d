"""The port's test files run their tiny tensors on one torch intra-op
thread: with several test workers on the CPU, a thread pool per worker
oversubscribes it many times over (the JAX reference files beside them
slow down too).  A test module takes it with
``from _torch_threads import one_thread  # noqa: F401``."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
