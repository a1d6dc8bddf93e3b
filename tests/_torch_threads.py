"""One PyTorch intra-op thread for the port's CPU tests.

The suite runs in several pytest-xdist workers at once, each of which
would otherwise start one intra-op thread per core: the workers' threads
then outnumber the cores many times over, and the small tensor operations
of the parity tests wait on each other (a narrow-ResNet Lanczos test took
307 s in 6 workers against 14 s with one thread each).  A test file takes
the fixture by importing it::

    from _torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)
