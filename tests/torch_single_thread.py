"""One intra-op thread for the PyTorch port's CPU tests.

The plain blends run as many small tensor ops in a loop. Tier-1 runs six
test processes at once on the same cores, and there each op's intra-op
threads wait on one another: with PyTorch's default thread count the
long-list blend tests take many times longer than with one thread. Test
modules import this autouse fixture."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
