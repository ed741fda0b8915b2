"""Shared fixture of the PyTorch port's CPU tests.

The port's CPU tests run many small tensor ops. Torch's default pool of
one thread per core spins between them, and beside the suite's other
xdist workers that slows every worker on the machine (a 4 s module took
over 160 s). Each module that imports this runs torch on one thread.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
