"""Torch's CPU thread count for one test module.

CPU reductions (and so maps, renders and ICP poses) depend on the count
of torch threads. A count set when a module is imported holds only until
the next module is imported or a test changes it, and under xdist every
worker imports every module first. So each port test module that needs a
count declares it with::

    from torch_threads import threads

    torch_threads = threads(2)

which sets the count while the module's tests run and restores the count
it found after them.
"""

import pytest
import torch


def threads(n: int):
    """A module-scoped autouse fixture that runs the module's tests at
    ``n`` torch threads and restores the earlier count afterwards."""

    @pytest.fixture(scope="module", autouse=True, name="torch_threads")
    def torch_threads():
        before = torch.get_num_threads()
        torch.set_num_threads(n)
        try:
            yield n
        finally:
            torch.set_num_threads(before)

    return torch_threads
