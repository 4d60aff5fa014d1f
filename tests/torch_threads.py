"""A module-scoped autouse fixture that runs torch on one intra-op thread.

Import it into a test module (``from tests.torch_threads import one_thread``)
to run that module's torch work on one thread. Under the test runner's
parallel workers each torch op's parallel region otherwise waits on threads
that the other workers have descheduled: models of many small ops (the
SNNs' LIF steps, recurrent cells, window gathers) then run several times
slower than on one thread.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
