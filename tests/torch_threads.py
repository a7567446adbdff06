"""One torch intra-op thread for the port's CPU tests.

The suite runs in several worker processes on one machine's cores, and the
port's tests work on small tensors that gain nothing from intra-op
threads: more threads only contend with the other workers. A test module
imports `one_torch_thread`, an autouse module fixture that sets one thread
and restores the previous count after the module.
"""

from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
