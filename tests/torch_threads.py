"""One torch intra-op thread for a test module's cases: import
`one_torch_thread` (an autouse fixture) into the module.

The suite runs in several worker processes on one machine.  Oversubscribed,
torch's OpenMP threads spin-wait at every small op: under a loaded CPU one
case of tests/test_torch_pms.py (the exact search on tensor4d) took 121 s
on torch's default threads and 2.3 s on one."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
