"""One PyTorch intra-op thread in every test process.

The tier-1 run puts six pytest-xdist workers on an eight-core machine.
With PyTorch's default of one intra-op thread a core, each worker's
small tensor operations (the plain versions run thousands of them a
call) wait on threads the other workers hold: a test of kernel 2's plain
version at N = 180 took 430 s there and 13 s alone.  Every worker imports
every test module while it collects, before any test runs, so the
setting made here holds in each of them.  The module must stay collected
in every run of the port's tests (it sets the thread count when it is
imported, and no other file does): the test below fails in a worker
where the count is not one."""

import torch

torch.set_num_threads(1)


def test_one_torch_thread_a_test_process():
    assert torch.get_num_threads() == 1
