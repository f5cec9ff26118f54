"""One intra-op thread for the port's CPU tests.

pytest-xdist runs several workers on the machine's cores, and each
PyTorch process starts one intra-op thread per core.  The port's tests
run thousands of small ops, each a parallel region whose threads meet
at a barrier and then wait on threads that the other workers keep off
the cores: the split-and-merge cases of ``test_torch_block_knn_split.py``
took 44.7 s as six concurrent single-threaded copies and did not finish
in 900 s with the default thread count.  A test module that imports
``one_intra_op_thread`` runs with one thread and restores the count
after it.  ``test_torch_harness.py`` keeps the default: a residual of
about 1e-10 in its pcg.txt moves with the matrix products' thread
partition beyond that check's tolerance.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
