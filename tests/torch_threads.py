"""One intra-op thread for the port's CPU tests.

The suite runs in several pytest-xdist workers on the cores of one
machine, and PyTorch gives each process as many intra-op threads as the
machine has cores: the plain versions' many small tensor ops then spend
most of their time in threads waiting for each other (the paper harness's
quick run took 306 s under six workers and 13 s alone).  Each
test file of the port imports :func:`one_intra_op_thread`, so its module
runs on one thread, and the processes it starts (gloo ranks, subprocess
legs) inherit ``OMP_NUM_THREADS=1``; both are restored after the module.
"""
import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    threads, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(threads)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = env
