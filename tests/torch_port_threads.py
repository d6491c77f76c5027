"""One thread for the port's tests, module by module.

The tier-1 run spreads the test files over several worker processes on one
machine; each process would otherwise start as many torch intra-op, BLAS
and OpenCV threads as the machine has cores, and the small ops of the
port's CPU tests then spend most of their time waiting on each other's
threads (and on those of the other workers, whose wall-clock tests share
the machine).  A test module that imports :func:`one_torch_thread` runs
torch, BLAS (through threadpoolctl, where it is installed) and cv2 (where
it is installed) on one thread each, and gives the worker's settings back
when it ends.
"""
import contextlib

import pytest
import torch

try:
    import cv2
except ImportError:
    cv2 = None
try:
    from threadpoolctl import threadpool_limits
except ImportError:
    threadpool_limits = None


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    n_cv2 = cv2.getNumThreads() if cv2 is not None else None
    torch.set_num_threads(1)
    if cv2 is not None:
        cv2.setNumThreads(1)
    blas = (threadpool_limits(1) if threadpool_limits is not None
            else contextlib.nullcontext())
    with blas:
        yield
    torch.set_num_threads(n)
    if cv2 is not None:
        cv2.setNumThreads(n_cv2)
