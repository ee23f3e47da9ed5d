"""One BLAS/OpenMP thread per test worker, for the port's test files.

The suite runs in several worker processes at once (``-n 6``), and
numpy's OpenBLAS starts one thread per core in each of them;
``torch.set_num_threads`` does not reach it. Each ``tests/test_torch_*.py``
imports :func:`one_blas_thread`, an autouse module fixture, which limits
every thread pool ``threadpoolctl`` finds to one thread for the module and
restores the limits afterwards.
"""

import warnings

import pytest


@pytest.fixture(autouse=True, scope="module")
def one_blas_thread():
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        warnings.warn("threadpoolctl is not importable: BLAS and OpenMP "
                      "thread pools keep their default sizes")
        yield
        return
    with threadpool_limits(1):
        yield
