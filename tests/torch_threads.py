"""One BLAS/OpenMP thread per test worker, for the port's test files.

The suite runs in several worker processes at once (``-n 6``), and
numpy's OpenBLAS starts one thread per core in each of them;
``torch.set_num_threads`` does not reach it. Each ``tests/test_torch_*.py``
imports :func:`one_blas_thread`, an autouse module fixture, which limits
every thread pool ``threadpoolctl`` finds to one thread for the module and
restores the limits afterwards.

A file whose tests run the serving threads also imports
:func:`port_lock_order`, the port's lock-order check
(``quest_tpu_torch/testing/lockcheck.py``) for the module.
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


@pytest.fixture(autouse=True, scope="module")
def port_lock_order():
    """The port's lock-order check over a module whose tests run threads:
    installed for the module (beside the JAX package's copy, which the
    test configuration installs), and no new violation and no cycle in
    the acquisition graph at its end."""
    from quest_tpu_torch.testing import lockcheck
    was = lockcheck.installed()
    lockcheck.install()
    before = len(lockcheck.violations())
    yield lockcheck
    new = lockcheck.violations()[before:]
    if not was:
        lockcheck.uninstall()
    assert not new, [str(v) for v in new]
    assert lockcheck.find_cycle() is None, lockcheck.find_cycle()
