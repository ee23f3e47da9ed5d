"""The port's top-level namespace against the JAX package's.

Every public name of ``quest_tpu/__init__.py`` resolves on
``quest_tpu_torch`` (less ``compat``, the JAX package's ``shard_map`` shim,
and ``initialize_multihost``, the multi-process bootstrap not yet ported),
each one the object of the port submodule that defines it; importing them
starts no thread and imports no JAX.
"""

import inspect
import subprocess
import sys

import pytest

import quest_tpu as jq
import quest_tpu_torch as tq
from torch_threads import one_blas_thread  # noqa: F401

NOT_PORTED = {"compat", "initialize_multihost"}

# the names the JAX package's own tests read at top level
USED_BY_TESTS = ("set_input_error_handler", "ServeError", "NumericalFault",
                 "DeadlineExceeded", "TenantPolicy")


def _public(module):
    names = set(getattr(module, "__all__", ()))
    names |= {n for n in dir(module) if not n.startswith("_")}
    return names


@pytest.mark.parametrize("name", sorted(set(jq.__all__) - NOT_PORTED))
def test_public_name_resolves(name):
    assert hasattr(tq, name), name
    assert name in tq.__all__, name


def test_every_public_attribute_resolves():
    """Also the names ``dir()`` shows beyond ``__all__``. Submodules are
    left out: which ones ``dir()`` lists depends on what the process
    imported before (another test's ``quest_tpu.native``)."""
    missing = sorted(n for n in _public(jq) - NOT_PORTED
                     if not inspect.ismodule(getattr(jq, n))
                     and not hasattr(tq, n))
    assert not missing, missing


@pytest.mark.parametrize("name", USED_BY_TESTS)
def test_names_the_jax_tests_use(name):
    assert getattr(tq, name) is not None


@pytest.mark.parametrize("name, module", [
    ("TrajectoryProgram", "quest_tpu_torch.ops.trajectories"),
    ("DensityMaterialisationError", "quest_tpu_torch.ops.trajectories"),
    ("ServeError", "quest_tpu_torch.serve.engine"),
    ("TenantPolicy", "quest_tpu_torch.serve.sched"),
    ("CoalescePolicy", "quest_tpu_torch.serve.coalesce"),
    ("NumericalFault", "quest_tpu_torch.resilience.health"),
    ("FaultInjector", "quest_tpu_torch.resilience.faults"),
    ("AutoscalePolicy", "quest_tpu_torch.resilience.recovery"),
    ("Tracer", "quest_tpu_torch.telemetry.tracing"),
    ("PerfLedger", "quest_tpu_torch.telemetry.ledger"),
    ("set_input_error_handler", "quest_tpu_torch.types"),
    ("default_compensated", "quest_tpu_torch.env"),
    ("default_precision", "quest_tpu_torch.config"),
])
def test_name_is_the_submodules_object(name, module):
    import importlib
    assert getattr(tq, name) is getattr(importlib.import_module(module),
                                        name)


def test_serve_error_hierarchy_matches():
    for name in ("QueueFull", "DeadlineExceeded", "ServiceClosed",
                 "CircuitBreakerOpen", "QuotaExceeded"):
        assert issubclass(getattr(tq, name), tq.ServeError)
        assert issubclass(getattr(jq, name), jq.ServeError)


def test_input_error_handler_round_trip():
    seen = []

    def handler(message, func_name, code=0):
        seen.append(func_name)
        raise tq.QuESTError(message, func_name)

    tq.set_input_error_handler(handler)
    try:
        env = tq.createQuESTEnv(num_devices=1, device="cpu",
                                precision=tq.DOUBLE)
        q = tq.createQureg(2, env)
        with pytest.raises(tq.QuESTError):
            tq.hadamard(q, 5)
    finally:
        tq.set_input_error_handler(None)
    assert seen


def test_import_starts_no_thread_and_no_jax():
    code = ("import sys, threading; import quest_tpu_torch as qt; "
            "names = [qt.TrajectoryProgram, qt.ServeError, qt.Tracer, "
            "qt.metrics_registry, qt.profiler, qt.start_http_exporter, "
            "qt.FaultInjector]; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert threading.active_count() == 1, threading.enumerate(); "
            "print('ok')")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "ok"
