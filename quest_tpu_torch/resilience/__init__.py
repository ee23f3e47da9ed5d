"""quest_tpu_torch.resilience — fault-tolerant execution.

The failure modes a simulator meets in service, made testable and
survivable:

- :mod:`~quest_tpu_torch.resilience.faults` — deterministic, seedable
  fault injection at the dispatch boundaries (transient errors,
  simulated OOM, NaN poisoning, norm drift, slow-device stalls);
- :mod:`~quest_tpu_torch.resilience.health` — cheap invariant checks on
  the planes (NaN/Inf, norm drift, density trace) raising a typed
  :class:`NumericalFault` or renormalizing in the opt-in degraded mode;
- :mod:`~quest_tpu_torch.resilience.recovery` — the typed exception
  classifier, retry backoff, and per-program circuit breaker the
  serving runtime's recovery path runs on. A kernel that fails to build
  or launch, and a sticky CUDA error, are FATAL there: they fail the
  request typed, never retry and never fall back to a plain version.

- :mod:`~quest_tpu_torch.resilience.segments` — checkpoint-backed
  segment recovery for long runs and sweeps (snapshots through
  :mod:`quest_tpu_torch.checkpoint`, re-execution from the last good
  segment, resumable across process restarts), and the optimizer and
  dynamics handles' progress files, in the JAX package's formats.
"""

from .faults import (FaultInjector, FaultSpec, InjectedFault, SimulatedOOM,
                     SITES as FAULT_SITES, REPLICA_KINDS,
                     active as active_injector, fire, fire_router, inject,
                     install, uninstall)
from .health import (HealthConfig, NumericalFault, check_planes, configure,
                     get_config, guarded, health_stats, reset_stats)
from .recovery import (FATAL, POISON, TRANSIENT, AutoscalePolicy,
                       CircuitBreaker, ResiliencePolicy,
                       SupervisorPolicy, classify)

__all__ = [
    # faults
    "FaultInjector", "FaultSpec", "InjectedFault", "SimulatedOOM",
    "FAULT_SITES", "REPLICA_KINDS", "inject", "install", "uninstall",
    "active_injector", "fire", "fire_router",
    # health
    "HealthConfig", "NumericalFault", "check_planes", "configure",
    "get_config", "guarded", "health_stats", "reset_stats",
    # recovery
    "ResiliencePolicy", "SupervisorPolicy", "AutoscalePolicy",
    "CircuitBreaker", "classify",
    "TRANSIENT", "POISON", "FATAL",
    # segments (lazy: they import circuits and checkpoint)
    "split_circuit", "checkpointed_run", "checkpointed_sweep",
]

_SEGMENT_NAMES = {"split_circuit", "checkpointed_run", "checkpointed_sweep"}


def __getattr__(name):
    # segments imports quest_tpu_torch.circuits; loading it lazily keeps
    # this package importable from inside circuits.py (the fault hooks)
    if name in _SEGMENT_NAMES:
        from . import segments
        return getattr(segments, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
