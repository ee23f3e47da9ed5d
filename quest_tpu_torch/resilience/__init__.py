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

The checkpoint-backed segment recovery of the JAX package waits for
ROADMAP Queue 1 item 10.
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
]
