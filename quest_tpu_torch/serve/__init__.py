"""quest_tpu_torch.serve — the asynchronous serving runtime on one card.

Turns many independent callers into the large, well-shaped batches the
batched ensemble engine (:meth:`quest_tpu_torch.circuits.CompiledCircuit.
sweep` family, and :class:`~quest_tpu_torch.ops.trajectories.
TrajectoryProgram` wave loops) is fast at: request coalescing with padded
batch buckets, weighted-fair ordering of the ready batches across
tenants, bounded-queue admission control with typed backpressure, and
deadline-aware dispatch with a typed recovery path
(:mod:`quest_tpu_torch.resilience`). For production traffic,
:class:`ServiceRouter` fronts N service replicas (on the one card) with
health-aware routing, replica failover with supervised restart, and a
persistent warm-start cache (:class:`~quest_tpu_torch.serve.warmcache.
WarmCache`, ``QUEST_TPU_WARM_CACHE_DIR``) so a restarted replica loads its
packed operands instead of packing them. :mod:`.optimize` and
:mod:`.dynamics` run variational optimizations and Hamiltonian dynamics
inside the serving layer as streamed, checkpointed handles.
"""

from .coalesce import (CoalescePolicy, batch_bucket, coalesce_key,
                       plan_schedule, split_ready)
from .dynamics import DynamicsHandle, DynamicsProblem, run_dynamics
from .engine import (CircuitBreakerOpen, DeadlineExceeded, QueueFull,
                     QuotaExceeded, ServeError, ServiceClosed,
                     SimulationService)
from .metrics import RouterMetrics, ServiceMetrics
from .optimize import (Adam, GradientDescent, OptimizationHandle,
                       VariationalProblem, resolve_optimizer,
                       run_optimization)
from .router import AllReplicasUnavailable, ServiceRouter, replica_envs
from .sched import (DEFAULT_TENANT, TenantPolicy, WFQScheduler,
                    plan_wfq_schedule)
from .warmcache import WARM_CACHE_ENV, WarmCache

__all__ = [
    "SimulationService", "ServeError", "QueueFull", "DeadlineExceeded",
    "ServiceClosed", "CircuitBreakerOpen", "QuotaExceeded",
    "CoalescePolicy",
    "ServiceMetrics", "batch_bucket", "coalesce_key", "plan_schedule",
    "split_ready",
    "DEFAULT_TENANT", "TenantPolicy", "WFQScheduler",
    "plan_wfq_schedule",
    "ServiceRouter", "AllReplicasUnavailable", "replica_envs",
    "RouterMetrics", "WarmCache", "WARM_CACHE_ENV",
    "VariationalProblem", "OptimizationHandle", "GradientDescent",
    "Adam", "resolve_optimizer", "run_optimization",
    "DynamicsProblem", "DynamicsHandle", "run_dynamics",
]
