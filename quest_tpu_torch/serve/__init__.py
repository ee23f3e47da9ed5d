"""quest_tpu_torch.serve — the asynchronous serving runtime on one card.

Turns many independent callers into the large, well-shaped batches the
batched ensemble engine (:meth:`quest_tpu_torch.circuits.CompiledCircuit.
sweep` family, and :class:`~quest_tpu_torch.ops.trajectories.
TrajectoryProgram` wave loops) is fast at: request coalescing with padded
batch buckets, weighted-fair ordering of the ready batches across
tenants, bounded-queue admission control with typed backpressure, and
deadline-aware dispatch with a typed recovery path
(:mod:`quest_tpu_torch.resilience`). :mod:`.warmcache` holds the content
digest of a recorded circuit. The replicated router, the warm-start cache
and the optimizer/dynamics handles are ROADMAP Queue 1 item 10.
"""

from .coalesce import (CoalescePolicy, batch_bucket, coalesce_key,
                       plan_schedule, split_ready)
from .engine import (CircuitBreakerOpen, DeadlineExceeded, QueueFull,
                     QuotaExceeded, ServeError, ServiceClosed,
                     SimulationService)
from .metrics import ServiceMetrics
from .sched import (DEFAULT_TENANT, TenantPolicy, WFQScheduler,
                    plan_wfq_schedule)

__all__ = [
    "SimulationService", "ServeError", "QueueFull", "DeadlineExceeded",
    "ServiceClosed", "CircuitBreakerOpen", "QuotaExceeded",
    "CoalescePolicy",
    "ServiceMetrics", "batch_bucket", "coalesce_key", "plan_schedule",
    "split_ready",
    "DEFAULT_TENANT", "TenantPolicy", "WFQScheduler",
    "plan_wfq_schedule",
]
