"""quest_tpu_torch — the PyTorch / NVIDIA H100 port of quest_tpu.

The QuEST-named API for state vectors and density matrices (``createQureg``,
``createDensityQureg``, the ``mix*`` channels, the ``calc*`` functions) and
compiled circuits (``Circuit.compile``, with ``density=True`` for noisy
programs on a density register), Hamiltonian dynamics
(``CompiledCircuit.evolve_sweep``/``ground_sweep``), the algorithm library
(``quest_tpu_torch.algorithms``) and the QASM importer (``parse_qasm``) on
one CUDA device, with the fused gate-layer kernel written by hand in CUDA
C++ for Hopper (``csrc/layer_kernel.cu``), and the precision-tier ladder
(FAST, SINGLE, DOUBLE, QUAD; ``Circuit.compile(tier=/error_budget=)``,
``sweep(tier=)``), the double-double QUAD/QUAD64 registers and
``Circuit.compile_dd`` (``ops/doubledouble.py``), the serving runtime
(``createSimulationService``: ``serve/``, with ``telemetry/`` and
``resilience/``), the replicated router over replicas sharing the card
(``createServiceRouter``) with its persistent warm-start cache, the
optimizer and dynamics handles (``service.optimize``/``evolve``/
``ground_state``), and register checkpoints
(``quest_tpu_torch.checkpoint``); on a mesh of amplitude shards
(``createQuESTEnv(num_devices=n)``) registers, compiled programs, the
batched engine and trajectory ensembles; and runnable examples
(``quest_tpu_torch.examples``). Every top-level name of the JAX package
``quest_tpu`` but ``compat`` and ``initialize_multihost`` is here; that
package is the reference this port is tested against, and nothing here
imports it or JAX.

```python
import quest_tpu_torch as qt

env = qt.createQuESTEnv(num_devices=1)  # cuda:0, SINGLE; no CUDA raises
q = qt.createQureg(30, env)
qt.hadamard(q, 0)
qt.controlledNot(q, 0, 1)
print(qt.calcProbOfOutcome(q, 1, 1)) # 0.5
```
"""

from .api import *  # noqa: F401,F403
from .api import __all__ as _api_all
from .circuits import Circuit, CompiledCircuit, Param
from .config import (DOUBLE, DOUBLE_TIER, FAST_TIER, QUAD, QUAD64,
                     QUAD_TIER, SINGLE, SINGLE_TIER, TIER_LADDER, Precision,
                     PrecisionTier, default_precision, tier_by_name)
from .profiling import (choose_tier, engine_tiers, modeled_tier_error,
                        tier_runtime_tol)
from .env import (QuESTEnv, create_quest_env, default_compensated,
                  destroy_quest_env)
from .ops.dynamics import EvolveSpec, GroundSpec
from .ops.trajectories import DensityMaterialisationError, TrajectoryProgram
from .qasm_import import ParsedQASM, load_qasm_file, parse_qasm
from .qureg import Qureg
from .resilience import (AutoscalePolicy, FaultInjector, FaultSpec,
                         HealthConfig, NumericalFault, ResiliencePolicy,
                         SupervisorPolicy)
from .serve import (AllReplicasUnavailable, Adam, CircuitBreakerOpen,
                    CoalescePolicy, DeadlineExceeded, DynamicsHandle,
                    DynamicsProblem, GradientDescent, OptimizationHandle,
                    QueueFull, QuotaExceeded, ServeError, ServiceClosed,
                    ServiceRouter, SimulationService, TenantPolicy,
                    VariationalProblem, WarmCache, WFQScheduler)
from .telemetry import (DispatchProfiler, PerfLedger, TraceContext, Tracer,
                        metrics_registry, prometheus_text, profiler,
                        start_http_exporter)
from .types import (PAULI_I, PAULI_X, PAULI_Y, PAULI_Z, PauliOpType,
                    QuESTError, invalid_quest_input_error,
                    invalidQuESTInputError, set_input_error_handler)
from .validation import ErrorCode

__all__ = list(_api_all) + [
    "Circuit", "CompiledCircuit", "Param", "Precision", "SINGLE", "DOUBLE",
    "QUAD", "QUAD64",
    "PrecisionTier", "FAST_TIER", "SINGLE_TIER", "DOUBLE_TIER", "QUAD_TIER",
    "TIER_LADDER", "tier_by_name", "choose_tier", "modeled_tier_error",
    "engine_tiers", "tier_runtime_tol",
    "QuESTEnv", "Qureg", "EvolveSpec", "GroundSpec", "ParsedQASM",
    "parse_qasm", "load_qasm_file", "PauliOpType", "PAULI_I", "PAULI_X",
    "PAULI_Y", "PAULI_Z", "QuESTError", "ErrorCode",
    "SimulationService", "ServiceRouter", "AllReplicasUnavailable",
    "WarmCache", "VariationalProblem", "OptimizationHandle",
    "GradientDescent", "Adam", "DynamicsProblem", "DynamicsHandle",
    "default_precision", "default_compensated", "create_quest_env",
    "destroy_quest_env", "invalid_quest_input_error",
    "invalidQuESTInputError", "set_input_error_handler",
    "TrajectoryProgram", "DensityMaterialisationError",
    "CoalescePolicy", "ServeError", "QueueFull", "DeadlineExceeded",
    "ServiceClosed", "CircuitBreakerOpen", "QuotaExceeded", "TenantPolicy",
    "WFQScheduler",
    "FaultInjector", "FaultSpec", "HealthConfig", "NumericalFault",
    "ResiliencePolicy", "SupervisorPolicy", "AutoscalePolicy",
    "Tracer", "TraceContext", "metrics_registry", "prometheus_text",
    "start_http_exporter", "DispatchProfiler", "PerfLedger", "profiler",
]
