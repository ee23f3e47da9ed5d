"""The asynchronous simulation service: many callers, one batched engine.

Everything below the serving layer is a synchronous single-caller
library; the utilization of a service answering small requests is won
ABOVE the kernels, by the dispatch layer that turns many independent
requests into the large same-shaped batches the engine is fast at.
:class:`SimulationService` is that layer:

- :meth:`SimulationService.submit` accepts a request (circuit +
  parameter binding, optionally an observable or a shot count) and
  returns a :class:`concurrent.futures.Future` immediately;
- a background **dispatcher thread** drains a bounded admission queue,
  groups compatible requests per :mod:`quest_tpu_torch.serve.coalesce`,
  orders the ready batches by weighted fair queueing
  (:mod:`quest_tpu_torch.serve.sched`), and executes each group as ONE
  ``sweep`` / ``expectation_sweep`` / ``sample_sweep`` /
  ``value_and_grad_sweep`` / ``evolve_sweep`` / ``ground_sweep`` or
  trajectory wave-loop dispatch, fanning results back to the futures —
  on the card through the batched layer kernel (and the fused Kraus
  kernel for trajectory requests);
- **backpressure** is typed: a full queue raises :class:`QueueFull` at
  submit time (the caller sheds load, nothing is silently dropped), an
  unmeetable deadline raises / resolves :class:`DeadlineExceeded`;
- each request carries a **deadline** (caller-supplied, capped by the
  service's ``request_timeout_s``); requests that expire while queued
  get :class:`DeadlineExceeded` instead of occupying a batch slot;
- executor failures go through a **typed recovery path**
  (:mod:`quest_tpu_torch.resilience`): exceptions are classified (fatal
  errors — caller errors, and on the card a kernel that failed to build
  or launch or a sticky CUDA error — fail fast with the ORIGINAL
  exception; transient runtime faults and device OOM retry within a
  per-request budget, re-entering the queue after exponential backoff
  with seeded jitter), a per-program **circuit breaker** fast-fails
  batches with a typed :class:`CircuitBreakerOpen` after repeated faults,
  and a faulted multi-request batch is **quarantined by bisection** —
  halves re-execute independently so one poisoned request gets a typed
  failure instead of failing its batch companions. Result rows are
  screened for NaN/Inf (one poisoned row fails typed with
  :class:`~quest_tpu_torch.resilience.health.NumericalFault`; the rest of
  the batch completes normally). No path falls back to a kernel's plain
  version or to the CPU;
- a program whose batched dispatches keep faulting **degrades to
  sequential** per-request execution for a cooldown, and a watchdog
  thread counts dispatcher heartbeat stalls into the metrics;
- :meth:`SimulationService.warm` builds the kernels, precompiles the
  program and runs one padded dispatch per batch bucket, so a first
  request builds and packs nothing.

Request execution happens on the dispatcher thread; ``submit`` only
touches numpy and the future, so every device dispatch — and every draw
from the environment's ``torch.Generator`` (sample and trajectory
requests) — is made on that one thread. :meth:`SimulationService.warm`
and the one-time compile of a raw ``Circuit`` submission are the
deliberate exceptions (caller-thread setup work, meant to happen before
traffic opens; the kernel build they may start is serialised by
:func:`quest_tpu_torch.ops.cuda_build.build_all`).

The port's sweeps hand back host arrays for energies, gradients and
samples (their one transfer is inside the sweep), and device tensors for
planes and dynamics blocks. So with ``pipeline_depth > 1`` the ordering
and the results are the JAX package's, but only state and dynamics
batches leave their device-to-host copy to the completion thread.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
import weakref
from concurrent.futures import Future
from typing import Optional, Sequence

import numpy as np

import torch

from ..circuits import Circuit, CompiledCircuit
from ..ops import reductions as _red
from ..ops.trajectories import TrajectoryProgram
from ..resilience import faults as _faults
from ..resilience import health as _health
from ..resilience.health import NumericalFault
from ..resilience.recovery import (FATAL, POISON, PRECISION, TRANSIENT,
                                   CircuitBreaker, ResiliencePolicy,
                                   classify)
from ..telemetry import profile as _profile
from ..telemetry.events import make_event, read_timeline
from ..telemetry.metrics import metrics_registry
from ..telemetry.tracing import Tracer, dispatch_annotation
from .coalesce import (KIND_EVOLVE, KIND_EXPECTATION, KIND_GRADIENT,
                       KIND_GROUND, KIND_SAMPLE, KIND_STATE,
                       KIND_TRAJECTORY, CoalescePolicy,
                       coalesce_key, split_ready)
from .metrics import ServiceMetrics
from .sched import DEFAULT_TENANT, TenantPolicy, WFQScheduler

__all__ = ["ServeError", "QueueFull", "DeadlineExceeded", "ServiceClosed",
           "CircuitBreakerOpen", "QuotaExceeded", "SimulationService"]

# completion-queue shutdown sentinel (pipelined dispatch)
_PIPE_STOP = object()


class _BoundedLRU:
    """The LRU of recorded-Circuit compilations a service keeps
    (``max_circuits``): a service whose callers keep recording fresh
    circuits must not pin one compiled program per circuit forever.
    ``peek`` reads without touching the LRU order (safe for cross-thread
    health probes)."""

    def __init__(self, maxsize: int):
        if maxsize < 1:
            raise ValueError("cache bound must be >= 1")
        self.maxsize = maxsize
        self._d: "collections.OrderedDict" = collections.OrderedDict()

    def get(self, key, default=None):
        value = self._d.get(key, default)
        if key in self._d:
            self._d.move_to_end(key)
        return value

    def peek(self, key, default=None):
        return self._d.get(key, default)

    def __setitem__(self, key, value) -> None:
        if key in self._d:
            self._d.move_to_end(key)
        self._d[key] = value
        while len(self._d) > self.maxsize:
            self._d.popitem(last=False)


def _host(x) -> np.ndarray:
    """A dispatch result on the host: a tensor copied off its device (the
    wait for its device work), anything else as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class _Inflight:
    """One launched-but-unresolved batch (pipelined dispatch): the raw
    results (device tensors or host arrays) plus everything the
    completion thread needs to materialize, screen, and fan the batch
    out."""

    __slots__ = ("batch", "pkey", "cc", "tier", "B", "padded", "kind",
                 "t_dispatch", "traced", "poison", "guard", "sp", "raw")

    def __init__(self, batch, cc, tier, B, padded, kind, t_dispatch,
                 traced, poison, guard, sp, raw):
        self.batch = batch
        self.pkey = ""
        self.cc = cc
        self.tier = tier
        self.B = B
        self.padded = padded
        self.kind = kind
        self.t_dispatch = t_dispatch
        self.traced = traced
        self.poison = poison
        self.guard = guard
        self.sp = sp
        self.raw = raw


class ServeError(RuntimeError):
    """Base class for serving-runtime errors."""


class QueueFull(ServeError):
    """The admission queue is at capacity — backpressure: shed load or
    retry later. Raised by :meth:`SimulationService.submit`."""


class DeadlineExceeded(ServeError):
    """The request's deadline (or the service's per-request timeout)
    passed before it could be dispatched."""


class ServiceClosed(ServeError):
    """The service no longer accepts submissions."""


class CircuitBreakerOpen(ServeError):
    """The compiled program's circuit breaker is open after repeated
    executor faults: requests fast-fail (typed) instead of burning the
    executor/retry budget, until the cooldown half-opens the breaker."""


class QuotaExceeded(ServeError):
    """The submitting tenant is at its per-tenant quota
    (:class:`~quest_tpu_torch.serve.sched.TenantPolicy` ``max_queued``):
    tenant-scoped backpressure — other tenants keep admitting. Raised
    by :meth:`SimulationService.submit`."""


class _Request:
    """One queued submission (internal)."""

    __slots__ = ("compiled", "param_vec", "kind", "observables", "shots",
                 "submit_t", "deadline", "future", "retries_left", "key",
                 "not_before", "attempts", "tier", "escalations",
                 "obs_key", "trace", "trace_owned", "qspan", "dspan",
                 "trajectories", "sampling_budget", "tenant", "priority",
                 "dynamics", "progress")

    def __init__(self, compiled, param_vec, kind, observables, shots,
                 submit_t, deadline, future, retries_left, key,
                 tier=None, obs_key=(), trajectories=0,
                 sampling_budget=None, tenant=DEFAULT_TENANT,
                 priority=1, dynamics=None, progress=None):
        self.compiled = compiled
        self.param_vec = param_vec
        self.kind = kind
        self.observables = observables
        self.shots = shots
        self.submit_t = submit_t
        self.deadline = deadline
        self.future = future
        self.retries_left = retries_left
        self.key = key
        self.not_before = 0.0    # retry backoff: ineligible before this
        self.attempts = 0        # executor attempts already failed
        self.tier = tier         # precision tier (None = env precision)
        self.escalations = 0     # tier bumps already taken
        self.obs_key = obs_key   # canonical observable key (rekeying)
        self.trace = None        # TraceContext when the request sampled
        self.trace_owned = False  # this service created the trace
        self.qspan = None        # open "queue" span (per attempt)
        self.dspan = None        # open "dispatch" span
        self.trajectories = trajectories      # max_T (trajectory kind)
        self.sampling_budget = sampling_budget  # target stderr (or None)
        self.tenant = tenant     # WFQ accounting + quota dimension
        self.priority = priority  # strict class (0 = interactive)
        self.dynamics = dynamics  # (spec, state_f) for evolve/ground
        self.progress = progress  # per-wave listener (trajectory kinds)


def _canonical_observables(compiled, observables) -> tuple:
    """Validate a ``(pauli_terms, coeffs)`` Hamiltonian at SUBMIT time
    (errors belong to the caller, not the dispatcher thread) and return
    ``(normalized_ham, hashable_key)`` — the key is what makes two
    requests' observables coalescible."""
    terms_in, coeffs_in = observables
    nq = compiled.num_qubits // 2 if compiled.is_density \
        else compiled.num_qubits
    terms, coeffs = _red.validated_pauli_terms(terms_in, coeffs_in, nq)
    key = (tuple(terms), tuple(float(c) for c in coeffs))
    return (terms, coeffs), key


class SimulationService:
    """Asynchronous request-coalescing front end over the batched engine.

    Parameters
    ----------
    env : QuESTEnv
        Environment every served circuit must be compiled against.
    max_queue : int
        Admission bound — requests admitted but not yet dispatched.
        Submissions past it raise :class:`QueueFull`.
    max_batch, max_wait_s :
        The coalescing knobs (:class:`quest_tpu_torch.serve.coalesce.
        CoalescePolicy`): requests per dispatch cap, and the longest a
        lone request waits for batch companions.
    request_timeout_s : float
        Default per-request deadline; ``submit(deadline=...)`` can only
        tighten it.
    max_retries : int
        Dispatch retries per request after a transient executor failure
        (fatal caller errors never burn one — they fail fast with the
        original exception).
    max_circuits : int
        LRU bound on recorded-Circuit submissions compiled and cached
        by the service (CompiledCircuit submissions are never cached —
        the caller owns those).
    resilience : ResiliencePolicy
        The fault-tolerance knobs (:class:`quest_tpu_torch.resilience.
        ResiliencePolicy`): retry backoff, circuit-breaker thresholds,
        batch quarantine, output guarding, degraded mode, and the
        watchdog timeout. Defaults to the standard policy.
    record_events : int
        Ring-buffer bound on the recovery timeline
        (:attr:`SimulationService.events`; read it with
        :meth:`timeline`). 0 disables recording entirely: a reader then
        warns once and renders an empty timeline, so leave the default
        unless the per-event cost has been measured to matter.
    trace_sample_rate : float
        Fraction of requests that record a full request-scoped trace
        (:mod:`quest_tpu_torch.telemetry.tracing`): spans for submit, queue,
        coalesce, dispatch, retry, escalation, and resolve, exported
        from :attr:`tracer` as JSON or Chrome trace events. 0 (default)
        disables tracing; 1.0 traces everything. Sampling is a
        deterministic stride, not a random draw.
    tracer : Tracer | None
        An explicit :class:`~quest_tpu_torch.telemetry.tracing.Tracer` to
        record into (shared across services); None builds one from
        ``trace_sample_rate``.
    name : str | None
        The service's name in the process-global metrics registry
        (:func:`quest_tpu_torch.telemetry.metrics.metrics_registry`), where
        its full ``dispatch_stats()`` document is registered for the
        Prometheus/JSON exporters. None auto-generates a unique name.
    warm_cache : WarmCache | False | None
        The persistent warm-start cache
        (:class:`quest_tpu_torch.serve.warmcache.WarmCache`). Default None
        resolves the ambient cache from ``QUEST_TPU_WARM_CACHE_DIR``
        (disabled when unset); pass an explicit cache to share one, or
        ``False`` to force it off. With a cache, :meth:`warm` LOADS each
        form's packed operands instead of packing them (hit/miss counters
        land in the metrics).
    perf_ledger : PerfLedger | False | None
        The persistent perf ledger (:class:`quest_tpu_torch.telemetry.ledger.
        PerfLedger`). Default None resolves ``QUEST_TPU_PERF_LEDGER_DIR``
        (disabled when unset); ``False`` forces it off. With a ledger,
        :meth:`close` records each served program's measured request
        latency and observed batch buckets, :meth:`warm` defaults its
        bucket choices to the buckets prior runs actually hit, and the
        WFQ scheduler prices a program's first batches from the
        recorded means instead of a flat 1.0 per request.
    tenants : dict[str, TenantPolicy] | None
        Per-tenant scheduling contracts (:class:`~quest_tpu_torch.serve.sched.
        TenantPolicy`): WFQ weight, strict priority class, and
        inflight/queued quotas. Tenants absent from the dict run under
        the default contract; :meth:`set_tenant` installs or replaces
        one live.
    scheduler : str
        ``"wfq"`` (default) orders each dispatch cycle's ready batches
        by virtual-time weighted fair queueing over projected mesh
        seconds (per-program cost from the live EMA, seeded by the
        perf ledger); ``"fifo"`` drains ready batches in arrival order
        (the measurement baseline for the WFQ order).
    pipeline_depth : int
        How many launched engine dispatches may be in flight at once.
        1 (default) is the classic synchronous dispatcher. Above 1 the
        dispatcher only LAUNCHES each batch and hands the in-flight handle
        to a completion thread that copies results off the device,
        screens, and fans out IN LAUNCH ORDER — per-program completion
        order is preserved, and the resilience machinery (breaker,
        bisection quarantine, per-row screens) runs per in-flight
        batch. The port's energy, gradient and sample sweeps copy their
        results to the host inside the dispatch, so only state and
        dynamics batches overlap their copy with the next dispatch.
    """

    def __init__(self, env, *, max_queue: int = 1024, max_batch: int = 64,
                 max_wait_s: float = 2e-3, request_timeout_s: float = 60.0,
                 max_retries: int = 1, latency_window: int = 4096,
                 max_circuits: int = 32,
                 resilience: Optional[ResiliencePolicy] = None,
                 record_events: int = 256, warm_cache=None,
                 perf_ledger=None,
                 trace_sample_rate: float = 0.0,
                 tracer: Optional[Tracer] = None,
                 name: Optional[str] = None,
                 tenants: Optional[dict] = None,
                 scheduler: str = "wfq",
                 pipeline_depth: int = 1):
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if request_timeout_s <= 0.0:
            raise ValueError("request_timeout_s must be > 0")
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if scheduler not in ("wfq", "fifo"):
            raise ValueError(
                f"scheduler must be 'wfq' or 'fifo', got {scheduler!r}")
        if int(pipeline_depth) < 1:
            raise ValueError("pipeline_depth must be >= 1")
        self.env = env
        self.policy = CoalescePolicy(max_batch=max_batch,
                                     max_wait_s=max_wait_s)
        self.max_queue = int(max_queue)
        self.request_timeout_s = float(request_timeout_s)
        self.max_retries = int(max_retries)
        self.metrics = ServiceMetrics(latency_window=latency_window)
        self._cond = threading.Condition()
        self._queue: collections.deque = collections.deque()
        self._backlog = 0          # admitted, not yet dispatched/expired
        self._closed = False
        self._drain_on_close = True
        self._paused = False
        # id(Circuit) -> (Circuit, CompiledCircuit); LRU-bounded
        # (``max_circuits``)
        self._compiled = _BoundedLRU(int(max_circuits))
        self._last_cc: Optional[CompiledCircuit] = None
        self.metrics.queue_depth_fn = lambda: self._backlog
        if warm_cache is None:
            from .warmcache import WarmCache
            warm_cache = WarmCache.from_env()
        self.warm_cache = warm_cache or None
        if perf_ledger is None:
            from ..telemetry.ledger import PerfLedger
            perf_ledger = PerfLedger.from_env()
        self.perf_ledger = perf_ledger or None
        # per-program measured latency, flushed to the perf ledger on
        # close: digest -> [completed, total_request_s, {bucket: n}]
        # (dispatcher-thread writes; close() reads after the join)
        self._lat_by_program: dict = {}
        self._inflight = 0           # requests inside an engine dispatch
        # multi-tenant scheduling (quest_tpu/serve/sched): the WFQ
        # virtual-time scheduler plus per-tenant queued/inflight and
        # per-priority-class accounting — all counters mutate under
        # _cond, mirroring every _backlog/_inflight transition
        self.scheduler = scheduler
        self._sched = WFQScheduler(tenants)
        self._tenant_queued: dict = {}    # tenant -> queued requests
        self._tenant_inflight: dict = {}  # tenant -> in-flight requests
        self._prio_queued: dict = {}      # priority class -> queued
        self._cost_est: dict = {}         # digest -> est request seconds
        # pipelined dispatch: above depth 1 the dispatcher launches and a
        # dedicated completion thread blocks/fans out in launch order;
        # the semaphore bounds launched-but-incomplete batches
        self.pipeline_depth = int(pipeline_depth)
        self._pipe: Optional[queue.Queue] = None
        self._pipe_sem: Optional[threading.Semaphore] = None
        self._completion: Optional[threading.Thread] = None
        # replica-fault simulation hooks (router chaos: a SIGKILLed
        # process / a wedged dispatcher that stops heartbeating)
        self._crashed = False
        self._wedge_until = 0.0
        # fault-tolerance state (quest_tpu/resilience): classifier-driven
        # retries with backoff, per-program circuit breaker, degraded
        # sequential mode, recovery event timeline, dispatcher heartbeat
        self.resilience = resilience if resilience is not None \
            else ResiliencePolicy()
        rp = self.resilience
        self._breaker = CircuitBreaker(rp.breaker_threshold,
                                       rp.breaker_window_s,
                                       rp.breaker_cooldown_s)
        self._retry_rng = np.random.default_rng(rp.seed)
        self._consec_faults: dict = {}     # program key -> fault streak
        self._degraded_until: dict = {}    # program key -> monotonic time
        self._tier_observed: dict = {}     # tier name -> max |norm - 1|
        self._program_refs: dict = {}      # program key -> weakref(cc)
        self._t0 = time.monotonic()
        self.events: collections.deque = collections.deque(
            maxlen=max(0, int(record_events)))
        # unified telemetry (quest_tpu/telemetry): request-scoped traces
        # behind a deterministic sampler, and the service's combined
        # dispatch_stats() document registered (weakly) for the
        # Prometheus/JSON exporters
        self.name = name or metrics_registry().unique_name("service")
        self.tracer = tracer if tracer is not None else Tracer(
            sample_rate=trace_sample_rate, name=self.name)
        self._registry_token = metrics_registry().register(
            self.name, self._registry_stats, kind="service", owner=self)
        self._heartbeat = time.monotonic()
        self._stall_flagged = False
        self._watchdog_stop = threading.Event()
        self._watchdog: Optional[threading.Thread] = None
        if self.pipeline_depth > 1:
            self._pipe = queue.Queue()
            self._pipe_sem = threading.Semaphore(self.pipeline_depth)
            self._completion = threading.Thread(
                target=self._completion_loop, daemon=True,
                name=f"quest-tpu-torch-serve-complete-{id(self):x}")
            self._completion.start()
        self._thread = threading.Thread(
            target=self._dispatch_loop, daemon=True,
            name=f"quest-tpu-torch-serve-{id(self):x}")
        self._thread.start()
        if rp.watchdog_timeout_s and rp.watchdog_timeout_s > 0:
            self._watchdog = threading.Thread(
                target=self._watchdog_loop, daemon=True,
                name=f"quest-tpu-torch-serve-watchdog-{id(self):x}")
            self._watchdog.start()

    # -- circuit resolution ------------------------------------------------

    def _resolve(self, circuit, trajectories: bool = False):
        """Accept a CompiledCircuit / TrajectoryProgram as-is; compile
        (and cache) a recorded Circuit. The cache is keyed on object
        identity — the strong ref to the source circuit keeps the id
        stable for the service's lifetime. ``trajectories=True`` lowers
        a recorded Circuit through ``compile_trajectories`` instead
        (its own cache slot: a circuit can be served both ways)."""
        if isinstance(circuit, TrajectoryProgram):
            if circuit.env is not self.env:
                raise ValueError(
                    "trajectory program was compiled against a "
                    "different QuESTEnv than this service's")
            return circuit
        if isinstance(circuit, CompiledCircuit):
            if circuit.env is not self.env:
                raise ValueError(
                    "circuit was compiled against a different QuESTEnv "
                    "than this service's")
            return circuit
        if isinstance(circuit, Circuit):
            cache_key = ("traj", id(circuit)) if trajectories \
                else id(circuit)
            entry = self._compiled.get(cache_key)
            if entry is None or entry[0] is not circuit:
                compiled = circuit.compile_trajectories(self.env) \
                    if trajectories else circuit.compile(self.env)
                entry = (circuit, compiled)
                self._compiled[cache_key] = entry
            return entry[1]
        raise TypeError(f"expected Circuit, CompiledCircuit or "
                        f"TrajectoryProgram, got "
                        f"{type(circuit).__name__}")

    def _param_vec(self, compiled: CompiledCircuit, params) -> np.ndarray:
        names = compiled.param_names
        # vector forms FIRST: a numpy array has no truth value, so the
        # `params or {}` default must only ever see dict/None
        if params is not None and not isinstance(params, dict):
            vec = np.asarray(params, dtype=np.float64)
            if vec.shape != (len(names),):
                raise ValueError(
                    f"parameter vector has shape {vec.shape}; expected "
                    f"({len(names)},) ordered like {list(names)}")
            return vec
        params = params or {}
        missing = [nm for nm in names if nm not in params]
        if missing:
            raise ValueError(f"missing circuit parameters: {missing}")
        return np.asarray([float(params[nm]) for nm in names],
                          dtype=np.float64)

    # -- public API --------------------------------------------------------

    def submit(self, circuit, params: Optional[dict] = None, *,
               observables=None, shots: Optional[int] = None,
               trajectories: Optional[int] = None,
               sampling_budget: Optional[float] = None,
               gradient: bool = False,
               evolve=None, ground_state=None, init_state=None,
               deadline: Optional[float] = None,
               error_budget: Optional[float] = None,
               tier=None, tenant: str = DEFAULT_TENANT,
               priority: Optional[int] = None, _trace=None,
               _progress=None) -> Future:
        """Enqueue one simulation request; returns its Future.

        ``circuit``: a :class:`CompiledCircuit` (preferred — submissions
        sharing the object coalesce) or a recorded :class:`Circuit`
        (compiled once and cached per object). ``params``: name->angle
        dict (or an ordered vector). Exactly one result shape per
        request:

        - default — the final packed ``(2, 2^n)`` planes (numpy);
        - ``observables=(pauli_terms, coeffs)`` — the scalar
          ``<H>`` / ``Tr(H rho)`` energy;
        - ``shots=m`` — ``(outcomes int64[m], total_norm)`` basis
          samples.

        ``deadline`` is a per-request latency budget in SECONDS from
        now (capped by the service's ``request_timeout_s``); a request
        that cannot dispatch in time resolves its future with
        :class:`DeadlineExceeded` instead of running stale. A
        non-positive deadline raises immediately; a full admission
        queue raises :class:`QueueFull`.

        ``trajectories=T`` makes this a TRAJECTORY request
        (``kind="trajectory"``): ``circuit`` is a noisy circuit lowered
        through ``compile_trajectories`` (a recorded Circuit with
        channels, compiled and cached here, or a ``TrajectoryProgram``)
        and the result is the ``(mean, stderr)`` Monte-Carlo estimate
        of the required ``observables=`` Pauli sum over at most T
        stochastic draws. ``sampling_budget`` states the target
        standard error: the dispatcher's wave loop stops as soon as the
        running estimate fits it, so typical requests execute a
        fraction of T (``trajectories_run`` / ``trajectories_saved``
        in the metrics; the dispatch trace span carries
        ``trajectories_run`` / ``early_stopped``). Requests sharing the
        program, observables, and (T, budget) contract coalesce into
        one (B, T) wave loop; a NaN result row is quarantined PER ROW
        (typed NumericalFault), its batchmates complete. Trajectory
        requests run at the environment precision (no tier ladder).

        ``gradient=True`` makes this a GRADIENT request
        (``kind="gradient"``): the result is the
        ``(value, grad)`` pair of the required ``observables=`` Pauli
        sum — the ``(P,)`` gradient w.r.t. the circuit's declared
        parameters, computed by ONE reverse pass through the batched
        engine (:meth:`~quest_tpu_torch.circuits.CompiledCircuit.
        value_and_grad_sweep`), never a parameter-shift loop. Requests
        sharing the program, observables, and tier coalesce into one
        ``(B, P)`` gradient executable with a single ``(B, P+1)``
        transfer. Combined with ``trajectories=T`` the request is a
        NOISY gradient: the trajectory program's differentiable wave
        loop returns ``(value, grad, stderr)`` with early stopping
        against ``sampling_budget``. Non-differentiable submissions
        reject typed at this boundary: ``shots=`` (samples have no
        gradient), a circuit with no declared parameters, and the
        QUAD tier (the dd walk has no transpose rules).

        ``evolve=EvolveSpec(t, steps, order)`` makes this a
        HAMILTONIAN-DYNAMICS request (``kind="evolve"``): the circuit
        prepares the start state (from |0..0> or ``init_state=``
        packed ``(2, 2^n)`` planes), then the request applies the
        Trotterised ``exp(-i H t)`` of the required ``observables=``
        Pauli sum with the WHOLE step loop iterating inside ONE
        executable (:meth:`~quest_tpu_torch.circuits.CompiledCircuit.
        evolve_sweep` — no per-step dispatch). The result is the
        packed per-row block — per-step energies ``<H>``, the folded
        Welford carry, and the final state planes; decode with
        :func:`quest_tpu_torch.ops.dynamics.unpack_evolve_block` (or use
        :meth:`evolve`, which streams decoded segments).
        ``ground_state=GroundSpec(...)`` is the imaginary-time /
        Lanczos analogue (``kind="ground_state"``): one fixed-step
        segment with on-device renormalisation and a device-resident
        convergence residual in the same single packed transfer
        (:meth:`ground_state` chains segments to convergence).
        Requests coalesce only when they agree on the Hamiltonian, the
        FULL spec contract, and the start-state digest — a group
        shares one keyed executable and one ``(B, W)`` transfer.
        Statevector programs only; the QUAD tier rejects typed (the
        scan-resident Trotter walk has no double-double form); not
        combinable with ``shots``/``trajectories``/``gradient``.

        ``error_budget`` states the max amplitude error this request
        may carry; the service picks the cheapest
        :class:`~quest_tpu_torch.config.PrecisionTier` whose modeled error
        fits (an unmeetable budget raises ``ValueError`` here).
        ``tier`` pins a rung explicitly. The tier is a coalescing
        dimension — a FAST sweep never pads into a batch at another
        tier — and the runtime fidelity monitor re-executes a request
        whose result drifts outside its tier's tolerance ONE TIER UP
        (``tier_escalations`` in the metrics) rather than returning an
        out-of-budget answer.

        ``tenant`` names the submitting tenant (default
        ``"default"``): a full coalescing dimension (batches stay
        single-tenant) and the WFQ scheduler's accounting unit — the
        tenant's :class:`~quest_tpu_torch.serve.sched.TenantPolicy` (see the
        constructor's ``tenants=`` / :meth:`set_tenant`) sets its fair
        share, priority class, and quotas. A tenant at its
        ``max_queued`` quota rejects typed with
        :class:`QuotaExceeded` — tenant-scoped backpressure that never
        blocks other tenants' admission. ``priority`` overrides the
        policy's class for THIS request (lower is more urgent; class 0
        is the interactive tier that checkpointed ``optimize()`` runs
        yield the mesh to).
        """
        if self._closed:
            raise ServiceClosed("service is closed")
        if observables is not None and shots is not None:
            raise ValueError(
                "a request returns ONE result: pass observables= for an "
                "energy or shots= for samples, not both (submit twice "
                "to get both)")
        if gradient:
            if shots is not None:
                raise ValueError(
                    "gradient requests differentiate a Pauli-sum "
                    "expectation; shot blocks have no gradient (drop "
                    "shots= or gradient=)")
            if observables is None:
                raise ValueError(
                    "gradient requests differentiate a Pauli-sum "
                    "observable; pass observables=(terms, coeffs)")
        if trajectories is not None:
            if int(trajectories) < 2:
                raise ValueError("trajectories must be >= 2 (a standard "
                                 "error needs at least two draws)")
            if shots is not None:
                raise ValueError(
                    "a request returns ONE result: trajectory requests "
                    "estimate observables=, not shot blocks")
            if observables is None:
                raise ValueError(
                    "trajectory requests estimate a Pauli-sum "
                    "observable; pass observables=(terms, coeffs)")
            if tier is not None or error_budget is not None:
                raise ValueError(
                    "trajectory requests run at the environment "
                    "precision; the tier ladder does not apply")
        elif sampling_budget is not None:
            raise ValueError("sampling_budget needs trajectories=")
        if sampling_budget is not None and float(sampling_budget) <= 0.0:
            raise ValueError("sampling_budget is a target standard "
                             "error and must be > 0")
        dyn_spec = None
        if evolve is not None and ground_state is not None:
            raise ValueError(
                "a request returns ONE result: pass evolve= for time "
                "evolution or ground_state= for the ground-state "
                "segment, not both")
        if evolve is not None or ground_state is not None:
            from ..ops.dynamics import EvolveSpec, GroundSpec
            if evolve is not None:
                if not isinstance(evolve, EvolveSpec):
                    raise TypeError(
                        "evolve= takes a quest_tpu_torch.ops.dynamics."
                        "EvolveSpec")
                dyn_spec = evolve
            else:
                if not isinstance(ground_state, GroundSpec):
                    raise TypeError(
                        "ground_state= takes a quest_tpu_torch.ops.dynamics."
                        "GroundSpec")
                dyn_spec = ground_state
            if shots is not None or trajectories is not None or gradient:
                raise ValueError(
                    "dynamics requests apply exp(-iHt) / imaginary "
                    "time to the prepared state; they do not combine "
                    "with shots=, trajectories=, or gradient=")
            if observables is None:
                raise ValueError(
                    "dynamics requests need the Hamiltonian: pass "
                    "observables=(pauli_terms, coeffs)")
        elif init_state is not None:
            raise ValueError("init_state= needs evolve= or ground_state=")
        compiled = self._resolve(circuit,
                                 trajectories=trajectories is not None)
        if isinstance(compiled, TrajectoryProgram) \
                and trajectories is None:
            raise ValueError(
                "TrajectoryProgram submissions need trajectories= "
                "(the ensemble's max draw count)")
        if trajectories is not None \
                and not isinstance(compiled, TrajectoryProgram):
            raise TypeError(
                "trajectories= needs a trajectory-lowerable circuit: "
                "pass the recorded noisy Circuit (the service compiles "
                "and caches it) or a TrajectoryProgram, not a "
                "CompiledCircuit")
        if gradient and not compiled.param_names:
            raise ValueError(
                "gradient requests differentiate the circuit's "
                "declared parameters; this circuit declares none "
                "(record angles via Circuit.parameter / Param "
                "placeholders)")
        vec = self._param_vec(compiled, params)
        now = time.monotonic()
        abs_deadline = now + self.request_timeout_s
        if deadline is not None:
            if deadline <= 0.0:
                self.metrics.incr("rejected_deadline")
                raise DeadlineExceeded(
                    f"deadline {deadline!r} s is already unmeetable")
            abs_deadline = min(abs_deadline, now + float(deadline))
        if trajectories is not None:
            kind = KIND_GRADIENT if gradient else KIND_TRAJECTORY
            ham, obs_key = _canonical_observables(compiled, observables)
            # the convergence contract is a coalescing dimension: a
            # group must agree on (max_T, budget) to share a wave loop
            obs_key = obs_key + (int(trajectories),
                                 float(sampling_budget)
                                 if sampling_budget is not None else -1.0)
            if gradient:
                # the gradient width is a coalescing dimension too
                obs_key = obs_key + (len(compiled.param_names),)
        elif gradient:
            kind = KIND_GRADIENT
            ham, obs_key = _canonical_observables(compiled, observables)
            # obs masks + the gradient width P: a group must agree on
            # both to share one (B, P) reverse pass
            obs_key = obs_key + (len(compiled.param_names),)
        elif dyn_spec is not None:
            kind = KIND_EVOLVE if evolve is not None else KIND_GROUND
            if compiled.is_density:
                raise ValueError(
                    "dynamics requests run on statevector-compiled "
                    "programs (Trotter rotations act on ket "
                    "amplitudes); evolve density registers through "
                    "their channel circuits")
            ham, obs_key = _canonical_observables(compiled, observables)
            dyn_state = None
            sd = "zero"
            if init_state is not None:
                nq_c = compiled.num_qubits
                # the caller's start planes, validated and digested at
                # admission (a tensor is copied to the host once here)
                dyn_state = _host(init_state).astype(np.float64)
                if dyn_state.shape != (2, 1 << nq_c):
                    raise ValueError(
                        f"init_state must be packed (2, {1 << nq_c}) "
                        f"planes; got {dyn_state.shape}")
                import hashlib
                sd = hashlib.sha256(dyn_state.tobytes()).hexdigest()[:16]
            # the spec contract + start-state digest are coalescing
            # dimensions: a group must agree on the WHOLE evolution
            # (dt, steps, order / tau, method, tol AND the seed
            # planes) to share one keyed executable and one packed
            # (B, W) transfer per segment
            obs_key = obs_key + dyn_spec.contract() + (sd,)
        elif shots is not None:
            if int(shots) < 1:
                raise ValueError("shots must be >= 1")
            if compiled.is_density:
                raise ValueError(
                    "shot requests draw from |amp|^2 of statevector "
                    "programs; use observables= on density circuits")
            kind, ham, obs_key = KIND_SAMPLE, None, ()
        elif observables is not None:
            kind = KIND_EXPECTATION
            ham, obs_key = _canonical_observables(compiled, observables)
        else:
            kind, ham, obs_key = KIND_STATE, None, ()
        if tier is not None:
            # per-request = per-dispatch: the QUAD rung is admitted here
            # (dd engine runner), where a compile-time quad would be
            # rejected. Gradient requests take the GRAD resolution —
            # the quad rung rejects typed (the dd walk has no
            # transpose rules)
            req_tier = compiled._grad_tier(tier) if gradient \
                else compiled._resolve_tier(tier, dispatch=True)
        elif error_budget is not None:
            from ..profiling import choose_tier, engine_tiers
            ladder = None
            if gradient:
                # the budget selector must never hand a gradient
                # request the non-differentiable quad rung
                ladder = [t for t in engine_tiers(self.env)
                          if t.name != "quad"]
            req_tier = choose_tier(
                float(error_budget),
                max(compiled.circuit.depth, 1), self.env, tiers=ladder)
        else:
            req_tier = compiled.tier     # the compile-time tier, if any
        if dyn_spec is not None and req_tier is not None \
                and req_tier.name == "quad":
            raise ValueError(
                "dynamics requests cannot run at the QUAD tier: the "
                "double-double walk has no scan-resident Trotter form; "
                "use tier='double' for the highest rung")
        tenant = str(tenant)
        tpol = self._sched.policy_for(tenant)
        prio = tpol.priority if priority is None else int(priority)
        if prio < 0:
            raise ValueError(f"priority must be >= 0, got {prio}")
        key = coalesce_key(compiled, kind, obs_key, int(shots or 0),
                           req_tier, tenant=tenant)
        fut: Future = Future()
        req = _Request(compiled, vec, kind, ham, int(shots or 0), now,
                       abs_deadline, fut, self.max_retries, key,
                       tier=req_tier, obs_key=obs_key,
                       trajectories=int(trajectories or 0),
                       sampling_budget=(float(sampling_budget)
                                        if sampling_budget is not None
                                        else None),
                       tenant=tenant, priority=prio,
                       dynamics=((dyn_spec, dyn_state)
                                 if dyn_spec is not None else None),
                       progress=_progress)
        # request-scoped tracing: a router-propagated context rides in
        # via _trace (the router owns + finishes it); otherwise the
        # service's own sampler decides, and the service finishes the
        # trace at future resolution (one done-callback catches EVERY
        # resolution path — fan-out, expiry, breaker, quarantine)
        ctx = _trace if _trace is not None else self.tracer.start(
            service=self.name)
        if ctx is not None:
            req.trace = ctx
            req.trace_owned = _trace is None
            ctx.add("submit", service=self.name, kind=kind,
                    program=self._program_key_str(compiled),
                    tier=req_tier.name if req_tier is not None else "env",
                    deadline_s=round(abs_deadline - now, 6))
            req.qspan = ctx.begin("queue")
            if req.trace_owned:
                fut.add_done_callback(
                    lambda f, c=ctx: self._finish_trace(c, f))
        try:
            with self._cond:
                if self._closed:
                    raise ServiceClosed("service is closed")
                if self._backlog >= self.max_queue:
                    self.metrics.incr("rejected_queue_full")
                    raise QueueFull(
                        f"admission queue is at capacity "
                        f"({self.max_queue}); retry later or raise "
                        "max_queue")
                if tpol.max_queued is not None and \
                        self._tenant_queued.get(tenant, 0) \
                        >= tpol.max_queued:
                    self.metrics.incr("rejected_quota")
                    self.metrics.incr_tenant(tenant, "rejected_quota")
                    raise QuotaExceeded(
                        f"tenant {tenant!r} is at its queued-request "
                        f"quota ({tpol.max_queued}); shed load or "
                        f"raise max_queued in its TenantPolicy")
                self._backlog += 1
                self._note_queued(req, 1)
                self._queue.append(req)
                self._cond.notify_all()
        except ServeError as e:
            # admission rejected: the future will never resolve, so a
            # service-owned trace must be closed HERE or it leaks
            # unfinished (a router-owned one lives on — the router
            # re-places the work and finishes it)
            if ctx is not None and req.trace_owned:
                ctx.add("resolve", status=type(e).__name__)
                ctx.finish(type(e).__name__)
            raise
        self.metrics.incr("submitted")
        self.metrics.incr_tenant(tenant, "submitted")
        return fut

    def warm(self, circuit, batch_sizes: Optional[Sequence[int]] = None,
             observables=None, shots: Optional[int] = None,
             tier=None, trajectories: Optional[int] = None,
             gradient: bool = False):
        """Do the setup the given traffic will need before it arrives, so
        first requests pay dispatch latency only: on the card build the
        kernels (:func:`quest_tpu_torch.ops.cuda_build.build_all`),
        precompile the program (its layers packed, its plain ops'
        operators on the device) and run one throwaway padded dispatch
        per batch size in ``batch_sizes`` (default: the buckets this
        program's traffic hit in prior runs, per the perf ledger, else
        the policy's ``max_batch`` bucket) through the same entry point
        live requests will use — ``sweep`` by default,
        ``expectation_sweep`` when ``observables`` is given,
        ``value_and_grad_sweep`` with ``gradient=True``,
        ``sample_sweep`` when ``shots`` is (from a private generator:
        the environment's stream is drawn on the dispatcher thread
        only). With a persistent warm cache, each bucket's form is
        LOADED from disk when a previous process stored it
        (``warm_cache_hits``: its layers pack nothing) and packed and
        stored otherwise (``warm_cache_misses``), before the program is
        precompiled. ``tier`` warms one precision tier's plan (the traffic's
        ``submit(tier=...)`` / ``error_budget`` rung). ``trajectories``
        (with ``observables=``) warms the TRAJECTORY wave loop instead —
        a recorded noisy circuit lowers through ``compile_trajectories``
        and one throwaway wave runs per batch bucket (seeded, off the
        environment's stream). Returns the compiled circuit (submit it
        back for guaranteed coalescing)."""
        compiled = self._resolve(circuit,
                                 trajectories=trajectories is not None)
        if compiled.env.device.type == "cuda":
            from ..ops import cuda_build
            cuda_build.build_all()
        if isinstance(compiled, TrajectoryProgram):
            if observables is None:
                raise ValueError(
                    "warming a trajectory program needs observables= "
                    "(the wave loop embeds the Pauli-sum reduction)")
            ham, _ = _canonical_observables(compiled, observables)
            sizes = tuple(batch_sizes) if batch_sizes is not None \
                else (1,)
            warm_t = int(trajectories) if trajectories is not None \
                and int(trajectories) >= 2 \
                else 32   # the live loop's default wave
            for bs in sizes:
                padded = self.policy.bucket_size(int(bs), 1)
                pm = np.zeros((padded, len(compiled.param_names)),
                              dtype=np.float64)
                if gradient:
                    compiled.expectation_grad_batch(pm, ham, warm_t,
                                                    wave_size=warm_t,
                                                    seed=0)
                else:
                    compiled.expectation_batch(pm, ham, warm_t,
                                               wave_size=warm_t, seed=0)
            self._last_cc = compiled
            return compiled
        tier = compiled._effective_tier(tier)
        if batch_sizes is not None:
            sizes = tuple(batch_sizes)
        else:
            # default bucket choice: the buckets this program's traffic
            # ACTUALLY hit in prior runs (the persistent perf ledger),
            # falling back to the policy's max_batch bucket cold
            sizes = ()
            if self.perf_ledger is not None:
                recorded = self.perf_ledger.warm_buckets(
                    getattr(compiled, "program_digest", "") or "")
                sizes = tuple(b for b in recorded
                              if 1 <= b <= 2 * self.policy.max_batch)
            if not sizes:
                sizes = (self.policy.max_batch,)
        mult = self._device_multiple(compiled)
        ham = None
        if observables is not None:
            ham, _ = _canonical_observables(compiled, observables)
        if gradient and ham is None:
            raise ValueError("warming gradient dispatches needs "
                             "observables= (the reverse pass embeds "
                             "the Pauli-sum reduction)")
        padded_sizes = [self.policy.bucket_size(int(bs), mult)
                        for bs in sizes]
        if self.warm_cache is not None:
            # gradient forms persist too ("grad": the adjoint layers are
            # their own), so gradient-heavy tenants restart warm
            kind = "grad" if gradient else (
                "energy" if observables is not None else "sweep")
            for padded in padded_sizes:
                status = self.warm_cache.warm_form(
                    compiled, kind, padded, hamiltonian=ham, tier=tier)
                if status == "hit":
                    self.metrics.incr("warm_cache_hits")
                elif status == "miss":
                    self.metrics.incr("warm_cache_misses")
        compiled.precompile()
        for padded in padded_sizes:
            pm = np.zeros((padded, len(compiled.param_names)),
                          dtype=np.float64)
            if gradient:
                compiled.value_and_grad_sweep(pm, ham, tier=tier)
            elif observables is not None:
                compiled.expectation_sweep(pm, ham, tier=tier)
            elif shots is not None:
                compiled.sample_sweep(pm, int(shots),
                                      generator=torch.Generator(),
                                      tier=tier)
            else:
                _host(compiled.sweep(pm, tier=tier))
        self._last_cc = compiled
        return compiled

    def optimize(self, problem, optimizer="adam", *,
                 max_iters: int = 100, tol: float = 1e-6,
                 learning_rate: Optional[float] = None,
                 checkpoint_path: Optional[str] = None,
                 resume: bool = True, max_restarts: int = 3,
                 tenant: str = DEFAULT_TENANT,
                 yield_to_interactive: bool = True,
                 preempt_hold_s: float = 5.0):
        """Run a variational optimization INSIDE the serving layer and
        stream its iterates back (the JAX package's optimizer-in-the-loop
        API).

        ``problem`` is a :class:`~quest_tpu_torch.serve.optimize.
        VariationalProblem` (circuit + Pauli-sum objective + starting
        point, optionally a trajectory/sampling-budget contract for noisy
        objectives). Each iterate is ONE ``gradient=True`` submission — a
        coalesced value-and-grad dispatch through the batched engine (on
        the card the batched layer kernel, and for a trajectory objective
        the fused Kraus kernel through ``expectation_grad_batch``) —
        followed by a host-side ``optimizer`` step (``"adam"`` / ``"gd"``
        or an ``init``/``update`` object). The returned
        :class:`~quest_tpu_torch.serve.optimize.OptimizationHandle` yields
        each ``{iteration, value, grad_norm, x, converged}`` from
        ``iterates()`` as it lands and resolves the final summary via
        ``result()``. Convergence is ``|value_k - value_{k-1}| <= tol``,
        bounded by ``max_iters``.

        ``checkpoint_path`` checkpoints every completed iterate atomically
        (:func:`quest_tpu_torch.resilience.segments.opt_progress_save`);
        with ``resume=True`` a killed run continues from its last good
        iterate, digest-guarded, so a checkpoint of another problem or
        optimizer configuration is ignored. Transient iterate faults
        re-execute within ``max_restarts``; fatal errors fail the handle
        with the original exception. ``tenant`` attributes every gradient
        submission to a WFQ tenant; ``yield_to_interactive`` yields to
        queued priority-0 work at each iterate (= checkpoint) boundary, at
        most ``preempt_hold_s`` seconds per preemption."""
        from .optimize import run_optimization
        return run_optimization(
            self, problem, optimizer, max_iters=max_iters, tol=tol,
            learning_rate=learning_rate,
            checkpoint_path=checkpoint_path, resume=resume,
            max_restarts=max_restarts, tenant=tenant,
            yield_to_interactive=yield_to_interactive,
            preempt_hold_s=preempt_hold_s)

    def evolve(self, circuit, params=None, *, hamiltonian, t: float,
               steps: int, order: int = 2, init_state=None, tier=None,
               segment_steps: int = 64,
               checkpoint_path: Optional[str] = None,
               resume: bool = True, max_restarts: int = 3,
               tenant: str = DEFAULT_TENANT,
               yield_to_interactive: bool = True,
               preempt_hold_s: float = 5.0):
        """Run real-time Hamiltonian evolution INSIDE the serving layer
        and stream its segments back.

        ``circuit`` prepares the start state (with ``params`` bound; an
        empty circuit evolves ``init_state`` / |0...0> directly), then the
        state evolves by ``exp(-i * hamiltonian * t)`` in ``steps`` Trotter
        steps of ``order`` (1 or 2), recording the Pauli-sum energy after
        EVERY step. A segment of ``segment_steps`` steps is one coalesced
        ``evolve=`` dispatch (``CompiledCircuit.evolve_sweep``: the prep
        program through the batched layer kernel on the card, then the
        step loop) returning one packed block: the per-step energies, the
        Welford carry and the exit-state planes the next segment seeds
        from, through an identity continuation circuit. The returned
        :class:`~quest_tpu_torch.serve.dynamics.DynamicsHandle` yields one
        dict per segment from ``iterates()`` and resolves ``{"energy",
        "energies", "planes", "welford", ...}`` via ``result()``.

        ``checkpoint_path`` checkpoints every completed segment atomically
        (:func:`quest_tpu_torch.resilience.segments.dyn_progress_save`,
        digest-guarded); with ``resume=True`` a killed run continues
        BIT-EXACTLY from its last good segment. Transient segment faults
        re-execute within ``max_restarts``; ``tenant`` /
        ``yield_to_interactive`` / ``preempt_hold_s`` attribute and preempt
        as in :meth:`optimize`."""
        from ..ops.dynamics import EvolveSpec
        from .dynamics import DynamicsProblem, run_dynamics
        spec = EvolveSpec(t=float(t), steps=int(steps), order=int(order))
        problem = DynamicsProblem(
            circuit=circuit, hamiltonian=hamiltonian, spec=spec,
            params=params, init_state=init_state, tier=tier)
        return run_dynamics(
            self, problem, segment_steps=segment_steps,
            checkpoint_path=checkpoint_path, resume=resume,
            max_restarts=max_restarts, tenant=tenant,
            yield_to_interactive=yield_to_interactive,
            preempt_hold_s=preempt_hold_s)

    def ground_state(self, circuit, params=None, *, hamiltonian,
                     steps: int = 16, tau: float = 0.1,
                     method: str = "power", tol: float = 1e-9,
                     max_segments: int = 64, init_state=None,
                     tier=None, checkpoint_path: Optional[str] = None,
                     resume: bool = True, max_restarts: int = 3,
                     tenant: str = DEFAULT_TENANT,
                     yield_to_interactive: bool = True,
                     preempt_hold_s: float = 5.0):
        """Run an imaginary-time ground-state search INSIDE the serving
        layer and stream its segments back.

        Each segment is ONE coalesced ``ground_state=`` dispatch
        (``CompiledCircuit.ground_sweep``): ``steps`` iterations of
        imaginary-time power iteration at time-step ``tau``
        (``method="power"``) or a ``steps``-vector Lanczos recursion
        (``method="lanczos"``), returning per-iteration energies, the
        convergence residual, the Welford carry and the exit-state planes
        in one packed block. The loop stops when the residual crosses
        ``tol`` (bounded by ``max_segments`` segments) and the handle
        resolves ``{"energy", "residual", "converged", ...}``.
        Checkpointing, resume, restart, tenancy and preemption behave as
        in :meth:`evolve`."""
        from ..ops.dynamics import GroundSpec
        from .dynamics import DynamicsProblem, run_dynamics
        spec = GroundSpec(steps=int(steps), tau=float(tau),
                          method=str(method), tol=float(tol))
        problem = DynamicsProblem(
            circuit=circuit, hamiltonian=hamiltonian, spec=spec,
            params=params, init_state=init_state, tier=tier)
        return run_dynamics(
            self, problem, max_segments=max_segments,
            checkpoint_path=checkpoint_path, resume=resume,
            max_restarts=max_restarts, tenant=tenant,
            yield_to_interactive=yield_to_interactive,
            preempt_hold_s=preempt_hold_s)

    def pause(self) -> None:
        """Hold dispatching (requests keep queueing, deadlines keep
        counting). For drain-control and deterministic tests."""
        with self._cond:
            self._paused = True
            self._cond.notify_all()

    def resume(self) -> None:
        with self._cond:
            self._paused = False
            self._cond.notify_all()

    def set_tenant(self, tenant: str, policy: TenantPolicy) -> None:
        """Install or replace one tenant's scheduling contract
        (:class:`~quest_tpu_torch.serve.sched.TenantPolicy`) live. Quotas
        apply to the next admission; the weight/priority apply to the
        next dispatch cycle."""
        with self._cond:
            self._sched.set_policy(str(tenant), policy)
            self._cond.notify_all()

    def interactive_pressure(self) -> bool:
        """True while priority-0 (interactive-class) work is queued —
        the yield signal long checkpointed work polls at its segment
        boundaries (:meth:`optimize` iterates,
        :func:`~quest_tpu_torch.resilience.segments.checkpointed_sweep`'s
        ``yield_to=``). Reads one int under the GIL: safe from any
        thread, never blocks."""
        return self._prio_queued.get(0, 0) > 0

    def _note_queued(self, req: "_Request", delta: int) -> None:
        """Per-tenant and per-priority-class queued accounting; must
        mirror every ``_backlog`` mutation. Caller holds ``_cond``."""
        t, p = req.tenant, req.priority
        n = self._tenant_queued.get(t, 0) + delta
        if n > 0:
            self._tenant_queued[t] = n
        else:
            self._tenant_queued.pop(t, None)
        n = self._prio_queued.get(p, 0) + delta
        if n > 0:
            self._prio_queued[p] = n
        else:
            self._prio_queued.pop(p, None)

    # -- replica-lifecycle hooks (serve/router.py) -------------------------

    def quiesce(self, timeout: Optional[float] = 30.0) -> bool:
        """Block until nothing is queued or mid-dispatch (the rolling-
        restart drain point: a quiesced replica can be swapped out with
        zero in-flight work). Returns False on timeout or when the
        dispatcher died with work still pending."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._cond:
                idle = self._backlog == 0 and self._inflight == 0
            if idle:
                return True
            if not self._thread.is_alive():
                return self._backlog == 0 and self._inflight == 0
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(1e-3)

    def is_alive(self) -> bool:
        """True while the dispatcher thread is serving (a crashed
        replica answers False immediately — the flag, not the thread's
        exit, is the death; the supervisor's liveness probe)."""
        return self._thread.is_alive() and not self._closed \
            and not self._crashed

    def program_state(self, circuit) -> dict:
        """Read-only per-program health for the router's breaker-aware
        placement: ``{"breaker": "closed"|"open"|"half-open"|"unknown",
        "degraded": bool}``. Never mutates breaker/LRU state (safe from
        any thread)."""
        cc = None
        if isinstance(circuit, CompiledCircuit):
            cc = circuit
        elif isinstance(circuit, Circuit):
            entry = self._compiled.peek(id(circuit))
            if entry is not None and entry[0] is circuit:
                cc = entry[1]
        if cc is None:
            return {"breaker": "unknown", "degraded": False}
        key = self._program_key_str(cc)
        return {"breaker": self._breaker.state(key),
                "degraded":
                    time.monotonic() < self._degraded_until.get(key, 0.0)}

    def _debug_crash(self) -> None:
        """TEST/CHAOS HOOK: die the way a SIGKILLed replica process
        does — the dispatcher thread exits immediately, queued and
        in-flight futures are STRANDED (never resolved by this
        service). The router's supervisor must detect the dead
        dispatcher and fail the work over; nothing in this process
        cleans up after it, exactly like the real failure."""
        self._crashed = True
        with self._cond:
            self._cond.notify_all()

    def _debug_wedge(self, duration_s: float) -> None:
        """TEST/CHAOS HOOK: wedge the dispatcher for ``duration_s`` —
        it stops heartbeating (the watchdog will flag a stall) and
        serves nothing, the shape of a hung collective. close()
        unwedges (a convenience a real hang would not offer)."""
        self._wedge_until = time.monotonic() + float(duration_s)

    def dispatch_stats(self) -> dict:
        """Engine-level :class:`~quest_tpu_torch.profiling.DispatchStats`
        fields of the most recently served compiled circuit (empty dict
        before the first dispatch), with the serving metrics snapshot
        folded in under ``"service"`` and the fault-tolerance accounting
        under ``"resilience"`` (breaker states, degraded programs,
        health-guard counters, and — when a fault injector is installed
        — its full injection accounting, so every injected fault is
        accounted for next to the recovery it caused)."""
        base = self._last_cc.dispatch_stats().as_dict() \
            if self._last_cc is not None else {}
        now = time.monotonic()
        # dict() copies are C-level atomic under the GIL; iterating the
        # live dict here would race the dispatcher thread's inserts
        degraded = dict(self._degraded_until)
        res = {
            "breaker": self._breaker.snapshot(),
            "degraded_programs": sorted(
                k for k, t in degraded.items() if t > now),
            "health": _health.health_stats(),
            "events_recorded": len(self.events),
            # modeled-vs-observed per tier: the compile-time model's
            # bound sits in the engine stats (modeled_tier_error); this
            # is the fidelity monitor's measured counterpart
            "tier_observed_drift": dict(self._tier_observed),
        }
        inj = _faults.active()
        if inj is not None:
            res["fault_injection"] = inj.snapshot()
        out = {**base, "service": self.metrics.snapshot(),
               "scheduler": {**self._sched.snapshot(),
                             "mode": self.scheduler,
                             "pipeline_depth": self.pipeline_depth,
                             "tenant_queued": dict(self._tenant_queued),
                             "tenant_inflight":
                                 dict(self._tenant_inflight)},
               "resilience": res,
               "telemetry": self.tracer.stats(),
               # the model-vs-measured layer: per-key device-time
               # percentiles + roofline_frac and the drift gauges (the
               # profiler is process-global)
               "profile": _profile.profiler().snapshot()}
        if self.warm_cache is not None:
            out["warm_cache"] = self.warm_cache.stats()
        if self.perf_ledger is not None:
            out["perf_ledger"] = self.perf_ledger.stats()
        return out

    def _registry_stats(self) -> dict:
        """The document the metrics registry scrapes: everything in
        :meth:`dispatch_stats` EXCEPT the process-global profiler
        section — that one is registered once under its own
        ``dispatch_profiler`` provider, and re-exporting it per
        service/replica would multiply every profiler gauge by the
        provider count in one ``prometheus_text()`` scrape."""
        out = self.dispatch_stats()
        out.pop("profile", None)
        return out

    def close(self, drain: bool = True, timeout: Optional[float] = 30.0
              ) -> None:
        """Stop accepting submissions and shut the dispatcher down.

        ``drain=True`` (default) dispatches everything already queued
        (max-wait no longer applies — partial batches flush
        immediately); ``drain=False`` fails queued futures with
        :class:`ServiceClosed`. Idempotent."""
        with self._cond:
            self._closed = True
            self._drain_on_close = self._drain_on_close and drain
            self._paused = False
            self._cond.notify_all()
        if threading.current_thread() is not self._thread:
            self._thread.join(timeout)
        if self._completion is not None and \
                threading.current_thread() is not self._completion:
            # the dispatcher no longer launches: a FIFO stop sentinel
            # lets every already-launched batch complete and fan out
            # before the completion thread exits
            self._pipe.put(_PIPE_STOP)
            self._completion.join(timeout)
        self._watchdog_stop.set()
        metrics_registry().unregister(self._registry_token)
        self._flush_perf_ledger()

    def _flush_perf_ledger(self) -> None:
        """Record this service's measured per-program accounting into
        the persistent perf ledger (idempotent: the accumulators are
        cleared after a successful flush, so a double close never
        double-counts). Best-effort: the ledger can make the next
        restart smarter, never make this shutdown fail."""
        if self.perf_ledger is None or not self._lat_by_program:
            return
        # RuntimeError included: a dispatcher that outlived a timed-out
        # join can mutate the dict mid-iteration — a lost flush window,
        # never a failed shutdown
        try:
            for digest, ent in list(self._lat_by_program.items()):
                if ent[0]:
                    self.perf_ledger.record_program(
                        digest, requests=ent[0], total_request_s=ent[1],
                        buckets=ent[2], tiers=ent[3])
            self._lat_by_program.clear()
            prof = _profile.profiler()
            if prof.sample_rate > 0.0:
                prof.flush_to_ledger(self.perf_ledger)
        except (OSError, ValueError, TypeError, KeyError, RuntimeError):
            pass    # best-effort persistence; the shutdown proceeds

    def __enter__(self) -> "SimulationService":
        return self

    def __exit__(self, *exc) -> bool:
        self.close(drain=exc == (None, None, None))
        return False

    # -- dispatcher --------------------------------------------------------

    @staticmethod
    def _device_multiple(compiled: CompiledCircuit) -> int:
        """Batch-bucket floor: pad to a device multiple on a mesh env, so
        a batch-sharded dispatch splits evenly over the shards and never
        takes the engine's pad-and-mask path."""
        return compiled.env.num_devices if compiled.env.mesh is not None \
            else 1

    def _idle_wait(self) -> float:
        """The longest the dispatcher may sleep with no scheduled wake
        deadline. Precise waking (submit/pause/resume/close all notify
        the condition, and every pending event — batch maturity, retry
        backoff, request expiry — feeds ``next_deadline``) removed the
        old fixed 50 ms cap; the only remaining bound is the watchdog:
        an idle dispatcher must keep heartbeating well inside
        ``watchdog_timeout_s`` or sleeping would read as a stall."""
        t = self.resilience.watchdog_timeout_s
        return max(1e-3, min(t / 4.0, 2.0)) if t and t > 0 else 2.0

    def _batch_cost(self, batch: list) -> float:
        """Projected mesh-seconds for one ready batch — the WFQ
        scheduler's currency. Per-program measured request seconds
        (live EMA from completed dispatches, seeded from the perf
        ledger's recorded history — elasticity and fairness price new
        work from what the program actually cost before), falling back
        to 1.0/request cold so relative weights still arbitrate."""
        digest = getattr(batch[0].compiled, "program_digest", "") or ""
        est = self._cost_est.get(digest)
        if est is None:
            est = 0.0
            if self.perf_ledger is not None and digest:
                est = self.perf_ledger.mean_request_s(digest)
            self._cost_est[digest] = est
        if est <= 0.0:
            est = 1.0
        return len(batch) * est

    def _dispatch_loop(self) -> None:
        pending: dict = {}   # coalesce key -> FIFO list of _Request
        while True:
            if self._crashed:
                return       # simulated process death: strand everything
            if self._wedge_until and not self._closed:
                # simulated hang: no heartbeat, no service, until the
                # wedge lapses (or close() pulls the plug)
                if time.monotonic() < self._wedge_until:
                    time.sleep(2e-3)
                    continue
                self._wedge_until = 0.0
            self._heartbeat = time.monotonic()
            with self._cond:
                if self._paused and not self._closed:
                    # held: requests stay in the admission queue
                    # (deadlines keep counting; they expire on resume —
                    # resume()/close() notify, so the wait only bounds
                    # the heartbeat cadence)
                    self._cond.wait(timeout=self._idle_wait())
                    continue
                if self._closed and not self._drain_on_close:
                    for req in list(self._queue) + \
                            [r for v in pending.values() for r in v]:
                        self._backlog -= 1
                        self._note_queued(req, -1)
                        if req.future.set_running_or_notify_cancel():
                            req.future.set_exception(ServiceClosed(
                                "service closed before dispatch"))
                    self._queue.clear()
                    return
                while self._queue:
                    req = self._queue.popleft()
                    pending.setdefault(req.key, []).append(req)
                if not pending:
                    if self._closed:
                        return
                    # nothing admitted anywhere: sleep until notified
                    # (submit notifies) — no deadline can pass while
                    # nothing is pending
                    self._cond.wait(timeout=self._idle_wait())
                    continue
            now = time.monotonic()
            self._expire(pending, now)
            drain = self._closed
            ready: list = []
            next_deadline = None
            for key in list(pending):
                group = pending[key]
                if drain:
                    # shutdown flushes everything — a retry backoff must
                    # not outlive the service
                    eligible, held = group, []
                else:
                    # retry backoff: requests sleeping out their delay
                    # stay pending (invisible to max-wait maturity) and
                    # wake the loop when the earliest delay lapses
                    eligible = [r for r in group if r.not_before <= now]
                    held = [r for r in group if r.not_before > now]
                batches, rest, nd = split_ready(eligible, now,
                                                self.policy, drain=drain)
                rest = rest + held
                if held:
                    wake = min(r.not_before for r in held)
                    nd = wake if nd is None else min(nd, wake)
                if rest:
                    pending[key] = rest
                else:
                    del pending[key]
                if rest:
                    # a surviving request's expiry is a wake deadline
                    # too: precise waking must run _expire on time, not
                    # an arbitrary 50 ms later
                    exp = min(r.deadline for r in rest)
                    nd = exp if nd is None else min(nd, exp)
                ready.extend(batches)
                if nd is not None:
                    next_deadline = nd if next_deadline is None \
                        else min(next_deadline, nd)
            if not ready:
                with self._cond:
                    if not self._queue and not self._closed:
                        # the precise-wake satellite: sleep exactly to
                        # the earliest pending event (batch maturity,
                        # backoff lapse, or expiry), bounded only by
                        # the watchdog-safe idle cap — not the old
                        # fixed 50 ms spin
                        wait = self._idle_wait() if next_deadline is None \
                            else max(1e-5, min(
                                next_deadline - time.monotonic(),
                                self._idle_wait()))
                        self._cond.wait(timeout=wait)
                continue
            if self.scheduler == "wfq" and len(ready) > 1:
                # weighted-fair dispatch order: strict priority class,
                # then virtual finish tags over projected mesh seconds
                entries = [(b[0].tenant, self._batch_cost(b), b)
                           for b in ready]
                ready = [b for _, _, b in self._sched.order(entries)]
            dispatched = 0
            deferred: list = []
            for batch in ready:
                tenant = batch[0].tenant
                tpol = self._sched.policy_for(tenant)
                if tpol.max_inflight is not None and not drain:
                    with self._cond:
                        inflight = self._tenant_inflight.get(tenant, 0)
                    # a batch wider than the quota still runs when the
                    # tenant is otherwise idle (it could never run at
                    # all otherwise); anything else defers until
                    # _finish_inflight frees rows
                    if inflight > 0 and \
                            inflight + len(batch) > tpol.max_inflight:
                        deferred.append(batch)
                        continue
                if self.scheduler == "wfq":
                    self._sched.charge(tenant, self._batch_cost(batch))
                self._execute(batch)
                dispatched += 1
            for batch in deferred:
                # over-quota batches return to the FRONT of their
                # group (oldest first) and re-form next cycle
                self.metrics.incr("quota_deferrals", len(batch))
                pending.setdefault(batch[0].key, [])[:0] = batch
            if deferred and not dispatched:
                # everything ready is quota-blocked: sleep until a
                # completion frees inflight rows (_finish_inflight
                # notifies) instead of spinning on mature batches
                with self._cond:
                    if not self._queue and not self._closed:
                        self._cond.wait(timeout=self._idle_wait())

    def _expire(self, pending: dict, now: float) -> None:
        for key in list(pending):
            alive = []
            for req in pending[key]:
                if now > req.deadline:
                    with self._cond:
                        self._backlog -= 1
                        self._note_queued(req, -1)
                    self.metrics.incr("timeouts")
                    if req.future.set_running_or_notify_cancel():
                        req.future.set_exception(DeadlineExceeded(
                            f"request expired after "
                            f"{now - req.submit_t:.3f}s in queue"))
                else:
                    alive.append(req)
            if alive:
                pending[key] = alive
            else:
                del pending[key]

    # -- recovery path -----------------------------------------------------

    @staticmethod
    def _program_key_str(cc: CompiledCircuit) -> str:
        """The key FORMAT shared by the mutating :meth:`_program_key`
        and the read-only :meth:`program_state` — one definition, so the
        router's breaker-aware placement can never drift onto a stale
        key shape and silently stop seeing open breakers."""
        return f"{'dm' if cc.is_density else 'sv'}-" \
               f"{cc.num_qubits}q-{id(cc):x}"

    def _program_key(self, cc: CompiledCircuit) -> str:
        """Stable resilience key for one compiled program. ``id()`` alone
        is not enough — CPython recycles addresses, so a collected
        circuit's open-breaker/degraded state could land on an unrelated
        new program. A weakref per key detects recycling (stale state is
        dropped) and lets dead keys be pruned, bounding the maps on a
        long-lived service. Dispatcher-thread only."""
        key = self._program_key_str(cc)
        ref = self._program_refs.get(key)
        if ref is None or ref() is not cc:
            if ref is not None:
                # recycled id: the recorded state belongs to a dead
                # program — reset everything filed under this key
                self._breaker.record_success(key)
                self._consec_faults.pop(key, None)
                self._degraded_until.pop(key, None)
            self._program_refs[key] = weakref.ref(cc)
            if len(self._program_refs) > 128:
                for k, r in list(self._program_refs.items()):
                    if r() is None:
                        self._program_refs.pop(k, None)
                        self._breaker.record_success(k)
                        self._consec_faults.pop(k, None)
                        self._degraded_until.pop(k, None)
        return key

    def _event(self, _name: str, _trace=None, **detail) -> None:
        """Append one recovery-timeline event (bounded ring; read via
        :meth:`timeline`). Records the unified schema
        (:mod:`quest_tpu_torch.telemetry.events`): monotonic offset ``t``
        (compat), wall-clock epoch ``wall``, and the trace id when the
        event belongs to one traced request."""
        if self.events.maxlen:
            self.events.append(make_event(
                _name, self._t0,
                trace_id=_trace.trace_id if _trace is not None else None,
                **detail))

    def timeline(self) -> list:
        """The recovery-event timeline as a plain list (warns once per
        process when this service was built with ``record_events=0`` —
        the ring is then disabled and always empty)."""
        return read_timeline(self, tool="timeline()")

    @staticmethod
    def _finish_trace(ctx, fut) -> None:
        """Future done-callback for service-owned traces: record the
        resolve span with the outcome and close the trace."""
        if fut.cancelled():
            status = "cancelled"
        else:
            exc = fut.exception()
            status = "ok" if exc is None else type(exc).__name__
        ctx.add("resolve", status=status)
        ctx.finish(status)

    def _watchdog_loop(self) -> None:
        """Heartbeat watchdog: the dispatcher stamps ``_heartbeat``
        every loop iteration and around every engine dispatch; a gap
        past ``watchdog_timeout_s`` (wedged collective, slow device,
        stuck compile) is counted ONCE per stall episode."""
        timeout = self.resilience.watchdog_timeout_s
        poll = max(min(timeout / 4.0, 1.0), 1e-3)
        while not self._watchdog_stop.wait(poll):
            if not self._thread.is_alive():
                return
            gap = time.monotonic() - self._heartbeat
            if gap > timeout:
                if not self._stall_flagged:
                    self._stall_flagged = True
                    self.metrics.incr("watchdog_stalls")
                    self._event("watchdog_stall",
                                heartbeat_gap_s=round(gap, 3))
            else:
                self._stall_flagged = False

    def _note_fault(self, pkey: str) -> None:
        """Degradation accounting: ``degrade_after`` consecutive faulted
        dispatches of one program put it in sequential per-request mode
        for ``degrade_cooldown_s`` (a poisoned batch member can't keep
        failing its companions while the fault persists)."""
        rp = self.resilience
        if not rp.degrade_after:
            return
        n = self._consec_faults.get(pkey, 0) + 1
        self._consec_faults[pkey] = n
        if n >= rp.degrade_after:
            until = time.monotonic() + rp.degrade_cooldown_s
            if self._degraded_until.get(pkey, 0.0) < until:
                self._degraded_until[pkey] = until
            self._event("degraded_mode", program=pkey,
                        consecutive_faults=n)

    def _execute(self, batch: list) -> None:
        """Run one coalesced group through the typed recovery path:
        breaker fast-fail, degraded sequential mode, then the
        quarantining group executor (synchronous, or launched into the
        in-flight pipe when ``pipeline_depth > 1``)."""
        with self._cond:
            self._backlog -= len(batch)
            for req in batch:
                self._note_queued(req, -1)
            self._inflight += len(batch)
            tenant = batch[0].tenant
            self._tenant_inflight[tenant] = \
                self._tenant_inflight.get(tenant, 0) + len(batch)
        pipelined = False
        try:
            pipelined = self._execute_guarded(batch)
        finally:
            if not pipelined:
                self._finish_inflight(batch)

    def _finish_inflight(self, batch: list) -> None:
        """Retire one batch's in-flight accounting (dispatcher thread
        for synchronous dispatches, completion thread for pipelined
        ones) and wake the dispatcher — a quota-deferred batch may be
        runnable now that rows freed up."""
        tenant = batch[0].tenant
        with self._cond:
            self._inflight -= len(batch)
            left = self._tenant_inflight.get(tenant, 0) - len(batch)
            if left <= 0:
                self._tenant_inflight.pop(tenant, None)
            else:
                self._tenant_inflight[tenant] = left
            self._cond.notify_all()

    def _execute_guarded(self, batch: list) -> bool:
        """Returns True when the batch was handed to the in-flight pipe
        (the completion thread owns retiring it), False when it was
        fully resolved synchronously."""
        cc = batch[0].compiled
        pkey = self._program_key(cc)
        rp = self.resilience
        if not self._breaker.allow(pkey):
            self.metrics.incr("breaker_fastfails", len(batch))
            self.metrics.incr("failed", len(batch))
            self._event("breaker_fastfail", program=pkey,
                        requests=len(batch))
            err = CircuitBreakerOpen(
                f"circuit breaker is open for program {pkey} after "
                f"repeated executor faults; fast-failing "
                f"(cooldown {rp.breaker_cooldown_s}s)")
            for req in batch:
                if req.future.set_running_or_notify_cancel():
                    req.future.set_exception(err)
            return False
        if rp.degrade_after and len(batch) > 1 and \
                time.monotonic() < self._degraded_until.get(pkey, 0.0):
            # graceful degradation: the batched path kept faulting, so
            # serve each request alone until the cooldown lapses —
            # degraded mode is deliberately synchronous (the fault is
            # still live; pipelining suspect work buys nothing)
            self.metrics.incr("degraded_dispatches", len(batch))
            self._event("degraded_dispatch", program=pkey,
                        requests=len(batch))
            for req in batch:
                self._run_group([req], pkey)
            return False
        if self._pipe is not None:
            return self._pipe_group(batch, pkey)
        self._run_group(batch, pkey)
        return False

    def _pipe_group(self, batch: list, pkey: str) -> bool:
        """Pipelined launch: start the batch's dispatch and hand the
        in-flight handle to the completion thread, which copies results
        off the device and fans out while the dispatcher coalesces the
        NEXT batch. The semaphore
        bounds the number of in-flight batches at ``pipeline_depth``;
        acquiring it with no lock held is the pipeline's backpressure
        point (deliberately not a ``with``-held lock)."""
        self._heartbeat = time.monotonic()
        self._pipe_sem.acquire()
        try:
            inf = self._launch_batch(batch)
        # quest: allow-broad-except(launch-side fault barrier: a fault
        # raised while LAUNCHING the dispatch recovers inline on the
        # dispatcher thread through the same classified path as the
        # synchronous mode)
        except Exception as e:
            self._pipe_sem.release()
            self._recover_group(batch, pkey, 0, e)
            return False
        inf.pkey = pkey
        self._pipe.put(inf)
        self.metrics.incr("pipelined_batches")
        return True

    def _completion_loop(self) -> None:
        """The completion pool: drains in-flight handles in launch order
        (one FIFO queue, one thread — global completion order equals
        launch order, so per-program in-order completion holds by
        construction), copies each batch's results to the host, and runs
        screening + fan-out. Faults surfacing at that copy (where an
        asynchronous device fault lands) recover here through the same
        classified barrier, including bisection quarantine re-run
        synchronously."""
        while True:
            inf = self._pipe.get()
            if inf is _PIPE_STOP:
                return
            self._heartbeat = time.monotonic()
            try:
                out = self._complete_batch(inf)
            # quest: allow-broad-except(completion-side fault barrier:
            # classify() routes the fault to typed recovery exactly as
            # the synchronous path does)
            except Exception as e:
                self._heartbeat = time.monotonic()
                self._recover_group(inf.batch, inf.pkey, 0, e)
            else:
                self._heartbeat = time.monotonic()
                self._breaker.record_success(inf.pkey)
                self._consec_faults.pop(inf.pkey, None)
                self._fan_out(inf.batch, *out)
            finally:
                self._finish_inflight(inf.batch)
                self._pipe_sem.release()

    def _run_group(self, batch: list, pkey: str, depth: int = 0) -> None:
        """Execute one compatible group as a single engine dispatch; on
        a classified fault, quarantine by bisection (halves re-execute
        independently — log2(B) extra dispatches isolate one poisoned
        request), escalate precision-tier violations one tier up, or
        retry/fail each request per the policy."""
        self._heartbeat = time.monotonic()
        try:
            results, bad_rows, viol_rows, t_dispatch, padded = \
                self._dispatch_batch(batch)
        # quest: allow-broad-except(THE classified fault barrier:
        # classify() routes FATAL/TRANSIENT/POISON/PRECISION to typed
        # recovery -- narrowing here would strand unknown runtime
        # faults with no recovery path at all)
        except Exception as e:
            self._heartbeat = time.monotonic()
            self._recover_group(batch, pkey, depth, e)
            return
        self._heartbeat = time.monotonic()
        self._breaker.record_success(pkey)
        self._consec_faults.pop(pkey, None)
        self._fan_out(batch, results, bad_rows, viol_rows, t_dispatch,
                      padded)

    def _recover_group(self, batch: list, pkey: str, depth: int,
                       e: BaseException) -> None:
        """The classified recovery path for one faulted group — shared
        by the synchronous executor, the pipelined launch side, and the
        completion thread (bisection re-runs execute synchronously on
        whichever thread recovers)."""
        rp = self.resilience
        kind = classify(e)
        self._event("fault", program=pkey, kind=kind,
                    error=type(e).__name__, requests=len(batch),
                    depth=depth)
        if kind == PRECISION:
            # the engine-level fidelity monitor tripped on the whole
            # dispatch: every member is out of budget at its tier —
            # escalation, not retry/quarantine, is the recovery
            self._breaker.release(pkey)
            for req in batch:
                self._escalate_or_fail(req, e)
            return
        if kind == FATAL:
            # caller error (ValueError / TypeError / validation):
            # fail fast with the ORIGINAL exception — retrying
            # cannot help and must not burn the retry budget. The
            # breaker counts only runtime faults, but a half-open
            # probe must not be left dangling (the probe was
            # inconclusive, not healthy)
            self._breaker.release(pkey)
            self.metrics.incr("failed", len(batch))
            self.metrics.incr("failed_fatal", len(batch))
            for req in batch:
                if req.future.set_running_or_notify_cancel():
                    req.future.set_exception(e)
            return
        self.metrics.incr("executor_faults")
        if self._breaker.record_failure(pkey):
            self.metrics.incr("breaker_trips")
            self._event("breaker_open", program=pkey)
        self._note_fault(pkey)
        if len(batch) > 1 and rp.quarantine:
            self.metrics.incr("quarantine_splits")
            self._event("quarantine_split", program=pkey,
                        requests=len(batch), depth=depth)
            for req in batch:
                if req.trace is not None:
                    req.trace.add("quarantine_split",
                                  requests=len(batch), depth=depth,
                                  error=type(e).__name__)
            mid = len(batch) // 2
            self._run_group(batch[:mid], pkey, depth + 1)
            self._run_group(batch[mid:], pkey, depth + 1)
            return
        for req in batch:
            self._fail_or_retry(req, e, kind)

    def _tier_tol(self, cc: CompiledCircuit, tier) -> float:
        """The runtime fidelity tolerance for one tiered dispatch."""
        from ..profiling import tier_runtime_tol
        return tier_runtime_tol(tier, max(cc.circuit.depth, 1))

    @staticmethod
    def _next_tier(cc: CompiledCircuit, tier):
        """The next rung UP the engine-executable ladder for this env
        (None at the top — escalation is bounded by the ladder)."""
        from ..profiling import engine_tiers
        if tier is None:
            return None      # legacy env precision carries no ladder
        for t in engine_tiers(cc.env):
            if t.rank > tier.rank:
                return t
        return None

    @staticmethod
    def _merged_progress(batch: list):
        """One per-wave listener for a coalesced trajectory group: each
        request's ``_progress`` callback (netserve streaming, notebooks)
        hears every wave. None when nobody is listening — the common
        case stays a no-callback wave loop."""
        cbs = [r.progress for r in batch if r.progress is not None]
        if not cbs:
            return None

        def fanout(info: dict) -> None:
            for cb in cbs:
                try:
                    cb(dict(info))
                # quest: allow-broad-except(progress listeners are
                # caller code; a sick listener must never kill the
                # dispatcher or its batchmates' waves)
                except Exception:
                    pass
        return fanout

    def _dispatch_batch(self, batch: list):
        """One synchronous engine dispatch for one group (the
        ``pipeline_depth=1`` path): launch and complete back-to-back.
        Returns ``(results, bad_rows, viol_rows, t_dispatch, padded)``
        where ``bad_rows`` indexes result rows screened out as
        non-finite (NaN poisoning — those requests get a typed failure;
        their batchmates are unaffected) and ``viol_rows`` indexes
        FINITE rows whose norm/trace drifts past the batch tier's
        runtime tolerance (the fidelity monitor — those requests
        escalate one tier up)."""
        return self._complete_batch(self._launch_batch(batch))

    def _launch_batch(self, batch: list) -> _Inflight:
        """Run one group's dispatch and return the in-flight handle with
        its raw results. Device tensors (planes, dynamics blocks) are not
        copied here — the copy, screening, and span close all live in
        :meth:`_complete_batch`; energies, gradients and samples arrive
        as host arrays already (the sweeps' own transfer)."""
        cc = batch[0].compiled
        tier = batch[0].tier
        B = len(batch)
        kind = batch[0].kind
        # trajectory groups (value AND gradient) pad only to the
        # power-of-two bucket — the device multiple lives on the
        # (inner) trajectory axis, and a padded REQUEST row costs a
        # whole throwaway ensemble
        padded = self.policy.bucket_size(
            B, 1 if (kind == KIND_TRAJECTORY
                     or isinstance(cc, TrajectoryProgram))
            else self._device_multiple(cc))
        pm = np.zeros((padded, len(cc.param_names)), dtype=np.float64)
        for i, req in enumerate(batch):
            pm[i] = req.param_vec
        t_dispatch = time.monotonic()
        tier_name = tier.name if tier is not None else "env"
        traced = [r for r in batch if r.trace is not None]
        for i, req in enumerate(batch):
            ctx = req.trace
            if ctx is None:
                continue
            if req.qspan is not None:
                ctx.end(req.qspan, queue_wait_s=round(
                    t_dispatch - req.submit_t, 6))
                req.qspan = None
            ctx.add("coalesce", batch=B, bucket=padded, row=i,
                    kind=kind, tier=tier_name)
            req.dspan = ctx.begin("dispatch", batch=B, bucket=padded,
                                  kind=kind, tier=tier_name,
                                  service=self.name)
        if tier is not None and tier.name == "fast":
            self.metrics.incr("fast_tier_dispatches")
        sp = None
        poison = False
        guard = self.resilience.guard_outputs
        try:
            # the trio (fault hook + trace annotation + profiler):
            # the profile span opens BEFORE the fault hook so injected
            # stalls land inside the measured wall-to-ready time, and
            # the whole trio sits inside the span-closing try so a
            # raising fault (transient/oom) still closes this
            # attempt's dispatch spans with the fault's type name
            sp = _profile.profile_dispatch("serve.execute")
            poison = _faults.fire("serve.execute")
            if poison == "precision" and (tier is None
                                          or kind in (KIND_EXPECTATION,
                                                      KIND_GRADIENT,
                                                      KIND_EVOLVE,
                                                      KIND_GROUND)):
                # a drifted result is UNDETECTABLE silent corruption
                # wherever the fidelity monitor cannot see it —
                # energies and gradients carry no unit-norm invariant,
                # and UNTIERED requests have no tier tolerance (and no
                # escalation rung) to screen against. Degrade the
                # injected fault to the NaN form the value/plane
                # screens catch: the request still fails typed, never
                # wrong — the one thing chaos runs must never produce.
                poison = "nan"
            # the annotation name carries kind + bucket + tier, so a
            # torch.profiler trace shows which serving dispatch each
            # kernel belongs to, aligned with the host "dispatch" spans
            # the request traces record
            ann = dispatch_annotation(
                f"quest_tpu_torch.serve.dispatch:{kind}:b{padded}:"
                f"{tier.name if tier is not None else 'env'}")
            if kind == KIND_TRAJECTORY:
                # one (B, T) wave loop with convergence-based early
                # stopping; live_rows excludes the padded bucket rows
                # from the stop decision so a throwaway row can't stall
                # the batch
                with ann:
                    means, errs, info = cc.expectation_batch(
                        pm, batch[0].observables, batch[0].trajectories,
                        sampling_budget=batch[0].sampling_budget,
                        live_rows=B,
                        progress=self._merged_progress(batch))
                raw = (means, errs, info)
            elif kind == KIND_GRADIENT and isinstance(cc,
                                                      TrajectoryProgram):
                # the differentiable wave loop: every row's value AND
                # gradient advance through shared gradient waves with
                # the same early-stopping contract as value requests
                with ann:
                    vals, grads, errs, info = cc.expectation_grad_batch(
                        pm, batch[0].observables, batch[0].trajectories,
                        sampling_budget=batch[0].sampling_budget,
                        live_rows=B,
                        progress=self._merged_progress(batch))
                raw = (vals, grads, errs, info)
            elif kind == KIND_GRADIENT:
                # ONE reverse pass through the batched engine: the
                # whole group's values + gradients arrive as a single
                # (B, P+1) block (CompiledCircuit.value_and_grad_sweep)
                with ann:
                    vals, grads = cc.value_and_grad_sweep(
                        pm, batch[0].observables, tier=tier)
                raw = (vals, grads)
            elif kind == KIND_EXPECTATION:
                with ann:
                    raw = (cc.expectation_sweep(
                        pm, batch[0].observables, tier=tier),)
            elif kind in (KIND_EVOLVE, KIND_GROUND):
                # the whole segment iterates INSIDE one executable
                # (the keyed evolve/ground form): the group's step
                # loops never touch the host, and the packed (B, W)
                # block is the segment's ONE device->host transfer
                # (materialised in _complete_batch)
                spec, dyn_state = batch[0].dynamics
                with ann:
                    if kind == KIND_EVOLVE:
                        raw = (cc.evolve_sweep(
                            pm, batch[0].observables, spec,
                            state_f=dyn_state, tier=tier),)
                    else:
                        raw = (cc.ground_sweep(
                            pm, batch[0].observables, spec,
                            state_f=dyn_state, tier=tier),)
            elif kind == KIND_SAMPLE:
                shots = max(req.shots for req in batch)
                with ann:
                    idx, totals = cc.sample_sweep(pm, shots, tier=tier)
                raw = (idx, totals)
            else:
                with ann:
                    raw = (cc.sweep(pm, tier=tier),)
        # quest: allow-broad-except(close-spans-and-reraise: open
        # dispatch spans must be closed on ANY interruption -- the
        # exception always propagates to the classified barrier)
        except BaseException as e:
            inf = _Inflight(batch, cc, tier, B, padded, kind,
                            t_dispatch, traced, poison, guard, sp, None)
            self._close_dspans(inf, status=type(e).__name__)
            raise
        return _Inflight(batch, cc, tier, B, padded, kind, t_dispatch,
                         traced, poison, guard, sp, raw)

    def _complete_batch(self, inf: _Inflight):
        """Materialize one launched batch (THE block-until-ready point —
        the completion thread's whole job in pipelined mode), run the
        per-row health screens and the fidelity monitor, price the
        dispatch, and close its spans. Returns ``(results, bad_rows,
        viol_rows, t_dispatch, padded)``."""
        batch, cc, tier = inf.batch, inf.cc, inf.tier
        B, padded, kind = inf.B, inf.padded, inf.kind
        poison, guard, sp = inf.poison, inf.guard, inf.sp
        viol = ()
        norms = None
        try:
            if kind == KIND_TRAJECTORY:
                means, errs, info = inf.raw
                means = _faults.poison_output(poison, _host(means))[:B]
                results = [(float(means[i]), float(errs[i]))
                           for i in range(B)]
                self.metrics.incr("trajectory_dispatches")
                self.metrics.incr("trajectories_run",
                                  info["trajectories_run"])
                self.metrics.incr("trajectories_saved",
                                  max(0, info["max_trajectories"]
                                      - info["trajectories_run"]))
                # a NaN trajectory poisons ITS row's running mean only:
                # the per-row screen quarantines that request typed
                # while its batchmates complete (per-row, never
                # per-batch)
                bad = _health.bad_value_rows(means) if guard else ()
            elif kind == KIND_GRADIENT and isinstance(cc,
                                                      TrajectoryProgram):
                vals, grads, errs, info = inf.raw
                vals, grads = _host(vals), _host(grads)
                block = np.concatenate([vals[:, None], grads], axis=1)
                block = _faults.poison_output(poison, block)[:B]
                results = [(float(block[i, 0]), np.array(block[i, 1:]),
                            np.array(errs[i])) for i in range(B)]
                self.metrics.incr("gradient_dispatches")
                self.metrics.incr("trajectory_dispatches")
                self.metrics.incr("trajectories_run",
                                  info["trajectories_run"])
                self.metrics.incr("trajectories_saved",
                                  max(0, info["max_trajectories"]
                                      - info["trajectories_run"]))
                # a NaN value OR gradient component poisons only ITS row
                bad = _health.bad_plane_rows(block) if guard else ()
            elif kind == KIND_GRADIENT:
                vals, grads = inf.raw
                # ONE (B, P+1) block resolves the whole coalesced group
                vals, grads = _host(vals), _host(grads)
                block = np.concatenate([vals[:, None], grads], axis=1)
                block = _faults.poison_output(poison, block)[:B]
                results = [(float(block[i, 0]), np.array(block[i, 1:]))
                           for i in range(B)]
                self.metrics.incr("gradient_dispatches")
                bad = _health.bad_plane_rows(block) if guard else ()
                # gradients carry no unit-norm invariant: only the NaN
                # screen applies (same contract as energies)
            elif kind == KIND_EXPECTATION:
                # one (B,) block resolves the whole coalesced group
                out = _faults.poison_output(poison, _host(inf.raw[0])[:B])
                results = [float(v) for v in out]
                bad = _health.bad_value_rows(out) if guard else ()
                # energies carry no unit-norm invariant: only the NaN
                # screen applies
            elif kind in (KIND_EVOLVE, KIND_GROUND):
                spec, _ = batch[0].dynamics
                # ONE packed (B, W) block resolves the whole coalesced
                # segment — the step loop already ran on the device
                block = _host(inf.raw[0])
                block = _faults.poison_output(poison, block)[:B]
                results = [np.array(block[i]) for i in range(B)]
                self.metrics.incr("evolve_dispatches"
                                  if kind == KIND_EVOLVE
                                  else "ground_dispatches")
                self.metrics.incr("evolve_steps_fused",
                                  B * int(spec.steps))
                # a NaN anywhere in a row's packed block (energies,
                # Welford carry, or planes) quarantines THAT row only
                bad = _health.bad_plane_rows(block) if guard else ()
            elif kind == KIND_SAMPLE:
                idx, totals = inf.raw
                # the sampled indices + totals resolve the whole group
                idx = _host(idx)
                totals = _faults.poison_output(poison, _host(totals)[:B])
                results = [(np.asarray(idx[i, :req.shots]),
                            float(totals[i]))
                           for i, req in enumerate(batch)]
                bad = _health.bad_value_rows(totals) if guard else ()
                # the pre-sampling totals are the SQUARED 2-norm (sum
                # of |amp|^2); the fidelity contract (|norm - 1| <=
                # tol) is on the norm itself, same root as
                # health.check_planes takes
                norms = np.sqrt(np.maximum(
                    np.asarray(totals, dtype=np.float64), 0.0))
            else:
                # one (B, planes) copy resolves the whole group
                planes = _faults.poison_output(poison, _host(inf.raw[0])[:B])
                results = [np.array(planes[i]) for i in range(B)]
                bad = _health.bad_plane_rows(planes) if guard else ()
                if guard and tier is not None:
                    norms = _health.plane_norms(
                        planes, is_density=cc.is_density,
                        num_qubits=(cc.num_qubits // 2 if cc.is_density
                                    else cc.num_qubits))
            if guard and tier is not None and norms is not None:
                viol = _health.drifted_rows(norms,
                                            self._tier_tol(cc, tier))
                arr = np.asarray(norms, dtype=np.float64)
                arr = arr[np.isfinite(arr)]  # NaN rows are the NaN
                # screen's
                m = float(np.max(np.abs(arr - 1.0), initial=0.0))
                with self._cond:
                    obs = self._tier_observed.setdefault(tier.name, 0.0)
                    self._tier_observed[tier.name] = max(obs, m)
                if m > 0.0:
                    # the tier error model's drift feed: modeled
                    # per-run bound vs the fidelity monitor's observed
                    # norm drift
                    from ..profiling import modeled_tier_error
                    _profile.record_model(
                        "tier_error",
                        modeled_tier_error(tier,
                                           max(cc.circuit.depth, 1)),
                        m)
            if sp is not None:
                mode = "none"
                bpp = 0.0
                models: dict = {}
                try:
                    pol = cc._batch_policy(padded)
                    mode = pol["mode"]
                    bpp = cc._bytes_per_pass(
                        padded, terms=len(batch[0].observables[0])
                        if kind == KIND_EXPECTATION else 0)
                    models = cc._drift_models(mode, padded, pol)
                except (AttributeError, TypeError, KeyError):
                    pass  # a trajectory program has no plan pricing
                sp.done(results,
                        program=getattr(cc, "program_digest", ""),
                        kind=kind, bucket=padded,
                        tier=tier.name if tier is not None else "env",
                        dtype=CompiledCircuit._dtype_token(
                            cc.env.precision.real_dtype),
                        sharding=mode, replica=self.name,
                        bytes_per_pass=bpp, models=models)
        # quest: allow-broad-except(close-spans-and-reraise: open
        # dispatch spans must be closed on ANY interruption -- the
        # exception always propagates to the classified barrier)
        except BaseException as e:
            self._close_dspans(inf, status=type(e).__name__)
            raise
        self._close_dspans(inf)
        return (results, {int(r) for r in bad}, {int(r) for r in viol},
                inf.t_dispatch, padded)

    def _close_dspans(self, inf: _Inflight,
                      status: Optional[str] = None) -> None:
        """Close one batch's per-request dispatch spans exactly once:
        with the fault's type name on the error path, or with the batch
        sharding mode (plus trajectory convergence stats) on success."""
        if status is not None:
            for req in inf.traced:
                if req.dspan is not None:
                    req.trace.end(req.dspan, status=status)
                    req.dspan = None
            return
        if not inf.traced:
            return
        cc, kind = inf.cc, inf.kind
        try:
            mode = cc.dispatch_stats().batch_sharding_mode
        except (AttributeError, KeyError, RuntimeError):
            mode = ""        # stats shape drift: the span just loses it
        extra = {}
        if kind == KIND_TRAJECTORY or (
                kind == KIND_GRADIENT
                and isinstance(cc, TrajectoryProgram)):
            info = getattr(cc, "last_traj_stats", None) or {}
            extra = {"trajectories_run":
                     info.get("trajectories_run", 0),
                     "early_stopped":
                     info.get("early_stopped", False)}
        for req in inf.traced:
            if req.dspan is not None:
                req.trace.end(req.dspan, sharding=mode, **extra)
                req.dspan = None

    def _fail_or_retry(self, req: _Request, exc: BaseException,
                       kind: str) -> None:
        """Transient faults with budget left re-enter the queue after
        exponential backoff with seeded jitter (the retried request may
        coalesce into a different batch); everything else fails typed
        with the classified exception."""
        rp = self.resilience
        if kind == TRANSIENT and req.retries_left > 0:
            req.retries_left -= 1
            req.attempts += 1
            delay = rp.backoff(req.attempts, self._retry_rng)
            now = time.monotonic()
            if now + delay > req.deadline:
                # the backoff hold would outlive the request's ORIGINAL
                # absolute deadline: fail fast with DeadlineExceeded
                # instead of burning the retry on a dispatch that could
                # only resolve stale (the deadline is never re-derived
                # from request_timeout_s on a retry)
                self.metrics.incr("timeouts")
                self._event("retry_abandoned",
                            remaining_s=round(req.deadline - now, 6),
                            backoff_s=round(delay, 6))
                if req.future.set_running_or_notify_cancel():
                    req.future.set_exception(DeadlineExceeded(
                        f"retry backoff of {delay:.3f}s exceeds the "
                        f"request's remaining deadline budget of "
                        f"{max(0.0, req.deadline - now):.3f}s"))
                return
            req.not_before = now + delay
            self.metrics.incr("retries")
            self._event("retry", _trace=req.trace, attempt=req.attempts,
                        delay_s=round(delay, 6))
            if req.trace is not None:
                req.trace.add("retry", attempt=req.attempts,
                              delay_s=round(delay, 6),
                              error=type(exc).__name__)
                req.qspan = req.trace.begin("queue", retry=req.attempts)
            with self._cond:
                self._backlog += 1
                self._note_queued(req, 1)
                self._queue.append(req)
                self._cond.notify_all()
            return
        self.metrics.incr("failed")
        if kind == POISON:
            self.metrics.incr("quarantined")
        self._event("request_failed", _trace=req.trace,
                    error=type(exc).__name__, kind=kind)
        if req.future.set_running_or_notify_cancel():
            req.future.set_exception(exc)

    def _escalate_or_fail(self, req: _Request, exc: BaseException) -> None:
        """Precision-violation recovery: re-enqueue the request ONE TIER
        UP the ladder (the coalesce key is recomputed — the escalated
        request joins the higher tier's batches), bounded by the top
        engine-executable rung; at the top (or with escalation off) the
        request fails typed — an out-of-budget answer never reaches the
        caller silently."""
        self.metrics.incr("tier_violations")
        nxt = self._next_tier(req.compiled, req.tier) \
            if self.resilience.escalate_tiers else None
        if nxt is None:
            self.metrics.incr("failed")
            self._event("tier_violation_failed",
                        tier=req.tier.name if req.tier else "env",
                        error=type(exc).__name__)
            if req.future.set_running_or_notify_cancel():
                req.future.set_exception(exc)
            return
        prev = req.tier
        req.tier = nxt
        req.escalations += 1
        req.key = coalesce_key(req.compiled, req.kind, req.obs_key,
                               req.shots, nxt, tenant=req.tenant)
        self.metrics.incr("tier_escalations")
        self._event("tier_escalation", _trace=req.trace,
                    from_tier=prev.name, to_tier=nxt.name,
                    escalations=req.escalations)
        if req.trace is not None:
            req.trace.add("escalate", from_tier=prev.name,
                          to_tier=nxt.name,
                          escalations=req.escalations)
            req.qspan = req.trace.begin("queue",
                                        escalations=req.escalations)
        with self._cond:
            self._backlog += 1
            self._note_queued(req, 1)
            self._queue.append(req)
            self._cond.notify_all()

    def _fan_out(self, batch: list, results: list, bad_rows: set,
                 viol_rows: set, t_dispatch: float, padded: int) -> None:
        cc = batch[0].compiled
        B = len(batch)
        self._last_cc = cc
        done_t = time.monotonic()
        digest = getattr(cc, "program_digest", "")
        if digest:
            # live per-request cost EMA: the WFQ scheduler's pricing
            # (seeded from ledger history) tracks what dispatches of
            # this program actually cost right now
            per_req = max(0.0, done_t - t_dispatch) / max(B, 1)
            prev = self._cost_est.get(digest)
            self._cost_est[digest] = per_req if not prev \
                else 0.8 * prev + 0.2 * per_req
        tenant = batch[0].tenant
        self.metrics.record_tenant_busy(
            tenant, max(0.0, done_t - t_dispatch))
        viol_rows = viol_rows - bad_rows   # NaN screen wins: nothing to
        # escalate in a non-finite row
        # metrics BEFORE resolving any future: a caller blocked on the
        # last result may read dispatch_stats() the instant it unblocks,
        # and must see this batch's accounting
        self.metrics.record_batch(B, padded)
        if bad_rows:
            self.metrics.incr("health_failures", len(bad_rows))
            self.metrics.incr("quarantined", len(bad_rows))
            self.metrics.incr("failed", len(bad_rows))
            self._event("poisoned_rows", rows=sorted(bad_rows),
                        requests=B)
        if viol_rows:
            self.metrics.incr("health_failures", len(viol_rows))
            self._event("tier_violation_rows", rows=sorted(viol_rows),
                        requests=B,
                        tier=batch[0].tier.name if batch[0].tier
                        else "env")
        for i, req in enumerate(batch):
            if i in bad_rows or i in viol_rows:
                continue
            self.metrics.incr("completed")
            self.metrics.record_latency(done_t - req.submit_t,
                                        t_dispatch - req.submit_t)
            self.metrics.incr_tenant(tenant, "completed")
            self.metrics.record_tenant_latency(
                tenant, done_t - req.submit_t,
                t_dispatch - req.submit_t)
        if batch[0].kind == KIND_GRADIENT:
            good = B - len(bad_rows) - len(viol_rows)
            if good > 0:
                self.metrics.incr("gradients_returned", good)
        if self.perf_ledger is not None:
            # per-program measured latency + bucket mix, flushed to the
            # persistent perf ledger on close (the router's EMA
            # warm-start and warm()'s bucket seed in the NEXT process)
            if digest:
                ent = self._lat_by_program.setdefault(
                    digest, [0, 0.0, {}, {}])
                for i, req in enumerate(batch):
                    if i in bad_rows or i in viol_rows:
                        continue
                    ent[0] += 1
                    ent[1] += done_t - req.submit_t
                ent[2][padded] = ent[2].get(padded, 0) + 1
                tname = batch[0].tier.name if batch[0].tier is not None \
                    else "env"
                ent[3][tname] = ent[3].get(tname, 0) + 1
        for i, (req, res) in enumerate(zip(batch, results)):
            if i in bad_rows:
                err = NumericalFault(
                    f"request result was non-finite (poisoned row {i} "
                    f"of a {B}-request batch); batchmates were "
                    f"unaffected", kind="nan", rows=(i,))
                if req.future.set_running_or_notify_cancel():
                    req.future.set_exception(err)
            elif i in viol_rows:
                tol = self._tier_tol(cc, req.tier)
                err = NumericalFault(
                    f"request result drifted outside its "
                    f"{req.tier.name if req.tier else 'env'}-tier "
                    f"runtime tolerance ({tol:g}) in row {i} of a "
                    f"{B}-request batch", kind="precision", rows=(i,))
                self._escalate_or_fail(req, err)
            elif req.future.set_running_or_notify_cancel():
                req.future.set_result(res)
