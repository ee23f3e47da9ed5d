"""Replicated serving: health-aware routing over N service replicas.

One :class:`~quest_tpu_torch.serve.SimulationService` has a fault story
of its own, but stays a single point of failure: one wedged dispatcher
takes all traffic down, and a restart pays its whole setup again.
:class:`ServiceRouter` closes that gap:

- **replicas** — N :class:`SimulationService` instances, each over its
  own :class:`~quest_tpu_torch.env.QuESTEnv`, behind the same
  ``submit() -> Future`` API. On one card :func:`replica_envs` makes N
  envs on the SAME device: the JAX package's shared-devices mode, where
  the failure domains are the replicas' threads, not silicon;
- **health-aware placement** — least-loaded routing weighted by each
  replica's live queue depth, an EMA of its per-request service time
  against the request's deadline slack, and its breaker/degraded/stall
  state (an open breaker for the submitted program routes the request to
  a replica whose breaker is closed instead of burning it on a
  fast-fail);
- **failover** — a replica fault (crashed dispatcher, breaker-open
  fast-fail, ``ServiceClosed``, a transient executor failure past the
  replica's own retry budget) re-places in-flight and queued requests on
  a healthy replica, PRESERVING the original absolute deadline; optional
  hedging duplicates a stuck request onto another replica after
  ``hedge_after_s``, and the first result wins;
- **supervised restart** — a supervisor thread quarantines a sick
  replica (dead dispatcher thread, heartbeat stall past
  ``SupervisorPolicy.stall_timeout_s``, executor-fault burst), fails its
  work over, restarts it in the background (re-warming through the
  persistent :mod:`~quest_tpu_torch.serve.warmcache`, so restart-to-ready
  LOADS each form's packed operands instead of packing them), and
  readmits it only after a half-open probe batch reproduces the reference
  results recorded at warm time to ``probe_tol``: a replica that comes
  back wrong stays out;
- **rolling restart** — :meth:`ServiceRouter.rolling_restart` drains and
  restarts every replica in turn while the others carry traffic: zero
  dropped requests.

Routing, failover and supervision live entirely ABOVE the engine: the
router never touches device state, so every correctness property of the
single service (typed errors, oracle parity, bounded queues) survives
composition.

**One card, one CUDA context.** Replicas sharing the card share its
context, so a sticky CUDA error (an illegal address, a device-side
assert: ``torch.AcceleratorError``) poisons every replica at once. Such
an error, like a kernel that failed to build or launch, classifies
FATAL (:mod:`quest_tpu_torch.resilience.recovery`): the router never
fails it over or restarts onto it, and the caller gets the typed error.
A replica of ``k`` shards (``replica_envs(devices_per_replica=k)``) runs
its mesh on the same card; replicas on separate cards are ROADMAP Queue 1
item 8's four-card part.
"""

from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future
from typing import Optional, Sequence

import numpy as np

from ..circuits import Circuit, CompiledCircuit
from ..ops.trajectories import TrajectoryProgram
from ..resilience import faults as _faults
from ..resilience.recovery import (FATAL, POISON, TRANSIENT,
                                   AutoscalePolicy, SupervisorPolicy,
                                   classify)
from ..telemetry import profile as _profile
from ..telemetry.events import make_event, read_timeline
from ..telemetry.metrics import metrics_registry
from ..telemetry.tracing import Tracer, dispatch_annotation
from .engine import (CircuitBreakerOpen, DeadlineExceeded, QueueFull,
                     QuotaExceeded, ServeError, ServiceClosed,
                     SimulationService)
from .metrics import RouterMetrics
from .sched import DEFAULT_TENANT

__all__ = ["ServiceRouter", "AllReplicasUnavailable", "replica_envs"]


class AllReplicasUnavailable(ServeError):
    """Every replica is out of service (dead past its restart budget,
    or the router is closed): the request cannot be placed anywhere."""


def replica_envs(num_replicas: int,
                 devices_per_replica: Optional[int] = None,
                 precision=None, seed: Optional[Sequence[int]] = None,
                 device=None) -> list:
    """Build one :class:`~quest_tpu_torch.env.QuESTEnv` per replica.

    The port runs on one card, so every replica's env is on the same
    device (``device``: None is ``cuda:0``, as ``createQuESTEnv``): the
    JAX package's shared-devices mode, where the failure domains are the
    replicas' threads, not silicon. ``devices_per_replica`` of None or 1
    gives one-device replicas; a power of two ``k`` above 1 gives each
    replica a ``k``-shard mesh env over that device repeated (``devices=
    [device] * k``; on the CPU, ``k`` host shards). Replica ``i`` seeds its
    measurement stream from ``seed + [i]`` (default: time and pid)."""
    from ..env import create_quest_env
    if num_replicas < 1:
        raise ValueError("num_replicas must be >= 1")
    k = 1
    if devices_per_replica is not None:
        k = int(devices_per_replica)
        if k < 1:
            raise ValueError("devices_per_replica must be >= 1")
        if k & (k - 1):
            raise ValueError("devices_per_replica must be a power of 2 "
                             "(amplitude sharding halves per device)")
    devices = [device if device is not None else "cuda:0"] * k \
        if k > 1 else None
    return [create_quest_env(
        precision=precision, device=device, devices=devices,
        seed=list(seed) + [i] if seed is not None else None)
        for i in range(num_replicas)]


class _WarmSpec:
    """One recorded warm() call, replayed on every replica (re)start,
    plus the oracle reference its probe requests must reproduce."""

    __slots__ = ("circuit", "batch_sizes", "observables", "shots",
                 "reference")

    def __init__(self, circuit, batch_sizes, observables, shots,
                 reference):
        self.circuit = circuit
        self.batch_sizes = batch_sizes
        self.observables = observables
        self.shots = shots
        self.reference = reference


class _Work:
    """One router-level request across however many replica hops it
    takes. The router future resolves exactly once (first completion
    wins — failover re-placements and hedges race benignly)."""

    __slots__ = ("circuit", "params", "observables", "shots", "submit_t",
                 "deadline", "future", "failovers_left", "lock", "done",
                 "tried", "active", "last_route_t", "hedged",
                 "park_logged", "trace", "trajectories",
                 "sampling_budget", "gradient", "tier", "tenant",
                 "priority", "evolve", "ground_state", "init_state",
                 "progress")

    def __init__(self, circuit, params, observables, shots, submit_t,
                 deadline, failovers_left, trajectories=None,
                 sampling_budget=None, gradient=False, tier=None,
                 tenant=DEFAULT_TENANT, priority=None, evolve=None,
                 ground_state=None, init_state=None, progress=None):
        self.circuit = circuit
        self.params = params
        self.observables = observables
        self.shots = shots
        self.trajectories = trajectories
        self.sampling_budget = sampling_budget
        self.gradient = gradient
        self.tier = tier
        self.tenant = tenant
        self.priority = priority
        self.evolve = evolve
        self.ground_state = ground_state
        self.init_state = init_state
        self.progress = progress
        self.submit_t = submit_t
        self.deadline = deadline        # ABSOLUTE (monotonic); immutable
        self.future: Future = Future()
        self.failovers_left = failovers_left
        self.lock = threading.Lock()
        self.done = False
        self.tried: set = set()         # replica indices ever holding it
        self.active: dict = {}          # replica index -> (future, hedge)
        self.last_route_t = submit_t
        self.hedged = False
        self.park_logged = False
        self.trace = None               # TraceContext when sampled


class _Replica:
    """One replica slot: the env is permanent, the service is replaced
    across restarts. ``state`` gates routing — only ``"ready"`` takes
    traffic."""

    __slots__ = ("index", "env", "service", "state", "restarts",
                 "restart_attempts", "next_restart_t", "last_faults",
                 "ema_request_s", "restart_thread", "quarantine_reason")

    def __init__(self, index, env, service):
        self.index = index
        self.env = env
        self.service = service
        self.state = "ready"    # ready|draining|quarantined|restarting|failed
        self.restarts = 0
        self.restart_attempts = 0
        self.next_restart_t = 0.0
        self.last_faults = 0
        self.ema_request_s = 0.0
        self.restart_thread: Optional[threading.Thread] = None
        self.quarantine_reason = ""


class ServiceRouter:
    """N :class:`SimulationService` replicas behind one ``submit()``.

    Parameters
    ----------
    envs : sequence of QuESTEnv | None
        One env per replica (:func:`replica_envs` builds them, all on
        the one card). ``None`` builds ``num_replicas`` envs with
        ``devices_per_replica`` shards each (more than 1: a mesh env over
        the card repeated).
    num_replicas, devices_per_replica :
        The :func:`replica_envs` shape when ``envs`` is None.
    supervisor : SupervisorPolicy
        Quarantine/restart/probe knobs (:class:`quest_tpu_torch.resilience.
        SupervisorPolicy`).
    max_failovers : int
        Re-placements per request after replica faults (default:
        ``num_replicas``). The original absolute deadline always caps
        the total, whatever the budget.
    hedge_after_s : float | None
        Opt-in tail-latency hedging: a request still unresolved this
        long after its last placement is duplicated onto one additional
        healthy replica (first result wins). None disables.
    autoscale : AutoscalePolicy | None
        Ledger-driven elasticity (:class:`quest_tpu_torch.resilience.
        AutoscalePolicy`): each supervisor poll prices the pooled
        backlog as a drain-time estimate (``backlog * mean_request_s /
        replicas`` — the mean comes from the shared perf ledger, else
        the live EMAs) and grows/shrinks the replica pool through
        :meth:`scale_to` when the policy says so. None disables (the
        pool stays at its constructed size; :meth:`scale_to` still
        works manually).
    env_factory : callable | None
        Zero-argument callable returning a fresh env for each replica
        added ABOVE the constructed pool (scale-up). None builds one
        env on the live pool's device at its precision.
    warm_cache : WarmCache | False | None
        One persistent warm-start cache SHARED by all replicas (same
        programs, same artifacts — replica 1's stores are replica 2's
        loads). None resolves ``QUEST_TPU_WARM_CACHE_DIR``; ``False``
        forces it off.
    perf_ledger : PerfLedger | False | None
        One persistent perf ledger (:class:`quest_tpu_torch.telemetry.ledger.
        PerfLedger`) SHARED by all replicas. None resolves
        ``QUEST_TPU_PERF_LEDGER_DIR``; ``False`` forces it off. With a
        ledger carrying prior-run records, every replica's service-time
        EMA warm-starts at the recorded mean request latency — the
        FIRST request is placed with a measured ``est_wait``, not the
        cold-start zero — and each replica service flushes its measured
        per-program accounting back on close. The EMA's live decay is
        ``SupervisorPolicy.ema_decay``.
    trace_sample_rate : float
        Fraction of router submissions that record a request-scoped
        trace (:mod:`quest_tpu_torch.telemetry.tracing`). The router CREATES
        the trace and propagates it into whichever replica serves each
        hop, so one trace follows the request across failovers and
        hedges; the router finishes it at resolution. 0 disables.
    tracer : Tracer | None
        Explicit tracer to record into; None builds one from
        ``trace_sample_rate``.
    name : str | None
        The router's name in the process-global metrics registry
        (replicas register as ``<name>-replica<i>``). None
        auto-generates a unique name.
    **service_kwargs :
        Forwarded to every replica's :class:`SimulationService`
        (max_batch, max_wait_s, max_queue, request_timeout_s,
        max_retries, resilience, record_events...).
    """

    def __init__(self, envs=None, *, num_replicas: Optional[int] = None,
                 devices_per_replica: Optional[int] = None,
                 supervisor: Optional[SupervisorPolicy] = None,
                 max_failovers: Optional[int] = None,
                 hedge_after_s: Optional[float] = None,
                 autoscale: Optional[AutoscalePolicy] = None,
                 env_factory=None,
                 warm_cache=None, perf_ledger=None,
                 record_events: int = 1024,
                 trace_sample_rate: float = 0.0,
                 tracer: Optional[Tracer] = None,
                 name: Optional[str] = None,
                 **service_kwargs):
        if envs is None:
            envs = replica_envs(num_replicas or 2, devices_per_replica)
        envs = list(envs)
        if not envs:
            raise ValueError("the router needs at least one replica env")
        if warm_cache is None:
            from .warmcache import WarmCache
            warm_cache = WarmCache.from_env()
        self.warm_cache = warm_cache or None
        if perf_ledger is None:
            from ..telemetry.ledger import PerfLedger
            perf_ledger = PerfLedger.from_env()
        self.perf_ledger = perf_ledger or None
        self.supervisor = supervisor if supervisor is not None \
            else SupervisorPolicy()
        self._service_kwargs = dict(service_kwargs)
        self.request_timeout_s = float(
            self._service_kwargs.get("request_timeout_s", 60.0))
        self.max_failovers = int(max_failovers) if max_failovers \
            is not None else len(envs)
        self.hedge_after_s = hedge_after_s
        self.autoscale = autoscale
        self._env_factory = env_factory
        self._devices_per_replica = devices_per_replica
        self._next_index = len(envs)    # monotonic: slots never reused
        self._last_scale_t = 0.0
        self._idle_since: Optional[float] = None
        self._scale_thread: Optional[threading.Thread] = None
        self.metrics = RouterMetrics()
        self.events: collections.deque = collections.deque(
            maxlen=max(0, int(record_events)))
        self._t0 = time.monotonic()
        # unified telemetry: router-owned request traces (propagated
        # into whichever replica serves each hop) + the router's
        # dispatch_stats() document in the process-global registry
        self.name = name or metrics_registry().unique_name("router")
        self.tracer = tracer if tracer is not None else Tracer(
            sample_rate=trace_sample_rate, name=self.name)
        self._registry_token = metrics_registry().register(
            self.name, self._registry_stats, kind="router", owner=self)
        self._lock = threading.RLock()
        self._closed = False
        self._warm_specs: list = []
        self._outstanding: dict = {}    # id(work) -> work
        self._parked: list = []         # work waiting for a ready replica
        self._replicas = [
            _Replica(i, env, self._new_service(env, index=i))
            for i, env in enumerate(envs)]
        if self.perf_ledger is not None:
            # EMA warm-start: a prior run's measured mean request
            # latency seeds every replica, so the very first placement
            # prices est_wait with a measurement instead of zero (live
            # traffic then blends it out at SupervisorPolicy.ema_decay)
            seed_s = self.perf_ledger.mean_request_s()
            if seed_s > 0.0:
                for h in self._replicas:
                    h.ema_request_s = seed_s
        self._stop = threading.Event()
        self._supervisor = threading.Thread(
            target=self._supervise_loop, daemon=True,
            name=f"quest-tpu-torch-router-supervisor-{id(self):x}")
        self._supervisor.start()

    # -- construction ------------------------------------------------------

    def _new_service(self, env,
                     index: Optional[int] = None) -> SimulationService:
        # every service generation gets a UNIQUE registry name (the
        # replica slot rides in the label-friendly prefix): a restarted
        # replica must never unregister its replacement's entry
        prefix = f"{self.name}-replica{index}" if index is not None \
            else f"{self.name}-replica"
        return SimulationService(env, warm_cache=self.warm_cache or False,
                                 perf_ledger=getattr(
                                     self, "perf_ledger", None) or False,
                                 name=metrics_registry().unique_name(
                                     prefix),
                                 **self._service_kwargs)

    @property
    def num_replicas(self) -> int:
        return len(self._replicas)

    def _event(self, _name: str, _trace=None, **detail) -> None:
        """One unified-schema timeline event (monotonic offset + wall
        epoch + optional trace id; :mod:`quest_tpu_torch.telemetry.events`)."""
        if self.events.maxlen:
            self.events.append(make_event(
                _name, self._t0,
                trace_id=_trace.trace_id if _trace is not None else None,
                **detail))

    def timeline(self) -> list:
        """The router-event timeline as a plain list (warns once per
        process when built with ``record_events=0``)."""
        return read_timeline(self, tool="timeline()")

    # -- routing -----------------------------------------------------------

    @staticmethod
    def _route_circuit(circuit):
        """Route by the RECORDED circuit: each replica compiles (and
        caches) its own program, so any replica can serve any request —
        the precondition for failover. Trajectory programs route the
        same way (the replica re-lowers through
        ``compile_trajectories`` when the request carries
        ``trajectories=``)."""
        if isinstance(circuit, (CompiledCircuit, TrajectoryProgram)):
            return circuit.circuit
        if isinstance(circuit, Circuit):
            return circuit
        raise TypeError(f"expected Circuit or CompiledCircuit, got "
                        f"{type(circuit).__name__}")

    def _pick(self, work: _Work, exclude: set) -> Optional[_Replica]:
        """Health-aware least-loaded placement. Score = estimated wait
        (live queue depth x the replica's per-request EMA), with hard
        penalties for an open breaker on THIS program, a flagged stall,
        and a degraded program — and a deadline-slack penalty when the
        estimated wait would blow the request's remaining budget."""
        now = time.monotonic()
        slack = work.deadline - now
        best, best_score = None, None
        with self._lock:
            replicas = list(self._replicas)
        for h in replicas:
            if h.index in exclude or h.state != "ready":
                continue
            svc = h.service
            if not svc.is_alive():
                continue
            depth = svc._backlog + svc._inflight
            score = float(depth)
            est_wait = depth * h.ema_request_s
            score += est_wait * 10.0
            if est_wait > max(slack, 0.0):
                score += 1e3        # would likely miss the deadline here
            ps = svc.program_state(work.circuit)
            if ps["breaker"] == "open":
                score += 1e6        # fast-fail territory: route around
            elif ps["breaker"] == "half-open":
                score += 10.0       # probe slot: light touch
            if ps["degraded"]:
                score += 100.0
            if svc._stall_flagged:
                score += 1e6
            if best_score is None or score < best_score:
                best, best_score = h, score
        return best

    def submit(self, circuit, params: Optional[dict] = None, *,
               observables=None, shots: Optional[int] = None,
               trajectories: Optional[int] = None,
               sampling_budget: Optional[float] = None,
               gradient: bool = False, tier=None,
               evolve=None, ground_state=None, init_state=None,
               tenant: str = DEFAULT_TENANT,
               priority: Optional[int] = None,
               deadline: Optional[float] = None,
               _progress=None) -> Future:
        """Enqueue one request on the healthiest replica; returns a
        router-owned Future. Semantics match
        :meth:`SimulationService.submit` — including trajectory
        requests (``trajectories=`` / ``sampling_budget=``; each
        replica lowers and caches its own trajectory program) and
        gradient requests (``gradient=True`` — kind="gradient"
        value-and-grad dispatches, failover-safe like every other
        kind: the recorded circuit re-routes and any replica's own
        compiled program serves it) and per-request precision
        tiers (``tier=`` — resolved and tier-keyed by whichever
        replica serves each hop) — plus:
        replica faults fail the request over to a healthy replica under
        its ORIGINAL absolute deadline, and a window with no ready
        replica parks the request for re-placement instead of dropping
        it (it still expires typed at its deadline). ``tenant`` /
        ``priority`` travel with the request across every hop —
        failovers and hedges land in the serving replica's WFQ
        scheduler under the SAME tenant accounting, and a replica's
        typed :class:`~quest_tpu_torch.serve.QuotaExceeded` propagates to
        the caller (tenant backpressure is caller-facing, not a
        replica fault to route around: every replica enforces the
        same per-tenant contract)."""
        if self._closed:
            raise ServiceClosed("router is closed")
        route = self._route_circuit(circuit)
        now = time.monotonic()
        abs_deadline = now + self.request_timeout_s
        if deadline is not None:
            if deadline <= 0.0:
                raise DeadlineExceeded(
                    f"deadline {deadline!r} s is already unmeetable")
            abs_deadline = min(abs_deadline, now + float(deadline))
        work = _Work(route, params, observables, shots, now, abs_deadline,
                     self.max_failovers, trajectories=trajectories,
                     sampling_budget=sampling_budget, gradient=gradient,
                     tier=tier, tenant=str(tenant), priority=priority,
                     evolve=evolve, ground_state=ground_state,
                     init_state=init_state, progress=_progress)
        ctx = self.tracer.start(router=self.name)
        if ctx is not None:
            work.trace = ctx
            ctx.add("submit", router=self.name,
                    deadline_s=round(abs_deadline - now, 6))
        kind = _faults.fire_router("router.route")
        if kind is not None:
            self._apply_replica_fault(kind)
        with self._lock:
            self._outstanding[id(work)] = work
        self._place(work, set(work.tried))
        return work.future

    def _place(self, work: _Work, exclude: set) -> None:
        """Place (or re-place) one work item; every path out either
        lands it on a replica, parks it, or resolves its future."""
        while True:
            if work.done:
                return
            now = time.monotonic()
            remaining = work.deadline - now
            if remaining <= 0.0:
                self._resolve(work, exc=DeadlineExceeded(
                    f"request expired after {now - work.submit_t:.3f}s "
                    "(including failover)"))
                return
            if self._closed:
                self._resolve(work, exc=ServiceClosed("router is closed"))
                return
            h = self._pick(work, exclude)
            if h is None:
                with work.lock:
                    has_active = bool(work.active)
                if has_active:
                    # a live hop is still serving this work (hedge or
                    # concurrent failover placement found no second
                    # replica): parking it would make _replace_parked
                    # re-place it with an EMPTY exclude set — an
                    # uncounted duplicate dispatch, possibly on the
                    # very replica already serving it
                    return
                with self._lock:
                    recoverable = any(r.state != "failed"
                                      for r in self._replicas)
                    if recoverable:
                        if work not in self._parked:
                            self._parked.append(work)
                        if not work.park_logged:
                            # once per work: the supervisor re-places
                            # every poll and would flood the ring
                            work.park_logged = True
                            self._event("parked", _trace=work.trace,
                                        tried=sorted(work.tried))
                            if work.trace is not None:
                                work.trace.add(
                                    "park", tried=sorted(work.tried))
                        return
                self.metrics.incr("failed_unroutable")
                self._resolve(work, exc=AllReplicasUnavailable(
                    "no replica can take this request: all replicas "
                    "are out of service past their restart budget"))
                return
            try:
                fut = h.service.submit(
                    work.circuit, work.params,
                    observables=work.observables, shots=work.shots,
                    trajectories=work.trajectories,
                    sampling_budget=work.sampling_budget,
                    gradient=work.gradient, tier=work.tier,
                    evolve=work.evolve, ground_state=work.ground_state,
                    init_state=work.init_state,
                    tenant=work.tenant, priority=work.priority,
                    deadline=remaining, _trace=work.trace,
                    _progress=work.progress)
            except QuotaExceeded as e:
                # tenant backpressure, not a replica fault: every
                # replica enforces the same per-tenant contract, so
                # routing around it would just probe N replicas to
                # deliver the same typed answer later
                self._resolve(work, exc=e)
                return
            except QueueFull:
                self.metrics.incr("rerouted_full")
                exclude = set(exclude) | {h.index}
                continue
            except ServiceClosed:
                exclude = set(exclude) | {h.index}
                continue
            except DeadlineExceeded as e:
                self._resolve(work, exc=e)
                return
            # quest: allow-broad-except(classified barrier: FATAL
            # resolves the work with the caller's original error,
            # everything else is a replica problem to route around)
            except Exception as e:
                if classify(e) == FATAL:
                    # caller error (bad params/observables): no replica
                    # can serve it — burning the exclusion set would
                    # end in a misleading AllReplicasUnavailable
                    self._resolve(work, exc=e)
                    return
                self._event("replica_submit_error", replica=h.index,
                            error=type(e).__name__)
                exclude = set(exclude) | {h.index}
                continue
            hedge = bool(work.active)
            if work.trace is not None:
                work.trace.add("route", replica=h.index, hedge=hedge)
            with work.lock:
                work.tried.add(h.index)
                # entry carries ITS OWN dispatch timestamp: a later
                # hedge/failover placement overwrites last_route_t, and
                # the EMA must attribute each hop's duration to the
                # replica that actually served that hop
                work.active[h.index] = (fut, hedge, time.monotonic())
                work.last_route_t = time.monotonic()
            self.metrics.incr("routed")
            fut.add_done_callback(
                lambda f, h=h, w=work: self._on_replica_done(w, h, f))
            return

    def _on_replica_done(self, work: _Work, h: _Replica, fut) -> None:
        # runs as a Future callback ON the replica's dispatcher thread:
        # an escaped exception would kill that dispatcher (cascading a
        # one-request problem into a replica-level fault) and strand
        # the work forever — resolve with the error instead
        try:
            self._handle_replica_done(work, h, fut)
        # quest: allow-broad-except(callback barrier: an escaped
        # exception would kill the replica dispatcher thread and strand
        # the work; ANY failure must resolve the future instead)
        except Exception as e:
            self._resolve(work, exc=e)

    def _handle_replica_done(self, work: _Work, h: _Replica, fut) -> None:
        with work.lock:
            entry = work.active.pop(h.index, None)
        if entry is None:
            # this hop was already disowned (_reroute_from re-placed
            # the work when the replica was quarantined): only a benign
            # late success may still win — treating the disowned hop's
            # ServiceClosed as a fresh fault would burn a second
            # failover and double-dispatch the request
            if not work.done and not fut.cancelled() \
                    and fut.exception() is None:
                self._resolve(work, result=fut.result())
            return
        was_hedge = bool(entry[1])
        if work.done:
            return
        if fut.cancelled():
            exc: Optional[BaseException] = ServiceClosed(
                "replica cancelled the request")
        else:
            exc = fut.exception()
        if exc is None:
            dur = time.monotonic() - entry[2]
            d = self.supervisor.ema_decay
            h.ema_request_s = dur if h.ema_request_s == 0.0 \
                else (1.0 - d) * dur + d * h.ema_request_s
            if was_hedge:
                self.metrics.incr("hedge_wins")
            self._resolve(work, result=fut.result())
            return
        kind = classify(exc)
        replica_fault = isinstance(exc, ServiceClosed)
        eligible = replica_fault or kind == TRANSIENT \
            or isinstance(exc, CircuitBreakerOpen)
        if isinstance(exc, DeadlineExceeded) or kind in (FATAL, POISON):
            eligible = False
        if replica_fault:
            self._note_replica_fault(h, exc)
        if eligible and work.failovers_left > 0 and not self._closed:
            work.failovers_left -= 1
            self.metrics.incr("failovers")
            self._event("failover", _trace=work.trace, replica=h.index,
                        error=type(exc).__name__,
                        remaining_s=round(
                            work.deadline - time.monotonic(), 6))
            if work.trace is not None:
                work.trace.add("failover", replica=h.index,
                               error=type(exc).__name__)
            self._place(work, set(work.tried))
            return
        if not work.active:     # no other hop can still save it
            self._resolve(work, exc=exc)

    def _resolve(self, work: _Work, result=None,
                 exc: Optional[BaseException] = None) -> None:
        with work.lock:
            if work.done:
                return
            work.done = True
        with self._lock:
            self._outstanding.pop(id(work), None)
            if work in self._parked:
                self._parked.remove(work)
        if work.future.set_running_or_notify_cancel():
            if exc is not None:
                work.future.set_exception(exc)
            else:
                work.future.set_result(result)
        if exc is None:
            self.metrics.record_latency(time.monotonic() - work.submit_t)
        if work.trace is not None:
            status = "ok" if exc is None else type(exc).__name__
            work.trace.add("resolve", status=status,
                           failovers=self.max_failovers
                           - work.failovers_left)
            work.trace.finish(status)

    # -- multi-tenancy + elasticity ----------------------------------------

    def set_tenant(self, tenant: str, policy) -> None:
        """Install or replace one tenant's scheduling contract
        (:class:`~quest_tpu_torch.serve.TenantPolicy`) on EVERY replica —
        live ones immediately, future ones (restarts, scale-ups)
        through the recorded service kwargs."""
        with self._lock:
            tenants = dict(self._service_kwargs.get("tenants") or {})
            tenants[str(tenant)] = policy
            self._service_kwargs["tenants"] = tenants
            replicas = list(self._replicas)
        for h in replicas:
            if h.state != "failed":
                h.service.set_tenant(tenant, policy)

    def interactive_pressure(self) -> bool:
        """True while any replica holds queued priority-0 (interactive)
        work — the preemption signal checkpointed runs poll at segment
        boundaries (:func:`~quest_tpu_torch.serve.run_optimization`'s
        ``yield_to_interactive``)."""
        with self._lock:
            replicas = list(self._replicas)
        return any(h.state == "ready" and h.service.interactive_pressure()
                   for h in replicas)

    def scale_to(self, n: int, *, timeout: float = 30.0) -> dict:
        """Resize the replica pool to ``n`` live replicas.

        Growing stands each new replica up OFF the router lock — fresh
        env (``env_factory`` or a :func:`replica_envs` slice), new
        service, warm-spec replay through the shared warm cache, and
        the same oracle-grade half-open probe a restart passes — then
        admits it atomically; a probe failure aborts the grow (the
        pool never admits a replica that computes wrong answers).
        Shrinking drains the highest-index replicas first (quiesce,
        then close) so no queued request is dropped. Returns
        accounting: ``{"replicas", "added", "removed", "ready_s"}``
        (``ready_s``: the scale-up-to-ready latency)."""
        n = int(n)
        if n < 1:
            raise ValueError("the pool needs at least one replica")
        if self._closed:
            raise ServiceClosed("router is closed")
        sp = _profile.profile_dispatch("serve.scale")
        _faults.fire("serve.scale")
        t0 = time.perf_counter()
        added: list = []
        removed: list = []
        with self._lock:
            cur = sum(1 for h in self._replicas if h.state != "failed")
        with dispatch_annotation(
                f"quest_tpu_torch.serve.scale:{cur}to{n}"):
            while True:            # grow, one replica at a time
                with self._lock:
                    live = sum(1 for h in self._replicas
                               if h.state != "failed")
                    if live >= n or self._closed:
                        break
                    idx = self._next_index
                    self._next_index += 1
                h = self._stand_up_replica(idx)
                if h is None:
                    break           # probe failed: never admit it
                with self._lock:
                    if self._closed:
                        break
                    self._replicas.append(h)
                added.append(idx)
                self.metrics.incr("scale_ups")
                self._event("replica_scaled_up", replica=idx,
                            ready_s=round(time.perf_counter() - t0, 4))
            while True:            # shrink, newest replica first
                with self._lock:
                    ready = [h for h in self._replicas
                             if h.state != "failed"]
                    if len(ready) <= max(n, 1) or self._closed:
                        break
                    h = max(ready, key=lambda r: r.index)
                    h.state = "draining"
                self._event("replica_draining", replica=h.index)
                try:
                    h.service.quiesce(timeout=timeout)
                    h.service.close(drain=True, timeout=timeout)
                except (ServeError, RuntimeError, OSError):
                    pass    # best-effort: the slot is leaving the pool
                with self._lock:
                    if h in self._replicas:
                        self._replicas.remove(h)
                removed.append(h.index)
                self.metrics.incr("scale_downs")
                self._event("replica_scaled_down", replica=h.index)
        with self._lock:
            self._last_scale_t = time.monotonic()
            count = sum(1 for h in self._replicas if h.state != "failed")
        ready_s = time.perf_counter() - t0
        if sp is not None:
            sp.done(None, program=f"pool{count}", kind="scale",
                    bucket=max(1, count), tier="env", dtype="float64",
                    sharding="none")
        return {"replicas": count, "added": added, "removed": removed,
                "ready_s": ready_s}

    def _stand_up_replica(self, idx: int):
        """Build one scale-up replica end to end (env, service, warm
        replay, probe) with NO router lock held; returns the admitted
        :class:`_Replica` or None when the probe fails."""
        if self._env_factory is not None:
            env = self._env_factory()
        else:
            # mirror the live pool: its device, shards and precision
            with self._lock:
                live = [r for r in self._replicas if r.state != "failed"]
            like = live[0].env if live else None
            k = self._devices_per_replica
            if k is None and like is not None:
                k = like.num_devices
            env = replica_envs(
                1, k, precision=like.precision if like is not None else None,
                device=like.device if like is not None else None)[0]
        svc = self._new_service(env, index=idx)
        with self._lock:
            specs = list(self._warm_specs)
        try:
            for spec in specs:
                svc.warm(spec.circuit, batch_sizes=spec.batch_sizes,
                         observables=spec.observables, shots=spec.shots)
            ok = self._probe(svc)
        # quest: allow-broad-except(admission barrier: ANY warm/probe
        # failure means the candidate replica is not admitted -- the
        # typed outcome is an aborted scale-up, not an exception)
        except Exception:
            ok = False
        if not ok:
            self.metrics.incr("probe_failures")
            self._event("scale_up_probe_failed", replica=idx)
            try:
                svc.close(drain=False, timeout=1.0)
            except (ServeError, RuntimeError, OSError):
                pass    # best-effort teardown of the failed candidate
            return None
        h = _Replica(idx, env, svc)
        if self.perf_ledger is not None:
            seed_s = self.perf_ledger.mean_request_s()
            if seed_s > 0.0:
                h.ema_request_s = seed_s
        return h

    def _maybe_autoscale(self, now: float) -> None:
        """One elasticity decision per supervisor poll: pool the live
        backlog/inflight, price the drain time with the perf ledger's
        mean request latency (live EMA fallback), and hand the numbers
        to :class:`~quest_tpu_torch.resilience.AutoscalePolicy`. The actual
        resize runs on a background thread — standing a replica up
        warms and probes it, which must never stall quarantine/hedge
        service for the whole pool."""
        pol = self.autoscale
        if pol is None or self._closed:
            return
        if self._scale_thread is not None \
                and self._scale_thread.is_alive():
            return                  # one resize in flight at a time
        with self._lock:
            live = [h for h in self._replicas if h.state != "failed"]
            replicas = len(live)
            backlog = sum(h.service._backlog for h in live)
            inflight = sum(h.service._inflight for h in live)
        if replicas == 0:
            return
        if backlog + inflight > 0:
            self._idle_since = None
        elif self._idle_since is None:
            self._idle_since = now
        est = self.perf_ledger.mean_request_s() \
            if self.perf_ledger is not None else 0.0
        if est <= 0.0:
            emas = [h.ema_request_s for h in live if h.ema_request_s > 0]
            est = sum(emas) / len(emas) if emas else 0.0
        delta = pol.decide(now=now, replicas=replicas, backlog=backlog,
                           inflight=inflight, mean_request_s=est,
                           last_scale_t=self._last_scale_t,
                           idle_since=self._idle_since)
        if delta == 0:
            return
        target = max(1, replicas + delta)
        self._event("autoscale_decision", replicas=replicas,
                    target=target, backlog=backlog,
                    mean_request_s=round(est, 6))

        def _resize():
            try:
                self.scale_to(target)
            # quest: allow-broad-except(elasticity barrier: a failed
            # resize (injected scale fault, probe failure, close race)
            # must not kill the scale thread unlogged -- the pool just
            # holds and the next poll re-decides)
            except Exception as e:
                self.metrics.incr("supervisor_errors")
                self._event("autoscale_error", error=type(e).__name__)

        self._scale_thread = threading.Thread(
            target=_resize, daemon=True,
            name=f"quest-tpu-torch-router-scale-{id(self):x}")
        self._scale_thread.start()

    # -- warm + probe ------------------------------------------------------

    def warm(self, circuit, batch_sizes: Optional[Sequence[int]] = None,
             observables=None, shots: Optional[int] = None) -> None:
        """Warm every replica for the given traffic AND record the spec:
        a restarted replica replays it (through the shared persistent
        warm cache — load, not recompile) and its half-open probe must
        reproduce the reference computed here."""
        route = self._route_circuit(circuit)
        reference = None
        for i, h in enumerate(list(self._replicas)):
            if h.state != "ready":
                continue
            cc = h.service.warm(route, batch_sizes=batch_sizes,
                                observables=observables, shots=shots)
            if reference is None:
                # device-multiple rows: a 1-row sweep on a mesh replica
                # would take the engine's pad-and-mask path
                pm0 = np.zeros((max(1, cc.env.num_devices),
                                len(cc.param_names)), dtype=np.float64)
                if observables is not None:
                    ham = (observables[0], observables[1])
                    reference = float(cc.expectation_sweep(pm0, ham)[0])
                elif shots is None:
                    reference = cc.sweep(pm0)[0].cpu().numpy()
        with self._lock:
            self._warm_specs.append(_WarmSpec(
                route, tuple(batch_sizes) if batch_sizes else None,
                observables, shots, reference))

    def optimize(self, problem, optimizer="adam", *,
                 max_iters: int = 100, tol: float = 1e-6,
                 learning_rate: Optional[float] = None,
                 checkpoint_path: Optional[str] = None,
                 resume: bool = True, max_restarts: int = 3,
                 tenant: str = DEFAULT_TENANT,
                 yield_to_interactive: bool = True,
                 preempt_hold_s: float = 5.0):
        """Optimizer-in-the-loop over the REPLICATED front end: same
        contract as :meth:`SimulationService.optimize`, with each
        iterate's gradient submission routed/failed-over like any
        other request — a replica death mid-optimization costs at most
        one re-executed iterate (the handle's restart budget), and
        with ``checkpoint_path`` a router-wide outage resumes from the
        last good iterate. The problem's circuit should be a RECORDED
        :class:`~quest_tpu_torch.circuits.Circuit` (the router routes by it;
        each replica compiles its own program)."""
        from .optimize import run_optimization
        return run_optimization(
            self, problem, optimizer, max_iters=max_iters, tol=tol,
            learning_rate=learning_rate,
            checkpoint_path=checkpoint_path, resume=resume,
            max_restarts=max_restarts, tenant=tenant,
            yield_to_interactive=yield_to_interactive,
            preempt_hold_s=preempt_hold_s)

    def _probe(self, svc: SimulationService) -> bool:
        """Half-open readmission probe: a batch of zero-parameter
        requests per warm spec, every result checked against the
        reference recorded at warm time (oracle-grade — NaN, norm
        drift, or a wrong value all fail). Vacuously true with no
        recorded specs (nothing to check against)."""
        sp = self.supervisor
        self.metrics.incr("probe_batches")
        with self._lock:
            specs = list(self._warm_specs)
        try:
            for spec in specs:
                names = spec.circuit.param_names
                params = {nm: 0.0 for nm in names}
                futs = [svc.submit(spec.circuit, params,
                                   observables=spec.observables,
                                   shots=spec.shots,
                                   deadline=sp.probe_timeout_s)
                        for _ in range(sp.probe_batch)]
                for f in futs:
                    got = f.result(timeout=sp.probe_timeout_s)
                    # reference can be None: warm() ran in a window
                    # with no ready replica (all quarantined). The
                    # probe then degrades to finiteness-only — a None
                    # reference must never fail every future probe
                    # and wedge the replica in permanent quarantine
                    if spec.observables is not None:
                        if not np.isfinite(got):
                            return False
                        if spec.reference is not None and \
                                abs(got - spec.reference) > sp.probe_tol:
                            return False
                    elif spec.shots is not None:
                        idx, total = got
                        if idx.shape != (spec.shots,) or \
                                not np.isfinite(total) or \
                                abs(total - 1.0) > 1e-6:
                            return False
                    else:
                        if not np.all(np.isfinite(got)):
                            return False
                        if spec.reference is not None and \
                                np.abs(np.asarray(got)
                                       - spec.reference).max() \
                                > sp.probe_tol:
                            return False
        # quest: allow-broad-except(oracle-grade probe: ANY failure --
        # timeout, typed fault, wrong shape -- means not ready)
        except Exception:
            return False
        return True

    # -- supervision -------------------------------------------------------

    def _note_replica_fault(self, h: _Replica, exc) -> None:
        """A replica-scoped failure observed by the routing layer (a
        breaker-open fast-fail is PROGRAM-scoped and does not count)."""
        if h.state == "ready" and not h.service.is_alive():
            self._quarantine(h, f"dispatcher dead "
                                f"({type(exc).__name__})")

    def _apply_replica_fault(self, kind: str) -> None:
        """Injected replica fault (chaos): applied to the replica the
        router would have picked next — the worst case, since it holds
        the most traffic of any eligible replica's queue."""
        with self._lock:
            ready = [h for h in self._replicas if h.state == "ready"
                     and h.service.is_alive()]
        if not ready:
            return
        h = min(ready, key=lambda r: r.service._backlog)
        inj = _faults.active()
        if kind == "replica_crash":
            self._event("injected_replica_crash", replica=h.index)
            h.service._debug_crash()
        elif kind == "replica_stall":
            stall = max(inj.stall_s if inj is not None else 0.05,
                        self.supervisor.stall_timeout_s * 2.0)
            self._event("injected_replica_stall", replica=h.index,
                        stall_s=round(stall, 3))
            h.service._debug_wedge(stall)

    def _quarantine(self, h: _Replica, reason: str) -> None:
        with self._lock:
            if h.state not in ("ready", "draining"):
                return
            h.state = "quarantined"
            h.quarantine_reason = reason
        self.metrics.incr("replica_quarantines")
        self._event("replica_quarantined", replica=h.index, reason=reason)
        svc = h.service
        # fail queued work over: a live dispatcher resolves its queue
        # with ServiceClosed (our callbacks re-place); a dead one
        # strands futures, so the outstanding scan below re-places them
        try:
            if svc._thread.is_alive():
                svc.close(drain=False, timeout=1.0)
        except (ServeError, RuntimeError, OSError):
            pass    # best-effort: the replica is being quarantined
        self._reroute_from(h)

    def _reroute_from(self, h: _Replica) -> None:
        """Re-place every outstanding work item stranded on a replica
        (its future may never resolve — simulated SIGKILL). The old hop
        stays recorded in ``tried``; a late success from it still wins
        benignly."""
        with self._lock:
            works = [w for w in self._outstanding.values()
                     if h.index in w.active and not w.done]
        for w in works:
            with w.lock:
                entry = w.active.pop(h.index, None)
            if entry is None:
                # the replica's own ServiceClosed callback raced us
                # here and already failed this work over — a second
                # decrement would double-burn the failover budget and
                # double-dispatch the request
                continue
            if w.failovers_left > 0:
                w.failovers_left -= 1
                self.metrics.incr("failovers")
                self._event("failover", _trace=w.trace, replica=h.index,
                            error="replica_quarantined")
                if w.trace is not None:
                    w.trace.add("failover", replica=h.index,
                                error="replica_quarantined")
                self._place(w, set(w.tried))
            elif not w.active:
                self._resolve(w, exc=AllReplicasUnavailable(
                    "replica quarantined and the failover budget is "
                    "exhausted"))

    def _supervise_loop(self) -> None:
        sp = self.supervisor
        while not self._stop.wait(sp.poll_s):
            # the supervisor must outlive ANY single bad poll: an
            # exception here would silently end quarantine/restart/
            # hedge service for the router's whole lifetime
            try:
                self._supervise_once()
            # quest: allow-broad-except(thread barrier: the supervisor
            # must outlive any single bad poll or quarantine/restart/
            # hedge service silently ends for the router's lifetime)
            except Exception as e:
                self.metrics.incr("supervisor_errors")
                self._event("supervisor_error", error=type(e).__name__)

    def _supervise_once(self) -> None:
        sp = self.supervisor
        now = time.monotonic()
        with self._lock:
            replicas = list(self._replicas)
        for h in replicas:
            if h.state == "ready":
                svc = h.service
                dead = not svc._thread.is_alive() or svc._crashed
                gap = now - svc._heartbeat
                busy = (svc._backlog + svc._inflight) > 0
                stalled = sp.stall_quarantine and busy \
                    and gap > sp.stall_timeout_s
                faults = svc.metrics.get("executor_faults")
                burst = faults - h.last_faults \
                    >= sp.fault_quarantine_threshold
                h.last_faults = faults
                if dead:
                    self._quarantine(h, "dispatcher dead")
                elif stalled:
                    self._quarantine(
                        h, f"heartbeat stall ({gap:.2f}s)")
                elif burst:
                    self._quarantine(h, "executor fault burst")
            elif h.state == "quarantined":
                self._maybe_restart(h)
        self._replace_parked()
        self._maybe_hedge(now)
        self._maybe_autoscale(now)

    def _replace_parked(self) -> None:
        with self._lock:
            parked, self._parked = self._parked, []
        for w in parked:
            self._place(w, set())   # fresh pick; parks again if needed

    def _maybe_hedge(self, now: float) -> None:
        if self.hedge_after_s is None:
            return
        with self._lock:
            works = [w for w in self._outstanding.values()
                     if not w.done and not w.hedged
                     and len(w.active) == 1
                     and now - w.last_route_t > self.hedge_after_s]
        for w in works:
            if self._pick(w, set(w.tried)) is None:
                continue          # nowhere to hedge to; try next poll
            self._place(w, set(w.tried))
            # commit the hedge only if the placement actually landed a
            # second dispatch — marking w.hedged on a parked/failed
            # placement would permanently disable hedging for exactly
            # the requests that still need it (and miscount dispatches)
            with w.lock:
                landed = len(w.active) > 1
            if landed:
                w.hedged = True
                self.metrics.incr("hedged_dispatches")
                self._event("hedge", _trace=w.trace,
                            tried=sorted(w.tried))
                if w.trace is not None:
                    w.trace.add("hedge", tried=sorted(w.tried))

    def _maybe_restart(self, h: _Replica) -> None:
        sp = self.supervisor
        if h.restart_thread is not None and h.restart_thread.is_alive():
            return
        if time.monotonic() < h.next_restart_t:
            return
        if h.restart_attempts >= sp.max_restart_attempts:
            with self._lock:
                h.state = "failed"
            self._event("replica_failed", replica=h.index,
                        attempts=h.restart_attempts)
            return
        h.restart_thread = threading.Thread(
            target=self._restart_replica, args=(h,), daemon=True,
            name=f"quest-tpu-torch-replica-restart-{h.index}")
        h.restart_thread.start()

    def _restart_replica(self, h: _Replica, graceful: bool = False
                         ) -> dict:
        """Replace a replica's service: close the old one, stand up a
        fresh :class:`SimulationService` over the SAME env, re-warm it
        (the shared warm cache turns the compiles into loads), run the
        half-open probe, and readmit only on a pass. Returns timing
        accounting (the bench's restart-to-ready number)."""
        sp = self.supervisor
        with self._lock:
            h.state = "restarting"
            h.restart_attempts += 1
        self.metrics.incr("replica_restarts")
        self._event("replica_restart", replica=h.index,
                    attempt=h.restart_attempts)
        t0 = time.perf_counter()
        try:
            h.service.close(drain=graceful, timeout=2.0)
        except (ServeError, RuntimeError, OSError):
            pass    # the old service is being replaced regardless
        svc = self._new_service(h.env, index=h.index)
        with self._lock:
            specs = list(self._warm_specs)
        try:
            for spec in specs:
                svc.warm(spec.circuit, batch_sizes=spec.batch_sizes,
                         observables=spec.observables, shots=spec.shots)
            warm_s = time.perf_counter() - t0
            ok = self._probe(svc)
        # quest: allow-broad-except(restart barrier: ANY warm/probe
        # failure means the replica is not readmitted -- the typed
        # outcome is the quarantined state, not an exception)
        except Exception:
            warm_s = time.perf_counter() - t0
            ok = False
        if ok and not self._closed:
            with self._lock:
                h.service = svc
                h.state = "ready"
                h.restarts += 1
                h.restart_attempts = 0
                h.last_faults = 0
                h.next_restart_t = 0.0
            self.metrics.incr("readmissions")
            ready_s = time.perf_counter() - t0
            self._event("replica_readmitted", replica=h.index,
                        warm_s=round(warm_s, 4),
                        ready_s=round(ready_s, 4))
            return {"ok": True, "warm_s": warm_s, "ready_s": ready_s}
        if ok:
            # probe passed but the router closed mid-restart: not an
            # oracle failure — counting one would plant a spurious
            # probe_failed in the incident timeline
            try:
                svc.close(drain=False, timeout=1.0)
            except (ServeError, RuntimeError, OSError):
                pass    # best-effort teardown of the failed candidate
            return {"ok": False, "warm_s": warm_s,
                    "ready_s": time.perf_counter() - t0}
        self.metrics.incr("probe_failures")
        try:
            svc.close(drain=False, timeout=1.0)
        except (ServeError, RuntimeError, OSError):
            pass    # best-effort teardown of the failed candidate
        with self._lock:
            if not self._closed:
                h.state = "quarantined"
            h.next_restart_t = time.monotonic() \
                + sp.restart_delay(h.restart_attempts)
        self._event("probe_failed", replica=h.index,
                    attempt=h.restart_attempts)
        return {"ok": False, "warm_s": warm_s,
                "ready_s": time.perf_counter() - t0}

    # -- lifecycle ---------------------------------------------------------

    def rolling_restart(self, timeout_per_replica: float = 120.0) -> dict:
        """Restart every replica in sequence with ZERO dropped requests:
        each replica is drained (stops taking traffic, finishes its
        queue), restarted, probed, and readmitted before the next one
        goes. Needs >= 2 replicas (someone must carry the traffic).
        Returns per-replica restart accounting."""
        if self.num_replicas < 2:
            raise ValueError(
                "rolling restart needs >= 2 replicas so traffic always "
                "has a ready replica to land on")
        out = []
        for h in list(self._replicas):
            if h.state == "failed":
                out.append({"replica": h.index, "ok": False,
                            "skipped": "failed"})
                continue
            with self._lock:
                others = any(r.state == "ready" and r is not h
                             for r in self._replicas)
            if not others:
                raise RuntimeError(
                    "no other ready replica to carry traffic; aborting "
                    "the rolling restart")
            with self._lock:
                h.state = "draining"
            self._event("replica_draining", replica=h.index)
            h.service.quiesce(timeout=timeout_per_replica)
            acct = self._restart_replica(h, graceful=True)
            out.append({"replica": h.index, **acct})
        return {"replicas": out}

    def dispatch_stats(self) -> dict:
        """Router metrics + per-replica state and service snapshots (the
        replica-level analogue of ``SimulationService.dispatch_stats``;
        ``chip_smoke.py`` phase 19 prints it)."""
        with self._lock:
            replicas = list(self._replicas)
            parked = len(self._parked)
            outstanding = len(self._outstanding)
        per = []
        for h in replicas:
            svc = h.service
            per.append({
                "replica": h.index,
                "state": h.state,
                "alive": svc.is_alive(),
                "devices": h.env.num_devices,
                "queue_depth": svc._backlog,
                "inflight": svc._inflight,
                "restarts": h.restarts,
                "ema_request_s": round(h.ema_request_s, 6),
                "quarantine_reason": h.quarantine_reason,
                "service": svc.metrics.snapshot(),
            })
        out = {
            "router": {**self.metrics.snapshot(),
                       "replicas": len(replicas),
                       "parked": parked,
                       "outstanding": outstanding},
            "replicas": per,
            "telemetry": self.tracer.stats(),
            "profile": _profile.profiler().snapshot(),
        }
        if self.warm_cache is not None:
            out["warm_cache"] = self.warm_cache.stats()
        if self.perf_ledger is not None:
            out["perf_ledger"] = self.perf_ledger.stats()
        inj = _faults.active()
        if inj is not None:
            out["fault_injection"] = inj.snapshot()
        return out

    def _registry_stats(self) -> dict:
        """Registry-scraped document: :meth:`dispatch_stats` minus the
        process-global profiler section (exported once under its own
        ``dispatch_profiler`` provider — the engine-side rationale,
        :meth:`SimulationService._registry_stats`)."""
        out = self.dispatch_stats()
        out.pop("profile", None)
        return out

    def close(self, drain: bool = True,
              timeout: Optional[float] = 30.0) -> None:
        """Stop the supervisor and close every replica. ``drain=True``
        lets each replica flush its queue first; parked work that never
        found a replica fails typed. Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            parked = list(self._parked)
            self._parked.clear()
        self._stop.set()
        metrics_registry().unregister(self._registry_token)
        if threading.current_thread() is not self._supervisor:
            self._supervisor.join(timeout)
        t = self._scale_thread
        if t is not None and t.is_alive() \
                and threading.current_thread() is not t:
            t.join(timeout)
        for w in parked:
            self._resolve(w, exc=ServiceClosed(
                "router closed before the request could be placed"))
        with self._lock:
            replicas = list(self._replicas)
        for h in replicas:
            t = h.restart_thread
            if t is not None and t.is_alive():
                t.join(timeout)
            try:
                h.service.close(drain=drain, timeout=timeout)
            except (ServeError, RuntimeError, OSError):
                pass    # closing: nothing left to fail over to

    def __enter__(self) -> "ServiceRouter":
        return self

    def __exit__(self, *exc) -> bool:
        self.close(drain=exc == (None, None, None))
        return False
