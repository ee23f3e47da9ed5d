"""The metrics registries of the serving runtime.

Every :class:`quest_tpu_torch.serve.SimulationService` owns one
:class:`ServiceMetrics` and every :class:`~quest_tpu_torch.serve.router.
ServiceRouter` one :class:`RouterMetrics`, built on the typed primitives in
:mod:`quest_tpu_torch.telemetry.metrics`: named
:class:`~quest_tpu_torch.telemetry.metrics.Counter` objects for the
request lifecycle, and fixed-bucket :class:`~quest_tpu_torch.telemetry.
metrics.Histogram` latency distributions (constant memory, mergeable,
Prometheus-exportable). It is thread-safe — updated from BOTH the caller
threads (submit-side rejections) and the service's dispatcher thread.

:meth:`ServiceMetrics.snapshot` returns a plain dict with the JAX
package's keys; ``SimulationService.dispatch_stats()`` folds it in under
``"service"`` next to the engine-level :class:`quest_tpu_torch.profiling.
DispatchStats` fields, and the service registers that combined document
into the process-global :func:`~quest_tpu_torch.telemetry.metrics.
metrics_registry`, which the Prometheus/JSON exporters
(:mod:`quest_tpu_torch.telemetry.export`) scrape. Every
:class:`~quest_tpu_torch.netserve.server.NetServer` owns one
:class:`WireMetrics`, the front door's counters and parse/serialize
latencies, registered beside its backend's document.
"""

from __future__ import annotations

import threading

from ..telemetry.metrics import Counter, Histogram

__all__ = ["ServiceMetrics", "RouterMetrics", "WireMetrics"]


_COUNTERS = (
    "submitted",             # requests accepted into the queue
    "completed",             # futures resolved with a result
    "failed",                # futures resolved with an executor exception
    "timeouts",              # expired in queue (deadline / request timeout)
    "retries",               # re-queued after a transient executor failure
    "rejected_queue_full",   # submit() raised QueueFull
    "rejected_deadline",     # submit() raised DeadlineExceeded up front
    "batches",               # coalesced dispatches sent to the engine
    "coalesced_requests",    # requests carried by those dispatches
    "shared_batch_requests",  # of those, requests that shared their batch
    "padded_rows",           # throwaway rows added by batch bucketing
    # fault-tolerance accounting (resilience/):
    "executor_faults",       # engine dispatches that raised (non-fatal)
    "failed_fatal",          # futures failed fast on a caller error
    "quarantine_splits",     # faulted batches bisected by quarantine
    "quarantined",           # requests isolated + failed typed by quarantine
    "health_failures",       # result rows screened out as non-finite
    "breaker_trips",         # circuit breaker open transitions
    "breaker_fastfails",     # requests fast-failed by an open breaker
    "degraded_dispatches",   # requests run in sequential degraded mode
    "watchdog_stalls",       # dispatcher heartbeat gaps past the timeout
    # the persistent warm-start cache (serve/warmcache.py):
    "warm_cache_hits",       # warm() forms loaded from the persistent cache
    "warm_cache_misses",     # warm() forms packed fresh (and stored)
    # precision-tier execution (config.PrecisionTier):
    "fast_tier_dispatches",  # engine dispatches run at the FAST tier
    "tier_violations",       # result rows outside their tier's tolerance
    "tier_escalations",      # requests re-executed one tier up
    # trajectory-parallel noisy execution (ops/trajectories.py):
    "trajectory_dispatches",  # coalesced trajectory wave loops executed
    "trajectories_run",       # stochastic draws those loops executed
    "trajectories_saved",     # draws early stopping skipped vs max_T
    # gradient serving + optimizer-in-the-loop (serve/optimize.py):
    "gradient_dispatches",    # coalesced value-and-grad executables run
    "gradients_returned",     # (value, grad) results fanned back
    "optimizer_runs",         # optimize() handles started
    "optimizer_iterations",   # optimizer steps executed (all handles)
    "optimizer_converged",    # handles that met their tolerance
    "optimizer_resumes",      # handles resumed from a checkpoint
    # multi-tenant WFQ scheduling + pipelined dispatch:
    "rejected_quota",         # submit() raised QuotaExceeded (queued cap)
    "quota_deferrals",        # ready requests held back by an inflight cap
    "pipelined_batches",      # dispatches launched through the in-flight pipe
    "preemptions",            # checkpointed runs that yielded the mesh
    # Hamiltonian dynamics (ops/dynamics.py; the evolve()/ground_state()
    # handles of serve/dynamics.py):
    "evolve_dispatches",      # coalesced Trotter-evolution segments run
    "evolve_steps_fused",     # Trotter steps iterated inside executables
    "ground_dispatches",      # coalesced ground-state segments run
    "dynamics_runs",          # evolve()/ground_state() handles started
    "dynamics_resumes",       # handles resumed from a dynamics checkpoint
    "ground_converged",       # ground handles that met their residual tol
)

# per-tenant counter family (a subset of the service counters that is
# meaningful per submitting tenant; tracked by incr_tenant)
_TENANT_COUNTERS = ("submitted", "completed", "rejected_quota",
                    "preemptions")


class ServiceMetrics:
    """Typed counters + fixed-bucket latency histograms for one service.

    ``latency_window`` is accepted for backward compatibility (it
    bounded the old raw-sample reservoirs); the histograms are
    constant-memory regardless, so it is unused. ``queue_depth_fn`` is
    an optional gauge callback installed by the owning service (the
    queue lives there, not here).
    """

    def __init__(self, latency_window: int = 4096):
        # ONE reentrant lock shared by every counter: a snapshot must
        # read the whole counter family atomically w.r.t. record_batch,
        # or a reader can see shared_batch_requests from after an
        # update and coalesced_requests from before it (the torn-read
        # class the router-level coherence test hunts)
        self._lock = threading.RLock()
        self._latency = Histogram(
            "request_latency_s", "submit-to-result seconds")
        self._queue_wait = Histogram(
            "queue_wait_s", "submit-to-dispatch seconds")
        self._c = {name: Counter(name, lock=self._lock)
                   for name in _COUNTERS}
        self._max_occupancy = 0
        self.queue_depth_fn = None
        # per-tenant accounting: created lazily on first
        # touch so single-tenant services pay nothing new; all three
        # maps are guarded by the same registry lock
        self._tenant_c: dict = {}        # tenant -> {name: int}
        self._tenant_lat: dict = {}      # tenant -> (Histogram, Histogram)
        self._tenant_busy: dict = {}     # tenant -> mesh-busy seconds

    # -- recording ---------------------------------------------------------

    def incr(self, name: str, k: int = 1) -> None:
        c = self._c.get(name)
        if c is None:
            raise KeyError(f"unknown service counter {name!r}")
        c.inc(k)

    def get(self, name: str) -> int:
        """One counter, cheaply (no full snapshot — the router's
        supervisor polls this per replica per tick)."""
        return self._c[name].value

    def record_batch(self, size: int, padded_size: int) -> None:
        """One coalesced dispatch of ``size`` live requests, executed at
        ``padded_size`` rows (the batch bucket the executable ran at).
        One atomic update: a concurrent snapshot sees the whole batch's
        accounting or none of it."""
        with self._lock:
            self._c["batches"].inc()
            self._c["coalesced_requests"].inc(size)
            if size > 1:
                self._c["shared_batch_requests"].inc(size)
            self._c["padded_rows"].inc(max(0, padded_size - size))
            self._max_occupancy = max(self._max_occupancy, size)

    def record_latency(self, total_s: float, queue_wait_s: float) -> None:
        self._latency.observe(total_s)
        self._queue_wait.observe(queue_wait_s)

    # -- per-tenant accounting ----------------------------------------------

    def incr_tenant(self, tenant: str, name: str, k: int = 1) -> None:
        """One per-tenant counter tick. Unknown names raise (same
        typo-guard contract as :meth:`incr`)."""
        if name not in _TENANT_COUNTERS:
            raise KeyError(f"unknown tenant counter {name!r}")
        with self._lock:
            row = self._tenant_c.setdefault(
                tenant, dict.fromkeys(_TENANT_COUNTERS, 0))
            row[name] += k

    def record_tenant_latency(self, tenant: str, total_s: float,
                              queue_wait_s: float) -> None:
        with self._lock:
            pair = self._tenant_lat.get(tenant)
            if pair is None:
                pair = (Histogram("request_latency_s",
                                  "submit-to-result seconds"),
                        Histogram("queue_wait_s",
                                  "submit-to-dispatch seconds"))
                self._tenant_lat[tenant] = pair
        pair[0].observe(total_s)
        pair[1].observe(queue_wait_s)

    def record_tenant_busy(self, tenant: str, seconds: float) -> None:
        """Mesh-busy seconds attributed to one tenant's dispatches —
        the numerator of the share-of-mesh gauge."""
        with self._lock:
            self._tenant_busy[tenant] = \
                self._tenant_busy.get(tenant, 0.0) + float(seconds)

    def tenant_snapshot(self) -> dict:
        """Per-tenant view: counters, latency/queue-wait percentiles,
        busy seconds, and share-of-mesh (this tenant's busy seconds
        over all tenants'). Empty dict when no tenant ever recorded."""
        with self._lock:
            counters = {t: dict(row)
                        for t, row in self._tenant_c.items()}
            busy = dict(self._tenant_busy)
            lat = dict(self._tenant_lat)
        total_busy = sum(busy.values())
        tenants = set(counters) | set(busy) | set(lat)
        out = {}
        for t in sorted(tenants):
            pair = lat.get(t)
            out[t] = {
                **counters.get(t, dict.fromkeys(_TENANT_COUNTERS, 0)),
                "busy_s": busy.get(t, 0.0),
                "mesh_share": (busy.get(t, 0.0) / total_busy)
                if total_busy > 0 else 0.0,
                "p50_latency_s":
                    pair[0].percentile(50.0) if pair else 0.0,
                "p99_latency_s":
                    pair[0].percentile(99.0) if pair else 0.0,
                "p50_queue_wait_s":
                    pair[1].percentile(50.0) if pair else 0.0,
                "p99_queue_wait_s":
                    pair[1].percentile(99.0) if pair else 0.0,
            }
        return out

    # -- reading -----------------------------------------------------------

    @staticmethod
    def _pct(sorted_vals, p: float) -> float:
        """Percentile of a raw SORTED sample list — the convention the
        offline replays (:func:`~quest_tpu_torch.serve.sched.
        plan_wfq_schedule`, bench rows built from wall-clock lists)
        share with the live histograms."""
        if not sorted_vals:
            return 0.0
        i = min(len(sorted_vals) - 1,
                max(0, int(round(p / 100.0 * (len(sorted_vals) - 1)))))
        return float(sorted_vals[i])

    def latency_histograms(self) -> dict:
        """The raw histogram snapshots (Prometheus-shaped cumulative
        buckets) next to the derived percentiles in :meth:`snapshot`."""
        return {"request_latency_s": self._latency.snapshot(),
                "queue_wait_s": self._queue_wait.snapshot()}

    def snapshot(self) -> dict:
        """Point-in-time view as a plain dict (JSON-ready).

        ``batch_occupancy`` is mean live requests per dispatch — the
        number the coalescer exists to raise above 1. ``coalesce_ratio``
        is the fraction of dispatched requests that shared their batch
        with at least one other request. Percentiles are estimated from
        the fixed-bucket histograms (interpolated inside the owning
        bucket, clamped to the observed max).
        """
        with self._lock:
            # atomic family read (the RLock is the counters' own lock)
            c = {name: cnt.value for name, cnt in self._c.items()}
            max_occ = self._max_occupancy
        batches = c["batches"]
        dispatched = c["coalesced_requests"]
        depth = 0
        if self.queue_depth_fn is not None:
            try:
                depth = int(self.queue_depth_fn())
            # quest: allow-broad-except(exporter boundary: a failing
            # depth callback reads 0 rather than failing the snapshot)
            except Exception:
                depth = 0
        return {
            **c,
            "queue_depth": depth,
            "batch_occupancy": (dispatched / batches) if batches else 0.0,
            "max_batch_occupancy": max_occ,
            "coalesce_ratio": (c["shared_batch_requests"] / dispatched)
            if dispatched else 0.0,
            "padded_fraction": c["padded_rows"]
            / max(1, c["padded_rows"] + dispatched),
            "p50_latency_s": self._latency.percentile(50.0),
            "p99_latency_s": self._latency.percentile(99.0),
            "p50_queue_wait_s": self._queue_wait.percentile(50.0),
            "p99_queue_wait_s": self._queue_wait.percentile(99.0),
            # nested per-tenant block: the Prometheus exporter flattens
            # numeric leaves, so each tenant's counters/percentiles
            # export as tenants_<name>_<metric> series automatically
            "tenants": self.tenant_snapshot(),
        }


_ROUTER_COUNTERS = (
    "routed",                # requests placed on a replica
    "rerouted_full",         # re-placed after a replica's QueueFull
    "failovers",             # re-placed after a replica fault/breaker/crash
    "hedged_dispatches",     # duplicate dispatches issued by hedging
    "hedge_wins",            # hedge results that resolved the request
    "replica_quarantines",   # replicas pulled from routing by the supervisor
    "replica_restarts",      # replacement services started
    "readmissions",          # replicas returned to routing after a probe
    "probe_batches",         # half-open probe batches run
    "probe_failures",        # probes whose results failed the oracle check
    "failed_unroutable",     # requests failed: no healthy replica in budget
    "supervisor_errors",     # supervisor-loop iterations that raised
    # optimizer-in-the-loop over the replicated front end: router.optimize()
    # drives the same OptimizationHandle as the single service
    "optimizer_runs",        # optimize() handles started on this router
    "optimizer_iterations",  # optimizer steps executed (all handles)
    "optimizer_converged",   # handles that met their tolerance
    "optimizer_resumes",     # handles resumed from a checkpoint
    # elasticity (resilience.AutoscalePolicy, ServiceRouter.scale_to):
    "scale_ups",             # replica-pool grow operations
    "scale_downs",           # replica-pool shrink operations
    "preemptions",           # checkpointed runs that yielded the device
)


class RouterMetrics:
    """Typed counters + a latency histogram for one
    :class:`~quest_tpu_torch.serve.router.ServiceRouter` (the replica-level
    view; each replica's own :class:`ServiceMetrics` stays the per-service
    truth). Its snapshot has the JAX package's keys."""

    def __init__(self, latency_window: int = 4096):
        self._lock = threading.RLock()
        self._c = {name: Counter(name, lock=self._lock)
                   for name in _ROUTER_COUNTERS}
        self._latency = Histogram(
            "router_latency_s", "router submit-to-result seconds")

    def incr(self, name: str, k: int = 1) -> None:
        c = self._c.get(name)
        if c is None:
            raise KeyError(f"unknown router counter {name!r}")
        c.inc(k)

    def record_latency(self, total_s: float) -> None:
        self._latency.observe(total_s)

    def latency_histograms(self) -> dict:
        return {"router_latency_s": self._latency.snapshot()}

    def snapshot(self) -> dict:
        with self._lock:
            c = {name: cnt.value for name, cnt in self._c.items()}
        return {
            **c,
            "p50_latency_s": self._latency.percentile(50.0),
            "p99_latency_s": self._latency.percentile(99.0),
        }


_WIRE_COUNTERS = (
    # the network front door (quest_tpu_torch/netserve):
    "requests_total",        # wire requests answered (any status)
    "requests_sweep",        # ... by kind
    "requests_expectation",
    "requests_shots",
    "requests_trajectory",
    "requests_gradient",
    "requests_evolve",
    "requests_ground",
    "errors_total",          # requests answered with an error envelope
    "bytes_in",              # request body bytes read
    "bytes_out",             # response body bytes written
    "sessions_opened",       # POST /v1/session grants
    "auth_rejections",       # 401s (unknown token/session)
    "programs_registered",   # distinct digests decoded + warmed
    "program_hits",          # circuit_ref submissions served from registry
    "program_misses",        # full-circuit submissions (decode + register)
    "qasm_submissions",      # programs that arrived as OpenQASM 2.0
    "streams_opened",        # chunked-transfer streams started
    "stream_events",         # ndjson events written across all streams
    "stream_cancels",        # handles cancelled by client disconnect
    # the hardened front door:
    "dedup_hits",            # duplicate request_ids replayed from cache
    "dedup_joins",           # duplicates that joined an in-flight original
    "rate_limited",          # 429s from the per-session token bucket
    "load_shed",             # 429s from priority-aware overload shedding
    "read_timeouts",         # 408 slow-loris kills (read deadline)
    "conn_rejected",         # connections refused at max_connections
    "sessions_expired",      # sessions evicted by the idle TTL sweep
    "streams_resumed",       # successful stream-resume attachments
    "wire_faults",           # injected wire faults applied at this door
    "drains",                # graceful drains completed
    "programs_restored",     # programs readmitted from persisted state
)


class WireMetrics:
    """Typed counters + parse/serialize latency histograms for one
    :class:`~quest_tpu_torch.netserve.server.NetServer` — the wire layer's
    own accounting, registered into the process-global metrics
    registry next to the backend's ``dispatch_stats()`` document (one
    ``/metrics`` scrape answers both "what did the wire do" and "what
    did the engine do")."""

    def __init__(self):
        self._lock = threading.RLock()
        self._c = {name: Counter(name, lock=self._lock)
                   for name in _WIRE_COUNTERS}
        self._parse = Histogram("wire_parse_s",
                                "request parse + decode seconds")
        self._serialize = Histogram("wire_serialize_s",
                                    "result encode seconds")
        self._latency = Histogram("wire_request_s",
                                  "socket receive-to-flush seconds")

    def incr(self, name: str, k: int = 1) -> None:
        c = self._c.get(name)
        if c is None:
            raise KeyError(f"unknown wire counter {name!r}")
        c.inc(k)

    def get(self, name: str) -> int:
        return self._c[name].value

    def record_parse(self, seconds: float) -> None:
        self._parse.observe(seconds)

    def record_serialize(self, seconds: float) -> None:
        self._serialize.observe(seconds)

    def record_request(self, seconds: float) -> None:
        self._latency.observe(seconds)

    def snapshot(self) -> dict:
        with self._lock:
            c = {name: cnt.value for name, cnt in self._c.items()}
        return {
            **c,
            "p50_parse_s": self._parse.percentile(50.0),
            "p99_parse_s": self._parse.percentile(99.0),
            "p50_serialize_s": self._serialize.percentile(50.0),
            "p99_serialize_s": self._serialize.percentile(99.0),
            "p50_request_s": self._latency.percentile(50.0),
            "p99_request_s": self._latency.percentile(99.0),
        }
