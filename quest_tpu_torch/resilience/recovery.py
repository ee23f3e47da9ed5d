"""Recovery policy: fault classification, backoff, and circuit breaking.

The serving runtime's original fault story was one blind ``except
Exception`` retry — a ``ValueError`` burned the retry budget exactly
like a genuine executor hiccup, and a persistently broken program
re-failed every batch forever. This module is the typed replacement:

- :func:`classify` splits exceptions into **transient** (retry may
  succeed: ``torch.cuda.OutOfMemoryError``, runtime/timeout shapes,
  injected faults), **poison**
  (:class:`~quest_tpu_torch.resilience.health.NumericalFault` — the
  result is numerically wrong; retrying the same binding is pointless,
  the request gets a typed failure), and **fatal** (caller errors —
  ``ValueError``/``TypeError``/validation ``QuESTError`` — and, on the
  card, a kernel that failed to build or launch and a sticky CUDA error
  (``torch.AcceleratorError``): fail fast with the ORIGINAL exception,
  never burn a retry, never fall back to a plain version);
- :class:`ResiliencePolicy` is the serving config surface: retry
  backoff (exponential + seeded jitter), circuit-breaker thresholds,
  quarantine, output guarding, degraded sequential mode, and the
  dispatcher watchdog timeout;
- :class:`CircuitBreaker` trips per compiled program after
  ``threshold`` failures inside ``window_s``, fast-failing new batches
  for ``cooldown_s`` (then half-opens: one probe batch decides).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque

import torch

from ..ops.cuda_build import KernelBuildError, KernelLaunchError
from .faults import InjectedFault, SimulatedOOM
from .health import NumericalFault

__all__ = ["TRANSIENT", "POISON", "FATAL", "PRECISION", "classify",
           "ResiliencePolicy", "SupervisorPolicy", "AutoscalePolicy",
           "CircuitBreaker"]

TRANSIENT = "transient"
POISON = "poison"
FATAL = "fatal"
# the precision-tier fidelity monitor's class (NumericalFault with
# kind="precision"): the result drifted past the TIER's error budget —
# retrying the same rung is pointless, but unlike POISON the request is
# salvageable: the recovery policy re-executes it one tier UP the
# ladder (bounded by the top available rung)
PRECISION = "precision"

# caller errors: retrying cannot help and hides the bug from the caller
_FATAL_TYPES = (ValueError, TypeError, KeyError, IndexError,
                AttributeError, AssertionError, NotImplementedError,
                ArithmeticError)

# the card's own fatal class: a kernel that did not build or was refused
# at launch fails the same way on every retry, and a sticky CUDA error
# poisons the context for the rest of the process
_DEVICE_FATAL_TYPES = (KernelBuildError, KernelLaunchError) + (
    (torch.AcceleratorError,) if hasattr(torch, "AcceleratorError")
    else ())


def classify(exc: BaseException) -> str:
    """``"transient"`` | ``"poison"`` | ``"precision"`` | ``"fatal"`` for
    one executor exception. A kernel build or launch failure and a
    sticky CUDA error are fatal (RuntimeError-shaped, but no retry can
    help); a device out-of-memory error is transient (a bisected,
    smaller batch may fit). Other unknown ``Exception`` subclasses
    default to transient, while the caller-error part of the fatal set
    is a closed family."""
    if isinstance(exc, NumericalFault):
        return PRECISION if exc.kind == "precision" else POISON
    if isinstance(exc, _DEVICE_FATAL_TYPES):
        return FATAL
    if isinstance(exc, (InjectedFault, SimulatedOOM,
                        torch.cuda.OutOfMemoryError)):
        return TRANSIENT
    if isinstance(exc, _FATAL_TYPES):
        return FATAL
    return TRANSIENT


@dataclasses.dataclass(frozen=True)
class ResiliencePolicy:
    """The serving runtime's fault-tolerance knobs (one object so the
    ``SimulationService`` constructor doesn't sprout ten parameters).

    Backoff for retry attempt k (1-based) is
    ``min(backoff_cap_s, backoff_base_s * 2^(k-1))`` scaled by a seeded
    jitter in ``[1, 1 + backoff_jitter]`` — retried requests re-enter
    the queue after the delay and may coalesce differently.
    ``degrade_after`` consecutive faulted dispatches of one program put
    it in sequential per-request mode for ``degrade_cooldown_s`` (a
    poisoned batch member can't keep failing its companions);
    ``watchdog_timeout_s`` bounds how long the dispatcher may go
    without a heartbeat before the watchdog thread counts a stall
    (0 disables the thread). ``escalate_tiers`` gates the precision-
    tier recovery move: a request whose result violates its tier's
    runtime fidelity tolerance re-executes one tier up the ladder
    (off: the violation fails typed like any poison)."""

    backoff_base_s: float = 2e-3
    backoff_cap_s: float = 0.25
    backoff_jitter: float = 0.25
    seed: int = 0
    breaker_threshold: int = 5
    breaker_window_s: float = 30.0
    breaker_cooldown_s: float = 2.0
    quarantine: bool = True
    guard_outputs: bool = True
    degrade_after: int = 3
    degrade_cooldown_s: float = 5.0
    watchdog_timeout_s: float = 30.0
    escalate_tiers: bool = True

    def __post_init__(self):
        if self.backoff_base_s < 0 or self.backoff_cap_s < 0:
            raise ValueError("backoff delays must be >= 0")
        if self.backoff_jitter < 0:
            raise ValueError("backoff_jitter must be >= 0")
        if self.breaker_threshold < 1:
            raise ValueError("breaker_threshold must be >= 1")
        if self.degrade_after < 0:
            raise ValueError("degrade_after must be >= 0 (0 disables)")

    def backoff(self, attempt: int, rng) -> float:
        """Delay before retry ``attempt`` (1-based); ``rng`` supplies
        the jitter draw (the service owns one seeded generator)."""
        base = min(self.backoff_cap_s,
                   self.backoff_base_s * (2.0 ** max(0, attempt - 1)))
        return base * (1.0 + self.backoff_jitter * float(rng.random()))


@dataclasses.dataclass(frozen=True)
class SupervisorPolicy:
    """The replica supervisor's knobs (the replicated ``ServiceRouter``,
    ``serve/router.py``): when to
    quarantine a replica, how to restart it, and what a half-open
    readmission probe must pass.

    A replica is quarantined when its dispatcher thread dies, when its
    dispatcher heartbeat goes quiet for ``stall_timeout_s`` with work
    pending (``stall_quarantine``; the heartbeat cannot tick DURING a
    dispatch, so set this above the worst-case single dispatch —
    including a cold compile — or warm the buckets traffic will hit),
    or when its executor-fault count grows by
    ``fault_quarantine_threshold`` inside one supervisor poll window.
    Restart attempts are bounded
    (``max_restart_attempts`` per quarantine episode) and spaced by
    exponential backoff from ``restart_backoff_s``. A restarted replica
    is readmitted only after a ``probe_batch``-request half-open probe
    whose every result matches the reference recorded at warm time to
    ``probe_tol`` (oracle-grade: NaN, norm drift, or a wrong energy all
    fail the probe and send the replica back to quarantine)."""

    poll_s: float = 0.02
    stall_quarantine: bool = True
    stall_timeout_s: float = 5.0
    fault_quarantine_threshold: int = 8
    probe_batch: int = 2
    probe_timeout_s: float = 60.0
    probe_tol: float = 1e-9
    max_restart_attempts: int = 5
    restart_backoff_s: float = 0.05
    # the router's per-replica service-time EMA decay: each completed
    # hop blends as (1 - ema_decay) * measured + ema_decay * ema. 0.8
    # (the old hardcoded blend) weights ~the last 5 requests; raise it
    # for steadier placement under bursty latency, lower it to track
    # regime changes faster. The ledger warm-start seeds the EMA's
    # initial value; this knob sets how fast live traffic overrides it.
    ema_decay: float = 0.8

    def __post_init__(self):
        if self.poll_s <= 0:
            raise ValueError("poll_s must be > 0")
        if self.probe_batch < 1:
            raise ValueError("probe_batch must be >= 1")
        if self.max_restart_attempts < 1:
            raise ValueError("max_restart_attempts must be >= 1")
        if not (0.0 <= self.ema_decay < 1.0):
            raise ValueError("ema_decay must be in [0, 1) — 1.0 would "
                             "never admit a measurement")

    def restart_delay(self, attempt: int) -> float:
        """Backoff before restart ``attempt`` (1-based)."""
        return self.restart_backoff_s * (2.0 ** max(0, attempt - 1))


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """When the router's replica pool grows and shrinks.

    The decision is priced from the perf ledger: the backlog is
    converted to a drain-time estimate ``backlog * mean_request_s /
    replicas`` (``mean_request_s`` comes from
    :meth:`~quest_tpu_torch.telemetry.PerfLedger.mean_request_s` —
    measured per-program cost history, not a guess), and the pool grows
    by ``step`` whenever that estimate exceeds ``scale_up_drain_s``. It
    shrinks only after the pool has been fully idle (no backlog, no
    in-flight work) for ``scale_down_idle_s``. ``cooldown_s`` spaces
    consecutive decisions so a scale-up's own warm-up latency can't
    trigger a second one. :meth:`decide` is pure: the host-side replay
    (:func:`~quest_tpu_torch.serve.sched.plan_wfq_schedule`) drives it
    and the replicated router (``serve/router.py``) drive the SAME
    function."""

    min_replicas: int = 1
    max_replicas: int = 4
    scale_up_drain_s: float = 0.5
    scale_down_idle_s: float = 5.0
    cooldown_s: float = 2.0
    step: int = 1

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if self.step < 1:
            raise ValueError("step must be >= 1")
        if self.scale_up_drain_s <= 0:
            raise ValueError("scale_up_drain_s must be > 0")

    def decide(self, *, now: float, replicas: int, backlog: int,
               inflight: int, mean_request_s: float,
               last_scale_t: float, idle_since) -> int:
        """Replica-count delta for the current instant: positive to
        grow, negative to shrink, 0 to hold. ``idle_since`` is the
        monotonic time the pool last became fully idle (None while any
        work is queued or in flight)."""
        if now - last_scale_t < self.cooldown_s:
            return 0
        n = max(1, int(replicas))
        est = mean_request_s if mean_request_s > 0 else 0.0
        drain_s = backlog * est / n
        if drain_s > self.scale_up_drain_s and n < self.max_replicas:
            return min(self.step, self.max_replicas - n)
        if (backlog == 0 and inflight == 0 and idle_since is not None
                and now - idle_since >= self.scale_down_idle_s
                and n > self.min_replicas):
            return -min(self.step, n - self.min_replicas)
        return 0


class CircuitBreaker:
    """Per-key failure breaker (keys are compiled-program labels).

    Closed: everything flows, failures are recorded in a sliding
    ``window_s``. ``threshold`` failures in the window trip it OPEN:
    ``allow`` answers False (the caller fast-fails with a typed error)
    until ``cooldown_s`` passes, then HALF-OPEN: one batch may probe;
    success closes the breaker, failure re-opens it for another
    cooldown. Thread-safe; ``trips`` counts open transitions."""

    def __init__(self, threshold: int = 5, window_s: float = 30.0,
                 cooldown_s: float = 2.0, clock=time.monotonic):
        self.threshold = int(threshold)
        self.window_s = float(window_s)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._failures: dict = {}      # key -> deque of failure times
        self._open_until: dict = {}    # key -> reopen time
        self._half_open: set = set()   # keys probing after cooldown
        self.trips = 0

    def _prune(self, key, now: float):
        dq = self._failures.get(key)
        while dq and now - dq[0] > self.window_s:
            dq.popleft()

    def allow(self, key) -> bool:
        now = self._clock()
        with self._lock:
            until = self._open_until.get(key)
            if until is None:
                return True
            if now < until:
                return False
            # cooldown over: half-open — one probe through
            self._half_open.add(key)
            del self._open_until[key]
            return True

    def record_failure(self, key) -> bool:
        """Record one failed dispatch; returns True when this failure
        TRIPS the breaker open (new trip, not an already-open state)."""
        now = self._clock()
        with self._lock:
            if key in self._half_open:
                # the probe failed: straight back to open
                self._half_open.discard(key)
                self._open_until[key] = now + self.cooldown_s
                self.trips += 1
                return True
            dq = self._failures.setdefault(key, deque())
            dq.append(now)
            self._prune(key, now)
            if len(dq) >= self.threshold and key not in self._open_until:
                self._open_until[key] = now + self.cooldown_s
                dq.clear()
                self.trips += 1
                return True
            return False

    def record_success(self, key) -> None:
        with self._lock:
            self._half_open.discard(key)
            self._failures.pop(key, None)
            self._open_until.pop(key, None)

    def release(self, key) -> None:
        """An INCONCLUSIVE half-open probe (e.g. it died on a caller
        error before exercising the executor): return the key to OPEN
        for another cooldown so a future batch gets the probe slot —
        without counting a trip or a failure. No-op unless half-open."""
        now = self._clock()
        with self._lock:
            if key in self._half_open:
                self._half_open.discard(key)
                self._open_until[key] = now + self.cooldown_s

    def state(self, key) -> str:
        now = self._clock()
        with self._lock:
            if key in self._half_open:
                return "half-open"
            until = self._open_until.get(key)
            if until is not None and now < until:
                return "open"
            return "closed"

    def snapshot(self) -> dict:
        now = self._clock()
        with self._lock:
            keys = set(self._failures) | set(self._open_until) \
                | self._half_open
            per_key = {}
            for key in keys:
                self._prune(key, now)
                until = self._open_until.get(key)
                per_key[str(key)] = {
                    "state": ("half-open" if key in self._half_open else
                              "open" if until is not None and now < until
                              else "closed"),
                    "recent_failures": len(self._failures.get(key, ())),
                }
            return {"trips": self.trips, "programs": per_key}
