"""Deterministic, seedable fault injection at the dispatch boundaries.

Simulators meet real failure modes in service — transient runtime
errors, device OOM, NaN-poisoned buffers, and wedged/slow devices (the
failure classes mpiQulacs, arXiv:2203.16044, and the QuEST whitepaper,
arXiv:1802.08032, engineer around) — but none of them can be provoked
on demand in CI. This module makes them reproducible:
a :class:`FaultInjector` carries a seeded schedule of faults, and the
execution layers call :func:`fire` at their dispatch boundaries
(:data:`SITES`), which is a no-op unless an injector is installed.

Fault kinds:

- ``"transient"`` — raises :class:`InjectedFault` (a ``RuntimeError``,
  the shape of a transient executor failure; the recovery layer must
  absorb it with a retry);
- ``"oom"`` — raises :class:`SimulatedOOM` (the injected stand-in for
  ``torch.cuda.OutOfMemoryError``; recovery may succeed at a smaller
  batch, which is exactly what the serving layer's quarantine bisection
  produces);
- ``"nan"`` — the dispatch RUNS, then its output is NaN-poisoned in one
  deterministic row (:meth:`FaultInjector.poison_array`) — the silent
  corruption the numerical health guards exist to catch;
- ``"precision"`` — the dispatch runs, then its output is NORM-DRIFTED
  (uniformly scaled by a few percent,
  :meth:`FaultInjector.drift_array`) — the in-budget-looking-but-wrong
  result the precision-tier fidelity monitor exists to catch; the
  serving recovery must re-execute the affected requests one tier up,
  not retry the same rung;
- ``"stall"`` — the dispatch runs after sleeping ``stall_s`` seconds (a
  slow device / wedged collective; the serving watchdog's prey);
- ``"replica_crash"`` / ``"replica_stall"`` — replica-level failure
  domains (a SIGKILLed service process / a wedged dispatcher that stops
  heartbeating). These fire only at the ROUTER boundary
  (``"router.route"``, :func:`fire_router`): the router applies them to
  the replica it was about to pick, then must fail traffic over. At the
  intra-service boundaries they are no-ops — a single service cannot
  kill itself meaningfully (``serve/router.py``).
- ``"conn_reset"`` / ``"slow_read"`` / ``"torn_body"`` /
  ``"dup_delivery"`` / ``"stale_ref"`` — WIRE-level failure domains
  (:data:`WIRE_KINDS`): a socket reset before the response, a
  slow-loris peer, a response truncated mid-body, the same request
  delivered twice, and a ``circuit_ref`` whose program the server
  evicted. These fire only at the netserve boundaries
  (``"netserve.*"``, :func:`fire_wire`): the front door applies them to
  the connection it is serving, and the client's idempotent retry loop
  must absorb them. At the engine and router boundaries they are
  no-ops — there is no socket to corrupt below the wire (the front
  door is :mod:`quest_tpu_torch.netserve`).

Determinism: given the same specs, seed, and sequence of ``fire`` calls,
the injected schedule is identical — ``at_calls`` schedules are exact,
and probabilistic draws come from one seeded ``numpy`` Generator. All
counters are thread-safe (the serving dispatcher fires from its own
thread while callers run warmups).
"""

from __future__ import annotations

import contextlib
import dataclasses
import fnmatch
import threading
import time
from typing import Optional, Sequence

import numpy as np

__all__ = ["InjectedFault", "SimulatedOOM", "FaultSpec", "FaultInjector",
           "install", "uninstall", "active", "inject", "fire",
           "fire_router", "fire_wire", "poison_output", "SITES",
           "KINDS", "REPLICA_KINDS", "POISON_KINDS", "WIRE_KINDS"]

# the dispatch boundaries that call fire() (site names are stable API,
# the JAX package's: chaos schedules target them by pattern; the port
# fires "circuits.run" and "serve.execute", the others wait for the
# slices that port their boundaries)
SITES = (
    "circuits.run",                # CompiledCircuit.run / apply dispatch
    "circuits.sweep",              # batched ensemble sweep dispatch
    "circuits.expectation_sweep",  # batched energy dispatch
    "circuits.grad_sweep",         # batched value-and-grad dispatch
    "pergate.gate",                # imperative sharded gate dispatch
    "pergate.relayout",            # imperative relayout exchange
    "serve.execute",               # serving dispatcher batch execution
    "serve.optimize",              # optimizer-in-the-loop iterate step
    "serve.evolve",                # Hamiltonian-dynamics segment dispatch
    "serve.preempt",               # checkpointed-run mesh yield boundary
    "serve.scale",                 # autoscaler replica-pool resize
    "router.route",                # ServiceRouter placement decision
    "netserve.request",            # wire front-door request dispatch
    "netserve.stream",             # wire front-door stream setup
)

KINDS = ("transient", "oom", "nan", "precision", "stall",
         "replica_crash", "replica_stall",
         "conn_reset", "slow_read", "torn_body", "dup_delivery",
         "stale_ref")

# the output-corrupting subset: fire() returns the kind for the caller
# to apply to its dispatch RESULT via poison_output()
POISON_KINDS = ("nan", "precision")

# the replica-scoped subset: returned by fire_router() for the router
# to apply to its chosen replica, inert at every other boundary
REPLICA_KINDS = ("replica_crash", "replica_stall")

# the wire-scoped subset: returned by fire_wire() for the netserve
# front door to apply to the connection it serves, inert everywhere else
WIRE_KINDS = ("conn_reset", "slow_read", "torn_body", "dup_delivery",
              "stale_ref")


class InjectedFault(RuntimeError):
    """A deliberately injected transient executor fault."""


class SimulatedOOM(RuntimeError):
    """A deliberately injected device out-of-memory failure, classified
    as ``torch.cuda.OutOfMemoryError`` is (transient)."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault class.

    ``kind`` is one of :data:`KINDS`; ``site`` is an ``fnmatch`` pattern
    over :data:`SITES` (``"*"`` hits every boundary). A spec triggers at
    the exact per-site call indices in ``at_calls`` (0-based,
    deterministic) and/or independently with ``probability`` per
    eligible call (drawn from the injector's seeded generator).
    """

    kind: str
    site: str = "*"
    probability: float = 0.0
    at_calls: tuple = ()

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {KINDS}")
        if not 0.0 <= self.probability <= 1.0:
            raise ValueError("probability must be in [0, 1]")
        object.__setattr__(self, "at_calls",
                           tuple(int(i) for i in self.at_calls))


class FaultInjector:
    """A seeded fault schedule plus its accounting.

    ``max_faults`` caps total injections (a chaos run that must end);
    ``stall_s`` is the sleep for ``"stall"`` faults. ``snapshot()``
    returns the full accounting — the serving runtime folds it into
    ``dispatch_stats()`` so every injected fault is accounted for next
    to the recovery counters it caused.
    """

    def __init__(self, specs: Sequence[FaultSpec], seed: int = 0,
                 max_faults: Optional[int] = None, stall_s: float = 0.05):
        self.specs = tuple(specs)
        for spec in self.specs:
            if not isinstance(spec, FaultSpec):
                raise TypeError(f"expected FaultSpec, got {type(spec)}")
        self.seed = int(seed)
        self.max_faults = None if max_faults is None else int(max_faults)
        self.stall_s = float(stall_s)
        self._rng = np.random.default_rng(self.seed)
        self._lock = threading.Lock()
        self._calls: dict = {}       # site -> fire() count
        self._injected: dict = {}    # (site, kind) -> count
        self._total = 0

    # -- scheduling --------------------------------------------------------

    def draw(self, site: str) -> Optional[str]:
        """Advance the site's call counter and return the fault kind to
        inject at this call (None for a clean dispatch)."""
        with self._lock:
            idx = self._calls.get(site, 0)
            self._calls[site] = idx + 1
            if self.max_faults is not None and self._total >= self.max_faults:
                return None
            for spec in self.specs:
                if not fnmatch.fnmatchcase(site, spec.site):
                    continue
                hit = idx in spec.at_calls
                if not hit and spec.probability > 0.0:
                    hit = float(self._rng.random()) < spec.probability
                if hit:
                    key = (site, spec.kind)
                    self._injected[key] = self._injected.get(key, 0) + 1
                    self._total += 1
                    return spec.kind
            return None

    def poison_array(self, arr):
        """Return ``arr`` with one element of a seeded-random leading row
        set to NaN — the minimal corruption that makes the whole row's
        result wrong while leaving its shape intact. Works on numpy arrays
        and torch tensors (on a copy: the input is left as it was)."""
        if getattr(arr, "ndim", 0) == 0 or arr.shape[0] == 0:
            return arr
        with self._lock:
            row = int(self._rng.integers(arr.shape[0]))
        idx = (row,) + (0,) * (arr.ndim - 1)
        out = arr.copy() if isinstance(arr, np.ndarray) else arr.clone()
        out[idx] = np.nan
        return out

    DRIFT_SCALE = 1.05   # 5% norm inflation: outside every tier budget

    def drift_array(self, arr):
        """Return the WHOLE ``arr`` scaled by :data:`DRIFT_SCALE` — a
        finite, plausible-looking result whose norm/trace violates every
        tier's runtime tolerance (the fidelity-monitor analogue of
        :meth:`poison_array`'s NaN). Uniform on purpose: this boundary
        cannot know which axis (if any) is a batch axis, and a per-row
        scale on packed ``(2, 2^n)`` planes or a flat state could land
        on an all-zero plane and silently inject NOTHING — a chaos run
        must never count a fault that produced no corruption."""
        return arr * self.DRIFT_SCALE

    # -- accounting --------------------------------------------------------

    @property
    def total_injected(self) -> int:
        with self._lock:
            return self._total

    def counts(self, kind: Optional[str] = None) -> int:
        """Total injections, optionally of one kind."""
        with self._lock:
            if kind is None:
                return self._total
            return sum(n for (_, k), n in self._injected.items()
                       if k == kind)

    def snapshot(self) -> dict:
        """JSON-ready accounting: per-site call counts, injections by
        site/kind, and totals."""
        with self._lock:
            by_kind: dict = {}
            by_site: dict = {}
            for (site, kind), n in self._injected.items():
                by_kind[kind] = by_kind.get(kind, 0) + n
                by_site.setdefault(site, {})[kind] = n
            return {"seed": self.seed,
                    "total_calls": sum(self._calls.values()),
                    "calls_by_site": dict(self._calls),
                    "total_injected": self._total,
                    "injected_by_kind": by_kind,
                    "injected_by_site": by_site}


# ---------------------------------------------------------------------------
# the active-injector hook the dispatch boundaries consult
# ---------------------------------------------------------------------------

_ACTIVE: Optional[FaultInjector] = None


def install(injector: FaultInjector) -> None:
    """Install ``injector`` globally (all dispatch boundaries consult
    it). Prefer the :func:`inject` context manager."""
    global _ACTIVE
    if not isinstance(injector, FaultInjector):
        raise TypeError("install() takes a FaultInjector")
    _ACTIVE = injector


def uninstall() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> Optional[FaultInjector]:
    return _ACTIVE


@contextlib.contextmanager
def inject(injector: FaultInjector):
    """Scope an injector: ``with faults.inject(inj): ...`` — guaranteed
    uninstall on exit, so a failing chaos test can't poison the suite."""
    install(injector)
    try:
        yield injector
    finally:
        uninstall()


def fire(site: str):
    """The dispatch-boundary hook. No-op (falsy) when no injector is
    installed. Otherwise: raises for ``transient``/``oom`` faults,
    sleeps for ``stall`` faults, and returns the corruption KIND
    (``"nan"`` | ``"precision"``, truthy) when the CALLER must corrupt
    this dispatch's output via :func:`poison_output` (output faults
    poison results, not inputs — the corruption the health guards and
    the tier fidelity monitor must catch)."""
    inj = _ACTIVE
    if inj is None:
        return False
    kind = inj.draw(site)
    if kind is None:
        return False
    if kind == "transient":
        raise InjectedFault(f"injected transient fault at {site}")
    if kind == "oom":
        raise SimulatedOOM(
            f"RESOURCE_EXHAUSTED: injected simulated OOM at {site}")
    if kind == "stall":
        time.sleep(inj.stall_s)
        return False
    if kind in REPLICA_KINDS or kind in WIRE_KINDS:
        # replica faults only mean something to the router, wire faults
        # only to the netserve front door
        return False
    return kind     # "nan"/"precision": caller corrupts its output


def fire_router(site: str) -> Optional[str]:
    """The ROUTER-boundary hook. Replica-scoped kinds are not raised —
    only the router knows its replicas, so ``"replica_crash"`` /
    ``"replica_stall"`` are RETURNED for the caller to apply to the
    replica it was about to pick. Every other kind behaves exactly as
    at the engine boundaries (transient/oom raise, stall sleeps); the
    output-corrupting kinds (nan/precision) have no router meaning and
    are dropped. None = clean routing."""
    inj = _ACTIVE
    if inj is None:
        return None
    kind = inj.draw(site)
    if kind is None or kind in POISON_KINDS or kind in WIRE_KINDS:
        return None
    if kind in REPLICA_KINDS:
        return kind
    if kind == "transient":
        raise InjectedFault(f"injected transient fault at {site}")
    if kind == "oom":
        raise SimulatedOOM(
            f"RESOURCE_EXHAUSTED: injected simulated OOM at {site}")
    time.sleep(inj.stall_s)     # "stall"
    return None


def fire_wire(site: str) -> Optional[str]:
    """The NETSERVE-boundary hook. Wire-scoped kinds are not raised —
    only the front door owns the socket, so :data:`WIRE_KINDS` are
    RETURNED for the server to apply to the connection it is serving
    (reset it, trickle it, tear the body, re-deliver the request, or
    evict the referenced program first). Every other kind behaves
    exactly as at the engine boundaries (transient/oom raise — they
    surface as typed 500s the client may retry — and stall sleeps); the
    output-corrupting and replica-scoped kinds have no wire meaning and
    are dropped. None = a clean request."""
    inj = _ACTIVE
    if inj is None:
        return None
    kind = inj.draw(site)
    if kind is None or kind in POISON_KINDS or kind in REPLICA_KINDS:
        return None
    if kind in WIRE_KINDS:
        return kind
    if kind == "transient":
        raise InjectedFault(f"injected transient fault at {site}")
    if kind == "oom":
        raise SimulatedOOM(
            f"RESOURCE_EXHAUSTED: injected simulated OOM at {site}")
    time.sleep(inj.stall_s)     # "stall"
    return None


def poison_output(poison, arr):
    """Apply a drawn output fault to a dispatch output: pass
    :func:`fire`'s return value (``"nan"`` | ``"precision"`` | falsy)
    and the output array. One helper so every boundary shares the same
    semantics — including the edge where the injector was uninstalled
    between ``fire()`` and the dispatch completing (the chaos scope
    ended: the poison is dropped)."""
    inj = _ACTIVE
    if poison and inj is not None:
        if poison == "precision":
            return inj.drift_array(arr)
        return inj.poison_array(arr)
    return arr
