"""Typed metric primitives + the process-global metrics registry.

The serving stack's accounting grew as ad-hoc ``{name: int}`` dicts and
raw latency lists. This module gives it one vocabulary:

- :class:`Counter` — monotonically increasing integer;
- :class:`Gauge` — point-in-time value, either set directly or read
  through a callback (queue depths live where the queue lives);
- :class:`Histogram` — fixed-bucket distribution with O(#buckets)
  memory whatever the traffic volume. Latency percentiles come from
  linear interpolation inside the owning bucket (clamped to the
  observed max), which replaces the bounded raw-sample reservoirs the
  serving metrics used to keep: constant memory, mergeable across
  replicas, and exportable as a standard Prometheus histogram.
- :class:`MetricsRegistry` — the process-global snapshot-provider
  registry. Services, routers, and anything else with a
  ``dispatch_stats()``-shaped dict register a named provider; the
  exporters (:mod:`quest_tpu_torch.telemetry.export`) walk the registry and
  flatten whatever is live. Providers are held via weak references —
  a service that is garbage-collected (tests create thousands) drops
  out of the registry instead of pinning itself forever.
"""

from __future__ import annotations

import math
import threading
import weakref
from typing import Callable, Optional, Sequence

__all__ = ["Counter", "Gauge", "Histogram", "LATENCY_BUCKETS_S",
           "MetricsRegistry", "metrics_registry"]


# Fixed latency buckets (seconds): ~1.6 decades per 4 buckets from 10 us
# to 2 minutes — wide enough for a single-chip microsecond dispatch and
# a pod-scale multi-second compile storm in the same histogram.
LATENCY_BUCKETS_S = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4,
    1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)


class Counter:
    """Monotonic integer counter (thread-safe).

    ``lock`` lets a registry share ONE (reentrant) lock across a family
    of counters so a multi-counter snapshot can be read atomically —
    per-counter locks keep each count exact but let a reader observe
    counter A from before a writer's update and counter B from after
    it, tearing cross-counter invariants (e.g. shared-batch <=
    coalesced requests)."""

    __slots__ = ("name", "help", "_lock", "_v")

    def __init__(self, name: str, help: str = "", lock=None):
        self.name = name
        self.help = help
        self._lock = lock if lock is not None else threading.Lock()
        self._v = 0

    def inc(self, k: int = 1) -> None:
        if k < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._v += k

    @property
    def value(self) -> int:
        with self._lock:
            return self._v


class Gauge:
    """Point-in-time value: ``set()`` it, or construct with ``fn`` to
    read it live from wherever the truth lives (a failing callback
    reads 0 — the exporter must never take the service down)."""

    __slots__ = ("name", "help", "fn", "_lock", "_v")

    def __init__(self, name: str, help: str = "",
                 fn: Optional[Callable[[], float]] = None):
        self.name = name
        self.help = help
        self.fn = fn
        self._lock = threading.Lock()
        self._v = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    @property
    def value(self) -> float:
        if self.fn is not None:
            try:
                return float(self.fn())
            # quest: allow-broad-except(exporter boundary: a failing
            # gauge callback reads 0 -- the exporter must never take
            # the service down)
            except Exception:
                return 0.0
        with self._lock:
            return self._v


class Histogram:
    """Fixed-bucket histogram with percentile estimation.

    ``buckets`` are ascending upper bounds; one implicit +Inf bucket
    catches the tail. :meth:`percentile` finds the target rank's bucket
    by cumulative count and interpolates linearly inside it, clamped to
    the observed max (so the +Inf bucket never invents a value and a
    one-sample histogram answers that sample's bucket edge, not zero).
    """

    __slots__ = ("name", "help", "buckets", "_lock", "_counts", "_count",
                 "_sum", "_max")

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = LATENCY_BUCKETS_S):
        self.name = name
        self.help = help
        self.buckets = tuple(float(b) for b in buckets)
        if list(self.buckets) != sorted(set(self.buckets)):
            raise ValueError("histogram buckets must be ascending and "
                             "unique")
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)
        self._count = 0
        self._sum = 0.0
        self._max = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        if math.isnan(v):
            return
        # linear scan is fine: len(buckets) ~ 22 and latencies cluster
        # low, so the expected scan is short; a bisect would allocate
        i = 0
        nb = len(self.buckets)
        while i < nb and v > self.buckets[i]:
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, p: float) -> float:
        """Estimated p-th percentile (0 with no observations)."""
        with self._lock:
            total = self._count
            counts = list(self._counts)
            vmax = self._max
        if total == 0:
            return 0.0
        target = max(1, int(math.ceil(p / 100.0 * total)))
        cum = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            prev = cum
            cum += c
            if cum >= target:
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i] if i < len(self.buckets) else vmax
                frac = (target - prev) / float(c)
                return float(min(lo + frac * max(hi - lo, 0.0), vmax))
        return float(vmax)

    def snapshot(self) -> dict:
        """Prometheus-histogram-shaped dict: cumulative bucket counts
        keyed by upper bound, plus count/sum/max."""
        with self._lock:
            counts = list(self._counts)
            out = {"count": self._count, "sum": self._sum,
                   "max": self._max}
        cum = 0
        cum_buckets = {}
        for i, c in enumerate(counts):
            cum += c
            le = self.buckets[i] if i < len(self.buckets) else float("inf")
            cum_buckets[f"{le:g}"] = cum
        out["buckets"] = cum_buckets
        return out


class _Provider:
    """One registered snapshot source. The owner (and a bound snapshot
    method's self) is only weakly held."""

    __slots__ = ("name", "kind", "labels", "_fn", "_wfn", "_owner")

    def __init__(self, name, kind, labels, fn, owner):
        self.name = name
        self.kind = kind
        self.labels = dict(labels or {})
        self._fn = None
        self._wfn = None
        try:
            self._wfn = weakref.WeakMethod(fn)
        except TypeError:
            self._fn = fn            # plain function / lambda: strong ref
        self._owner = weakref.ref(owner) if owner is not None else None

    def alive(self) -> bool:
        if self._owner is not None and self._owner() is None:
            return False
        if self._wfn is not None and self._wfn() is None:
            return False
        return True

    def snapshot(self) -> Optional[dict]:
        fn = self._wfn() if self._wfn is not None else self._fn
        if fn is None:
            return None
        try:
            return fn()
        # quest: allow-broad-except(exporter boundary: a failing
        # provider is skipped -- one sick source must not hide the
        # fleet)
        except Exception:
            return None


class MetricsRegistry:
    """Process-global registry of named snapshot providers.

    ``register(name, fn)`` files a provider whose ``fn()`` returns a
    plain (possibly nested) dict — a ``ServiceMetrics.snapshot``, a full
    ``dispatch_stats()``, a warm-cache ``stats()``. Bound methods are
    held weakly through their owner, so registration never extends a
    service's lifetime; dead providers are pruned on the next
    :meth:`collect`. Names collide last-writer-wins (a restarted
    replica re-registers under its slot name).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._providers: dict = {}     # name -> _Provider
        self._seq = 0

    def register(self, name: str, fn: Callable[[], dict], *,
                 kind: str = "source", labels: Optional[dict] = None,
                 owner=None) -> str:
        if owner is None and hasattr(fn, "__self__"):
            owner = fn.__self__
        with self._lock:
            self._providers[name] = _Provider(name, kind, labels, fn,
                                              owner)
        return name

    def unregister(self, name: str) -> None:
        with self._lock:
            self._providers.pop(name, None)

    def unique_name(self, prefix: str) -> str:
        with self._lock:
            self._seq += 1
            return f"{prefix}-{self._seq}"

    def names(self) -> list:
        with self._lock:
            return sorted(self._providers)

    def collect(self) -> list:
        """Snapshot every live provider: ``[{"name", "kind", "labels",
        "metrics": {...}}]``. Dead providers (collected owners) are
        pruned, failing providers skipped — one sick source must not
        hide the rest of the fleet from the exporter."""
        with self._lock:
            items = list(self._providers.items())
        out = []
        dead = []
        for name, prov in items:
            if not prov.alive():
                dead.append(name)
                continue
            snap = prov.snapshot()
            if snap is None:
                continue
            out.append({"name": name, "kind": prov.kind,
                        "labels": dict(prov.labels), "metrics": snap})
        if dead:
            with self._lock:
                for name in dead:
                    # only prune if not re-registered meanwhile
                    prov = self._providers.get(name)
                    if prov is not None and not prov.alive():
                        self._providers.pop(name, None)
        return out


_REGISTRY = MetricsRegistry()


def metrics_registry() -> MetricsRegistry:
    """The process-global registry the exporters read."""
    return _REGISTRY
