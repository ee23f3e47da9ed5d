"""Shared observability endpoint plumbing.

One resolver serves both HTTP front doors — the telemetry loopback
exporter (:class:`~quest_tpu_torch.telemetry.export.MetricsServer`) and the
netserve request server — so "what does ``GET /metrics`` return"
has exactly one answer per process:

- ``/metrics`` — Prometheus exposition text
  (:func:`~quest_tpu_torch.telemetry.export.prometheus_text`);
- ``/metrics.json`` — the versioned JSON snapshot
  (:func:`~quest_tpu_torch.telemetry.export.json_snapshot`);
- ``/healthz`` — a replica/breaker summary built from the health
  source's ``dispatch_stats()`` (absent on the bare exporter: 404);
- ``/healthz/live`` — pure liveness: always ``200 {"status": "alive"}``
  while the process answers at all. A draining or overloaded server is
  still ALIVE — orchestrators must not kill it for shedding load;
- ``/healthz/ready`` — readiness: 200 only when the health source is
  healthy AND the mounting server's ``readiness`` hook (if any) reports
  ``ready`` — a draining netserve flips this to 503 so load balancers
  stop routing to it while in-flight work finishes.

The resolver is transport-agnostic: it maps a path to a
``(status, content_type, body_bytes)`` triple and never touches
sockets, so ``http.server`` handlers and asyncio protocols mount it
identically.
"""

from __future__ import annotations

import json
from typing import Optional

from .metrics import MetricsRegistry

__all__ = ["ObservabilityEndpoints", "health_summary"]


def health_summary(stats: dict) -> dict:
    """Condense one ``dispatch_stats()`` document into the ``/healthz``
    answer: overall status plus per-replica state and breaker counts.
    Accepts both shapes — a router document (with ``"replicas"``) and a
    single service's stats (treated as one implicit ready replica)."""
    replicas = stats.get("replicas")
    if replicas is None:
        # a single SimulationService: alive == ready
        alive = bool(stats.get("alive", True))
        return {"status": "ok" if alive else "unhealthy",
                "ready_replicas": 1 if alive else 0,
                "total_replicas": 1,
                "replicas": [{"state": "ready" if alive else "down"}]}
    rows = []
    ready = 0
    for rep in replicas:
        state = str(rep.get("state", "unknown"))
        if state == "ready":
            ready += 1
        row = {"replica": rep.get("replica", rep.get("index")),
               "state": state,
               "restarts": rep.get("restarts", 0)}
        breakers = rep.get("breakers") or rep.get("service", {}).get(
            "breakers")
        if breakers:
            open_b = sum(1 for b in (breakers.values()
                                     if isinstance(breakers, dict)
                                     else breakers)
                         if (b.get("state") if isinstance(b, dict)
                             else b) == "open")
            row["open_breakers"] = open_b
        rows.append(row)
    total = len(rows)
    status = "ok" if ready == total and total > 0 else (
        "degraded" if ready > 0 else "unhealthy")
    return {"status": status, "ready_replicas": ready,
            "total_replicas": total, "replicas": rows}


class ObservabilityEndpoints:
    """Path -> ``(status, content_type, body)`` for the shared
    observability surface. ``health_source`` is anything with a
    ``dispatch_stats()`` (a router or service); without one,
    ``/healthz`` answers 404 (the bare exporter's contract).
    ``readiness`` is an optional zero-arg hook returning a dict with a
    boolean ``"ready"`` (plus any detail to surface) — the mounting
    server's own admission state (e.g. netserve draining), AND-ed into
    ``/healthz/ready``."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 health_source=None, readiness=None):
        self._registry = registry
        self._health_source = health_source
        self._readiness = readiness

    def resolve(self, path: str):
        """Serve one observability path; None when the path is not an
        observability endpoint (the caller then 404s or falls through
        to its own routes)."""
        from .export import prometheus_text, json_snapshot
        if path.startswith("/metrics.json"):
            body = json.dumps(json_snapshot(self._registry),
                              default=str).encode()
            return 200, "application/json", body
        if path.startswith("/metrics"):
            return (200, "text/plain; version=0.0.4",
                    prometheus_text(self._registry).encode())
        # the subpaths MUST be checked before the bare /healthz prefix
        if path.startswith("/healthz/live"):
            return 200, "application/json", b'{"status": "alive"}'
        if path.startswith("/healthz/ready"):
            return self._ready()
        if path.startswith("/healthz"):
            if self._health_source is None:
                return (404, "application/json",
                        b'{"error": "no health source mounted"}')
            summary = health_summary(self._health_source.dispatch_stats())
            status = 200 if summary["status"] == "ok" else 503
            return (status, "application/json",
                    json.dumps(summary, default=str).encode())
        return None

    def _ready(self):
        """Readiness = backend health AND the server's own admission
        state. Either signal alone can flip routing off (503) without
        claiming the process is dead — that is /healthz/live's job."""
        if self._health_source is None and self._readiness is None:
            return (404, "application/json",
                    b'{"error": "no readiness source mounted"}')
        summary: dict = {"status": "ok"}
        if self._health_source is not None:
            summary = health_summary(self._health_source.dispatch_stats())
        ready = summary.get("status") == "ok"
        if self._readiness is not None:
            local = self._readiness()
            summary.update(local)
            ready = ready and bool(local.get("ready", True))
        summary["ready"] = ready
        return (200 if ready else 503, "application/json",
                json.dumps(summary, default=str).encode())
