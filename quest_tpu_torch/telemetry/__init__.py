"""quest_tpu_torch.telemetry — tracing, metrics and the event schema.

The serving runtime's observability, in one dependency-free subsystem:

- :mod:`~quest_tpu_torch.telemetry.tracing` — request-scoped spans: a
  :class:`TraceContext` is created at ``submit``, rides the request
  through queueing, coalescing, dispatch, retries, quarantine bisection
  and precision-tier escalations, and closes at future resolution.
  Traces export as self-contained JSON and as Perfetto-compatible Chrome
  trace events, and every engine dispatch is wrapped in a
  ``torch.profiler.record_function`` range (plus an NVTX range on a card)
  so device profiles line up with the host spans. ``trace_sample_rate``
  bounds the per-request cost.
- :mod:`~quest_tpu_torch.telemetry.metrics` — typed :class:`Counter` /
  :class:`Gauge` / :class:`Histogram` primitives (fixed-bucket latency
  histograms) and a process-global :class:`MetricsRegistry` that services
  register snapshot providers into.
- :mod:`~quest_tpu_torch.telemetry.events` — the single versioned event
  record shape (wall-clock epoch + monotonic offset + optional trace id)
  shared by the service and resilience timelines.
- :mod:`~quest_tpu_torch.telemetry.export` — Prometheus-text and JSON
  exporters over the registry: one-shot snapshots, file snapshots, and an
  opt-in local HTTP endpoint (``/metrics``, ``/metrics.json``).
- :mod:`~quest_tpu_torch.telemetry.profile` — the sampled dispatch
  profiler (CUDA-event timed on a card) and the model-drift monitor;
  :mod:`~quest_tpu_torch.telemetry.ledger` persists its aggregates.

The schema strings and metric names are the JAX package's, so one
collector reads both.
"""

from .events import EVENT_SCHEMA, make_event, read_timeline
from .metrics import (Counter, Gauge, Histogram, LATENCY_BUCKETS_S,
                      MetricsRegistry, metrics_registry)
from .export import (METRICS_SCHEMA, MetricsServer, json_snapshot,
                     prometheus_text, start_http_exporter,
                     validate_prometheus_text, write_snapshot)
from .tracing import (TRACE_SCHEMA, Span, TraceContext, Tracer,
                      dispatch_annotation)
from .profile import (DEFAULT_PROFILE_RATE, DispatchProfiler,
                      DriftMonitor, profile_dispatch, profiler)
from .ledger import PERF_LEDGER_ENV, PERF_SCHEMA, PerfLedger

__all__ = [
    "TRACE_SCHEMA", "Span", "TraceContext", "Tracer",
    "dispatch_annotation",
    "Counter", "Gauge", "Histogram", "LATENCY_BUCKETS_S",
    "MetricsRegistry", "metrics_registry",
    "METRICS_SCHEMA", "MetricsServer", "json_snapshot",
    "prometheus_text", "start_http_exporter",
    "validate_prometheus_text", "write_snapshot",
    "EVENT_SCHEMA", "make_event", "read_timeline",
    "DEFAULT_PROFILE_RATE", "DispatchProfiler", "DriftMonitor",
    "profile_dispatch", "profiler",
    "PERF_LEDGER_ENV", "PERF_SCHEMA", "PerfLedger",
]
