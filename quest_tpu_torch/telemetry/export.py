"""Metric exporters: Prometheus text, JSON snapshots, file, and HTTP.

Everything reads the process-global :class:`~quest_tpu_torch.telemetry.
metrics.MetricsRegistry` (or an explicit one): providers are nested
plain dicts (service snapshots, full ``dispatch_stats()`` documents),
and the exporters flatten every NUMERIC leaf into
``quest_tpu_<path>{source="<provider>", ...}`` samples — booleans count
as 0/1, strings and lists are skipped (they belong in traces and event
timelines, not gauges).

Three delivery modes, all opt-in:

- :func:`prometheus_text` / :func:`json_snapshot` — one-shot strings/
  dicts for tests, tools, and ad-hoc scraping;
- :func:`write_snapshot` — atomic-enough file snapshot (write + rename
  is overkill here; a torn scrape re-reads next interval) for sidecar
  collectors;
- :func:`start_http_exporter` — a daemon-thread HTTP endpoint serving
  ``/metrics`` (Prometheus exposition format) and ``/metrics.json``;
  binds localhost by default and picks a free port with ``port=0``
  (the test/default mode).
"""

from __future__ import annotations

import json
import re
import threading
import time
from typing import Optional

from .metrics import MetricsRegistry, metrics_registry

__all__ = ["METRICS_SCHEMA", "prometheus_text", "json_snapshot",
           "write_snapshot", "validate_prometheus_text",
           "MetricsServer", "start_http_exporter"]

METRICS_SCHEMA = "quest_tpu.metrics/1"

# one exposition sample line: name, optional {labels}, numeric value
# (scientific notation, +-Inf, and NaN are all legal Prometheus floats)
_PROM_SAMPLE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? "
    r"[-+]?(\d+(\.\d+)?([eE][-+]?\d+)?|Inf|NaN)$")


def validate_prometheus_text(text: str) -> list:
    """The exposition-format line check shared by tests and bench rows:
    returns the lines that are neither comments nor well-formed samples
    (empty list = the export parses)."""
    return [ln for ln in text.splitlines()
            if ln and not ln.startswith("#")
            and not _PROM_SAMPLE.match(ln)]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")
_LABEL_BAD = re.compile(r"[\\\"\n]")


def _metric_name(*parts: str) -> str:
    name = "_".join(_NAME_RE.sub("_", p).strip("_") for p in parts if p)
    if not name or not (name[0].isalpha() or name[0] == "_"):
        name = "_" + name
    return "quest_tpu_" + name


def _label_value(v) -> str:
    return _LABEL_BAD.sub("_", str(v))


def _flatten(prefix: tuple, obj, out: list) -> None:
    """Yield ``(key_path_tuple, float)`` for every numeric leaf."""
    if isinstance(obj, bool):
        out.append((prefix, 1.0 if obj else 0.0))
    elif isinstance(obj, (int, float)):
        out.append((prefix, float(obj)))
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _flatten(prefix + (str(k),), v, out)
    # strings / lists / None: not scrapeable scalars — skipped


def json_snapshot(registry: Optional[MetricsRegistry] = None) -> dict:
    """Every live provider's snapshot as one versioned JSON document."""
    reg = registry or metrics_registry()
    return {"schema": METRICS_SCHEMA,
            "generated_wall": round(time.time(), 6),
            "sources": reg.collect()}


def prometheus_text(registry: Optional[MetricsRegistry] = None) -> str:
    """Prometheus exposition format (text/plain; version 0.0.4).

    One sample per numeric leaf:
    ``quest_tpu_<flattened_path>{source="<provider>",<labels>} <value>``
    with a ``# TYPE ... gauge`` line per family (counters are gauges to
    the scraper; rate() works on either and the registry's snapshots
    are point-in-time reads by construction).
    """
    reg = registry or metrics_registry()
    families: dict = {}
    for src in reg.collect():
        leaves: list = []
        _flatten((), src["metrics"], leaves)
        labels = {"source": src["name"], **src["labels"]}
        label_txt = ",".join(
            f'{_NAME_RE.sub("_", k)}="{_label_value(v)}"'
            for k, v in sorted(labels.items()))
        for path, value in leaves:
            name = _metric_name(*path)
            families.setdefault(name, []).append((label_txt, value))
    lines = []
    for name in sorted(families):
        lines.append(f"# TYPE {name} gauge")
        for label_txt, value in families[name]:
            # exposition-format special floats: '{:g}' would render
            # lowercase 'inf'/'nan', which scrapers (and our own
            # validator) reject
            if value != value:
                txt = "NaN"
            elif value == float("inf"):
                txt = "+Inf"
            elif value == float("-inf"):
                txt = "-Inf"
            else:
                txt = f"{value:g}"
            lines.append(f"{name}{{{label_txt}}} {txt}")
    return "\n".join(lines) + "\n"


def write_snapshot(path: str, fmt: str = "json",
                   registry: Optional[MetricsRegistry] = None) -> str:
    """Write one metrics snapshot to ``path`` (``fmt``: ``"json"`` or
    ``"prom"``); returns the path."""
    if fmt == "json":
        payload = json.dumps(json_snapshot(registry), indent=2,
                             default=str)
    elif fmt == "prom":
        payload = prometheus_text(registry)
    else:
        raise ValueError(f"unknown snapshot format {fmt!r} "
                         "(expected 'json' or 'prom')")
    with open(path, "w") as fh:
        fh.write(payload)
    return path


class MetricsServer:
    """Opt-in local HTTP exporter (daemon thread).

    ``GET /metrics`` serves the Prometheus text; ``GET /metrics.json``
    the JSON snapshot. Default bind is loopback — exposing simulator
    internals beyond the host is a deployment decision, not a default.
    """

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry: Optional[MetricsRegistry] = None,
                 health_source=None):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from .endpoints import ObservabilityEndpoints
        reg = registry or metrics_registry()
        # the shared observability resolver: the netserve front door
        # mounts this same object, so both ports serve identical
        # /metrics, /metrics.json, and (with a health source) /healthz
        endpoints = ObservabilityEndpoints(reg, health_source)

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):                      # noqa: N802 (stdlib API)
                try:
                    resolved = endpoints.resolve(self.path)
                    if resolved is None:
                        self.send_error(404)
                        return
                    status, ctype, body = resolved
                # quest: allow-broad-except(exporter boundary: one
                # sick provider answers 500; it must never kill the
                # metrics server)
                except Exception as e:
                    self.send_error(500, str(e))
                    return
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):             # quiet by design
                pass

        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"quest-tpu-metrics-exporter-{self.port}")
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def start_http_exporter(port: int = 0, host: str = "127.0.0.1",
                        registry: Optional[MetricsRegistry] = None
                        ) -> MetricsServer:
    """Start the opt-in HTTP exporter; ``port=0`` picks a free port
    (read it back from ``server.port``)."""
    return MetricsServer(port=port, host=host, registry=registry)
