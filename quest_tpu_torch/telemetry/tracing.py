"""Request-scoped tracing: follow ONE request through the whole stack.

A :class:`TraceContext` is created where a request enters the system
(:meth:`SimulationService.submit` / :meth:`ServiceRouter.submit`) and
carried BY the request object through every layer it crosses — the
coalescer group, the dispatcher batch, retries with backoff, replica
failovers, quarantine bisection, precision-tier escalations — until its
future resolves. Each hop records a :class:`Span`: a named interval (or
instant) with a wall-clock epoch anchor, a monotonic offset (the two
clocks the unified event schema carries, :mod:`quest_tpu_torch.telemetry.
events`), and structured attributes (program key, batch bucket, tier,
replica, sharding mode).

Design constraints, in order:

1. **Cheap.** Tracing is on the serving hot path; an unsampled request
   costs one ``None`` check per instrumentation point, and a sampled
   request costs plain object construction — no I/O, no formatting, no
   stack inspection. ``sample_rate`` is enforced with a deterministic
   stride (exactly ``round(N * rate)`` of every ``N`` starts sampled,
   reproducible across runs), not a random draw.
2. **Zero dependencies.** Plain dataclass-free objects under one small
   lock per trace; exports are plain dicts.
3. **Two export formats.** ``TraceContext.to_dict()`` is a
   self-contained versioned JSON document (``quest_tpu.trace/1``);
   ``TraceContext.chrome_trace()`` emits Perfetto-compatible Chrome
   trace events (``ph: "X"`` complete events / ``ph: "i"`` instants)
   that load directly in ``ui.perfetto.dev`` or ``chrome://tracing``.
4. **Device alignment.** :func:`dispatch_annotation` wraps every engine
   dispatch in a ``torch.profiler.record_function`` range, and on a card
   an NVTX range too, so a ``torch.profiler`` trace shows the same
   dispatch names the host spans carry.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Optional

__all__ = ["TRACE_SCHEMA", "Span", "TraceContext", "Tracer",
           "dispatch_annotation"]

TRACE_SCHEMA = "quest_tpu.trace/1"

# 128-bit ids from a per-process random prefix + an atomic counter:
# os.urandom costs tens of microseconds PER CALL on some kernels, which
# alone would blow the serving path's tracing budget — one urandom at
# import plus a counter is unique within the process and collision-
# resistant across processes at ~100x less cost.
_ID_PREFIX = os.urandom(8).hex()
_ID_COUNTER = itertools.count(1)


def _new_trace_id() -> str:
    return f"{_ID_PREFIX}{next(_ID_COUNTER):016x}"


class Span:
    """One named interval (or instant) inside a trace.

    ``t_wall`` anchors the span in epoch seconds; ``t_mono`` /
    ``end_mono`` are ``time.monotonic`` readings (durations never go
    backwards under clock steps). ``end_mono is None`` while open; an
    instant span is created already closed with zero duration.
    """

    __slots__ = ("name", "span_id", "parent_id", "t_wall", "t_mono",
                 "end_mono", "attrs", "status")

    def __init__(self, name: str, span_id: int, parent_id: Optional[int],
                 t_wall: float, t_mono: float,
                 end_mono: Optional[float] = None, attrs: dict = None,
                 status: str = "ok"):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.t_wall = t_wall
        self.t_mono = t_mono
        self.end_mono = end_mono
        self.attrs = attrs or {}
        self.status = status

    @property
    def duration_s(self) -> Optional[float]:
        if self.end_mono is None:
            return None
        return self.end_mono - self.t_mono


class TraceContext:
    """The spans of ONE request, accumulated across threads.

    Hot-path recording is lock-free: span ids come from an atomic
    counter and appends ride CPython's GIL-atomic ``list.append`` (the
    same guarantee the serving engine already leans on for its stats
    dicts) — submit runs on the caller's thread, dispatch on the
    service dispatcher, resolution on whichever thread resolves the
    future, and none of them may contend a lock per span. Only
    :meth:`finish` takes the lock, for its idempotency flag: the first
    call closes any still-open spans and hands the trace to its
    :class:`Tracer`'s bounded finished ring.
    """

    __slots__ = ("trace_id", "t0_wall", "t0_mono", "attrs", "_spans",
                 "_lock", "_tracer", "_finished", "_ids", "status")

    def __init__(self, tracer: Optional["Tracer"] = None,
                 trace_id: Optional[str] = None, **attrs):
        self.trace_id = trace_id or _new_trace_id()
        self.t0_wall = time.time()
        self.t0_mono = time.monotonic()
        self.attrs = attrs
        self._spans: list = []
        self._lock = threading.Lock()
        self._tracer = tracer
        self._finished = False
        self._ids = itertools.count()
        self.status = "open"

    # -- recording ---------------------------------------------------------

    def begin(self, name: str, parent: Optional[Span] = None,
              **attrs) -> Span:
        """Open a duration span (close it with :meth:`end`)."""
        now_m = time.monotonic()
        sp = Span(name, next(self._ids),
                  parent.span_id if parent is not None else None,
                  self.t0_wall + (now_m - self.t0_mono), now_m,
                  attrs=attrs)
        self._spans.append(sp)
        return sp

    def end(self, span: Span, status: str = "ok", **attrs) -> None:
        """Close an open span (no-op on an already-closed one)."""
        if span.end_mono is None:
            span.end_mono = time.monotonic()
            span.status = status
            if attrs:
                span.attrs.update(attrs)

    def add(self, name: str, status: str = "ok", **attrs) -> Span:
        """Record an instant span (zero duration)."""
        now_m = time.monotonic()
        sp = Span(name, next(self._ids), None,
                  self.t0_wall + (now_m - self.t0_mono), now_m,
                  end_mono=now_m, attrs=attrs, status=status)
        self._spans.append(sp)
        return sp

    def finish(self, status: str = "ok") -> None:
        """Close the trace (idempotent): open spans are ended with their
        current status, and the trace lands in the tracer's finished
        ring."""
        with self._lock:
            if self._finished:
                return
            self._finished = True
            self.status = status
            now_m = time.monotonic()
            for sp in list(self._spans):
                if sp.end_mono is None:
                    sp.end_mono = now_m
        if self._tracer is not None:
            self._tracer._record_finished(self)

    # -- reading -----------------------------------------------------------

    def span_names(self) -> list:
        return [sp.name for sp in list(self._spans)]

    def spans(self) -> list:
        return list(self._spans)

    def to_dict(self) -> dict:
        """Self-contained versioned JSON document for one trace."""
        spans = list(self._spans)
        return {
            "schema": TRACE_SCHEMA,
            "trace_id": self.trace_id,
            "t0_wall": round(self.t0_wall, 6),
            "status": self.status,
            "attrs": dict(self.attrs),
            "spans": [{
                "name": sp.name,
                "span_id": sp.span_id,
                "parent_id": sp.parent_id,
                "trace_id": self.trace_id,
                "t_wall": round(sp.t_wall, 6),
                "t": round(sp.t_mono - self.t0_mono, 9),
                "duration_s": (round(sp.duration_s, 9)
                               if sp.duration_s is not None else None),
                "status": sp.status,
                "attrs": dict(sp.attrs),
            } for sp in spans],
        }

    def chrome_trace(self) -> dict:
        """Perfetto-compatible Chrome trace events for one trace.

        Duration spans emit ``ph: "X"`` complete events; instants emit
        ``ph: "i"`` (thread-scoped). ``ts`` is microseconds from the
        trace origin, so multiple traces dumped together stay readable.
        """
        spans = list(self._spans)
        events = []
        for sp in spans:
            base = {
                "name": sp.name,
                "cat": "quest_tpu.serve",
                "pid": 1,
                "tid": 1,
                "ts": round((sp.t_mono - self.t0_mono) * 1e6, 3),
                "args": {"trace_id": self.trace_id,
                         "status": sp.status, **sp.attrs},
            }
            dur = sp.duration_s
            if dur is not None and dur > 0.0:
                events.append({**base, "ph": "X",
                               "dur": round(dur * 1e6, 3)})
            else:
                events.append({**base, "ph": "i", "s": "t"})
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"schema": TRACE_SCHEMA,
                              "trace_id": self.trace_id,
                              "t0_wall": round(self.t0_wall, 6)}}


class Tracer:
    """Per-component trace factory + bounded finished-trace ring.

    ``sample_rate`` in [0, 1] gates :meth:`start`: unsampled requests
    get ``None`` back and every downstream instrumentation point costs
    one ``None`` check. Sampling is a deterministic stride over the
    start counter — exactly ``floor(N * rate)`` of the first ``N``
    requests trace, reproducibly — because a seeded-random gate would
    make the acceptance tests (and any replayed incident) flaky.
    """

    def __init__(self, sample_rate: float = 0.0, max_traces: int = 256,
                 name: str = "tracer"):
        if not (0.0 <= sample_rate <= 1.0):
            raise ValueError(
                f"trace sample rate must be in [0, 1], got {sample_rate!r}")
        self.name = name
        self.sample_rate = float(sample_rate)
        self._lock = threading.Lock()
        self._started = 0
        self._sampled = 0
        self._finished_count = 0
        import collections
        self._done = collections.deque(maxlen=max(0, int(max_traces)))

    def start(self, **attrs) -> Optional[TraceContext]:
        """A new sampled :class:`TraceContext`, or None (unsampled).

        Disabled tracing (rate 0, the serving default) returns before
        touching the lock — one branch per request, no shared-lock
        contention on the submit path. ``requests_seen`` therefore
        counts only while sampling is enabled."""
        rate = self.sample_rate
        if rate <= 0.0:
            return None
        with self._lock:
            self._started += 1
            take = int(self._started * rate) > int((self._started - 1)
                                                   * rate)
            if not take:
                return None
            self._sampled += 1
        return TraceContext(tracer=self, **attrs)

    def _record_finished(self, ctx: TraceContext) -> None:
        with self._lock:
            self._finished_count += 1
            if self._done.maxlen:
                self._done.append(ctx)

    def finished(self) -> list:
        """The retained finished traces, oldest first."""
        with self._lock:
            return list(self._done)

    def stats(self) -> dict:
        with self._lock:
            return {"sample_rate": self.sample_rate,
                    "requests_seen": self._started,
                    "traces_sampled": self._sampled,
                    "traces_finished": self._finished_count,
                    "traces_retained": len(self._done)}

    # -- export ------------------------------------------------------------

    def export_json(self, path: Optional[str] = None) -> dict:
        """All retained traces as one versioned JSON document (written
        to ``path`` when given)."""
        doc = {"schema": TRACE_SCHEMA,
               "tracer": self.name,
               "generated_wall": round(time.time(), 6),
               "traces": [c.to_dict() for c in self.finished()]}
        if path is not None:
            import json
            with open(path, "w") as fh:
                json.dump(doc, fh, indent=2)
        return doc

    def export_chrome(self, path: Optional[str] = None) -> dict:
        """All retained traces as ONE Chrome trace-events document; each
        trace keeps its own origin-relative timestamps but a distinct
        ``pid`` so Perfetto renders them as separate tracks."""
        events = []
        for i, ctx in enumerate(self.finished()):
            for ev in ctx.chrome_trace()["traceEvents"]:
                events.append({**ev, "pid": i + 1})
        doc = {"traceEvents": events, "displayTimeUnit": "ms",
               "otherData": {"schema": TRACE_SCHEMA,
                             "tracer": self.name}}
        if path is not None:
            import json
            with open(path, "w") as fh:
                json.dump(doc, fh)
        return doc


@contextlib.contextmanager
def dispatch_annotation(name: str):
    """A named range around one engine dispatch: a
    ``torch.profiler.record_function`` (near-free while no profiler is
    recording) and, when a card is in use, a ``torch.cuda.nvtx`` range, so
    host spans, ``torch.profiler`` traces and NVTX timelines carry the
    same dispatch names."""
    import torch
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()
