"""Wire-robustness primitives: the token bucket, the idempotency
window, the WFQ backlog estimate, and the resumable-stream buffer.

These are the host-side building blocks behind the front door's
overload and retry contract, as in the JAX package:

- :class:`TokenBucket` — per-session request-rate limiting. An empty
  bucket answers 429 :class:`~quest_tpu_torch.netserve.errors.RateLimited`
  with ``retry_after_s`` = when the next token lands, so a compliant
  client backs off by the server's own estimate.
- :class:`DedupWindow` — the bounded server-side idempotency window.
  Client-supplied ``request_id``s deduplicate here, which is what makes
  the client's retry loop safe: a retried request that already
  SUCCEEDED replays the cached response instead of dispatching again
  (at-most-one successful dispatch per id); a duplicate of an
  IN-FLIGHT request joins the original's result. Failed attempts are
  deliberately NOT pinned — a retry after a transient failure must
  re-execute, and re-executing a failure is not a double dispatch.
- :func:`backlog_estimate` — a cheap (lock-free attribute probe, never
  ``dispatch_stats()``) read of the backend's queue depth and
  per-request service time, for the load-shedding watermark and the
  ``Retry-After`` estimate on every 429.
- :class:`ResumableStream` — the server-side buffer behind resumable
  ndjson streams: every event is stamped with a monotone ``cursor``;
  a disconnected client's stream keeps absorbing events for a grace
  TTL, and a reconnect replays everything after the last-acked cursor
  then continues live.

Locks here are leaves: none of these primitives acquires another lock
while holding its own (the delivery callbacks in
:class:`ResumableStream` run outside the lock), so they add no edges
to the runtime lock-order graph
(:mod:`quest_tpu_torch.testing.lockcheck`).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

__all__ = ["TokenBucket", "DedupWindow", "ResumableStream",
           "backlog_estimate"]


class TokenBucket:
    """A classic token bucket: ``rate`` tokens/second refill, ``burst``
    capacity. :meth:`acquire` spends one token and returns 0.0, or —
    when the bucket is empty — returns the seconds until the next token
    lands (the ``Retry-After`` the caller surfaces)."""

    __slots__ = ("rate", "burst", "_tokens", "_last", "_lock")

    def __init__(self, rate, burst):
        if rate <= 0 or burst < 1:
            raise ValueError(
                f"rate must be > 0 and burst >= 1; got rate={rate!r} "
                f"burst={burst!r}")
        self.rate = rate
        self.burst = burst
        self._tokens = burst * 1.0
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def acquire(self, now: Optional[float] = None):
        """Spend one token. Returns 0.0 (admitted) or the seconds until
        a token is available (rejected — the caller answers 429)."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            elapsed = now - self._last
            if elapsed > 0:
                self._tokens = min(self.burst * 1.0,
                                   self._tokens + elapsed * self.rate)
            self._last = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return 0.0
            return (1.0 - self._tokens) / self.rate


class _DedupEntry:
    """One in-flight-or-cached request: joiners wait on ``event``;
    ``status``/``payload`` are the completed response."""

    __slots__ = ("event", "status", "payload")

    def __init__(self):
        self.event = threading.Event()
        self.status = None
        self.payload = None


class DedupWindow:
    """The bounded idempotency window, keyed by ``(session_id,
    request_id)``.

    Contract (the invariant the chaos storm audits): at most ONE
    successful dispatch per key. :meth:`begin` answers one of

    - ``("dispatch", entry)`` — first sight: the caller executes and
      MUST call :meth:`complete`;
    - ``("join", entry)`` — the original is still in flight: the caller
      waits on it via :meth:`wait` and relays its response;
    - ``("replay", entry)`` — the original already succeeded: the
      caller relays the cached ``(status, payload)`` without touching
      the backend.

    Completions with status 200 stay cached (bounded FIFO — oldest
    completed entries evict first; in-flight entries are pinned).
    Non-200 completions wake their joiners with the failure, then DROP
    the entry so a client retry re-executes fresh.
    """

    def __init__(self, max_entries: int = 4096, wait_s: float = 300.0):
        self._lock = threading.Lock()
        self._entries: dict = {}      # key -> _DedupEntry (insertion order)
        self._max = int(max_entries)
        self._wait_s = wait_s
        self._hits = 0
        self._joins = 0
        self._dispatches = 0
        self._double_dispatches = 0   # the invariant counter: stays 0

    def begin(self, key):
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                if e.event.is_set():
                    # only status-200 completions remain cached
                    self._hits += 1
                    return "replay", e
                self._joins += 1
                return "join", e
            e = _DedupEntry()
            if len(self._entries) >= self._max:
                for k in list(self._entries):
                    if self._entries[k].event.is_set():
                        del self._entries[k]
                        if len(self._entries) < self._max:
                            break
            self._entries[key] = e
            self._dispatches += 1
            return "dispatch", e

    def complete(self, key, entry: _DedupEntry, status: int,
                 payload) -> None:
        """Record the dispatch's response and wake joiners. Failures
        (non-200) are handed to current joiners but not cached — the
        next retry of this id dispatches fresh."""
        with self._lock:
            if entry.event.is_set() and entry.status == 200:
                # a second completion for an id that already succeeded
                # would mean the window granted two dispatches: the
                # zero this counter must stay at is the storm's proof
                self._double_dispatches += 1
            entry.status = int(status)
            entry.payload = payload
            if status != 200 and self._entries.get(key) is entry:
                del self._entries[key]
        entry.event.set()

    def wait(self, entry: _DedupEntry):
        """Block until the in-flight original completes; returns
        ``(status, payload)`` or None on timeout."""
        if not entry.event.wait(self._wait_s):
            return None
        return entry.status, entry.payload

    def snapshot(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries),
                    "max_entries": self._max,
                    "dispatches": self._dispatches,
                    "replays": self._hits,
                    "joins": self._joins,
                    "double_dispatches": self._double_dispatches}

    @property
    def double_dispatches(self) -> int:
        with self._lock:
            return self._double_dispatches


def backlog_estimate(backend):
    """``(queue_depth, est_service_s)`` for a backend — a
    :class:`~quest_tpu_torch.serve.engine.SimulationService` (its
    ``_backlog``/``_inflight`` counters) or a
    :class:`~quest_tpu_torch.serve.router.ServiceRouter` (summed over ready
    replicas, with their routing EMA as the service time). Deliberately
    attribute probes, not ``dispatch_stats()``: this runs on the
    admission path of EVERY request under overload, where taking the
    backend's stats locks would turn the shed check into contention."""
    est = 0.05                       # conservative cold default
    replicas = getattr(backend, "_replicas", None)
    if replicas is not None:
        depth = 0
        emas = []
        for h in list(replicas):
            svc = getattr(h, "service", None)
            if svc is None:
                continue
            depth += getattr(svc, "_backlog", 0) \
                + getattr(svc, "_inflight", 0)
            ema = getattr(h, "ema_request_s", 0.0)
            if ema > 0:
                emas.append(ema)
        if emas:
            est = sum(emas) / len(emas)
        return depth, est
    depth = getattr(backend, "_backlog", 0) \
        + getattr(backend, "_inflight", 0)
    return depth, est


class ResumableStream:
    """Server-side state for one resumable ndjson stream.

    The pump thread calls :meth:`append` for every event; each event is
    stamped with the next monotone ``cursor`` and retained in a bounded
    replay buffer (drop-oldest — :attr:`truncated` records when the
    window slid). At most one consumer (an asyncio queue on the
    server's loop) is attached at a time; live events are relayed to it
    thread-safely, and ``None`` is the end-of-stream sentinel.

    On disconnect the consumer detaches and the stream keeps absorbing
    events; :meth:`expired` turns true ``ttl_s`` after the last detach
    (or after completion with no consumer), at which point the server
    sweeps it — cancelling the handle if the run is still live.
    """

    def __init__(self, stream_id: str, handle, session_id: str,
                 kind: str, max_buffer: int = 4096, ttl_s: float = 30.0):
        self.id = str(stream_id)
        self.handle = handle
        self.session_id = session_id
        self.kind = kind
        self.ttl_s = ttl_s
        self._lock = threading.Lock()
        self._events: list = []
        self._base = 0                 # cursor of _events[0]
        self._next = 0                 # next cursor to assign
        self._max = int(max_buffer)
        self._sink = None              # (loop, queue) while attached
        self.done = False
        self.truncated = False
        self._detached_at = time.monotonic()

    def append(self, ev: dict) -> dict:
        """Stamp + buffer one event and relay it to the attached
        consumer (if any). Returns the stamped event."""
        with self._lock:
            ev = dict(ev)
            ev["cursor"] = self._next
            self._next += 1
            self._events.append(ev)
            if len(self._events) > self._max:
                self._events.pop(0)
                self._base += 1
                self.truncated = True
            sink = self._sink
        if sink is not None:
            loop, q = sink
            try:
                loop.call_soon_threadsafe(q.put_nowait, ev)
            except RuntimeError:
                pass                   # loop closed mid-stream
        return ev

    def finish(self) -> None:
        """Mark the run complete and wake the attached consumer with
        the end-of-stream sentinel."""
        with self._lock:
            self.done = True
            sink = self._sink
            if sink is None:
                self._detached_at = time.monotonic()
        if sink is not None:
            loop, q = sink
            try:
                loop.call_soon_threadsafe(q.put_nowait, None)
            except RuntimeError:
                pass

    def attach(self, cursor: int, loop, q) -> bool:
        """Replay every buffered event with ``cursor`` greater than the
        client's last-acked one into ``q``, then attach for live
        events. MUST run on the consumer's loop thread: the replay puts
        are synchronous, so they order before any live relay callback.
        Returns False when the requested cursor fell off the bounded
        buffer (the resume cannot be gap-free)."""
        with self._lock:
            if cursor + 1 < self._base:
                return False
            replay = [e for e in self._events if e["cursor"] > cursor]
            self._sink = (loop, q)
            done = self.done
        for e in replay:
            q.put_nowait(e)
        if done:
            q.put_nowait(None)
        return True

    def detach(self) -> None:
        with self._lock:
            self._sink = None
            self._detached_at = time.monotonic()

    def attached(self) -> bool:
        with self._lock:
            return self._sink is not None

    def expired(self, now: Optional[float] = None) -> bool:
        if now is None:
            now = time.monotonic()
        with self._lock:
            if self._sink is not None:
                return False
            return (now - self._detached_at) > self.ttl_s

    def last_cursor(self) -> int:
        with self._lock:
            return self._next - 1
