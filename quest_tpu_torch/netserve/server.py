"""The netserve front door: a stdlib asyncio HTTP/1.1 JSON server.

One daemon-thread event loop accepts connections and parses requests;
every blocking step (decode, backend ``submit``, ``future.result()``,
encode) runs on the server's own worker pool
(:class:`~quest_tpu_torch.netserve._pool.WorkerPool` — NOT the loop's
default ``ThreadPoolExecutor``; see ``_pool.py``) so slow dispatches
never stall the acceptor. Routes:

- ``POST /v1/session`` — open a session: ``{"token": ...}`` through the
  :class:`~quest_tpu_torch.netserve.session.AuthHook` to a tenant (401 on
  rejection); the grant's WFQ policy is installed on the backend.
- ``POST /v1/submit`` — one wire request
  (:mod:`quest_tpu_torch.netserve.wire`), one JSON result. The program is
  resolved through the digest-keyed registry (first submission warms
  the backend; repeats skip decode entirely), the session's tenant
  rides into the SAME WFQ admission as in-process callers, and the
  relative ``timeout_s`` is converted to an absolute deadline at
  SERVER receipt — client clocks never extend a deadline.
- ``POST /v1/stream`` — chunked-transfer ndjson events
  (:data:`~quest_tpu_torch.telemetry.events.EVENT_SCHEMA` shape, each
  stamped with a monotone ``cursor``): optimizer iterates
  (``kind="gradient"`` + ``optimizer``), dynamics segments
  (``evolve``/``ground``), trajectory wave progress (``trajectory``).
  Client disconnect cancels the underlying handle — UNLESS the request
  carried ``resumable: true``, in which case the run keeps going and
  its events buffer server-side for ``resume_ttl_s``.
- ``POST /v1/resume`` — ``{"stream": id, "cursor": n}`` reattaches to a
  resumable stream: every buffered event after the last-acked cursor
  replays, then live events continue (404
  :class:`~quest_tpu_torch.netserve.errors.UnknownStream` when the stream is
  gone or the cursor fell off the bounded replay buffer).
- ``GET /metrics``, ``/metrics.json``, ``/healthz`` — the shared
  observability resolver (:class:`~quest_tpu_torch.telemetry.endpoints.
  ObservabilityEndpoints`), identical to the telemetry exporter's,
  plus ``/healthz/live`` (pure liveness) and ``/healthz/ready``
  (readiness — flips 503 while draining); and ``GET /v1/sessions`` —
  per-session program-registry hit rates, TTL-eviction aggregates, and
  the dedup-window snapshot.

Hardening (the JAX package's overload/retry/drain contract):

- **read deadline** — a request that dribbles in slower than
  ``read_timeout_s`` answers 408 and loses the connection (slow-loris
  guard); an IDLE keep-alive peer is closed silently.
- **connection cap** — past ``max_connections`` concurrent sockets,
  new connections answer 503 immediately.
- **per-session rate limit** — ``rate_limit=(rate, burst)`` token
  buckets answer 429 ``RateLimited`` with ``Retry-After`` = when the
  next token lands.
- **priority-aware shedding** — past ``shed_watermark`` of backend
  queue depth, requests with priority > 0 answer 429
  ``ServerOverloaded`` with ``Retry-After`` derived from the WFQ
  backlog estimate; priority-0 (ui-class) traffic is never shed.
- **idempotency** — a client-supplied ``request_id`` deduplicates in a
  bounded window: a retried id that already succeeded replays the
  cached response (at most ONE successful dispatch per id); a
  duplicate of an in-flight id joins the original's result.
- **drain** — :meth:`NetServer.drain` stops accepting, finishes
  in-flight work, and atomically persists the program registry +
  session table to ``state_path``; a restarted server readmits the
  sessions and serves ``circuit_ref`` submissions without a resend
  storm.
- **chaos** — the ``netserve.request``/``netserve.stream`` fault sites
  fire the wire kinds (:data:`~quest_tpu_torch.resilience.faults.WIRE_KINDS`)
  at this boundary: connection resets, stalled reads, torn response
  bodies, duplicate deliveries, stale program refs.

Request handling is traced (``quest_tpu.trace/1``) when
``trace_sample_rate`` samples it: ``parse`` -> ``queue`` ->
``dispatch`` -> ``serialize`` spans per request.
"""

from __future__ import annotations

import asyncio
import json
import threading
import time
import uuid
from typing import Optional

from ..resilience import faults as _faults
from ..telemetry import profile as _profile
from ..telemetry.endpoints import ObservabilityEndpoints
from ..telemetry.events import make_event
from ..telemetry.metrics import metrics_registry
from ..telemetry.tracing import Tracer, dispatch_annotation
from . import robust, wire
from ._pool import WorkerPool
from .errors import (AuthError, RateLimited, RequestTimeout,
                     ServerOverloaded, StreamUnsupported, UnknownStream,
                     WireError, WireFormatError, error_body, http_status,
                     retry_after_s)
from .session import ProgramRegistry, SessionManager

__all__ = ["NetServer"]

_SERVER_NAME = "quest-tpu-netserve"
SESSION_HEADER = "x-quest-session"
NETSTATE_SCHEMA = "quest_tpu.netstate/1"

_REASONS = {200: "OK", 400: "Bad Request", 401: "Unauthorized",
            404: "Not Found", 408: "Request Timeout", 409: "Conflict",
            429: "Too Many Requests", 500: "Internal Server Error",
            501: "Not Implemented", 503: "Service Unavailable",
            504: "Gateway Timeout"}

_NOT_FOUND = (b'{"error": {"type": "NotFound", "message": '
              b'"unknown route", "classification": "fatal"}}')

_BUSY = (b'{"error": {"type": "ServerOverloaded", "message": '
         b'"connection limit reached", '
         b'"classification": "transient"}}')

_DRAINING = (b'{"error": {"type": "ServiceClosed", "message": '
             b'"server is draining", '
             b'"classification": "transient"}}')


class _SlowLoris(Exception):
    """Internal marker: the peer dribbled a request past the read
    deadline (never crosses the wire — mapped to a 408 answer)."""


def _response(status: int, body: bytes,
              ctype: str = "application/json",
              keep_alive: bool = True,
              extra_headers: Optional[dict] = None) -> bytes:
    reason = _REASONS.get(status, "Error")
    conn = "keep-alive" if keep_alive else "close"
    extra = ""
    if extra_headers:
        extra = "".join(f"{k}: {v}\r\n" for k, v in extra_headers.items())
    head = (f"HTTP/1.1 {status} {reason}\r\n"
            f"Server: {_SERVER_NAME}\r\n"
            f"Content-Type: {ctype}\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"{extra}"
            f"Connection: {conn}\r\n\r\n")
    return head.encode("latin-1") + body


class NetServer:
    """The network front door over one backend (a
    :class:`~quest_tpu_torch.serve.router.ServiceRouter` or a bare
    :class:`~quest_tpu_torch.serve.engine.SimulationService`).

    ``port=0`` (the default) binds a free loopback port — read it back
    from ``server.port``. The server is a context manager; ``close()``
    cancels live stream handles, stops the loop, and unregisters the
    wire metrics provider.

    Hardening knobs (all off/permissive by default so an un-configured
    server behaves exactly like the pre-hardening one):

    - ``max_connections`` — concurrent-socket cap (None = unlimited).
    - ``read_timeout_s`` — per-request read deadline (None = never).
    - ``rate_limit`` — ``(rate, burst)`` per-session token bucket.
    - ``shed_watermark`` — backend queue depth past which priority > 0
      requests shed with 429 + Retry-After.
    - ``dedup_window`` — size of the request_id idempotency window.
    - ``session_ttl_s`` — idle sessions evict after this long; expired
      ids answer typed 401 ``SessionExpired``.
    - ``resume_ttl_s`` / ``resume_buffer`` — how long a disconnected
      resumable stream keeps absorbing events, and how many it buffers.
    - ``state_path`` — where :meth:`drain` persists the warm state; a
      file already there at boot is restored (sessions + programs).
    """

    def __init__(self, backend, *, auth=None, allow_anonymous: bool = True,
                 host: str = "127.0.0.1", port: int = 0,
                 max_body: int = 16 << 20, max_programs: int = 256,
                 registry=None, trace_sample_rate: float = 0.0,
                 warm_on_register: bool = True, max_workers: int = 16,
                 max_connections: Optional[int] = None,
                 read_timeout_s: Optional[float] = 30.0,
                 rate_limit: Optional[tuple] = None,
                 shed_watermark: Optional[int] = None,
                 dedup_window: int = 4096,
                 session_ttl_s: Optional[float] = None,
                 resume_ttl_s: float = 30.0,
                 resume_buffer: int = 4096,
                 state_path: Optional[str] = None):
        from ..serve.metrics import WireMetrics
        self.backend = backend
        # NOT the loop's default executor (a ThreadPoolExecutor): see
        # netserve/_pool.py. Every blocking step — session open, wire
        # decode, backend submit + future.result(), stream pump — runs
        # here; each in-flight request occupies one worker for its
        # whole dispatch, so max_workers bounds server-side concurrency
        self._pool = WorkerPool(int(max_workers), "quest-netserve")
        self.metrics = WireMetrics()
        self.sessions = SessionManager(
            auth, backend, allow_anonymous=allow_anonymous,
            ttl_s=session_ttl_s,
            on_evict=lambda n: self.metrics.incr("sessions_expired", n))
        self.programs = ProgramRegistry(max_programs=max_programs)
        self.dedup = robust.DedupWindow(max_entries=int(dedup_window))
        self.tracer = Tracer(sample_rate=trace_sample_rate,
                             name="netserve")
        self._max_body = int(max_body)
        self._warm_on_register = bool(warm_on_register)
        self._max_connections = max_connections
        self._read_timeout_s = read_timeout_s
        if rate_limit is not None:
            rate, burst = rate_limit
            rate_limit = (rate, int(burst))
        self._rate_limit = rate_limit
        self._rl_lock = threading.Lock()     # lazy per-session buckets
        self._shed_watermark = shed_watermark
        self._resume_ttl_s = resume_ttl_s
        self._resume_buffer = int(resume_buffer)
        self._state_path = state_path
        self._draining = False
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._streams: dict = {}             # stream id -> ResumableStream
        self._streams_lock = threading.Lock()
        self._conn_open = 0                  # touched only on the loop thread
        self._registry = registry if registry is not None \
            else metrics_registry()
        self._endpoints = ObservabilityEndpoints(
            self._registry,
            backend if hasattr(backend, "dispatch_stats") else None,
            readiness=self._readiness)
        self._metrics_name = self._registry.unique_name("netserve")
        self._registry.register(self._metrics_name, self.metrics.snapshot,
                                kind="netserve", owner=self)
        self._handles_lock = threading.Lock()
        self._handles: set = set()
        self._debug_last_handle = None      # tests poke at this
        self._closed = False
        self._server = None
        self._start_exc: Optional[BaseException] = None
        self._started = threading.Event()
        self._loop = asyncio.new_event_loop()
        self.host = host
        self.port = int(port)
        self.restored = {"sessions": 0, "programs": 0}
        if state_path is not None:
            self._restore_state()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"quest-tpu-netserve-{host}")
        self._thread.start()
        self._started.wait(30.0)
        if self._start_exc is not None:
            exc, self._start_exc = self._start_exc, None
            self._registry.unregister(self._metrics_name)
            raise exc
        if not self._started.is_set():
            raise RuntimeError("netserve event loop failed to start")

    # -- lifecycle ---------------------------------------------------------

    def _run(self) -> None:
        asyncio.set_event_loop(self._loop)
        try:
            self._server = self._loop.run_until_complete(
                asyncio.start_server(self._handle_conn, self.host,
                                     self.port))
            sockname = self._server.sockets[0].getsockname()
            self.host, self.port = sockname[0], int(sockname[1])
        # quest: allow-broad-except(boot failure propagates to the
        # constructor through _start_exc, whatever the bind raised)
        except Exception as e:
            self._start_exc = e
            self._started.set()
            return
        self._started.set()
        try:
            self._loop.run_forever()
        finally:
            try:
                self._server.close()
                self._loop.run_until_complete(
                    self._server.wait_closed())
                self._loop.run_until_complete(
                    self._loop.shutdown_asyncgens())
            # quest: allow-broad-except(shutdown best-effort: the
            # daemon loop thread must exit cleanly regardless)
            except Exception:
                pass
            self._loop.close()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def _readiness(self) -> dict:
        """/healthz/ready's local admission signal: a draining server
        is alive but must not receive new traffic."""
        return {"ready": not self._draining, "draining": self._draining}

    def drain(self, timeout: float = 30.0) -> dict:
        """Graceful drain: stop accepting connections, let in-flight
        requests and live streams finish (up to ``timeout`` seconds),
        then atomically persist the program registry + session table to
        ``state_path`` (crash-safe temp + fsync + replace — a
        restarted server readmits the sessions and serves
        ``circuit_ref`` submissions with zero program misses).
        Idempotent; flips ``/healthz/ready`` to 503 immediately.
        Returns a summary dict."""
        self._draining = True
        if self._started.is_set() and self._start_exc is None \
                and self._server is not None:
            try:
                self._loop.call_soon_threadsafe(self._server.close)
            except RuntimeError:
                pass                      # loop already gone
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._inflight_lock:
                busy = self._inflight
            with self._handles_lock:
                busy += len(self._handles)
            if busy == 0:
                break
            time.sleep(0.005)
        summary = {"persisted": False, "sessions": 0, "programs": 0}
        if self._state_path is not None:
            summary = self._persist_state()
        self.metrics.incr("drains")
        return summary

    def _persist_state(self) -> dict:
        from ..checkpoint import atomic_write_json
        programs = []
        for digest, circuit in self.programs.items():
            try:
                programs.append({"digest": str(digest),
                                 "circuit": wire.encode_circuit(circuit)})
            except WireError:
                # a program that cannot round-trip the wire form is
                # skipped: its clients self-heal via the 404 resend path
                continue
        doc = {"schema": NETSTATE_SCHEMA,
               "sessions": self.sessions.persist(),
               "programs": programs}
        atomic_write_json(self._state_path, doc)
        return {"persisted": True, "path": self._state_path,
                "sessions": len(doc["sessions"]["rows"]),
                "programs": len(programs)}

    def _restore_state(self) -> None:
        """Warm handover: readmit a drained predecessor's sessions and
        programs from ``state_path`` (missing/torn/mismatched files are
        ignored — a cold start is always safe)."""
        try:
            with open(self._state_path, "r", encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return
        if not isinstance(doc, dict) or doc.get("schema") != NETSTATE_SCHEMA:
            return
        n_sessions = self.sessions.restore(doc.get("sessions") or {})
        n_programs = 0
        for row in doc.get("programs") or []:
            try:
                c = wire.decode_circuit(row.get("circuit"),
                                        verify_digest=True)
            except WireError:
                continue          # one bad row never blocks the rest
            if self.programs.register(str(row.get("digest")), c):
                n_programs += 1
        if n_programs:
            self.metrics.incr("programs_restored", n_programs)
        self.restored = {"sessions": n_sessions, "programs": n_programs}

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        with self._handles_lock:
            handles = list(self._handles)
            self._handles.clear()
        for h in handles:
            self._cancel_handle(h)
        with self._streams_lock:
            self._streams.clear()
        if self._started.is_set() and self._start_exc is None:
            try:
                self._loop.call_soon_threadsafe(self._loop.stop)
            except RuntimeError:
                pass                      # loop already gone
            self._thread.join(10.0)
        self._pool.shutdown(wait=False)
        self._registry.unregister(self._metrics_name)

    def __enter__(self) -> "NetServer":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    @staticmethod
    def _cancel_handle(handle) -> None:
        try:
            handle.cancel()
        # quest: allow-broad-except(cancel is best-effort teardown; a
        # handle mid-completion may legally refuse)
        except Exception:
            pass

    def _track(self, handle) -> None:
        self._debug_last_handle = handle
        with self._handles_lock:
            self._handles.add(handle)

    def _untrack(self, handle) -> None:
        with self._handles_lock:
            self._handles.discard(handle)

    # -- connection handling -----------------------------------------------

    async def _read_request(self, reader):
        timeout = self._read_timeout_s
        if timeout is None:
            line = await reader.readline()
        else:
            try:
                line = await asyncio.wait_for(reader.readline(), timeout)
            except asyncio.TimeoutError:
                return None    # idle keep-alive peer: close silently
        if not line or line in (b"\r\n", b"\n"):
            return None
        # the WHOLE request (headers + body) shares ONE read deadline
        # anchored at the request line: a peer dribbling bytes cannot
        # hold a connection slot open (slow-loris guard -> 408)
        deadline = None if timeout is None \
            else time.monotonic() + timeout

        async def _within(coro):
            if deadline is None:
                return await coro
            left = deadline - time.monotonic()
            if left <= 0:
                coro.close()
                raise _SlowLoris()
            try:
                return await asyncio.wait_for(coro, left)
            except asyncio.TimeoutError:
                raise _SlowLoris()

        parts = line.decode("latin-1").strip().split()
        if len(parts) != 3:
            raise WireFormatError(f"malformed request line {line!r}")
        method, path, _version = parts
        headers = {}
        while True:
            hline = await _within(reader.readline())
            if hline in (b"\r\n", b"\n", b""):
                break
            name, sep, value = hline.decode("latin-1").partition(":")
            if not sep:
                raise WireFormatError(f"malformed header {hline!r}")
            headers[name.strip().lower()] = value.strip()
        body = b""
        length = int(headers.get("content-length", "0") or "0")
        if length:
            if length > self._max_body:
                raise WireFormatError(
                    f"request body of {length} bytes exceeds the "
                    f"server's max_body of {self._max_body}")
            body = await _within(reader.readexactly(length))
        return method, path, headers, body

    async def _handle_conn(self, reader, writer) -> None:
        self._conn_open += 1
        try:
            if self._draining:
                writer.write(_response(503, _DRAINING, keep_alive=False))
                await writer.drain()
                return
            if self._max_connections is not None \
                    and self._conn_open > self._max_connections:
                self.metrics.incr("conn_rejected")
                writer.write(_response(503, _BUSY, keep_alive=False))
                await writer.drain()
                return
            while True:
                try:
                    req = await self._read_request(reader)
                except _SlowLoris:
                    self.metrics.incr("read_timeouts")
                    self.metrics.incr("errors_total")
                    e = RequestTimeout(
                        "request not completed within read_timeout_s="
                        f"{self._read_timeout_s}s (slow-loris guard) — "
                        "retry promptly on a fresh connection",
                        detail={"read_timeout_s": self._read_timeout_s})
                    writer.write(_response(
                        408, json.dumps(error_body(e)).encode(),
                        keep_alive=False,
                        extra_headers={"Retry-After": "0.0"}))
                    await writer.drain()
                    break
                except (asyncio.IncompleteReadError, ConnectionError):
                    break
                except WireFormatError as e:
                    writer.write(_response(
                        400, wire.canonical_json(error_body(e)).encode(),
                        keep_alive=False))
                    await writer.drain()
                    break
                if req is None:
                    break
                method, path, headers, body = req
                keep = headers.get("connection", "").lower() != "close"
                if self._draining and method != "GET":
                    # keep-alive conns learn about the drain on their
                    # next submission; probes (GET) still answer
                    writer.write(_response(503, _DRAINING,
                                           keep_alive=False))
                    await writer.drain()
                    break
                if method == "GET":
                    resolved = await asyncio.wrap_future(
                        self._pool.submit(self._get_blocking, path))
                    status, ctype, payload = resolved
                    writer.write(_response(status, payload, ctype,
                                           keep_alive=keep))
                    await writer.drain()
                elif method == "POST" and path.startswith("/v1/session"):
                    status, payload = await asyncio.wrap_future(
                        self._pool.submit(self._open_session_blocking,
                                          body))
                    writer.write(_response(status, payload,
                                           keep_alive=keep))
                    await writer.drain()
                elif method == "POST" and path.startswith("/v1/submit"):
                    status, payload, extra, wfault = \
                        await asyncio.wrap_future(
                            self._pool.submit(self._submit_blocking,
                                              headers, body))
                    if wfault == "conn_reset":
                        # injected wire fault: the request may have
                        # EXECUTED, but the peer sees a bare reset —
                        # its retry must dedup, not double-dispatch
                        transport = writer.transport
                        if transport is not None:
                            transport.abort()
                        return
                    if wfault == "torn_body":
                        # injected wire fault: declared Content-Length,
                        # half the bytes, then close — the peer's read
                        # fails mid-body and its retry must dedup
                        resp = _response(status, payload,
                                         keep_alive=False,
                                         extra_headers=extra)
                        cut = max(1, len(payload) // 2 + 1)
                        writer.write(resp[:len(resp) - cut])
                        await writer.drain()
                        break
                    writer.write(_response(status, payload,
                                           keep_alive=keep,
                                           extra_headers=extra))
                    await writer.drain()
                elif method == "POST" and path.startswith("/v1/resume"):
                    await self._handle_resume(headers, body, reader,
                                              writer)
                    break             # streams own (and end) the socket
                elif method == "POST" and path.startswith("/v1/stream"):
                    await self._handle_stream(headers, body, reader,
                                              writer)
                    break             # streams own (and end) the socket
                else:
                    writer.write(_response(404, _NOT_FOUND,
                                           keep_alive=keep))
                    await writer.drain()
                if not keep:
                    break
        # quest: allow-broad-except(connection boundary: one sick
        # socket must never take down the acceptor loop)
        except Exception:
            pass
        finally:
            self._conn_open -= 1
            try:
                writer.close()
            # quest: allow-broad-except(double-close on a reset socket
            # is not an event)
            except Exception:
                pass

    # -- GET ---------------------------------------------------------------

    def _get_blocking(self, path: str):
        try:
            if path.startswith("/v1/sessions"):
                with self._streams_lock:
                    n_streams = len(self._streams)
                body = wire.canonical_json(
                    {"sessions": self.sessions.snapshot(),
                     "programs": len(self.programs),
                     "evicted": self.sessions.evicted_summary(),
                     "dedup": self.dedup.snapshot(),
                     "resumable_streams": n_streams,
                     "draining": self._draining}).encode()
                return 200, "application/json", body
            resolved = self._endpoints.resolve(path)
            if resolved is None:
                return 404, "application/json", _NOT_FOUND
            return resolved
        # quest: allow-broad-except(observability boundary: a failing
        # provider answers 500, it must not kill the connection loop)
        except Exception as e:
            return (500, "application/json",
                    json.dumps(error_body(e)).encode())

    # -- sessions ----------------------------------------------------------

    def _open_session_blocking(self, body: bytes):
        try:
            doc = json.loads(body.decode("utf-8")) if body else {}
            token = doc.get("token")
            sess = self.sessions.open(
                str(token) if token is not None else None)
            self.metrics.incr("sessions_opened")
            payload = wire.canonical_json(
                {"session": sess.id, "tenant": sess.tenant}).encode()
            return 200, payload
        # quest: allow-broad-except(wire boundary: every failure
        # answers typed — AuthError 401, bad JSON 400)
        except Exception as e:
            self.metrics.incr("errors_total")
            if isinstance(e, AuthError):
                self.metrics.incr("auth_rejections")
            return http_status(e), json.dumps(error_body(e)).encode()

    # -- submit ------------------------------------------------------------

    def _submit_blocking(self, headers: dict, body: bytes):
        """One hardened wire submission. Returns ``(status, payload,
        extra_headers, wire_fault)`` — the connection handler applies
        ``conn_reset``/``torn_body`` wire faults at the socket, since
        only it owns the writer."""
        with self._inflight_lock:
            self._inflight += 1
        self.metrics.incr("bytes_in", len(body))
        # fault hook + trace annotation + profiler, as at the engine's
        # dispatch boundaries: the profile span opens BEFORE the fault
        # hook so injected stalls land inside the measured wall-to-ready
        # time
        sp = _profile.profile_dispatch("netserve.request")
        try:
            try:
                wf = _faults.fire_wire("netserve.request")
            # quest: allow-broad-except(wire boundary: a RAISING
            # injected fault (transient/oom) answers typed like any
            # other dispatch failure)
            except Exception as e:
                return self._error_response(None, e) + (None,)
            if wf is not None:
                self.metrics.incr("wire_faults")
                if wf == "slow_read":
                    # the backend stalls mid-read: the peer's deadline
                    # budget, not ours, decides whether this is fatal
                    inj = _faults.active()
                    time.sleep(inj.stall_s if inj is not None else 0.05)
            with dispatch_annotation("quest_tpu_torch.netserve.request"):
                if wf == "dup_delivery":
                    # the same body delivered twice back-to-back: the
                    # dedup window must collapse the second delivery
                    # into the first's cached result
                    self._submit_once(headers, body, None)
                    status, payload, extra = self._submit_once(
                        headers, body, None)
                else:
                    status, payload, extra = self._submit_once(
                        headers, body, wf)
            wire_fault = wf if wf in ("conn_reset", "torn_body") else None
            return status, payload, extra, wire_fault
        finally:
            if sp is not None:
                sp.done(kind="netserve")
            with self._inflight_lock:
                self._inflight -= 1

    def _submit_once(self, headers: dict, body: bytes, wf):
        """Session + idempotency gate around one execution. A
        ``request_id`` goes through the dedup window: replays answer
        from cache, duplicates of in-flight originals join their
        result, and exactly one ``dispatch`` per id ever reaches
        :meth:`_execute_submit`."""
        ctx = self.tracer.start(endpoint="submit")
        t0 = time.perf_counter()
        try:
            sess = self.sessions.resolve(headers.get(SESSION_HEADER))
        # quest: allow-broad-except(wire boundary: session failures —
        # AuthError, SessionExpired — answer typed)
        except Exception as e:
            return self._error_response(ctx, e)
        sess.requests += 1
        try:
            doc = json.loads(body.decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as e:
            return self._error_response(
                ctx, WireFormatError(f"request body is not valid "
                                     f"JSON: {e}"))
        rid = doc.get("request_id") if isinstance(doc, dict) else None
        if not (isinstance(rid, str) and rid):
            return self._execute_submit(sess, doc, ctx, t0, wf)
        key = (sess.id, rid)
        state, entry = self.dedup.begin(key)
        if state == "replay":
            self.metrics.incr("dedup_hits")
            if ctx:
                ctx.add("dedup", state="replay", request_id=rid)
                ctx.finish("ok")
            return entry.status, entry.payload, {"x-quest-dedup": "replay"}
        if state == "join":
            self.metrics.incr("dedup_joins")
            res = self.dedup.wait(entry)
            if ctx:
                ctx.add("dedup", state="join", request_id=rid)
                ctx.finish("ok" if res else "error")
            if res is None:
                e = ServerOverloaded(
                    "the in-flight original for this request_id did "
                    "not complete within the dedup wait window — retry",
                    detail={"retry_after_s": 1.0})
                return self._error_response(None, e)
            return res[0], res[1], {"x-quest-dedup": "join"}
        try:
            status, payload, extra = self._execute_submit(
                sess, doc, ctx, t0, wf)
        # quest: allow-broad-except(re-raised unmodified — this belt
        # only wakes dedup joiners so they can never wedge on a lost
        # completion; _execute_submit answers typed for everything)
        except BaseException:
            self.dedup.complete(key, entry, 500, b"")
            raise
        self.dedup.complete(key, entry, status, payload)
        return status, payload, extra

    def _execute_submit(self, sess, doc, ctx, t0, wf):
        """Admission (rate limit, shed) + program resolution + backend
        dispatch for exactly one wire request."""
        try:
            if self._rate_limit is not None:
                bucket = sess.bucket
                if bucket is None:
                    with self._rl_lock:
                        if sess.bucket is None:
                            sess.bucket = robust.TokenBucket(
                                *self._rate_limit)
                        bucket = sess.bucket
                wait = bucket.acquire()
                if wait > 0:
                    self.metrics.incr("rate_limited")
                    raise RateLimited(
                        f"session {sess.id} exceeded "
                        f"{self._rate_limit[0]} requests/s (burst "
                        f"{self._rate_limit[1]}) — back off "
                        "retry_after_s before retrying",
                        detail={"retry_after_s": round(wait, 4)})
            sp = ctx.begin("parse") if ctx else None
            p0 = time.perf_counter()
            wr = wire.decode_request(doc)
            if wf == "stale_ref" and wr.circuit_ref is not None:
                # injected wire fault: the referenced program vanishes
                # (evicted/restarted server) — the request answers 404
                # UnknownProgram and the client self-heals via resend
                self.programs.evict(str(wr.circuit_ref))
            self._shed_check(sess, wr)
            circuit, digest = self._resolve_program(sess, wr, ctx)
            self.metrics.record_parse(time.perf_counter() - p0)
            if ctx:
                ctx.end(sp, kind=wr.kind, program=digest,
                        session=sess.id)
            kw = wr.submit_kwargs()
            kw["tenant"] = sess.tenant
            if wr.timeout_s is not None:
                # RELATIVE budget: the backend anchors it to ITS clock
                # at receipt (min with the service policy's own cap)
                kw["deadline"] = wr.timeout_s
            sp = ctx.begin("queue") if ctx else None
            fut = self.backend.submit(circuit, **kw)
            if ctx:
                ctx.end(sp)
            sp = ctx.begin("dispatch") if ctx else None
            value = fut.result()
            if ctx:
                ctx.end(sp)
            sp = ctx.begin("serialize") if ctx else None
            s0 = time.perf_counter()
            payload = wire.canonical_json(
                {"schema": wire.WIRE_SCHEMA, "kind": wr.kind,
                 "program": digest,
                 "result": wire.encode_result(wr.kind, value)}).encode()
            self.metrics.record_serialize(time.perf_counter() - s0)
            if ctx:
                ctx.end(sp)
                ctx.finish("ok")
            self.metrics.incr("requests_total")
            self.metrics.incr("requests_" + wr.kind)
            self.metrics.incr("bytes_out", len(payload))
            self.metrics.record_request(time.perf_counter() - t0)
            return 200, payload, None
        # quest: allow-broad-except(wire boundary: EVERY failure maps
        # to a typed JSON error envelope + HTTP status — the socket
        # never sees a traceback)
        except Exception as e:
            return self._error_response(ctx, e)

    def _error_response(self, ctx, e):
        """Typed error -> ``(status, payload, extra_headers)``; every
        429/408 carries a ``Retry-After`` header (the typed
        ``retry_after_s`` detail, or the WFQ backlog estimate)."""
        self.metrics.incr("errors_total")
        if isinstance(e, AuthError):
            self.metrics.incr("auth_rejections")
        if ctx:
            ctx.add("error", type=type(e).__name__)
            ctx.finish("error")
        status = http_status(e)
        extra = None
        if status in (408, 429):
            ra = retry_after_s(e)
            if ra is None:
                depth, est = robust.backlog_estimate(self.backend)
                ra = min(max(depth * est, 0.05), 30.0)
            extra = {"Retry-After": f"{ra:.3f}"}
        return status, json.dumps(error_body(e)).encode(), extra

    def _shed_check(self, sess, wr) -> None:
        """Priority-aware load shedding: past the backend queue-depth
        watermark, sheddable (priority > 0) requests answer 429 with a
        ``Retry-After`` derived from the WFQ backlog estimate.
        Priority 0 — the ui class — is NEVER shed: under a 4x overload
        burst, interactive traffic keeps flowing while batch backs
        off."""
        if self._shed_watermark is None:
            return
        depth, est = robust.backlog_estimate(self.backend)
        if depth < self._shed_watermark:
            return
        prio = wr.priority
        if prio is None:
            policy = getattr(sess.grant, "policy", None)
            prio = policy.priority if policy is not None else 1
        if prio <= 0:
            return
        retry = min(max(depth * est, 0.05), 30.0)
        self.metrics.incr("load_shed")
        raise ServerOverloaded(
            f"backend queue depth {depth} crossed the shed watermark "
            f"{self._shed_watermark} and priority {prio} is sheddable "
            "— retry after the backlog drains",
            detail={"retry_after_s": round(retry, 3),
                    "queue_depth": depth, "priority": int(prio)})

    def _resolve_program(self, sess, wr, ctx):
        """``circuit_ref``/``circuit``/``qasm`` -> (Circuit, digest),
        with per-session hit accounting. First sight of a digest
        registers AND warms; repeats skip decode entirely."""
        if wr.circuit_ref is not None:
            c = self.programs.lookup(str(wr.circuit_ref))
            sess.hits += 1
            self.metrics.incr("program_hits")
            return c, str(wr.circuit_ref)
        if wr.qasm is not None:
            from ..qasm_import import parse_qasm
            from ..serve.warmcache import circuit_digest
            self.metrics.incr("qasm_submissions")
            c = parse_qasm(wr.qasm, dialect="quest").circuit
            digest = circuit_digest(c)
            existing = self.programs.get(digest)
            if existing is not None:
                sess.hits += 1
                self.metrics.incr("program_hits")
                return existing, digest
            self._register_and_warm(digest, c, wr, ctx)
            sess.misses += 1
            self.metrics.incr("program_misses")
            return c, digest
        doc = wr.circuit_doc
        claimed = doc.get("digest") if isinstance(doc, dict) else None
        if claimed is not None:
            existing = self.programs.get(claimed)
            if existing is not None:
                # a full resend of a known program: the digest IS the
                # content address, so skip the replay entirely
                sess.hits += 1
                self.metrics.incr("program_hits")
                return existing, claimed
        c = wire.decode_circuit(doc)          # verifies the digest claim
        if claimed is None:
            from ..serve.warmcache import circuit_digest
            claimed = circuit_digest(c)
        self._register_and_warm(claimed, c, wr, ctx)
        sess.misses += 1
        self.metrics.incr("program_misses")
        return c, claimed

    def _register_and_warm(self, digest, circuit, wr, ctx=None) -> None:
        if not self.programs.register(digest, circuit):
            return
        self.metrics.incr("programs_registered")
        if not self._warm_on_register:
            return
        warm = getattr(self.backend, "warm", None)
        if warm is None:
            return
        if ctx:
            ctx.add("warm", program=digest, kind=wr.kind)
        obs = wr.observables
        try:
            if wr.kind == "expectation" and obs is not None:
                warm(circuit, observables=obs)
            elif wr.kind == "shots" and wr.shots is not None:
                warm(circuit, shots=wr.shots)
            elif wr.kind == "gradient" and obs is not None \
                    and wr.trajectories is None:
                try:
                    warm(circuit, observables=obs, gradient=True)
                except TypeError:
                    # routers warm observables only; the gradient
                    # executable compiles on first dispatch
                    warm(circuit, observables=obs)
            elif wr.kind == "trajectory" and obs is not None:
                try:
                    warm(circuit, observables=obs,
                         trajectories=wr.trajectories or 1)
                except TypeError:
                    pass   # no trajectory warm surface on this backend
            elif wr.kind == "sweep":
                warm(circuit)
            # evolve/ground compile per-segment executables — no
            # submit-shaped warm form exists for them
        # quest: allow-broad-except(warming is an optimization: a warm
        # failure must never fail the request that triggered it)
        except Exception:
            pass

    # -- streaming ---------------------------------------------------------

    def _sweep_streams(self) -> None:
        """Drop resumable streams whose resume TTL lapsed with no
        consumer attached; a still-live run is cancelled then (nobody
        is coming back for it)."""
        now = time.monotonic()
        doomed = []
        with self._streams_lock:
            for sid in list(self._streams):
                rs = self._streams[sid]
                if rs.expired(now):
                    del self._streams[sid]
                    doomed.append(rs)
        for rs in doomed:
            if not rs.done and rs.handle is not None:
                self._cancel_handle(rs.handle)
                self.metrics.incr("stream_cancels")

    async def _relay_events(self, queue, reader, writer, on_disconnect,
                            torn: bool = False):
        """Relay events from ``queue`` to the chunked socket until the
        ``None`` end-of-stream sentinel. ``on_disconnect`` fires once
        if the peer goes away first. Returns ``"done"`` (terminal chunk
        written), ``"disconnect"``, or ``"torn"`` (injected torn_body:
        the stream is abandoned mid-flight without the terminal
        chunk)."""
        disconnected = asyncio.Event()

        async def watch_disconnect() -> None:
            # the client sends nothing after the request: the next
            # read resolving (EOF or reset) means the peer went away
            try:
                await reader.read(1)
            except (ConnectionError, asyncio.CancelledError):
                pass
            if not disconnected.is_set():
                disconnected.set()
                on_disconnect()

        watcher = asyncio.ensure_future(watch_disconnect())
        wrote = 0
        try:
            while True:
                ev = await queue.get()
                if ev is None:
                    break
                line = (json.dumps(ev, sort_keys=True, default=str)
                        + "\n").encode("utf-8")
                chunk = (f"{len(line):x}\r\n".encode("latin-1") + line
                         + b"\r\n")
                try:
                    writer.write(chunk)
                    await writer.drain()
                except (ConnectionError, ConnectionResetError):
                    if not disconnected.is_set():
                        disconnected.set()
                        on_disconnect()
                    return "disconnect"
                self.metrics.incr("stream_events")
                self.metrics.incr("bytes_out", len(chunk))
                wrote += 1
                if torn and wrote >= 2:
                    # injected torn_body: a couple of events went out,
                    # then the body tears with no terminal chunk — the
                    # client must resume from its last-acked cursor
                    return "torn"
            if disconnected.is_set():
                return "disconnect"
            try:
                writer.write(b"0\r\n\r\n")
                await writer.drain()
            except (ConnectionError, ConnectionResetError):
                pass
            return "done"
        finally:
            watcher.cancel()

    async def _handle_stream(self, headers, body, reader, writer) -> None:
        loop = asyncio.get_running_loop()
        queue: asyncio.Queue = asyncio.Queue()
        t0 = time.monotonic()
        self.metrics.incr("bytes_in", len(body))
        # the emit sink: events route into the ResumableStream once the
        # setup publishes one (its buffer owns cursor stamping), else
        # straight onto the loop's queue with a local cursor counter
        state = {"rs": None, "cursor": 0}

        def emit(name: str, **detail) -> None:
            ev = make_event(name, t0, **wire.jsonable(detail))
            rs = state["rs"]
            if rs is not None:
                rs.append(ev)
                return
            ev["cursor"] = state["cursor"]
            state["cursor"] += 1
            try:
                loop.call_soon_threadsafe(queue.put_nowait, ev)
            except RuntimeError:
                pass                        # loop closed mid-stream

        setup = await asyncio.wrap_future(
            self._pool.submit(self._stream_setup_blocking, headers,
                              body, emit, state))
        if setup.get("fault") == "conn_reset":
            # injected wire fault: the peer sees a reset before any
            # response bytes — it reconnects and resumes or restarts
            transport = writer.transport
            if transport is not None:
                transport.abort()
            return
        if setup["err"] is not None:
            writer.write(_response(setup["status"], setup["err"],
                                   keep_alive=False))
            await writer.drain()
            return
        mode, handle = setup["mode"], setup["handle"]
        digest, kind, rs = setup["digest"], setup["kind"], setup["rs"]
        writer.write((f"HTTP/1.1 200 OK\r\n"
                      f"Server: {_SERVER_NAME}\r\n"
                      "Content-Type: application/x-ndjson\r\n"
                      "Transfer-Encoding: chunked\r\n"
                      "Connection: close\r\n\r\n").encode("latin-1"))
        await writer.drain()
        self.metrics.incr("streams_opened")
        if rs is not None:
            # attach BEFORE stream.open so the replay (any events the
            # run emitted during setup) orders ahead of live relays;
            # attach runs here, on the loop thread, by design
            rs.attach(-1, loop, queue)
            emit("stream.open", kind=kind, program=digest, stream=rs.id,
                 resumable=True)
        else:
            emit("stream.open", kind=kind, program=digest)

        def pump() -> None:
            try:
                if mode == "handle":
                    name = "segment" if kind in ("evolve", "ground") \
                        else "iterate"
                    for it in handle.iterates():
                        emit(name, **it)
                    emit("result", kind=kind, result=handle.result())
                else:
                    # a trajectory future: wave events already ride the
                    # _progress callback; just resolve the value
                    value = handle.result()
                    emit("result", kind=kind,
                         result=wire.encode_result(kind, value))
            # quest: allow-broad-except(stream boundary: a failing run
            # becomes a terminal "error" event, never a half-closed
            # socket with no explanation)
            except Exception as e:
                emit("error", **error_body(e)["error"])
            finally:
                self._untrack(handle)
                if rs is not None:
                    rs.finish()
                else:
                    try:
                        loop.call_soon_threadsafe(queue.put_nowait, None)
                    except RuntimeError:
                        pass

        pump_fut = asyncio.wrap_future(self._pool.submit(pump))

        def on_disconnect() -> None:
            if rs is not None:
                # resumable: the run KEEPS GOING — events buffer for
                # resume_ttl_s awaiting a /v1/resume reattach
                rs.detach()
                queue.put_nowait(None)
            elif not pump_fut.done():
                self._cancel_handle(handle)
                self.metrics.incr("stream_cancels")

        torn = setup.get("fault") == "torn_body"
        try:
            await self._relay_events(queue, reader, writer,
                                     on_disconnect, torn=torn)
        finally:
            if rs is not None:
                rs.detach()
            else:
                try:
                    await pump_fut
                # quest: allow-broad-except(the pump already reported
                # its failure as an "error" event)
                except Exception:
                    pass

    def _stream_setup_blocking(self, headers, body, emit, state):
        """Resolve the request into a streamable handle BEFORE any bytes
        go out, so typed failures still answer as plain HTTP errors.
        Returns a dict: status/err (error path), mode/handle/digest/
        kind/rs (success), fault (wire-fault directive for the
        socket-owning caller)."""
        fail = {"status": 500, "err": b"", "mode": None, "handle": None,
                "digest": None, "kind": None, "rs": None, "fault": None}
        # fault hook + trace annotation + profiler, as in
        # _submit_blocking: the span opens before the fault hook
        sp = _profile.profile_dispatch("netserve.stream")
        try:
            try:
                wf = _faults.fire_wire("netserve.stream")
            # quest: allow-broad-except(wire boundary: a RAISING
            # injected fault answers typed before streaming starts)
            except Exception as e:
                st, payload, _extra = self._error_response(None, e)
                return dict(fail, status=st, err=payload)
            if wf is not None:
                self.metrics.incr("wire_faults")
                if wf == "conn_reset":
                    return dict(fail, err=None, fault="conn_reset")
                if wf == "slow_read":
                    inj = _faults.active()
                    time.sleep(inj.stall_s if inj is not None else 0.05)
                # dup_delivery has no stream meaning (a second identical
                # stream would be a second run): dropped here
            with dispatch_annotation("quest_tpu_torch.netserve.stream"):
                return self._stream_setup_inner(headers, body, emit,
                                                state, wf, fail)
        finally:
            if sp is not None:
                sp.done(kind="netserve")

    def _stream_setup_inner(self, headers, body, emit, state, wf, fail):
        try:
            sess = self.sessions.resolve(headers.get(SESSION_HEADER))
            sess.requests += 1
            wr = wire.decode_request(json.loads(body.decode("utf-8")))
            if wf == "stale_ref" and wr.circuit_ref is not None:
                self.programs.evict(str(wr.circuit_ref))
            self._shed_check(sess, wr)
            circuit, digest = self._resolve_program(sess, wr, None)
            kind = wr.kind
            rs = None
            if wr.resumable:
                self._sweep_streams()
                rs = robust.ResumableStream(
                    f"st-{uuid.uuid4().hex[:12]}", None, sess.id,
                    kind=kind, max_buffer=self._resume_buffer,
                    ttl_s=self._resume_ttl_s)
                # publish BEFORE the handle exists: progress callbacks
                # can fire during submit and must land in the buffer
                state["rs"] = rs
            if kind == "gradient" and wr.optimizer is not None:
                from ..serve.optimize import VariationalProblem
                opt = dict(wr.optimizer)
                problem = VariationalProblem(
                    circuit=circuit, observables=wr.observables,
                    x0=wr.params if wr.params is not None else {},
                    trajectories=wr.trajectories,
                    sampling_budget=wr.sampling_budget, tier=wr.tier)
                handle = self.backend.optimize(
                    problem, opt.get("name", "adam"),
                    max_iters=int(opt.get("max_iters", 100)),
                    tol=opt.get("tol", 1e-6),
                    learning_rate=opt.get("learning_rate"),
                    tenant=sess.tenant)
                mode = "handle"
            elif kind in ("evolve", "ground"):
                fn = getattr(self.backend,
                             "evolve" if kind == "evolve"
                             else "ground_state", None)
                if fn is None:
                    raise StreamUnsupported(
                        f"this backend has no streaming {kind!r} "
                        "surface — POST /v1/submit runs it as one "
                        "request instead")
                if wr.observables is None:
                    raise WireFormatError(
                        f"{kind} requests carry the Hamiltonian as "
                        "observables={'terms': ..., 'coeffs': ...}")
                if kind == "evolve":
                    handle = fn(circuit, wr.params,
                                hamiltonian=wr.observables,
                                t=wr.evolve.t, steps=wr.evolve.steps,
                                order=wr.evolve.order,
                                init_state=wr.init_state, tier=wr.tier,
                                tenant=sess.tenant)
                else:
                    handle = fn(circuit, wr.params,
                                hamiltonian=wr.observables,
                                steps=wr.ground.steps,
                                tau=wr.ground.tau,
                                method=wr.ground.method,
                                tol=wr.ground.tol,
                                init_state=wr.init_state, tier=wr.tier,
                                tenant=sess.tenant)
                mode = "handle"
            elif kind == "trajectory":
                kw = wr.submit_kwargs()
                kw["tenant"] = sess.tenant
                if wr.timeout_s is not None:
                    kw["deadline"] = wr.timeout_s
                handle = self.backend.submit(
                    circuit,
                    _progress=lambda info: emit("wave", **info), **kw)
                mode = "future"
            else:
                raise StreamUnsupported(
                    f"kind {kind!r} has no streaming form — "
                    "POST /v1/submit")
            if rs is not None:
                rs.handle = handle
                with self._streams_lock:
                    self._streams[rs.id] = rs
            self._track(handle)
            self.metrics.incr("requests_total")
            self.metrics.incr("requests_" + kind)
            return {"status": 200, "err": None, "mode": mode,
                    "handle": handle, "digest": digest, "kind": kind,
                    "rs": rs, "fault": "torn_body"
                    if wf == "torn_body" else None}
        # quest: allow-broad-except(wire boundary: setup failures
        # answer as typed plain-HTTP errors BEFORE streaming starts)
        except Exception as e:
            state["rs"] = None          # never leave a dead buffer wired
            st, payload, _extra = self._error_response(None, e)
            return dict(fail, status=st, err=payload)

    # -- resume ------------------------------------------------------------

    async def _handle_resume(self, headers, body, reader, writer) -> None:
        loop = asyncio.get_running_loop()
        self.metrics.incr("bytes_in", len(body))
        setup = await asyncio.wrap_future(
            self._pool.submit(self._resume_setup_blocking, headers,
                              body))
        status, err_payload, rs, cursor = setup
        if err_payload is not None:
            writer.write(_response(status, err_payload,
                                   keep_alive=False))
            await writer.drain()
            return
        queue: asyncio.Queue = asyncio.Queue()
        # attach on the loop thread: the buffered replay (everything
        # after the client's last-acked cursor) orders ahead of any
        # live relay callback by construction
        if not rs.attach(cursor, loop, queue):
            e = UnknownStream(
                f"cursor {cursor} fell off stream {rs.id!r}'s bounded "
                "replay buffer — a gap-free resume is impossible; "
                "restart the stream")
            self.metrics.incr("errors_total")
            writer.write(_response(404,
                                   json.dumps(error_body(e)).encode(),
                                   keep_alive=False))
            await writer.drain()
            return
        self.metrics.incr("streams_resumed")
        writer.write((f"HTTP/1.1 200 OK\r\n"
                      f"Server: {_SERVER_NAME}\r\n"
                      "Content-Type: application/x-ndjson\r\n"
                      "Transfer-Encoding: chunked\r\n"
                      "Connection: close\r\n\r\n").encode("latin-1"))
        await writer.drain()

        def on_disconnect() -> None:
            rs.detach()
            queue.put_nowait(None)

        try:
            await self._relay_events(queue, reader, writer,
                                     on_disconnect)
        finally:
            rs.detach()

    def _resume_setup_blocking(self, headers, body):
        """Validate a resume request -> ``(status, err_payload, rs,
        cursor)``; the socket-owning caller performs the attach."""
        try:
            sess = self.sessions.resolve(headers.get(SESSION_HEADER))
            doc = json.loads(body.decode("utf-8"))
            if not isinstance(doc, dict):
                raise WireFormatError(
                    "resume body must be a JSON object: "
                    '{"stream": id, "cursor": n}')
            stream_id = str(doc.get("stream") or "")
            try:
                cursor = int(doc.get("cursor", -1))
            except (TypeError, ValueError):
                raise WireFormatError(
                    f"cursor must be an integer, got "
                    f"{doc.get('cursor')!r}")
            self._sweep_streams()
            with self._streams_lock:
                rs = self._streams.get(stream_id)
            if rs is None:
                raise UnknownStream(
                    f"no resumable stream {stream_id!r} on this server "
                    "(never opened, finished and swept, or expired "
                    f"past resume_ttl_s={self._resume_ttl_s}) — "
                    "restart the stream")
            if rs.session_id != sess.id:
                raise AuthError(
                    f"stream {stream_id!r} belongs to another session")
            if rs.attached():
                e = WireError(
                    f"stream {stream_id!r} already has a live consumer "
                    "attached — one consumer at a time")
                e.status = 409
                raise e
            return 200, None, rs, cursor
        # quest: allow-broad-except(wire boundary: resume failures
        # answer typed — UnknownStream 404, AuthError 401, bad JSON
        # 400 — before any streaming bytes)
        except Exception as e:
            self.metrics.incr("errors_total")
            if isinstance(e, AuthError):
                self.metrics.incr("auth_rejections")
            return (http_status(e), json.dumps(error_body(e)).encode(),
                    None, None)
