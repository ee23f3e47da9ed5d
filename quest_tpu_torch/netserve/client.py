"""The stdlib sync client: ``submit() -> Future`` over a socket.

:class:`NetClient` mirrors the in-process
:meth:`~quest_tpu_torch.serve.engine.SimulationService.submit` shape — pass a
recorded circuit plus the kind's knobs, get a
:class:`concurrent.futures.Future` resolving with the SAME value shape
the in-process future resolves with (planes array, ``(mean, stderr)``,
``(value, grad)``, …). Server errors re-raise as the SAME typed
exception family (``except QueueFull`` works identically over the
socket, :func:`~quest_tpu_torch.netserve.errors.raise_typed`).

The client is content-address aware: the first submission of a circuit
ships the full wire form; repeats ship only its digest
(``circuit_ref``), falling back to a one-shot full resend when the
server answers 404 ``UnknownProgram`` (evicted or restarted). Deadlines
are RELATIVE (``timeout_s``) by protocol — there is no way to send an
absolute timestamp, so a skewed client clock cannot extend one.

Retries are built in and SAFE: every submission carries a
client-generated ``request_id``, which the server deduplicates in a
bounded idempotency window — so the retry loop (exponential backoff
with jitter, honoring the server's ``Retry-After`` on 429/408) can
never double-dispatch, even when a connection reset or torn response
body hides whether the original executed. The ORIGINAL relative
deadline budget is preserved across attempts (each retry ships the
remaining ``timeout_s``, mirroring router failover); an exhausted
budget raises :class:`~quest_tpu_torch.serve.engine.DeadlineExceeded`. A 401
``SessionExpired`` (the server's idle-TTL sweep evicted the session)
transparently re-opens the session and replays.

:meth:`NetClient.stream` yields the server's ndjson events (optimizer
iterates, dynamics segments, trajectory waves) as plain dicts; closing
the generator closes the socket, which cancels the server-side handle.
With ``resumable=True`` the server instead keeps the run alive across
disconnects, every event carries a monotone ``cursor``, and the client
auto-reconnects via ``POST /v1/resume`` from the last event it saw —
replay overlap is deduplicated by cursor, so the yielded sequence is
identical to an uninterrupted run.
"""

from __future__ import annotations

import http.client
import itertools
import json
import random
import threading
import time
import uuid
from concurrent.futures import Future
from typing import Optional

from . import wire
from ._pool import WorkerPool
from .errors import UnknownProgram, raise_typed
from .server import SESSION_HEADER

__all__ = ["NetClient"]

# statuses the retry loop may replay (the request_id makes it safe):
# 408 slow-loris kill, 429 rate-limit/shed/queue-full, 503 draining/
# breaker/unavailable. 500s replay only when the server classified the
# failure transient. 504 (DeadlineExceeded) never replays: the budget
# is already spent.
_RETRYABLE = (408, 429, 503)


def _infer_kind(observables, shots, trajectories, gradient, evolve,
                ground) -> str:
    if evolve is not None:
        return "evolve"
    if ground is not None:
        return "ground"
    if gradient:
        return "gradient"
    if shots is not None:
        return "shots"
    if trajectories is not None:
        return "trajectory"
    if observables is not None:
        return "expectation"
    return "sweep"


class NetClient:
    """One server endpoint, many concurrent requests.

    Each request rides its own ``http.client.HTTPConnection`` on a
    small thread pool — the stdlib connection is not thread-safe, and
    per-request connections keep the client dependency-free while the
    server side multiplexes fine.

    ``retries`` bounds the replay loop (0 restores fail-fast
    single-shot behavior); ``backoff_s``/``backoff_max_s`` shape the
    jittered exponential backoff; ``retry_seed`` pins the jitter for
    deterministic tests. :attr:`stats` counts retries, program resends,
    session re-opens, and stream resumes.
    """

    def __init__(self, host: str, port: int, *,
                 token: Optional[str] = None, timeout: float = 300.0,
                 max_workers: int = 8, retries: int = 4,
                 backoff_s: float = 0.05, backoff_max_s: float = 2.0,
                 retry_seed: Optional[int] = None):
        self.host = host
        self.port = int(port)
        self._token = token
        self._timeout = float(timeout)
        self._retries = int(retries)
        self._backoff_s = float(backoff_s)
        self._backoff_max_s = float(backoff_max_s)
        self._rng = random.Random(retry_seed)
        self._lock = threading.Lock()
        self._session_lock = threading.Lock()
        self._session: Optional[str] = None
        self.tenant: Optional[str] = None
        self._programs: dict = {}      # digest -> full circuit doc
        self._confirmed: set = set()   # digests the server acked
        self._rid_prefix = uuid.uuid4().hex[:10]
        self._rid_counter = itertools.count(1)
        self._stats_lock = threading.Lock()
        self._stats = {"retries": 0, "resends": 0,
                       "session_reopens": 0, "resumes": 0}
        self._pool = WorkerPool(int(max_workers), "quest-netclient")

    # -- plumbing ----------------------------------------------------------

    def _request(self, method: str, path: str, body: bytes = None,
                 headers: dict = None,
                 timeout: Optional[float] = None):
        conn = http.client.HTTPConnection(
            self.host, self.port,
            timeout=self._timeout if timeout is None else timeout)
        try:
            hdrs = {"Content-Type": "application/json"}
            if headers:
                hdrs.update(headers)
            conn.request(method, path, body=body, headers=hdrs)
            resp = conn.getresponse()
            rhdrs = {k.lower(): v for k, v in resp.getheaders()}
            return resp.status, resp.read(), rhdrs
        finally:
            conn.close()

    @staticmethod
    def _payload(status: int, data: bytes) -> dict:
        try:
            return json.loads(data.decode("utf-8"))
        except ValueError:
            return {"error": {"type": "WireError",
                              "message": f"non-JSON body (HTTP "
                                         f"{status}): {data[:200]!r}"}}

    @property
    def stats(self) -> dict:
        """Resilience accounting: retries, program resends, session
        re-opens, stream resumes this client performed."""
        with self._stats_lock:
            return dict(self._stats)

    def _count(self, name: str) -> None:
        with self._stats_lock:
            self._stats[name] += 1

    def _next_request_id(self) -> str:
        return f"{self._rid_prefix}-{next(self._rid_counter)}"

    # -- sessions ----------------------------------------------------------

    def open_session(self) -> str:
        """Open (or return) this client's session; called lazily by the
        first submit."""
        # one session per client: serialize creation so concurrent
        # first submits don't each open their own
        with self._session_lock:
            if self._session is not None:
                return self._session
            doc = {} if self._token is None else {"token": self._token}
            status, data, _hdrs = self._request(
                "POST", "/v1/session", json.dumps(doc).encode())
            payload = self._payload(status, data)
            if status != 200:
                raise_typed(status, payload)
            self._session = str(payload["session"])
            self.tenant = payload.get("tenant")
            return self._session

    def _drop_session(self) -> None:
        """Forget an expired session so the next attempt re-opens."""
        with self._session_lock:
            self._session = None
        self._count("session_reopens")

    @property
    def session(self) -> Optional[str]:
        return self._session

    # -- submit ------------------------------------------------------------

    def submit(self, circuit=None, params=None, *, kind=None,
               circuit_ref=None, qasm=None, observables=None,
               shots=None, trajectories=None, sampling_budget=None,
               gradient: bool = False, evolve=None, ground=None,
               ground_state=None, init_state=None, tier=None,
               priority=None, timeout_s=None,
               request_id: Optional[str] = None) -> Future:
        """Submit one request; returns a Future resolving with the same
        value shape the in-process API resolves with."""
        ground = ground if ground is not None else ground_state
        wk = kind or _infer_kind(observables, shots, trajectories,
                                 gradient, evolve, ground)
        cdoc = None
        if circuit is not None:
            cdoc = circuit if isinstance(circuit, dict) \
                else wire.encode_circuit(circuit)
            digest = cdoc.get("digest")
            with self._lock:
                # ref only digests the server ACKED (a 200 with this
                # program): switching on first SEND would race our own
                # in-flight full submission to the server
                known = digest in self._confirmed
                if digest is not None:
                    self._programs[digest] = cdoc
            if known:
                circuit_ref, cdoc_sent = digest, None
            else:
                cdoc_sent = cdoc
        else:
            cdoc_sent = None
        doc = wire.encode_request(
            wk, circuit=cdoc_sent, circuit_ref=circuit_ref, qasm=qasm,
            params=params, observables=observables, shots=shots,
            trajectories=trajectories, sampling_budget=sampling_budget,
            tier=tier, priority=priority, timeout_s=timeout_s,
            evolve=evolve, ground=ground, init_state=init_state,
            request_id=request_id)
        return self._pool.submit(self._roundtrip, wk, doc)

    def submit_wire(self, doc: dict) -> Future:
        """Submit a raw wire document verbatim (tests, tooling)."""
        kind = doc.get("kind")
        return self._pool.submit(self._roundtrip, kind, dict(doc))

    def _accept(self, kind: str, payload: dict):
        program = payload.get("program")
        if program is not None:
            with self._lock:
                self._confirmed.add(program)
        self.last_program = program
        return wire.parse_result(kind, payload["result"])

    def _backoff(self, attempt: int, retry_after, deadline) -> None:
        """Jittered exponential backoff, floored by the server's
        Retry-After estimate, capped by the remaining deadline."""
        sleep = min(self._backoff_max_s,
                    self._backoff_s * (2 ** max(0, attempt - 1)))
        sleep *= 0.5 + self._rng.random()          # jitter in [0.5, 1.5)
        if retry_after is not None:
            sleep = max(sleep, retry_after)
        if deadline is not None:
            sleep = min(sleep, max(0.0, deadline - time.monotonic()))
        self._count("retries")
        if sleep > 0:
            time.sleep(sleep)

    @staticmethod
    def _retry_after(hdrs: dict, err: dict):
        ra = hdrs.get("retry-after")
        if ra is None:
            detail = err.get("detail")
            if isinstance(detail, dict):
                ra = detail.get("retry_after_s")
        try:
            return max(0.0, float(ra)) if ra is not None else None
        except (TypeError, ValueError):
            return None

    def _roundtrip(self, kind: str, doc: dict):
        doc = dict(doc)
        if self._retries > 0 and "request_id" not in doc:
            # idempotency key: the server's dedup window guarantees at
            # most one successful dispatch for it, making every retry
            # below safe even when the response was lost in flight
            doc["request_id"] = self._next_request_id()
        budget = doc.get("timeout_s")
        deadline = None if budget is None \
            else time.monotonic() + budget
        attempt = 0
        healed = False
        last_error = None            # (status, payload) or exception
        while True:
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self._raise_exhausted(budget, attempt, last_error)
                # the ORIGINAL relative budget shrinks across attempts
                # — a retry can never extend the caller's deadline
                doc["timeout_s"] = max(remaining, 1e-3)
            sid = self.open_session()
            body = wire.canonical_json(doc).encode()
            status = None
            retry_after = None
            try:
                # socket timeout = remaining budget + grace: the
                # server expires the dispatch at ITS deadline and
                # answers typed 504 — give that answer time to arrive
                # rather than tearing the socket at the exact budget
                status, data, hdrs = self._request(
                    "POST", "/v1/submit", body,
                    headers={SESSION_HEADER: sid},
                    timeout=None if remaining is None
                    else min(self._timeout, remaining + 5.0))
            except (OSError, http.client.HTTPException) as e:
                # reset / refused / torn body: the server may or may
                # not have executed — only the request_id knows
                if self._retries == 0:
                    raise
                last_error = e
            if status == 200:
                try:
                    payload = json.loads(data.decode("utf-8"))
                except ValueError as e:
                    # a torn 200: retry replays the cached response
                    last_error = e
                    status = None
                else:
                    return self._accept(kind, payload)
            if status is not None:
                payload = self._payload(status, data)
                err = payload.get("error", {})
                if status == 404 and doc.get("circuit_ref") is not None \
                        and not healed:
                    # evicted/restarted server forgot the program: one
                    # full resend re-registers it (same request_id —
                    # the failed ref attempt was not cached)
                    ref = doc["circuit_ref"]
                    with self._lock:
                        self._confirmed.discard(ref)
                        full = self._programs.get(ref)
                    if full is None:
                        raise UnknownProgram(
                            f"server forgot program {ref!r} and this "
                            "client holds no full wire form for it")
                    doc = {k: v for k, v in doc.items()
                           if k != "circuit_ref"}
                    doc["circuit"] = full
                    healed = True
                    self._count("resends")
                    continue
                if status == 401 and err.get("type") == "SessionExpired":
                    # idle-TTL eviction: re-open and replay — typed
                    # transient by contract
                    self._drop_session()
                    if self._retries == 0:
                        raise_typed(status, payload)
                elif status in _RETRYABLE or (
                        status == 500
                        and err.get("classification") == "transient"):
                    retry_after = self._retry_after(hdrs, err)
                else:
                    raise_typed(status, payload)
                last_error = (status, payload)
            attempt += 1
            if attempt > self._retries:
                self._raise_exhausted(budget, attempt, last_error)
            self._backoff(attempt, retry_after, deadline)

    def _raise_exhausted(self, budget, attempt, last_error):
        """Surface the LAST failure once the budget or attempts run
        out; a spent deadline raises typed DeadlineExceeded."""
        if isinstance(last_error, tuple):
            status, payload = last_error
            raise_typed(status, payload)
        from ..serve.engine import DeadlineExceeded
        if budget is not None:
            raise DeadlineExceeded(
                f"retry budget of {budget}s exhausted after "
                f"{attempt} attempts") from (
                last_error if isinstance(last_error, BaseException)
                else None)
        if isinstance(last_error, BaseException):
            raise last_error
        raise ConnectionError(
            f"request failed after {attempt} attempts with no "
            "response from the server")

    # -- streaming ---------------------------------------------------------

    def stream(self, circuit=None, params=None, *, kind=None,
               circuit_ref=None, qasm=None, observables=None,
               trajectories=None, sampling_budget=None, evolve=None,
               ground=None, ground_state=None, init_state=None,
               tier=None, optimizer=None, timeout_s=None,
               timeout: Optional[float] = None,
               resumable: bool = False):
        """Stream one run's events as dicts (``event`` in
        ``{"stream.open", "iterate", "segment", "wave", "result",
        "error"}``, each carrying a monotone ``cursor``). Closing the
        generator closes the socket, which cancels the server-side
        handle — unless ``resumable=True``, in which case the run
        survives disconnects and this generator transparently
        reconnects via ``POST /v1/resume`` from the last event it saw,
        yielding a sequence identical to an uninterrupted run."""
        ground = ground if ground is not None else ground_state
        if kind is None:
            if optimizer is not None:
                kind = "gradient"
            else:
                kind = _infer_kind(observables, None, trajectories,
                                   False, evolve, ground)
        if circuit is not None and not isinstance(circuit, dict):
            circuit = wire.encode_circuit(circuit)
        doc = wire.encode_request(
            kind, circuit=circuit, circuit_ref=circuit_ref, qasm=qasm,
            params=params, observables=observables,
            trajectories=trajectories, sampling_budget=sampling_budget,
            tier=tier, timeout_s=timeout_s, evolve=evolve,
            ground=ground, init_state=init_state, optimizer=optimizer,
            resumable=True if resumable else None)
        sid = self.open_session()
        body = wire.canonical_json(doc).encode()
        if not resumable:
            yield from self._stream_socket("/v1/stream", body, sid,
                                           timeout)
            return
        state = {"stream": None, "cursor": -1}
        attempts = 0
        path, payload = "/v1/stream", body
        while True:
            last_exc = None
            done = False
            try:
                for ev in self._stream_socket(path, payload, sid,
                                              timeout):
                    cur = ev.get("cursor")
                    if cur is not None:
                        if cur <= state["cursor"]:
                            continue       # replay overlap: already seen
                        state["cursor"] = cur
                    if ev.get("event") == "stream.open" \
                            and ev.get("stream"):
                        state["stream"] = str(ev["stream"])
                    if ev.get("event") in ("result", "error"):
                        done = True
                    yield ev
                if done:
                    return                 # terminal event: clean end
                # the socket ended WITHOUT a terminal event. A torn
                # chunked body reads as a clean EOF through
                # http.client (its peek swallows IncompleteRead), so
                # only the protocol contract — every stream ends with
                # "result" or "error" — can tell a tear from the end
            except (OSError, http.client.HTTPException,
                    ValueError) as e:
                # reset or a line torn mid-event: same recovery
                last_exc = e
            if state["stream"] is None:
                if last_exc is not None:
                    raise last_exc     # died before the id arrived
                raise ConnectionError(
                    "stream ended before a stream id arrived")
            attempts += 1
            if attempts > max(1, self._retries):
                if last_exc is not None:
                    raise last_exc
                raise ConnectionError(
                    f"stream still truncated after {attempts - 1} "
                    "resume attempts")
            self._count("resumes")
            self._backoff(attempts, None, None)
            path = "/v1/resume"
            payload = json.dumps(
                {"stream": state["stream"],
                 "cursor": state["cursor"]}).encode()

    def resume_stream(self, stream_id: str, cursor: int = -1,
                      timeout: Optional[float] = None):
        """Reattach to a resumable stream by id: replays every buffered
        event after ``cursor``, then continues live (the raw surface
        under :meth:`stream`'s auto-resume; 404 ``UnknownStream`` when
        the stream is gone or the cursor fell off the buffer)."""
        sid = self.open_session()
        body = json.dumps({"stream": str(stream_id),
                           "cursor": int(cursor)}).encode()
        yield from self._stream_socket("/v1/resume", body, sid, timeout)

    def _stream_socket(self, path: str, body: bytes, sid: str,
                       timeout: Optional[float]):
        conn = http.client.HTTPConnection(
            self.host, self.port,
            timeout=self._timeout if timeout is None else timeout)
        try:
            conn.request("POST", path, body=body,
                         headers={"Content-Type": "application/json",
                                  SESSION_HEADER: sid})
            resp = conn.getresponse()
            if resp.status != 200:
                raise_typed(resp.status,
                            self._payload(resp.status, resp.read()))
            while True:
                line = resp.readline()
                if not line:
                    return
                yield json.loads(line)
        finally:
            conn.close()

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        self._pool.shutdown(wait=True)

    def __enter__(self) -> "NetClient":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
