"""The port's hardened front door, on the CPU.

The JAX package's wire-hardening tests, run on the port: the read deadline
(408), the connection cap (503), the per-session token bucket (429 with
``Retry-After``), priority-aware shedding that never touches priority 0,
request-id dedup with zero double dispatches under injected resets, torn
bodies and duplicate deliveries, a bit-exact resume of a torn stream,
drain and restart with the sessions and programs readmitted, TTL 401
recovery, registry races under the port's lock-order check, and the router
as backend. Each condition is made deterministic: a backend stub whose
queue depth the test sets, a paused service, a token bucket that cannot
refill within the test, faults injected at fixed calls, and ``port=0``.
"""

import http.client
import json
import socket
import threading
import time
import urllib.request
from concurrent.futures import Future

import numpy as np
import pytest
import torch

import quest_tpu_torch as tq
from quest_tpu_torch.circuits import Circuit
from quest_tpu_torch.netserve import (NetClient, NetServer, ProgramRegistry,
                                      RateLimited, ServerOverloaded,
                                      SessionExpired, SessionManager,
                                      UnknownProgram, UnknownStream,
                                      WireError, wire)
from quest_tpu_torch.netserve.server import SESSION_HEADER
from quest_tpu_torch.resilience import (FaultInjector, FaultSpec,
                                        SupervisorPolicy, faults)
from quest_tpu_torch.serve import (DeadlineExceeded, QueueFull,
                                   ServiceRouter, SimulationService,
                                   replica_envs)
from quest_tpu_torch.serve.warmcache import circuit_digest
from torch_threads import one_blas_thread, port_lock_order  # noqa: F401

ATOL = 1e-12
T = 120


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _hea(num_qubits, layers=1, tag=0.0):
    c = Circuit(num_qubits)
    for layer in range(layers):
        for q in range(num_qubits):
            c.ry(q, c.parameter(f"y{layer}_{q}"))
            c.rz(q, c.parameter(f"z{layer}_{q}"))
        for q in range(num_qubits):
            c.cnot(q, (q + 1) % num_qubits)
    if tag:
        c.rz(0, tag)
    return c


def _ham(num_qubits):
    terms = [[(q, 3)] for q in range(num_qubits)]
    terms.append([(0, 1), (1, 1)])
    return terms, [1.0] * num_qubits + [0.5]


def _params(circuit, i):
    return {nm: 0.1 + 0.01 * i + 0.003 * j
            for j, nm in enumerate(circuit.param_names)}


def _close(got, want):
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       atol=ATOL, rtol=0)
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=ATOL, rtol=0)


def _post(host, port, path, doc, sid=None, timeout=T):
    """One raw POST: ``(status, payload, lowercase headers)``."""
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        hdrs = {"Content-Type": "application/json"}
        if sid is not None:
            hdrs[SESSION_HEADER] = sid
        body = doc if isinstance(doc, bytes) \
            else wire.canonical_json(doc).encode()
        conn.request("POST", path, body=body, headers=hdrs)
        r = conn.getresponse()
        data = r.read()
        return (r.status, json.loads(data) if data else {},
                {k.lower(): v for k, v in r.getheaders()})
    finally:
        conn.close()


def _until(cond, what, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


class _CountingBackend:
    """A submit-counting proxy around the service: the ground truth for
    how many times a request really dispatched."""

    def __init__(self, svc):
        self._svc = svc
        self.dispatched = 0
        self._count_lock = threading.Lock()

    def submit(self, *args, **kwargs):
        with self._count_lock:
            self.dispatched += 1
        return self._svc.submit(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._svc, name)


class _DeepQueueBackend:
    """A backend stub whose queue depth the test sets (``_backlog``, the
    attribute the shed check reads) and which answers every admitted
    request at once with its priority: shedding becomes a pure function
    of depth and priority, with no timing in it."""

    def __init__(self, depth):
        self._backlog = depth
        self._inflight = 0
        self.admitted = []

    def submit(self, circuit, params=None, **kw):
        self.admitted.append(kw.get("priority"))
        f = Future()
        f.set_result(float(kw.get("priority") or 0))
        return f


@pytest.fixture(scope="module")
def net():
    class _Net:
        pass

    n = _Net()
    n.env = tq.createQuESTEnv(precision=tq.DOUBLE, device="cpu",
                              seed=[20252])
    with SimulationService(n.env, max_batch=8, max_wait_s=2e-3) as svc:
        n.svc = svc
        with NetServer(svc) as srv:
            n.srv = srv
            with NetClient(srv.host, srv.port, retry_seed=7) as client:
                n.client = client
                yield n


# -- overload protection ------------------------------------------------------

class TestOverloadProtection:
    def test_slow_loris_answers_408(self, net):
        with NetServer(net.svc, read_timeout_s=0.3) as srv:
            s = socket.create_connection((srv.host, srv.port), timeout=30)
            try:
                s.sendall(b"POST /v1/submit HTTP/1.1\r\n"
                          b"Content-Length: 64\r\n")
                # ... and never finish the headers
                s.settimeout(10)
                chunks = []
                while True:
                    b = s.recv(65536)
                    if not b:
                        break
                    chunks.append(b)
            finally:
                s.close()
            data = b"".join(chunks)
            assert b" 408 " in data.split(b"\r\n", 1)[0]
            assert b"retry-after" in data.lower()
            assert b"RequestTimeout" in data
            assert srv.metrics.get("read_timeouts") == 1

    def test_idle_keep_alive_closed_silently(self, net):
        with NetServer(net.svc, read_timeout_s=0.2) as srv:
            s = socket.create_connection((srv.host, srv.port), timeout=30)
            try:
                s.settimeout(10)
                assert s.recv(4096) == b""
            finally:
                s.close()
            assert srv.metrics.get("read_timeouts") == 0

    def test_connection_cap_answers_503(self, net):
        with NetServer(net.svc, max_connections=2,
                       read_timeout_s=30.0) as srv:
            holders = [socket.create_connection((srv.host, srv.port),
                                                timeout=30)
                       for _ in range(2)]
            try:
                _until(lambda: srv._conn_open == 2,
                       "the two holders were never accepted")
                s = socket.create_connection((srv.host, srv.port),
                                             timeout=30)
                try:
                    s.settimeout(10)
                    data = s.recv(65536)
                finally:
                    s.close()
                assert b" 503 " in data.split(b"\r\n", 1)[0]
                assert b"ServerOverloaded" in data
                assert srv.metrics.get("conn_rejected") == 1
            finally:
                for h in holders:
                    h.close()

    def test_rate_limit_429_with_retry_after(self, net):
        # one token, refilled once in 1000 s: the second request is
        # always over the limit
        with NetServer(net.svc, rate_limit=(1e-3, 1)) as srv:
            with NetClient(srv.host, srv.port, retries=0) as cl:
                c = _hea(2, tag=0.31)
                p = _params(c, 0)
                cl.submit(c, p).result(timeout=T)
                doc = wire.encode_request("sweep",
                                          circuit=wire.encode_circuit(c),
                                          params=p, timeout_s=60.0)
                status, payload, hdrs = _post(srv.host, srv.port,
                                              "/v1/submit", doc,
                                              sid=cl.session)
                assert status == 429
                assert payload["error"]["type"] == "RateLimited"
                assert payload["error"]["classification"] == "transient"
                assert float(hdrs["retry-after"]) > 0
                assert payload["error"]["detail"]["retry_after_s"] > 0
                with pytest.raises(RateLimited) as ei:
                    cl.submit(c, p).result(timeout=T)
                assert ei.value.detail["retry_after_s"] > 0
                assert srv.metrics.get("rate_limited") == 2

    def test_rate_limited_client_retries_through(self, net):
        with NetServer(net.svc, rate_limit=(50.0, 2)) as srv:
            with NetClient(srv.host, srv.port, retries=8, backoff_s=0.01,
                           retry_seed=3) as cl:
                c = _hea(2, tag=0.32)
                want = net.svc.submit(c, _params(c, 0)).result(timeout=T)
                futs = [cl.submit(c, _params(c, 0), timeout_s=120.0)
                        for _ in range(10)]
                for f in futs:
                    _close(f.result(timeout=T), want)
                assert cl.stats["retries"] >= 1

    def test_shedding_never_touches_priority_zero(self):
        """Past the watermark every sheddable request answers 429 with a
        ``Retry-After`` from the backlog estimate, and priority 0 is
        admitted every time."""
        stub = _DeepQueueBackend(depth=8)
        with NetServer(stub, shed_watermark=2,
                       warm_on_register=False) as srv:
            with NetClient(srv.host, srv.port, retries=0) as cl:
                c = _hea(2, tag=0.33)
                for i in range(4):
                    assert cl.submit(c, _params(c, i), priority=0).result(
                        timeout=T) == 0.0
                    for prio in (1, 2, None):
                        with pytest.raises(ServerOverloaded) as ei:
                            cl.submit(c, _params(c, i),
                                      priority=prio).result(timeout=T)
                        assert ei.value.detail["queue_depth"] == 8
                        assert ei.value.detail["retry_after_s"] > 0
                doc = wire.encode_request("sweep", circuit=c,
                                          params=_params(c, 0), priority=2)
                status, payload, hdrs = _post(srv.host, srv.port,
                                              "/v1/submit", doc,
                                              sid=cl.session)
                assert status == 429 and float(hdrs["retry-after"]) > 0
            assert stub.admitted == [0, 0, 0, 0]
            assert srv.metrics.get("load_shed") == 13
            stub._backlog = 1                       # below the watermark
            with NetClient(srv.host, srv.port, retries=0) as cl:
                assert cl.submit(c, _params(c, 0), priority=2).result(
                    timeout=T) == 2.0

    def test_priority_zero_admitted_over_a_real_backlog(self, net):
        """The same bar over the port's service: a paused service holding
        a backlog past the watermark sheds priority 2 and admits priority
        0, which completes with parity once the service resumes."""
        c = _hea(3, tag=0.34)
        want = net.svc.submit(c, _params(c, 0)).result(timeout=T)
        with NetServer(net.svc, shed_watermark=3) as srv:
            with NetClient(srv.host, srv.port, retries=0) as cl:
                cl.submit(c, _params(c, 1)).result(timeout=T)   # register
                net.svc.pause()
                try:
                    held = [net.svc.submit(c, _params(c, 2))
                            for _ in range(4)]
                    with pytest.raises(ServerOverloaded):
                        cl.submit(c, _params(c, 0), priority=2).result(
                            timeout=T)
                    ui = cl.submit(c, _params(c, 0), priority=0)
                    _until(lambda: net.svc._backlog == 5,
                           "the priority-0 request never reached the queue")
                finally:
                    net.svc.resume()
                _close(ui.result(timeout=T), want)
                for f in held:
                    f.result(timeout=T)
            assert srv.metrics.get("load_shed") == 1


# -- idempotent retries -------------------------------------------------------

class TestIdempotentRetries:
    def test_duplicate_request_id_dispatches_once(self, net):
        bk = _CountingBackend(net.svc)
        with NetServer(bk) as srv:
            with NetClient(srv.host, srv.port, retries=0) as cl:
                c = _hea(2, tag=0.41)
                p = _params(c, 1)
                rid = "rid-chaos-dup-1"
                a = cl.submit(c, p, request_id=rid).result(timeout=T)
                before = bk.dispatched
                b = cl.submit(c, p, request_id=rid).result(timeout=T)
                np.testing.assert_array_equal(a, b)
                assert bk.dispatched == before
                snap = srv.dedup.snapshot()
                assert snap["replays"] == 1
                assert snap["double_dispatches"] == 0
                assert srv.metrics.get("dedup_hits") == 1

    def test_concurrent_duplicates_join_one_dispatch(self, net):
        bk = _CountingBackend(net.svc)
        with NetServer(bk) as srv:
            with NetClient(srv.host, srv.port, retries=0) as cl:
                c = _hea(2, tag=0.42)
                p = _params(c, 2)
                cl.submit(c, p).result(timeout=T)      # warm + ref
                before = bk.dispatched
                rid = "rid-chaos-join-1"
                net.svc.pause()
                try:
                    f1 = cl.submit(c, p, request_id=rid)
                    f2 = cl.submit(c, p, request_id=rid)
                    _until(lambda: srv.dedup.snapshot()["joins"] == 1,
                           "the duplicate never joined the original")
                finally:
                    net.svc.resume()
                np.testing.assert_array_equal(f1.result(timeout=T),
                                              f2.result(timeout=T))
                assert bk.dispatched == before + 1
                assert srv.dedup.snapshot()["double_dispatches"] == 0

    def test_failed_attempt_is_not_pinned(self, net):
        with NetServer(net.svc) as srv:
            with NetClient(srv.host, srv.port, retries=0) as cl:
                c = _hea(2, tag=0.43)
                p = _params(c, 3)
                rid = "rid-chaos-notpin-1"
                ghost = circuit_digest(_hea(2, tag=0.431))
                bad = wire.encode_request("sweep", circuit_ref=ghost,
                                          params=p, timeout_s=60.0,
                                          request_id=rid)
                with pytest.raises(UnknownProgram):
                    cl.submit_wire(bad).result(timeout=T)
                want = net.svc.submit(c, p).result(timeout=T)
                got = cl.submit(c, p, request_id=rid).result(timeout=T)
                _close(got, want)
                assert srv.dedup.snapshot()["double_dispatches"] == 0

    @pytest.mark.parametrize("kind", ["conn_reset", "torn_body",
                                      "dup_delivery", "stale_ref",
                                      "slow_read"])
    def test_each_wire_fault_never_double_dispatches(self, net, kind):
        """One fault of each wire kind on the second request: the answer
        keeps parity, and the request dispatched exactly once."""
        bk = _CountingBackend(net.svc)
        inj = FaultInjector([FaultSpec(kind, site="netserve.request",
                                       at_calls=(1,))], seed=5,
                            stall_s=0.01)
        with NetServer(bk) as srv:
            with NetClient(srv.host, srv.port, retries=4, backoff_s=0.01,
                           retry_seed=11) as cl:
                c = _hea(2, tag=0.44)
                p = _params(c, 4)
                want = net.svc.submit(c, p).result(timeout=T)
                with faults.inject(inj):
                    cl.submit(c, p).result(timeout=T)       # call 0: clean
                    before = bk.dispatched
                    got = cl.submit(c, p).result(timeout=T)  # call 1
                _close(got, want)
                assert inj.total_injected == 1
                assert bk.dispatched == before + 1
                snap = srv.dedup.snapshot()
                assert snap["double_dispatches"] == 0
                if kind in ("conn_reset", "torn_body"):
                    assert cl.stats["retries"] == 1
                    assert snap["replays"] == 1
                if kind == "dup_delivery":
                    assert snap["replays"] == 1
                if kind == "stale_ref":
                    assert cl.stats["resends"] == 1
            assert srv.metrics.get("wire_faults") == 1

    def test_seeded_storm_zero_double_dispatches(self, net):
        """Every wire kind at a seeded rate over 96 requests: each
        completed request equals its fault-free value, every other one
        fails typed, and no request dispatched twice."""
        c = _hea(3)
        ham = _ham(3)

        def req(i):
            p = _params(c, i)
            which = i % 3
            if which == 0:
                return dict(circuit=c, params=p)
            if which == 1:
                return dict(circuit=c, params=p, observables=ham)
            return dict(circuit=c, params=p, observables=ham, gradient=True)

        n = 96
        want = [f.result(timeout=T) for f in
                [net.svc.submit(**req(i)) for i in range(n)]]
        bk = _CountingBackend(net.svc)
        inj = FaultInjector([FaultSpec(kind, site="netserve.request",
                                       probability=0.08)
                             for kind in faults.WIRE_KINDS], seed=20,
                            stall_s=0.01)
        typed = (WireError, QueueFull, DeadlineExceeded)
        ok = 0
        with NetServer(bk) as srv:
            with NetClient(srv.host, srv.port, retries=6, backoff_s=0.005,
                           retry_seed=41) as cl:
                with faults.inject(inj):
                    futs = [cl.submit(**req(i), timeout_s=300.0)
                            for i in range(n)]
                    for i, f in enumerate(futs):
                        try:
                            got = f.result(timeout=T)
                        except typed:
                            continue
                        _close(got, want[i])
                        ok += 1
                snap = srv.dedup.snapshot()
            stats = cl.stats
        fired = inj.snapshot()
        assert fired["total_injected"] >= 20, fired
        for kind in faults.WIRE_KINDS:
            assert fired["injected_by_kind"].get(kind, 0) >= 1, fired
        assert ok >= n - 4
        assert snap["double_dispatches"] == 0
        assert stats["retries"] >= 1
        assert snap["replays"] + snap["joins"] >= 1

    def test_exhausted_budget_raises_deadline_exceeded(self, net):
        with NetServer(net.svc) as srv:
            cl = NetClient(srv.host, srv.port, retries=3, backoff_s=0.05,
                           retry_seed=13)
            try:
                c = _hea(2, tag=0.45)
                p = _params(c, 5)
                cl.submit(c, p).result(timeout=T)
                srv.close()                           # server goes away
                with pytest.raises(DeadlineExceeded):
                    cl.submit(c, p, timeout_s=0.5).result(timeout=60)
            finally:
                cl.close()

    def test_exhausted_budget_surfaces_last_typed_error(self, net):
        with NetServer(net.svc, rate_limit=(1e-3, 1)) as srv:
            with NetClient(srv.host, srv.port, retries=10, backoff_s=0.01,
                           retry_seed=17) as cl:
                c = _hea(2, tag=0.46)
                p = _params(c, 6)
                cl.submit(c, p).result(timeout=T)
                with pytest.raises(RateLimited):
                    cl.submit(c, p, timeout_s=0.5).result(timeout=60)


# -- resumable streams --------------------------------------------------------

class TestResumableStreams:
    HAM2 = ([[(0, 3)], [(1, 3)]], [1.0, 0.5])
    OPTIM = {"name": "gd", "learning_rate": 0.4, "max_iters": 30,
             "tol": 1e-10}
    X0 = {"t0": 2.0, "t1": 2.0}

    def _vqe(self):
        c = Circuit(2)
        c.ry(0, c.parameter("t0"))
        c.ry(1, c.parameter("t1"))
        return c

    @staticmethod
    def _strip(events):
        # timestamps and stream ids differ across runs by construction
        return [{k: v for k, v in e.items()
                 if k not in ("t", "wall", "stream")} for e in events]

    def _stream(self, client):
        return client.stream(self._vqe(), self.X0, observables=self.HAM2,
                             optimizer=self.OPTIM, resumable=True)

    def test_every_event_carries_a_monotone_cursor(self, net):
        events = list(self._stream(net.client))
        assert [e["cursor"] for e in events] == list(range(len(events)))
        assert events[0]["event"] == "stream.open"
        assert events[0]["resumable"] is True and events[0]["stream"]
        assert events[-1]["event"] == "result"

    def test_reconnect_resumes_bit_exact(self, net):
        base = list(self._stream(net.client))
        assert len(base) > 10
        cancels_before = net.srv.metrics.get("stream_cancels")
        gen = self._stream(net.client)
        prefix = [next(gen) for _ in range(5)]
        gen.close()                       # tears the socket mid-run
        rs = net.srv._streams[prefix[0]["stream"]]
        _until(lambda: not rs.attached(), "the server never saw the "
               "client go")
        tail = list(net.client.resume_stream(prefix[0]["stream"],
                                             prefix[-1]["cursor"]))
        assert self._strip(prefix + tail) == self._strip(base)
        assert net.srv.metrics.get("stream_cancels") == cancels_before
        assert net.srv.metrics.get("streams_resumed") >= 1

    def test_client_auto_resumes_through_torn_stream(self, net):
        base = list(self._stream(net.client))
        with NetClient(net.srv.host, net.srv.port, retries=4,
                       backoff_s=0.01, retry_seed=23) as cl:
            inj = FaultInjector([FaultSpec("torn_body",
                                           site="netserve.stream",
                                           at_calls=(0,))], seed=9)
            with faults.inject(inj):
                got = list(self._stream(cl))
            assert inj.total_injected == 1
            assert cl.stats["resumes"] >= 1
            assert self._strip(got) == self._strip(base)

    def test_resume_unknown_stream_is_typed_404(self, net):
        with pytest.raises(UnknownStream):
            list(net.client.resume_stream("st-no-such-stream"))

    def test_cursor_fallen_off_buffer_is_typed_404(self, net):
        with NetServer(net.svc, resume_buffer=4) as srv:
            with NetClient(srv.host, srv.port) as cl:
                gen = self._stream(cl)
                first = next(gen)
                gen.close()
                handle = srv._debug_last_handle
                _until(lambda: handle.done, "the run never finished", T)
                with pytest.raises(UnknownStream):
                    list(cl.resume_stream(first["stream"], cursor=0))


# -- drain and restart --------------------------------------------------------

class TestDrainAndRestart:
    def test_drain_flips_ready_and_refuses_new_conns(self, net, tmp_path):
        with NetServer(net.svc,
                       state_path=str(tmp_path / "state.json")) as srv:
            conn = http.client.HTTPConnection(srv.host, srv.port,
                                              timeout=60)
            try:
                conn.request("GET", "/healthz/ready")
                r = conn.getresponse()
                assert r.status == 200
                assert json.loads(r.read())["ready"] is True
                assert srv.drain()["persisted"] is True
                conn.request("GET", "/healthz/ready")
                r = conn.getresponse()
                doc = json.loads(r.read())
                assert r.status == 503
                assert doc["ready"] is False and doc["draining"] is True
                conn.request("GET", "/healthz/live")
                r = conn.getresponse()
                assert r.status == 200
                r.read()
            finally:
                conn.close()
            with pytest.raises(OSError):
                socket.create_connection((srv.host, srv.port),
                                         timeout=5).close()
            assert srv.metrics.get("drains") == 1

    def test_restart_readmits_sessions_and_programs(self, net, tmp_path):
        state = str(tmp_path / "handover.json")
        c = _hea(3, tag=0.51)
        p = _params(c, 7)
        want = net.svc.submit(c, p).result(timeout=T)
        with NetServer(net.svc, state_path=state) as srv1:
            with NetClient(srv1.host, srv1.port) as cl:
                _close(cl.submit(c, p).result(timeout=T), want)
                sid = cl.session
                digest = cl.last_program
                assert digest == circuit_digest(c)
                (before,) = [s for s in srv1.sessions.snapshot()
                             if s["session"] == sid]
                summary = srv1.drain()
        assert summary["persisted"] is True
        assert summary["sessions"] >= 1 and summary["programs"] >= 1
        with NetServer(net.svc, state_path=state) as srv2:
            assert srv2.restored == {"sessions": summary["sessions"],
                                     "programs": summary["programs"]}
            assert srv2.metrics.get("programs_restored") \
                == summary["programs"]
            doc = wire.encode_request("sweep", circuit_ref=digest,
                                      params=p, timeout_s=120.0)
            status, payload, _ = _post(srv2.host, srv2.port, "/v1/submit",
                                       doc, sid=sid)
            assert status == 200, payload
            _close(wire.parse_result("sweep", payload["result"]), want)
            with urllib.request.urlopen(
                    f"http://{srv2.host}:{srv2.port}/v1/sessions",
                    timeout=30) as r:
                doc = json.loads(r.read())
            (row,) = [s for s in doc["sessions"] if s["session"] == sid]
            assert row["program_misses"] == before["program_misses"]
            assert row["program_hits"] == before["program_hits"] + 1

    def test_drain_waits_for_inflight(self, net, tmp_path):
        with NetServer(net.svc,
                       state_path=str(tmp_path / "wait.json")) as srv:
            with NetClient(srv.host, srv.port) as cl:
                c = _hea(2, tag=0.52)
                p = _params(c, 8)
                want = cl.submit(c, p).result(timeout=T)
                net.svc.pause()
                try:
                    fut = cl.submit(c, p)
                    _until(lambda: srv._inflight == 1,
                           "the request never reached the server")
                    done = []
                    t = threading.Thread(
                        target=lambda: done.append(srv.drain(timeout=60)))
                    t.start()
                    t.join(0.2)
                    assert not done                    # drain is waiting
                finally:
                    net.svc.resume()
                t.join(timeout=T)
                assert done and done[0]["persisted"] is True
                _close(fut.result(timeout=T), want)


# -- session TTL --------------------------------------------------------------

class TestSessionTTL:
    def test_idle_sessions_evict_with_accounting(self, net):
        now = [1000.0]
        m = SessionManager(None, net.svc, ttl_s=10.0, clock=lambda: now[0])
        s = m.open(None)
        s.hits += 3
        s.misses += 1
        assert m.resolve(s.id) is s
        now[0] += 11.0
        other = m.open(None)
        assert m.resolve(other.id) is other
        with pytest.raises(SessionExpired):
            m.resolve(s.id)
        summary = m.evicted_summary()
        assert summary["sessions"] == 1
        assert (summary["program_hits"], summary["program_misses"]) == \
            (3, 1)

    def test_expired_session_is_typed_401_and_client_reopens(self, net):
        with NetServer(net.svc, session_ttl_s=0.2) as srv:
            c = _hea(2, tag=0.61)
            p = _params(c, 9)
            want = net.svc.submit(c, p).result(timeout=T)
            with NetClient(srv.host, srv.port, retries=0) as cl0:
                cl0.submit(c, p).result(timeout=T)
                time.sleep(0.5)                  # past the idle TTL
                with pytest.raises(SessionExpired):
                    cl0.submit(c, p).result(timeout=T)
            with NetClient(srv.host, srv.port, retries=3, backoff_s=0.01,
                           retry_seed=31) as cl:
                cl.submit(c, p).result(timeout=T)
                first_sid = cl.session
                time.sleep(0.5)
                _close(cl.submit(c, p).result(timeout=T), want)
                assert cl.stats["session_reopens"] >= 1
                assert cl.session != first_sid
            assert srv.metrics.get("sessions_expired") >= 1


# -- registry races -----------------------------------------------------------

class TestRegistryRaces:
    def test_threaded_register_evict_lookup_hammer(self):
        reg = ProgramRegistry(max_programs=16)
        circuits = [_hea(2, tag=0.01 * (i + 1)) for i in range(24)]
        digests = [circuit_digest(c) for c in circuits]
        assert len(set(digests)) == len(digests)
        errors = []

        def worker(seed):
            rng = np.random.default_rng(seed)
            try:
                for _ in range(2000):
                    i = int(rng.integers(len(circuits)))
                    op = int(rng.integers(4))
                    if op == 0:
                        reg.register(digests[i], circuits[i])
                    elif op == 1:
                        reg.evict(digests[i])
                    elif op == 2:
                        try:
                            got = reg.lookup(digests[i])
                        except UnknownProgram:
                            got = reg.get(digests[i])
                        assert got is None or got is circuits[i]
                    else:
                        for d, circ in reg.items():
                            assert circ is circuits[digests.index(d)]
            except Exception as e:   # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(s,))
                   for s in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors
        assert len(reg) <= 16
        seen = [d for d, _ in reg.items()]
        assert len(seen) == len(set(seen))

    def test_eviction_race_self_heals_over_the_wire(self, net):
        with NetServer(net.svc) as srv:
            with NetClient(srv.host, srv.port, retries=2, backoff_s=0.01,
                           retry_seed=37) as cl:
                c = _hea(2, tag=0.71)
                p = _params(c, 10)
                want = net.svc.submit(c, p).result(timeout=T)
                cl.submit(c, p).result(timeout=T)
                digest = cl.last_program
                for _ in range(4):
                    srv.programs.evict(digest)
                    _close(cl.submit(c, p).result(timeout=T), want)
                assert cl.stats["resends"] == 4
                stop = threading.Event()

                def evictor():
                    while not stop.is_set():
                        srv.programs.evict(digest)
                        time.sleep(0.002)

                t = threading.Thread(target=evictor, daemon=True)
                t.start()
                try:
                    futs = [cl.submit(c, p) for _ in range(16)]
                    for f in futs:
                        _close(f.result(timeout=T), want)
                finally:
                    stop.set()
                    t.join(timeout=60)


# -- the router as backend ----------------------------------------------------

def test_router_backend_zero_dropped_across_rolling_restart():
    """Socket traffic through a 2-replica router while
    ``rolling_restart()`` cycles every replica: every request answers with
    parity and none is dropped."""
    c = _hea(3)
    ham = _ham(3)
    envs = replica_envs(2, precision=tq.DOUBLE, seed=[7], device="cpu")
    sup = SupervisorPolicy(poll_s=0.01, stall_timeout_s=2.0,
                           restart_backoff_s=0.02, probe_timeout_s=60.0,
                           probe_batch=2)
    results = [None] * 32
    errors = []
    with ServiceRouter(envs, supervisor=sup, max_batch=8, max_wait_s=2e-3,
                       request_timeout_s=120.0) as router:
        router.warm(c, batch_sizes=(8,), observables=ham)
        want = router.submit(c, _params(c, 0), observables=ham).result(
            timeout=T)
        with NetServer(router) as srv:
            with NetClient(srv.host, srv.port, retries=6, backoff_s=0.02,
                           retry_seed=29) as cl:
                started = threading.Event()

                def traffic():
                    try:
                        for i in range(len(results)):
                            results[i] = cl.submit(
                                c, _params(c, 0), observables=ham,
                                timeout_s=120.0).result(timeout=T)
                            started.set()
                    except Exception as e:   # noqa: BLE001
                        errors.append(e)
                    finally:
                        started.set()

                t = threading.Thread(target=traffic)
                t.start()
                started.wait(T)               # traffic in flight
                acct = router.rolling_restart(timeout_per_replica=120.0)
                t.join(timeout=300)
            wire_stats = srv.metrics.snapshot()
        st = router.dispatch_stats()
    assert not errors, errors
    assert all(r["ok"] for r in acct["replicas"]), acct
    assert st["router"]["replica_restarts"] >= 2
    for i, r in enumerate(results):
        assert r is not None, f"request {i} dropped"
        assert abs(r - want) <= ATOL, f"request {i}"
    assert wire_stats["requests_expectation"] == len(results)
