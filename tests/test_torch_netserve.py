"""The port's network front door over loopback on the CPU, at DOUBLE.

The JAX package's front-door tests, run on the port: every wire request
kind answered over a real socket equals the port's in-process
``SimulationService`` answer within 1e-12 (the same service backs both
paths), and the deterministic kinds equal the JAX package's in-process
answers within the serving slice's 1e-12; server failures come back as the
same typed exception family the in-process API raises, a kernel that did
not build or launch as the non-retryable server failure; streams deliver
optimizer iterates, dynamics segments and trajectory waves and cancel on
disconnect. Then the two packages across the wire: a JAX ``NetClient``
against the port's ``NetServer`` and the port's client against the JAX
package's server, on a static circuit and a QASM program, within 1e-12; a
Param circuit crosses neither way (``DigestMismatch``, 409).
"""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import quest_tpu as jq
from quest_tpu.netserve import NetClient as JNetClient
from quest_tpu.netserve import NetServer as JNetServer
from quest_tpu.serve import SimulationService as JService
import quest_tpu_torch as tq
from quest_tpu_torch.circuits import Circuit
from quest_tpu_torch.netserve import (AuthError, DigestMismatch, NetClient,
                                      NetServer, SessionGrant,
                                      StaticTokenAuth, UnknownProgram,
                                      WireError, WireFormatError, wire)
from quest_tpu_torch.ops import cuda_build
from quest_tpu_torch.ops.dynamics import EvolveSpec, GroundSpec
from quest_tpu_torch.serve import (DeadlineExceeded, QueueFull,
                                   SimulationService, TenantPolicy)
from quest_tpu_torch.serve.optimize import VariationalProblem
from torch_threads import one_blas_thread, port_lock_order  # noqa: F401

ATOL = 1e-12
T = 120


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _hea(C, num_qubits, layers=1, tag=0.0):
    """Hardware-efficient ansatz; ``tag`` bakes a distinct static angle
    in, minting a program no other test registered."""
    c = C(num_qubits)
    for layer in range(layers):
        for q in range(num_qubits):
            c.ry(q, c.parameter(f"y{layer}_{q}"))
            c.rz(q, c.parameter(f"z{layer}_{q}"))
        for q in range(num_qubits):
            c.cnot(q, (q + 1) % num_qubits)
    if tag:
        c.rz(0, tag)
    return c


def _static(C, num_qubits=3):
    c = C(num_qubits)
    for q in range(num_qubits):
        c.ry(q, 0.3 + 0.2 * q)
        c.rz(q, -0.1 * q)
    for q in range(num_qubits - 1):
        c.cnot(q, q + 1)
    c.crz(0, 2, 0.45)
    c.phase(1, 0.7)
    return c


def _noisy(C, num_qubits, p=0.02):
    c = C(num_qubits)
    for q in range(num_qubits):
        c.ry(q, c.parameter(f"t{q}"))
        c.dephase(q, p)
    for q in range(num_qubits - 1):
        c.cnot(q, q + 1)
    return c


def _ham(num_qubits):
    terms = [[(q, 3)] for q in range(num_qubits)]
    terms.append([(0, 1), (1, 1)])
    return terms, [1.0] * num_qubits + [0.5]


def _params(circuit, i):
    return {nm: 0.1 + 0.01 * i + 0.003 * j
            for j, nm in enumerate(circuit.param_names)}


QASM = ("OPENQASM 2.0;\nqreg q[2];\nh q[0];\n"
        "cx q[0],q[1];\nrz(0.25) q[1];\nry(0.5) q[0];\n")


@pytest.fixture(scope="module")
def net():
    """One port service, one loopback server, one client for the module."""

    class _Net:
        pass

    n = _Net()
    n.env = tq.createQuESTEnv(precision=tq.DOUBLE, device="cpu",
                              seed=[12345])
    with SimulationService(n.env, max_batch=8, max_wait_s=2e-3) as svc:
        n.svc = svc
        with NetServer(svc) as srv:
            n.srv = srv
            with NetClient(srv.host, srv.port) as client:
                n.client = client
                yield n


@pytest.fixture(scope="module")
def jnet():
    """The JAX package's service and server, for the reference answers
    and the cross-package pairings."""

    class _Net:
        pass

    n = _Net()
    n.env = jq.createQuESTEnv(num_devices=1, seed=[12345])
    with JService(n.env, max_batch=8, max_wait_s=2e-3) as svc:
        n.svc = svc
        with JNetServer(svc) as srv:
            n.srv = srv
            yield n


def _close(got, want):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       atol=ATOL, rtol=0)
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=ATOL, rtol=0)


KIND_FORMS = {
    "sweep": ({}, {}),
    "expectation": ({"observables": _ham(3)}, {"observables": _ham(3)}),
    "gradient": ({"observables": _ham(3), "gradient": True},
                 {"observables": _ham(3), "gradient": True}),
    "evolve": ({"observables": _ham(3),
                "evolve": EvolveSpec(t=0.4, steps=6, order=2)},
               {"observables": _ham(3),
                "evolve": {"t": 0.4, "steps": 6, "order": 2}}),
    "ground": ({"observables": _ham(3),
                "ground_state": GroundSpec(steps=4, tau=0.1)},
               {"observables": _ham(3),
                "ground": {"steps": 4, "tau": 0.1, "method": "power",
                           "tol": 1e-9}}),
}


@pytest.mark.parametrize("kind", sorted(KIND_FORMS))
def test_deterministic_kind_matches_in_process_and_reference(net, jnet,
                                                             kind):
    c = _hea(Circuit, 3)
    p = _params(c, 3)
    local, over_wire = KIND_FORMS[kind]
    want = net.svc.submit(c, p, **local).result(timeout=T)
    got = net.client.submit(c, p, **over_wire).result(timeout=T)
    _close(got, want)
    # the result holds host numpy and floats only: nothing of the card
    for part in (got if isinstance(got, tuple) else (got,)):
        assert isinstance(part, (float, np.ndarray))
    jlocal = dict(local)
    if kind == "evolve":
        from quest_tpu.ops.dynamics import EvolveSpec as JE
        jlocal["evolve"] = JE(t=0.4, steps=6, order=2)
    if kind == "ground":
        from quest_tpu.ops.dynamics import GroundSpec as JG
        jlocal["ground_state"] = JG(steps=4, tau=0.1)
    ref = jnet.svc.submit(_hea(jq.Circuit, 3), p, **jlocal).result(
        timeout=T)
    _close(got, ref)


def test_shots(net):
    c = _hea(Circuit, 3)
    p = _params(c, 2)
    # sampling draws from the env's generator: register (and warm) the
    # program first, then pin the generator so both paths draw alike
    net.client.submit(c, p, shots=4).result(timeout=T)
    state = net.env.generator.get_state()
    w_out, w_norm = net.svc.submit(c, p, shots=32).result(timeout=T)
    net.env.generator.set_state(state)
    g_out, g_norm = net.client.submit(c, p, shots=32).result(timeout=T)
    np.testing.assert_array_equal(g_out, w_out)
    assert g_out.dtype == np.int64
    assert abs(g_norm - w_norm) <= ATOL


def test_trajectory(net):
    c = _noisy(Circuit, 2)
    p = _params(c, 3)
    ham = _ham(2)
    net.client.submit(c, p, observables=ham, trajectories=4).result(
        timeout=T)
    state = net.env.generator.get_state()
    want = net.svc.submit(c, p, observables=ham,
                          trajectories=16).result(timeout=T)
    net.env.generator.set_state(state)
    got = net.client.submit(c, p, observables=ham,
                            trajectories=16).result(timeout=T)
    _close(got, want)


def test_qasm(net):
    want = net.svc.submit(tq.parse_qasm(QASM).circuit).result(timeout=T)
    got = net.client.submit(qasm=QASM, kind="sweep").result(timeout=T)
    _close(got, want)


class TestSessionsAndRegistry:
    def test_repeat_submissions_hit_the_registry(self, net):
        c = _hea(Circuit, 2, tag=0.731)
        ham = _ham(2)
        with NetClient(net.srv.host, net.srv.port) as cl:
            first = cl.submit(c, _params(c, 0),
                              observables=ham).result(timeout=T)
            for i in (1, 2):
                cl.submit(c, _params(c, i), observables=ham).result(
                    timeout=T)
            snap = {s["session"]: s for s in net.srv.sessions.snapshot()}
            sess = snap[cl.session]
        assert sess["requests"] == 3
        assert sess["program_misses"] == 1
        assert sess["program_hits"] == 2
        assert isinstance(first, float)

    def test_client_refetches_after_server_eviction(self, net):
        c = _hea(Circuit, 2, tag=0.877)
        with NetClient(net.srv.host, net.srv.port) as cl:
            want = cl.submit(c, _params(c, 0)).result(timeout=T)
            net.srv.programs._programs.clear()
            got = cl.submit(c, _params(c, 0)).result(timeout=T)
            assert cl.stats["resends"] == 1
        _close(got, want)

    def test_unknown_ref_is_typed_404(self, net):
        doc = wire.encode_request("sweep", circuit_ref="0" * 64)
        with pytest.raises(UnknownProgram):
            net.client.submit_wire(doc).result(timeout=T)

    def test_digest_mismatch_is_typed_409(self, net):
        doc = wire.encode_request("sweep", circuit=_hea(Circuit, 2))
        doc["circuit"] = dict(doc["circuit"], digest="0" * 64)
        with pytest.raises(DigestMismatch):
            net.client.submit_wire(doc).result(timeout=T)

    def test_malformed_request_is_typed_400(self, net):
        doc = wire.encode_request("sweep", circuit=_hea(Circuit, 2))
        doc["deadline_epoch"] = time.time() + 3600
        with pytest.raises(WireFormatError, match="RELATIVE"):
            net.client.submit_wire(doc).result(timeout=T)


def test_anonymous_rejected_and_token_resolves_tenant(net):
    auth = StaticTokenAuth({
        "sekrit": SessionGrant(tenant="acme",
                               policy=TenantPolicy(weight=2.0)),
    })
    with NetServer(net.svc, auth=auth, allow_anonymous=False) as srv:
        with NetClient(srv.host, srv.port) as anon:
            with pytest.raises(AuthError):
                anon.submit(_hea(Circuit, 2),
                            _params(_hea(Circuit, 2), 0)).result(timeout=T)
        with NetClient(srv.host, srv.port, token="sekrit") as cl:
            c = _hea(Circuit, 2)
            got = cl.submit(c, _params(c, 0)).result(timeout=T)
            assert cl.tenant == "acme"
            assert got.shape == (2, 4)
        assert srv.metrics.snapshot()["auth_rejections"] >= 1


def test_queue_full_is_typed_429(net):
    with SimulationService(net.env, max_queue=3, max_batch=8,
                           max_wait_s=5e-3) as svc:
        with NetServer(svc) as srv:
            with NetClient(srv.host, srv.port, retries=0) as cl:
                c = _hea(Circuit, 2)
                svc.pause()
                futs = [cl.submit(c, _params(c, i)) for i in range(3)]
                deadline = time.monotonic() + 30
                while svc.dispatch_stats()["service"]["submitted"] < 3:
                    assert time.monotonic() < deadline
                    time.sleep(0.01)
                with pytest.raises(QueueFull, match="capacity"):
                    cl.submit(c, _params(c, 3)).result(timeout=T)
                svc.resume()
                for f in futs:
                    assert f.result(timeout=T).shape == (2, 4)


def test_expired_relative_deadline_is_typed_504(net):
    with SimulationService(net.env, max_batch=8, max_wait_s=5e-3) as svc:
        with NetServer(svc) as srv:
            with NetClient(srv.host, srv.port) as cl:
                c = _hea(Circuit, 2)
                svc.pause()
                fut = cl.submit(c, _params(c, 0), timeout_s=0.05)
                deadline = time.monotonic() + 30
                while svc.dispatch_stats()["service"]["submitted"] < 1:
                    assert time.monotonic() < deadline
                    time.sleep(0.01)
                time.sleep(0.2)
                svc.resume()
                with pytest.raises(DeadlineExceeded):
                    fut.result(timeout=T)


@pytest.mark.parametrize("error", [cuda_build.KernelBuildError,
                                   cuda_build.KernelLaunchError])
def test_kernel_failure_reaches_the_client_fatal_and_unretried(
        net, monkeypatch, error):
    """A kernel that did not build or launch fails its wire request as
    the non-retryable server failure: 500, classified fatal, raised as
    ``WireError`` with no retry onto the broken card."""

    def broken(*args, **kwargs):
        raise error("the card refused the launch")

    monkeypatch.setattr(tq.CompiledCircuit, "expectation_sweep", broken)
    c = _hea(Circuit, 2, tag=0.913 + 0.01 * (error is
                                             cuda_build.KernelLaunchError))
    with SimulationService(net.env, max_batch=8) as svc:
        with NetServer(svc) as srv:
            with NetClient(srv.host, srv.port, retries=6,
                           backoff_s=0.001) as cl:
                with pytest.raises(WireError) as ei:
                    cl.submit(c, _params(c, 0), observables=_ham(2)).result(
                        timeout=T)
                assert cl.stats["retries"] == 0
            snap = svc.dispatch_stats()["service"]
    assert ei.value.status == 500
    assert error.__name__ in str(ei.value)
    assert (snap["failed_fatal"], snap["retries"]) == (1, 0)


class TestStreaming:
    HAM2 = ([[(0, 3)], [(1, 3)]], [1.0, 0.5])

    def _vqe(self):
        c = Circuit(2)
        c.ry(0, c.parameter("t0"))
        c.ry(1, c.parameter("t1"))
        return c

    def test_optimize_stream_matches_in_process(self, net):
        x0 = {"t0": 2.0, "t1": 2.0}
        h = net.svc.optimize(VariationalProblem(self._vqe(), self.HAM2, x0),
                             optimizer="gd", learning_rate=0.4,
                             max_iters=20, tol=1e-10)
        want_vals = [it["value"] for it in h.iterates()]
        want = h.result(timeout=T)
        events = list(net.client.stream(
            self._vqe(), x0, observables=self.HAM2,
            optimizer={"name": "gd", "learning_rate": 0.4,
                       "max_iters": 20, "tol": 1e-10}))
        assert events[0]["event"] == "stream.open"
        iters = [e for e in events if e["event"] == "iterate"]
        (res,) = [e for e in events if e["event"] == "result"]
        np.testing.assert_allclose([e["value"] for e in iters], want_vals,
                                   atol=ATOL, rtol=0)
        assert res["result"]["converged"] == want["converged"]
        assert abs(res["result"]["value"] - want["value"]) <= ATOL

    def test_trajectory_stream_waves_then_result(self, net):
        c = _noisy(Circuit, 2)
        p = _params(c, 7)
        ham = _ham(2)
        net.client.submit(c, p, observables=ham, trajectories=4).result(
            timeout=T)
        state = net.env.generator.get_state()
        want = net.svc.submit(c, p, observables=ham,
                              trajectories=16).result(timeout=T)
        net.env.generator.set_state(state)
        events = list(net.client.stream(c, p, observables=ham,
                                        trajectories=16))
        assert events[0]["event"] == "stream.open"
        assert any(e["event"] == "wave" for e in events)
        (res,) = [e for e in events if e["event"] == "result"]
        _close(wire.parse_result("trajectory", res["result"]), want)

    def test_evolve_stream_segments(self, net):
        c = _hea(Circuit, 2)
        events = list(net.client.stream(
            c, _params(c, 8), observables=_ham(2),
            evolve={"t": 0.4, "steps": 4, "order": 2}))
        assert any(e["event"] == "segment" for e in events)
        assert events[-1]["event"] == "result"

    def test_disconnect_cancels_server_handle(self, net):
        x0 = {"t0": 2.0, "t1": 2.0}
        before = net.srv.metrics.snapshot()["stream_cancels"]
        gen = net.client.stream(
            self._vqe(), x0, observables=self.HAM2,
            optimizer={"name": "adam", "learning_rate": 1e-3,
                       "max_iters": 5000, "tol": 0.0})
        seen = 0
        for ev in gen:
            if ev["event"] == "iterate":
                seen += 1
            if seen >= 2:
                break
        gen.close()                      # drops the socket mid-stream
        handle = net.srv._debug_last_handle
        deadline = time.monotonic() + 60
        while not handle.done:
            assert time.monotonic() < deadline, \
                "server handle kept optimizing after disconnect"
            time.sleep(0.02)
        assert len(handle.history) < 5000
        deadline = time.monotonic() + 10
        while net.srv.metrics.snapshot()["stream_cancels"] == before:
            assert time.monotonic() < deadline
            time.sleep(0.02)


class TestEndpoints:
    def _get(self, net, path):
        with urllib.request.urlopen(
                f"http://{net.srv.host}:{net.srv.port}{path}",
                timeout=30) as r:
            return r.status, r.read()

    def test_healthz_metrics_sessions(self, net):
        net.client.submit(_hea(Circuit, 2), _params(_hea(Circuit, 2), 0)
                          ).result(timeout=T)
        status, _ = self._get(net, "/healthz")
        assert status == 200
        status, body = self._get(net, "/metrics")
        assert status == 200
        assert "netserve" in body.decode()
        status, body = self._get(net, "/v1/sessions")
        assert status == 200
        doc = json.loads(body)
        assert isinstance(doc["sessions"], list)
        assert doc["programs"] >= 1

    def test_unknown_path_404(self, net):
        with pytest.raises(urllib.error.HTTPError) as ei:
            self._get(net, "/no/such/path")
        assert ei.value.code == 404


# -- across the packages ------------------------------------------------------

def test_jax_client_against_the_port_server(net, jnet):
    with JNetClient(net.srv.host, net.srv.port) as cl:
        got = cl.submit(_static(jq.Circuit)).result(timeout=T)
        want = net.svc.submit(_static(Circuit)).result(timeout=T)
        ref = jnet.svc.submit(_static(jq.Circuit)).result(timeout=T)
        _close(got, want)
        _close(got, ref)
        ham = _ham(3)
        got = cl.submit(_static(jq.Circuit), observables=ham).result(
            timeout=T)
        _close(got, net.svc.submit(_static(Circuit),
                                   observables=ham).result(timeout=T))
        got = cl.submit(qasm=QASM, kind="sweep").result(timeout=T)
        _close(got, net.svc.submit(tq.parse_qasm(QASM).circuit).result(
            timeout=T))
        # a repeat rides the digest the port server acknowledged
        cl.submit(_static(jq.Circuit)).result(timeout=T)
        from quest_tpu.netserve import DigestMismatch as JDigestMismatch
        with pytest.raises(JDigestMismatch):
            cl.submit(_hea(jq.Circuit, 2), _params(_hea(jq.Circuit, 2), 0)
                      ).result(timeout=T)


def test_port_client_against_the_jax_server(net, jnet):
    with NetClient(jnet.srv.host, jnet.srv.port) as cl:
        got = cl.submit(_static(Circuit)).result(timeout=T)
        _close(got, jnet.svc.submit(_static(jq.Circuit)).result(timeout=T))
        _close(got, net.svc.submit(_static(Circuit)).result(timeout=T))
        ham = _ham(3)
        got = cl.submit(_static(Circuit), observables=ham).result(timeout=T)
        _close(got, jnet.svc.submit(_static(jq.Circuit),
                                    observables=ham).result(timeout=T))
        got = cl.submit(qasm=QASM, kind="sweep").result(timeout=T)
        _close(got, jnet.svc.submit(jq.parse_qasm(QASM).circuit).result(
            timeout=T))
        with pytest.raises(DigestMismatch) as ei:
            cl.submit(_hea(Circuit, 2), _params(_hea(Circuit, 2), 0)
                      ).result(timeout=T)
        assert ei.value.detail["claimed"] != ei.value.detail["computed"]
