"""The port's replicated router against the JAX package's, on the CPU.

Replicas share one device (``replica_envs``: the JAX package's
shared-devices mode). The router's answers equal a direct
``expectation_sweep`` and the JAX package's at 1e-12; then its
behaviours, mirroring ``tests/test_router.py``: a crash mid-trace fails
over and the replica is restarted, probed and readmitted; a stall
quarantines the replica; a failed-over request keeps its absolute
deadline; the probe keeps a wrong replica out; hedging resolves a stuck
request; a rolling restart drops nothing; routing avoids an open breaker;
a refused kernel launch reaches the caller typed, with no failover; a
restart rides the shared warm cache; the pool scales; and
``RouterMetrics`` has the JAX package's keys.

The JAX package's router tests that fail on this tree are load-sensitive
timing oracles; these assert on events and counters only, never on rates
or sleeps, and every ``result()`` has a timeout of 30 s.
"""

import threading
import time

import numpy as np
import pytest
import torch

import quest_tpu as jq
from quest_tpu.serve.metrics import RouterMetrics as JRouterMetrics
import quest_tpu_torch as tq
from quest_tpu_torch.ops import cuda_build
from quest_tpu_torch.ops import layer_kernel as lk
from quest_tpu_torch.resilience import SupervisorPolicy
from quest_tpu_torch.serve import (AllReplicasUnavailable, CoalescePolicy,
                                   DeadlineExceeded, RouterMetrics,
                                   ServiceClosed, ServiceRouter, WarmCache,
                                   replica_envs)
from torch_threads import one_blas_thread, port_lock_order  # noqa: F401

TOL = 1e-12
TIMEOUT = 30


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def hea(C, n, layers=1):
    c = C(n)
    for layer in range(layers):
        for q in range(n):
            c.ry(q, c.parameter(f"y{layer}_{q}"))
            c.rz(q, c.parameter(f"z{layer}_{q}"))
        for q in range(n - 1):
            c.cnot(q, q + 1)
    return c


def z_ham(n):
    return ([[(q, 3)] for q in range(n)], [1.0] * n)


def envs(k=2, seed=7):
    return replica_envs(k, precision=tq.DOUBLE, seed=[seed], device="cpu")


def oracle(c, pm, ham):
    env = tq.createQuESTEnv(device="cpu", precision=tq.DOUBLE, seed=[99])
    return c.compile(env).expectation_sweep(np.asarray(pm), ham)


def supervisor(**kw):
    # stall_timeout 2 s: far above a warmed dispatch of these programs,
    # so only an injected wedge reads as a stall
    base = dict(poll_s=0.01, stall_timeout_s=2.0, restart_backoff_s=0.02,
                probe_timeout_s=TIMEOUT, probe_batch=2)
    base.update(kw)
    return SupervisorPolicy(**base)


def wait_for(pred, timeout=TIMEOUT):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.01)
    return False


def readmitted(router, count=1):
    return wait_for(lambda: router.metrics.snapshot()["readmissions"]
                    >= count and all(h.state == "ready"
                                     for h in router._replicas))


def results(futs):
    return [f.result(timeout=TIMEOUT) for f in futs]


def events(router):
    # one C-level copy: the supervisor appends from its own thread
    return [e["event"] for e in list(router.events)]


class TestReplicaEnvs:
    def test_replicas_share_the_device(self):
        es = envs(3)
        assert [e.num_devices for e in es] == [1, 1, 1]
        assert all(e.device == torch.device("cpu") for e in es)
        assert all(e.precision is tq.DOUBLE for e in es)
        draws = [e.uniform() for e in es]
        assert len(set(draws)) == 3          # seed + [i] per replica
        again = [e.uniform() for e in envs(3)]
        assert again == draws
        assert len(replica_envs(2, devices_per_replica=1,
                                device="cpu")) == 2

    def test_validation(self):
        with pytest.raises(ValueError):
            replica_envs(0, device="cpu")
        with pytest.raises(ValueError, match="power of 2"):
            replica_envs(2, devices_per_replica=3, device="cpu")
        # k > 1: each replica a k-shard mesh over the device repeated
        es = replica_envs(2, devices_per_replica=2, device="cpu")
        assert [e.num_devices for e in es] == [2, 2]
        assert all(e.mesh.devices == (torch.device("cpu"),) * 2
                   for e in es)


class TestRouterOracle:
    def test_concurrent_parity_with_the_engine_and_jax(self):
        """4 threads x 8 requests over 2 replicas: every energy equals a
        direct expectation_sweep and the JAX package's at 1e-12, and both
        replicas serve."""
        n = 5
        rng = np.random.default_rng(1)
        c = hea(tq.Circuit, n)
        ham = z_ham(n)
        pm = rng.uniform(0, 2 * np.pi, size=(32, len(c.param_names)))
        want = oracle(c, pm, ham)
        jcc = hea(jq.Circuit, n).compile(
            jq.createQuESTEnv(num_devices=1, precision=jq.DOUBLE,
                              seed=[99]))
        jwant = np.asarray(jcc.expectation_sweep(pm, ham))
        got = [None] * len(pm)
        errors = []
        with ServiceRouter(envs(), supervisor=supervisor(), max_batch=8,
                           max_wait_s=5e-3) as router:
            router.warm(c, batch_sizes=(8,), observables=ham)

            def worker(tid):
                try:
                    futs = [(i, router.submit(
                        c, dict(zip(c.param_names, pm[i])),
                        observables=ham))
                        for i in range(tid * 8, tid * 8 + 8)]
                    for i, f in futs:
                        got[i] = f.result(timeout=TIMEOUT)
                except Exception as e:        # read on the main thread
                    errors.append(e)

            threads = [threading.Thread(target=worker, args=(t,))
                       for t in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(TIMEOUT)
            st = router.dispatch_stats()
        assert not errors, errors
        got = np.asarray(got, dtype=np.float64)
        np.testing.assert_allclose(got, want, atol=TOL)
        np.testing.assert_allclose(got, jwant, atol=TOL)
        assert st["router"]["routed"] == len(pm)
        assert st["router"]["failovers"] == 0
        assert all(p["service"]["completed"] > 0 for p in st["replicas"])

    def test_mixed_kinds_roundtrip(self):
        n = 4
        c = tq.Circuit(n)
        c.rx(0, c.parameter("a"))
        ham = ([[(0, 3)]], [1.0])
        env = tq.createQuESTEnv(device="cpu", precision=tq.DOUBLE, seed=[1])
        with ServiceRouter(envs(), supervisor=supervisor(), max_batch=4,
                           max_wait_s=5e-3) as router:
            f_state = router.submit(c, {"a": 0.3})
            f_e = router.submit(c, {"a": np.pi}, observables=ham)
            f_shot = router.submit(c, {"a": 0.0}, shots=9)
            planes = f_state.result(timeout=TIMEOUT)
            q = tq.createQureg(n, env)
            tq.initZeroState(q)
            c.compile(env).run(q, {"a": 0.3})
            np.testing.assert_allclose(planes, q.state.numpy(), atol=TOL)
            assert abs(f_e.result(timeout=TIMEOUT) + 1.0) < TOL
            idx, total = f_shot.result(timeout=TIMEOUT)
        assert idx.shape == (9,) and np.all(idx == 0)
        assert abs(total - 1.0) < TOL

    def test_compiled_circuit_routes_by_recorded_program(self):
        c = hea(tq.Circuit, 3)
        es = envs()
        cc = c.compile(es[0])
        with ServiceRouter(es, supervisor=supervisor(),
                           max_wait_s=1e-3) as router:
            fut = router.submit(cc, {nm: 0.0 for nm in cc.param_names})
            assert fut.result(timeout=TIMEOUT).shape == (2, 8)

    def test_submit_validates(self):
        c = hea(tq.Circuit, 3)
        params = {nm: 0.0 for nm in c.param_names}
        with ServiceRouter(envs(), supervisor=supervisor()) as router:
            with pytest.raises(TypeError, match="Circuit"):
                router.submit("nope")
            with pytest.raises(DeadlineExceeded):
                router.submit(c, params, deadline=-1.0)
        with pytest.raises(ServiceClosed):
            router.submit(c, params)

    def test_breaker_aware_routing(self):
        """An open breaker for the program on one replica routes new
        requests to the other instead of burning them on a fast-fail."""
        c = hea(tq.Circuit, 3)
        params = {nm: 0.0 for nm in c.param_names}
        with ServiceRouter(envs(), supervisor=supervisor(),
                           max_wait_s=1e-3) as router:
            router.warm(c, batch_sizes=(1,))
            svc0 = router._replicas[0].service
            cc0 = svc0._compiled.peek(id(c))[1]
            key = svc0._program_key_str(cc0)
            svc0._breaker._open_until[key] = time.monotonic() + 600.0
            assert svc0.program_state(c)["breaker"] == "open"
            svc1 = router._replicas[1].service
            before = svc1.metrics.get("completed")
            results([router.submit(c, params) for _ in range(4)])
            assert svc1.metrics.get("completed") - before == 4
            assert svc0.metrics.get("breaker_fastfails") == 0


class TestFailoverAndRestart:
    def test_crash_mid_trace_fails_over_and_restarts(self):
        n = 4
        rng = np.random.default_rng(2)
        c = hea(tq.Circuit, n)
        ham = z_ham(n)
        pm = rng.uniform(0, 2 * np.pi, size=(24, len(c.param_names)))
        want = oracle(c, pm, ham)
        with ServiceRouter(envs(), supervisor=supervisor(), max_batch=8,
                           max_wait_s=2e-3) as router:
            router.warm(c, batch_sizes=(8,), observables=ham)
            futs = []
            for i, row in enumerate(pm):
                if i == 8:
                    router._replicas[0].service._debug_crash()
                futs.append(router.submit(
                    c, dict(zip(c.param_names, row)), observables=ham))
            got = np.array(results(futs))
            assert readmitted(router)
            st = router.dispatch_stats()
        np.testing.assert_allclose(got, want, atol=TOL)
        r = st["router"]
        assert r["replica_quarantines"] >= 1 and r["replica_restarts"] >= 1
        assert r["readmissions"] >= 1 and r["probe_batches"] >= 1
        assert r["failed_unroutable"] == 0
        # each counter moves just before its event is recorded
        assert wait_for(lambda: "replica_readmitted" in events(router))
        ev = events(router)
        assert ev.index("replica_quarantined") < ev.index(
            "replica_readmitted")

    def test_stall_quarantines_and_work_completes(self):
        n = 4
        rng = np.random.default_rng(3)
        c = hea(tq.Circuit, n)
        ham = z_ham(n)
        pm = rng.uniform(0, 2 * np.pi, size=(8, len(c.param_names)))
        want = oracle(c, pm, ham)
        with ServiceRouter(envs(), supervisor=supervisor(
                stall_timeout_s=0.3), max_batch=4,
                max_wait_s=2e-3) as router:
            router.warm(c, batch_sizes=(1, 2, 4), observables=ham)
            futs = []
            for i, row in enumerate(pm):
                if i == 2:
                    router._replicas[0].service._debug_wedge(1.5)
                futs.append(router.submit(
                    c, dict(zip(c.param_names, row)), observables=ham))
            got = np.array(results(futs))
            st = router.dispatch_stats()
        np.testing.assert_allclose(got, want, atol=TOL)
        assert st["router"]["replica_quarantines"] >= 1
        assert wait_for(lambda: "replica_quarantined" in events(router))

    def test_failover_preserves_absolute_deadline(self):
        c = hea(tq.Circuit, 3)
        params = {nm: 0.0 for nm in c.param_names}
        with ServiceRouter(envs(), supervisor=supervisor(),
                           max_wait_s=1e-3, request_timeout_s=60.0
                           ) as router:
            router.warm(c, batch_sizes=(1,))
            svcs = [h.service for h in router._replicas]
            # the request waits where its deadline can be read (the
            # restarted replica keeps the router's short wait)
            for svc in svcs:
                svc.policy = CoalescePolicy(max_batch=64, max_wait_s=60.0)
            svcs[1].pause()
            t_submit = time.monotonic()
            fut = router.submit(c, params, deadline=5.0)
            assert wait_for(lambda: sum(s._backlog for s in svcs) == 1)
            holder = 0 if svcs[0]._backlog else 1
            other = 1 - holder
            if holder == 1:
                svcs[1].resume()
                svcs[0].pause()
            svcs[holder]._debug_crash()
            assert wait_for(lambda: svcs[other]._backlog == 1)
            with svcs[other]._cond:
                reqs = list(svcs[other]._queue)
            assert reqs[0].deadline == pytest.approx(t_submit + 5.0,
                                                     abs=0.5)
            svcs[other].policy = CoalescePolicy(max_batch=64,
                                                max_wait_s=1e-3)
            svcs[other].resume()
            assert fut.result(timeout=TIMEOUT).shape == (2, 8)
            assert router.metrics.snapshot()["failovers"] == 1

    def test_probe_rejects_wrong_replica(self):
        n = 3
        c = hea(tq.Circuit, n)
        ham = z_ham(n)
        sp = supervisor(max_restart_attempts=2, restart_backoff_s=10.0)
        with ServiceRouter(envs(), supervisor=sp,
                           max_wait_s=2e-3) as router:
            router.warm(c, batch_sizes=(2,), observables=ham)
            with router._lock:
                router._warm_specs[0].reference += 1.0
            router._replicas[0].service._debug_crash()
            assert wait_for(lambda: router.metrics.snapshot()[
                "probe_failures"] >= 1)
            st = router.dispatch_stats()
            assert st["router"]["readmissions"] == 0
            assert router._replicas[0].state in ("quarantined",
                                                 "restarting", "failed")
            # the counter moves before the event is recorded
            assert wait_for(lambda: "probe_failed" in events(router))

    def test_hedge_resolves_stuck_request(self):
        n = 3
        rng = np.random.default_rng(4)
        c = hea(tq.Circuit, n)
        ham = z_ham(n)
        pm = rng.uniform(0, 2 * np.pi, size=(1, len(c.param_names)))
        want = oracle(c, pm, ham)
        sp = supervisor(stall_quarantine=False)
        with ServiceRouter(envs(), supervisor=sp, max_wait_s=1e-3,
                           hedge_after_s=0.1) as router:
            router.warm(c, batch_sizes=(1,), observables=ham)
            router._replicas[0].service._debug_wedge(5.0)
            router._replicas[1].service._debug_wedge(5.0)
            fut = router.submit(c, dict(zip(c.param_names, pm[0])),
                                observables=ham)
            assert wait_for(lambda: any(w.active for w in list(
                router._outstanding.values())))
            holder = next(iter(next(iter(
                router._outstanding.values())).active))
            router._replicas[1 - holder].service._wedge_until = 0.0
            got = fut.result(timeout=TIMEOUT)
            st = router.dispatch_stats()
        assert abs(got - want[0]) < TOL
        assert st["router"]["hedged_dispatches"] >= 1
        assert st["router"]["hedge_wins"] >= 1
        assert wait_for(lambda: "hedge" in events(router))

    def test_kernel_launch_error_is_typed_with_no_failover(self,
                                                          monkeypatch):
        """A refused kernel launch classifies FATAL: the caller gets the
        launch error itself, and the router neither fails it over nor
        restarts a replica for it."""
        n = 8                                  # the plan holds layers
        c = hea(tq.Circuit, n)
        ham = z_ham(n)
        with ServiceRouter(envs(), supervisor=supervisor(),
                           max_wait_s=1e-3) as router:
            router.warm(c, batch_sizes=(1,), observables=ham)
            cc = router._replicas[0].service._compiled.peek(id(c))[1]
            assert cc.num_layers > 0

            def refuse(*args, **kwargs):
                raise cuda_build.KernelLaunchError(
                    "layer kernel launch failed: refused (test)")

            monkeypatch.setattr(lk, "apply_layer_batched", refuse)
            fut = router.submit(c, {nm: 0.1 for nm in c.param_names},
                                observables=ham)
            with pytest.raises(cuda_build.KernelLaunchError,
                               match="refused"):
                fut.result(timeout=TIMEOUT)
            st = router.dispatch_stats()
        r = st["router"]
        assert r["failovers"] == 0 and r["replica_quarantines"] == 0
        assert r["replica_restarts"] == 0
        served = [p["service"] for p in st["replicas"]]
        assert sum(s["failed_fatal"] for s in served) == 1
        assert sum(s["retries"] for s in served) == 0


class TestRollingRestartAndScale:
    def test_rolling_restart_drops_zero_requests(self):
        n = 4
        rng = np.random.default_rng(5)
        c = hea(tq.Circuit, n)
        ham = z_ham(n)
        pm = rng.uniform(0, 2 * np.pi, size=(32, len(c.param_names)))
        want = oracle(c, pm, ham)
        got = [None] * len(pm)
        errors = []
        started = threading.Event()
        with ServiceRouter(envs(), supervisor=supervisor(), max_batch=8,
                           max_wait_s=2e-3) as router:
            router.warm(c, batch_sizes=(8,), observables=ham)

            def traffic():
                try:
                    for i, row in enumerate(pm):
                        fut = router.submit(
                            c, dict(zip(c.param_names, row)),
                            observables=ham)
                        started.set()
                        got[i] = fut.result(timeout=TIMEOUT)
                except Exception as e:       # read on the main thread
                    errors.append(e)

            t = threading.Thread(target=traffic)
            t.start()
            assert started.wait(TIMEOUT)
            acct = router.rolling_restart(timeout_per_replica=TIMEOUT)
            t.join(TIMEOUT * 2)
            st = router.dispatch_stats()
        assert not errors, errors
        np.testing.assert_allclose(np.asarray(got, dtype=np.float64), want,
                                   atol=TOL)
        assert all(r["ok"] for r in acct["replicas"]), acct
        assert st["router"]["replica_restarts"] == 2
        assert st["router"]["readmissions"] == 2
        assert st["router"]["failed_unroutable"] == 0

    def test_rolling_restart_needs_two_replicas(self):
        with ServiceRouter(envs(1), supervisor=supervisor()) as router:
            with pytest.raises(ValueError, match=">= 2"):
                router.rolling_restart()

    def test_restart_rides_the_shared_warm_cache(self, tmp_path):
        """A crashed replica's replacement warms from the cache the
        replicas share: hits, no fresh misses, nothing packed."""
        n = 8
        c = hea(tq.Circuit, n)
        ham = z_ham(n)
        cache = WarmCache(str(tmp_path))
        with ServiceRouter(envs(), supervisor=supervisor(), max_batch=4,
                           max_wait_s=1e-3, warm_cache=cache) as router:
            router.warm(c, batch_sizes=(4,), observables=ham)
            assert (cache.stats()["misses"], cache.stats()["hits"]) == (1, 1)
            packs = lk._operands.packs
            router._replicas[0].service._debug_crash()
            assert readmitted(router)
            st = router.dispatch_stats()
        assert cache.stats()["misses"] == 1
        assert cache.stats()["hits"] == 2 and cache.stats()["errors"] == 0
        assert st["warm_cache"]["hits"] == 2
        assert lk._operands.packs == packs

    def test_scale_to_grows_and_drains(self):
        n = 3
        c = hea(tq.Circuit, n)
        ham = z_ham(n)
        params = {nm: 0.2 for nm in c.param_names}
        with ServiceRouter(envs(1), supervisor=supervisor(),
                           max_wait_s=1e-3) as router:
            router.warm(c, batch_sizes=(1,), observables=ham)
            acct = router.scale_to(3)
            assert acct["replicas"] == 3 and len(acct["added"]) == 2
            assert all(h.env.device == torch.device("cpu")
                       for h in router._replicas)
            got = results([router.submit(c, params, observables=ham)
                           for _ in range(6)])
            acct = router.scale_to(1)
            assert acct["replicas"] == 1 and len(acct["removed"]) == 2
            st = router.metrics.snapshot()
        want = oracle(c, np.array([list(params.values())]), ham)[0]
        np.testing.assert_allclose(got, want, atol=TOL)
        assert (st["scale_ups"], st["scale_downs"]) == (2, 2)

    def test_no_replica_left_fails_typed(self):
        """A replica whose restart fails its probe past the attempt budget
        is failed for good; with none left a request fails typed."""
        c = hea(tq.Circuit, 3)
        ham = z_ham(3)
        sp = supervisor(max_restart_attempts=1)
        with ServiceRouter(envs(1), supervisor=sp, max_wait_s=1e-3,
                           max_failovers=0) as router:
            router.warm(c, batch_sizes=(1,), observables=ham)
            with router._lock:
                router._warm_specs[0].reference += 1.0
            router._replicas[0].service._debug_crash()
            assert wait_for(lambda: router._replicas[0].state == "failed")
            fut = router.submit(c, {nm: 0.0 for nm in c.param_names})
            with pytest.raises(AllReplicasUnavailable):
                fut.result(timeout=TIMEOUT)
            assert router.metrics.snapshot()["failed_unroutable"] == 1


def test_router_metrics_keys_match_jax():
    ours, theirs = RouterMetrics(), JRouterMetrics()
    for m in (ours, theirs):
        m.incr("routed", 3)
        m.record_latency(0.01)
    assert ours.snapshot().keys() == theirs.snapshot().keys()
    assert ours.snapshot()["routed"] == 3
    with pytest.raises(KeyError):
        ours.incr("nope")
    with ServiceRouter(envs(1), supervisor=supervisor()) as router:
        st = router.dispatch_stats()
    assert set(st) >= {"router", "replicas", "telemetry", "profile"}
    assert set(st["replicas"][0]) == {
        "replica", "state", "alive", "devices", "queue_depth", "inflight",
        "restarts", "ema_request_s", "quarantine_reason", "service"}
