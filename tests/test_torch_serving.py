"""The port's serving runtime against the JAX package's, on the CPU.

Programs of 3-5 qubits at DOUBLE. The same mixed request trace — states,
energies, gradients, trajectory energies and Trotter evolutions — goes
through both packages' ``SimulationService`` and every result agrees
within 1e-12 (the trajectory requests ride channels of strength 0, so
their draws cannot differ; a real channel is held against the port's own
``expectation_batch`` from the same generator state, and shots by shape,
norm and a 5-stderr histogram). Then the service's behaviours: typed
backpressure and deadlines, close with and without drain, the fault drills
(a retried transient fault, a quarantined NaN row, bisection, a circuit
breaker trip, degraded sequential mode, a kernel that failed to build or
launch failing fast as FATAL), ``pipeline_depth=2`` ordering, tenant
quotas and strict priority, tier escalation (FAST to SINGLE, DOUBLE to
QUAD, bounded at the top), the watchdog, ``dispatch_stats()``'s keys, the
health guard's cadence hook in ``CompiledCircuit.run``, and the float64
accumulation of the batched sampler's totals.
"""

import threading
import time

import numpy as np
import pytest
import torch

import quest_tpu as jq
from quest_tpu.ops.dynamics import EvolveSpec as JEvolveSpec
from quest_tpu.serve import SimulationService as JService
import quest_tpu_torch as tq
from quest_tpu_torch.ops import cuda_build
from quest_tpu_torch.parallel.sampling import sample_batched
from quest_tpu_torch.resilience import (FaultInjector, FaultSpec,
                                        NumericalFault, ResiliencePolicy,
                                        inject)
from quest_tpu_torch.resilience import health
from quest_tpu_torch.serve import (CircuitBreakerOpen, DeadlineExceeded,
                                   QueueFull, QuotaExceeded, ServiceClosed,
                                   SimulationService, TenantPolicy)
from torch_threads import one_blas_thread, port_lock_order  # noqa: F401

TOL = 1e-12
N = 5
TIMEOUT = 120


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


def quiet_channels(C, n):
    """A trajectory program whose channels have strength 0: every draw
    takes the identity branch, so both packages' ensembles are exact."""
    c = C(n)
    for q in range(n):
        c.ry(q, c.parameter(f"a{q}"))
    c.dephase(1, 0.0)
    for q in range(n - 1):
        c.cnot(q, q + 1)
    c.damp(2, 0.0)
    return c


def hamiltonian(rng, n, terms=6):
    codes = rng.integers(0, 4, size=(terms, n))
    return ([[(q, int(codes[t, q])) for q in range(n)]
             for t in range(terms)], rng.normal(size=terms))


def service(env, **kw):
    kw.setdefault("max_wait_s", 2e-3)
    return tq.createSimulationService(env, **kw)


def results(futs):
    return [f.result(timeout=TIMEOUT) for f in futs]


@pytest.fixture(scope="module")
def tenv():
    return tq.createQuESTEnv(device="cpu", precision=tq.DOUBLE, seed=[5])


@pytest.fixture(scope="module")
def trace():
    """One mixed trace through both packages' services, paused while it is
    submitted: ``{"jax": (results, stats), "torch": (results, stats)}``."""
    rng = np.random.default_rng(2026)
    ham = hamiltonian(rng, N)
    pm = rng.uniform(0, 2 * np.pi, size=(6, 2 * N))
    pt = rng.uniform(0, 2 * np.pi, size=(3, N))
    out = {}
    for name, pkg, Service, Spec, env in (
            ("jax", jq, JService, JEvolveSpec,
             jq.createQuESTEnv(num_devices=1, precision=jq.DOUBLE,
                               seed=[5])),
            ("torch", tq, SimulationService, tq.EvolveSpec,
             tq.createQuESTEnv(device="cpu", precision=tq.DOUBLE,
                               seed=[5]))):
        cc = hea(pkg.Circuit, N).compile(env)
        noisy = quiet_channels(pkg.Circuit, N)
        spec = Spec(t=0.4, steps=3, order=2)
        with Service(env, max_batch=8, max_wait_s=2e-3) as svc:
            svc.pause()
            futs = ([svc.submit(cc, pm[i]) for i in range(4)]
                    + [svc.submit(cc, pm[i], observables=ham)
                       for i in range(6)]
                    + [svc.submit(cc, pm[i], observables=ham, gradient=True)
                       for i in range(3)]
                    + [svc.submit(noisy, pt[i], observables=ham,
                                  trajectories=16) for i in range(3)]
                    + [svc.submit(cc, pm[i], observables=ham, evolve=spec)
                       for i in range(2)])
            svc.resume()
            res = results(futs)
            out[name] = (res, svc.dispatch_stats())
    return out


def test_mixed_trace_matches_jax(trace):
    (jres, jstats), (tres, tstats) = trace["jax"], trace["torch"]
    for i in range(4):                               # states
        np.testing.assert_allclose(tres[i], np.asarray(jres[i]), rtol=0,
                                   atol=TOL)
    for i in range(4, 10):                           # energies
        assert abs(tres[i] - jres[i]) <= TOL
    for i in range(10, 13):                          # gradients
        assert abs(tres[i][0] - jres[i][0]) <= TOL
        np.testing.assert_allclose(tres[i][1], jres[i][1], rtol=0, atol=TOL)
    for i in range(13, 16):                          # trajectories
        assert abs(tres[i][0] - jres[i][0]) <= TOL
        assert tres[i][1] == pytest.approx(0.0, abs=TOL)
    for i in range(16, 18):                          # evolutions
        np.testing.assert_allclose(tres[i], np.asarray(jres[i]), rtol=0,
                                   atol=TOL)
    for stats in (jstats["service"], tstats["service"]):
        assert stats["completed"] == 18 and stats["failed"] == 0
    for key in ("batches", "coalesced_requests", "padded_rows",
                "gradient_dispatches", "gradients_returned",
                "trajectory_dispatches", "trajectories_run",
                "evolve_dispatches", "evolve_steps_fused"):
        assert tstats["service"][key] == jstats["service"][key], key


def test_dispatch_stats_keys_match_jax(trace):
    jstats, tstats = trace["jax"][1], trace["torch"][1]
    assert sorted(tstats) == sorted(jstats)
    for section in ("service", "resilience", "scheduler", "telemetry",
                    "profile"):
        assert sorted(tstats[section]) == sorted(jstats[section]), section
    assert sorted(tstats["service"]["tenants"]["default"]) == \
        sorted(jstats["service"]["tenants"]["default"])


def test_trajectory_requests_match_a_direct_batch(tenv):
    rng = np.random.default_rng(3)
    c = tq.Circuit(4)
    for q in range(4):
        c.ry(q, c.parameter(f"a{q}"))
    c.damp(0, 0.3)
    c.cnot(0, 1)
    c.dephase(2, 0.2)
    ham = hamiltonian(rng, 4, 3)
    pm = rng.uniform(0, 2 * np.pi, size=(3, 4))
    heard = []
    with service(tenv, max_batch=4) as svc:
        tp = svc.warm(c, observables=ham, trajectories=64)
        tq.seedQuEST(tenv, [21])
        svc.pause()
        futs = [svc.submit(c, pm[i], observables=ham, trajectories=64,
                           _progress=heard.append) for i in range(3)]
        svc.resume()
        got = results(futs)
    tq.seedQuEST(tenv, [21])
    padded = np.vstack([pm, np.zeros((1, 4))])
    means, errs, info = tp.expectation_batch(padded, ham, 64, live_rows=3)
    for i in range(3):
        assert got[i] == (means[i], errs[i])
    assert len(heard) == 3 * info["waves"]
    assert set(heard[0]) == {"wave", "trajectories_run", "max_trajectories",
                             "max_stderr"}


def test_shots_shape_norm_and_histogram(tenv):
    rng = np.random.default_rng(8)
    cc = hea(tq.Circuit, 4).compile(tenv)
    p = rng.uniform(0, 2 * np.pi, size=8)
    shots = 20000
    with service(tenv) as svc:
        idx, total = svc.submit(cc, p, shots=shots).result(timeout=TIMEOUT)
        planes = svc.submit(cc, p).result(timeout=TIMEOUT)
    assert idx.shape == (shots,) and idx.dtype == np.int64
    assert abs(total - 1.0) <= TOL
    probs = planes[0] ** 2 + planes[1] ** 2
    counts = np.bincount(idx, minlength=16) / shots
    stderr = np.sqrt(probs * (1 - probs) / shots)
    assert np.all(np.abs(counts - probs) <= 5 * stderr + 1e-12)


def test_shot_totals_accumulate_in_float64():
    """The batched sampler's totals (and the cdf its draws search) are
    float64 sums: over 2^22 float32 probabilities a float32 running sum
    drifts by ~1e-4."""
    rng = np.random.default_rng(1)
    amps = rng.normal(size=(1, 2, 1 << 22)).astype(np.float32)
    amps /= np.sqrt((amps.astype(np.float64) ** 2).sum())
    planes = torch.from_numpy(amps)
    want = float((planes.double() ** 2).sum())
    _, totals = sample_batched(planes, torch.Generator().manual_seed(0), 8)
    assert totals.dtype == np.float64
    assert abs(float(totals[0]) - want) <= 1e-9


def test_backpressure_and_deadlines(tenv):
    cc = hea(tq.Circuit, 3).compile(tenv)
    p = np.zeros(6)
    with service(tenv, max_queue=2) as svc:
        svc.pause()
        f1 = svc.submit(cc, p, deadline=0.05)
        f2 = svc.submit(cc, p)
        with pytest.raises(QueueFull):
            svc.submit(cc, p)
        with pytest.raises(DeadlineExceeded):
            svc.submit(cc, p, deadline=0.0)
        time.sleep(0.1)
        svc.resume()
        with pytest.raises(DeadlineExceeded):
            f1.result(timeout=TIMEOUT)
        assert f2.result(timeout=TIMEOUT).shape == (2, 8)
        snap = svc.dispatch_stats()["service"]
    assert (snap["rejected_queue_full"], snap["rejected_deadline"],
            snap["timeouts"], snap["completed"]) == (1, 1, 1, 1)
    for kw in ({"max_queue": 0}, {"request_timeout_s": 0.0},
               {"max_retries": -1}, {"scheduler": "lifo"},
               {"pipeline_depth": 0}):
        with pytest.raises(ValueError):
            SimulationService(tenv, **kw)


@pytest.mark.parametrize("drain", [True, False])
def test_close_with_and_without_drain(tenv, drain):
    cc = hea(tq.Circuit, 3).compile(tenv)
    svc = service(tenv, max_wait_s=10.0)
    svc.pause()
    futs = [svc.submit(cc, np.full(6, 0.1 * i)) for i in range(3)]
    svc.close(drain=drain)
    assert not svc.is_alive()
    if drain:
        direct = cc.sweep(np.stack([np.full(6, 0.1 * i) for i in range(3)]))
        for i, f in enumerate(futs):
            np.testing.assert_array_equal(f.result(timeout=TIMEOUT),
                                          direct[i].numpy())
    else:
        for f in futs:
            with pytest.raises(ServiceClosed):
                f.result(timeout=TIMEOUT)
    with pytest.raises(ServiceClosed):
        svc.submit(cc, np.zeros(6))
    svc.close()                                      # idempotent


def _energy_batch(svc, cc, pm, ham):
    svc.pause()
    futs = [svc.submit(cc, row, observables=ham) for row in pm]
    svc.resume()
    out = []
    for f in futs:
        try:
            out.append(f.result(timeout=TIMEOUT))
        except Exception as e:        # the drill inspects the failure
            out.append(e)
    return out


@pytest.fixture(scope="module")
def drill(tenv):
    rng = np.random.default_rng(12)
    cc = hea(tq.Circuit, 4).compile(tenv)
    ham = hamiltonian(rng, 4)
    pm = rng.uniform(0, 2 * np.pi, size=(8, 8))
    return cc, ham, pm, cc.expectation_sweep(pm, ham)


def test_transient_fault_is_retried(tenv, drill):
    cc, ham, pm, clean = drill
    with service(tenv, max_batch=8, resilience=ResiliencePolicy(
            quarantine=False, backoff_jitter=0.0)) as svc, \
            inject(FaultInjector([FaultSpec("transient",
                                            site="serve.execute",
                                            at_calls=(0,))])):
        got = _energy_batch(svc, cc, pm, ham)
        snap = svc.dispatch_stats()["service"]
    np.testing.assert_allclose(got, clean, rtol=0, atol=TOL)
    assert (snap["retries"], snap["executor_faults"], snap["failed"]) == \
        (8, 1, 0)


def test_nan_row_fails_alone_and_bisection(tenv, drill):
    cc, ham, pm, clean = drill
    with service(tenv, max_batch=8, max_retries=0) as svc:
        with inject(FaultInjector([FaultSpec("nan", site="serve.execute",
                                             at_calls=(0,))], seed=4)):
            got = _energy_batch(svc, cc, pm, ham)
        bad = [i for i, r in enumerate(got) if isinstance(r, Exception)]
        assert len(bad) == 1 and isinstance(got[bad[0]], NumericalFault)
        assert got[bad[0]].kind == "nan"
        for i, r in enumerate(got):
            if i not in bad:
                assert abs(r - clean[i]) <= TOL
        # an executor fault on the whole batch: quarantine bisects it and
        # the halves complete (only the first dispatch faults)
        with inject(FaultInjector([FaultSpec("oom", site="serve.execute",
                                             at_calls=(0,))])):
            got = _energy_batch(svc, cc, pm, ham)
        snap = svc.dispatch_stats()["service"]
    np.testing.assert_allclose(got, clean, rtol=0, atol=TOL)
    assert snap["health_failures"] == 1 and snap["quarantine_splits"] == 1
    assert snap["quarantined"] == 1 and snap["retries"] == 0


def test_breaker_trips_and_fast_fails(tenv, drill):
    cc, ham, pm, _ = drill
    with service(tenv, max_retries=0, resilience=ResiliencePolicy(
            quarantine=False, breaker_threshold=2,
            breaker_cooldown_s=600.0)) as svc:
        with inject(FaultInjector([FaultSpec("transient",
                                             site="serve.execute",
                                             at_calls=(0, 1))])):
            for row in pm[:2]:
                with pytest.raises(Exception, match="injected transient"):
                    svc.submit(cc, row, observables=ham).result(
                        timeout=TIMEOUT)
            with pytest.raises(CircuitBreakerOpen):
                svc.submit(cc, pm[2], observables=ham).result(
                    timeout=TIMEOUT)
        snap = svc.dispatch_stats()
        state = svc.program_state(cc)
    assert snap["service"]["breaker_trips"] == 1
    assert snap["service"]["breaker_fastfails"] == 1
    assert state["breaker"] == "open"
    assert [e["event"] for e in svc.timeline()].count("breaker_open") == 1


def test_degrades_to_sequential(tenv, drill):
    cc, ham, pm, clean = drill
    with service(tenv, max_batch=8, resilience=ResiliencePolicy(
            quarantine=False, degrade_after=1, backoff_jitter=0.0)) as svc, \
            inject(FaultInjector([FaultSpec("transient",
                                            site="serve.execute",
                                            at_calls=(0,))])):
        got = _energy_batch(svc, cc, pm[:4], ham)
        stats = svc.dispatch_stats()
    np.testing.assert_allclose(got, clean[:4], rtol=0, atol=1e-12)
    assert stats["service"]["degraded_dispatches"] == 4
    assert len(stats["resilience"]["degraded_programs"]) == 1


@pytest.mark.parametrize("error", [cuda_build.KernelBuildError,
                                   cuda_build.KernelLaunchError])
def test_kernel_failures_fail_fast_as_fatal(tenv, drill, monkeypatch, error):
    """A kernel that did not build or launch fails its requests with the
    original error at once: no retry, no bisection, no plain version."""
    cc, ham, pm, _ = drill

    def broken(*args, **kwargs):
        raise error("nvcc failed on layer_kernel.cu")

    monkeypatch.setattr(cc, "expectation_sweep", broken)
    with service(tenv, max_batch=8) as svc:
        got = _energy_batch(svc, cc, pm[:4], ham)
        snap = svc.dispatch_stats()["service"]
    assert all(isinstance(r, error) for r in got)
    assert (snap["failed_fatal"], snap["retries"], snap["executor_faults"],
            snap["quarantine_splits"]) == (4, 0, 0, 0)


def test_pipeline_depth_two_keeps_order(tenv):
    cc = hea(tq.Circuit, 4).compile(tenv)
    pm = np.random.default_rng(2).uniform(0, 6, size=(12, 8))
    order, lock = [], threading.Lock()
    with service(tenv, max_batch=3, max_wait_s=1e-3,
                 pipeline_depth=2) as svc:
        futs = []
        for i in range(12):
            f = svc.submit(cc, pm[i])
            f.add_done_callback(lambda _, i=i: (lock.acquire(),
                                                order.append(i),
                                                lock.release()))
            futs.append(f)
        got = results(futs)
        snap = svc.dispatch_stats()
    assert order == list(range(12))
    direct = cc.sweep(pm).numpy()
    for i in range(12):
        np.testing.assert_allclose(got[i], direct[i], rtol=0, atol=TOL)
    assert snap["service"]["pipelined_batches"] == snap["service"]["batches"]
    assert snap["scheduler"]["pipeline_depth"] == 2


def test_tenant_quota_and_priority(tenv):
    cc = hea(tq.Circuit, 3).compile(tenv)
    order, lock = [], threading.Lock()
    tenants = {"bulk": TenantPolicy(priority=1, max_queued=2),
               "urgent": TenantPolicy(priority=0)}
    with service(tenv, tenants=tenants) as svc:
        svc.pause()
        futs = [svc.submit(cc, np.zeros(6), tenant="bulk")
                for _ in range(2)]
        with pytest.raises(QuotaExceeded):
            svc.submit(cc, np.zeros(6), tenant="bulk")
        assert not svc.interactive_pressure()
        futs.append(svc.submit(cc, np.full(6, 0.3), tenant="urgent"))
        assert svc.interactive_pressure()
        for f, name in zip(futs, ("bulk", "bulk", "urgent")):
            f.add_done_callback(lambda _, n=name: (lock.acquire(),
                                                   order.append(n),
                                                   lock.release()))
        # both groups mature before the dispatcher wakes, so one cycle
        # orders them: strict priority puts the urgent batch first
        time.sleep(0.02)
        svc.resume()
        results(futs)
        assert svc.quiesce(timeout=TIMEOUT)
        snap = svc.dispatch_stats()
    assert order[0] == "urgent"
    tenants_snap = snap["service"]["tenants"]
    assert tenants_snap["bulk"]["rejected_quota"] == 1
    assert tenants_snap["urgent"]["completed"] == 1
    assert snap["service"]["rejected_quota"] == 1


def _ry_program(env, n=3):
    c = tq.Circuit(n)
    for q in range(n):
        c.ry(q, c.parameter(f"y{q}"))
    return c.compile(env, pallas=False)


@pytest.mark.parametrize("start,escalated", [("fast", "single"),
                                             ("double", "quad")])
def test_tier_escalation_one_rung_up(tenv, start, escalated):
    cc = _ry_program(tenv)
    p = np.array([0.3, 1.1, 2.0])
    ref = cc.sweep(p[None])[0].numpy()
    with service(tenv) as svc, inject(FaultInjector(
            [FaultSpec("precision", site="serve.execute", at_calls=(0,))])):
        got = svc.submit(cc, p, tier=start).result(timeout=TIMEOUT)
        stats = svc.dispatch_stats()
    snap = stats["service"]
    assert snap["tier_violations"] == 1 and snap["tier_escalations"] == 1
    assert start in stats["resilience"]["tier_observed_drift"]
    tol = 1e-6 if escalated == "single" else TOL
    assert float(np.max(np.abs(got - ref))) <= tol
    events = [e for e in svc.timeline() if e["event"] == "tier_escalation"]
    assert [(e["from_tier"], e["to_tier"]) for e in events] == \
        [(start, escalated)]


def test_escalation_is_bounded_at_quad(tenv):
    cc = _ry_program(tenv)
    with service(tenv) as svc, inject(FaultInjector(
            [FaultSpec("precision", site="serve.execute", at_calls=(0,))])):
        with pytest.raises(NumericalFault) as ei:
            svc.submit(cc, np.zeros(3), tier="quad").result(timeout=TIMEOUT)
    assert ei.value.kind == "precision"


def test_watchdog_counts_a_wedged_dispatcher(tenv):
    with service(tenv, resilience=ResiliencePolicy(
            watchdog_timeout_s=0.02)) as svc:
        svc._debug_wedge(0.3)
        deadline = time.monotonic() + 10.0
        while svc.dispatch_stats()["service"]["watchdog_stalls"] == 0 \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        snap = svc.dispatch_stats()["service"]
    assert snap["watchdog_stalls"] >= 1


def test_api_and_what_waits_for_later_slices(tenv):
    svc = tq.createSimulationService(tenv, name="svc-api-test")
    try:
        assert isinstance(svc, SimulationService) and svc.is_alive()
        assert svc.program_state(tq.Circuit(2)) == {"breaker": "unknown",
                                                    "degraded": False}
        cc = hea(tq.Circuit, 3)
        before = tenv.generator.get_state()
        compiled = svc.warm(cc, batch_sizes=[2], shots=16)
        svc.warm(cc, batch_sizes=[1], observables=([[(0, 3)]], [1.0]),
                 gradient=True)
        assert torch.equal(tenv.generator.get_state(), before)
        assert svc.submit(cc, np.zeros(6)).result(timeout=TIMEOUT).shape \
            == (2, 8)
        assert svc.warm(cc) is compiled
        # the optimizer and dynamics handles refuse what the JAX
        # package's refuse, as it does (serve/optimize.py, dynamics.py)
        for call in (lambda: svc.optimize(None),
                     lambda: svc.evolve(cc, hamiltonian=None, t=1.0,
                                        steps=1),
                     lambda: svc.ground_state(cc, hamiltonian=None)):
            with pytest.raises(TypeError):
                call()
        with pytest.raises(ValueError):
            svc.submit(cc, np.zeros(6), observables=([[(0, 3)]], [1.0]),
                       shots=4)
        with pytest.raises(TypeError):
            svc.submit(cc.compile(tenv), np.zeros(6), trajectories=4,
                       observables=([[(0, 3)]], [1.0]))
    finally:
        svc.close()
    # the persistent warm cache is taken (serve/warmcache.py); False
    # turns it off
    with SimulationService(tenv, warm_cache=False) as off:
        assert off.warm_cache is None


def test_recorded_circuits_are_compiled_once_and_lru_bounded(tenv):
    circuits = [hea(tq.Circuit, 3) for _ in range(3)]
    with service(tenv, max_circuits=2) as svc:
        for c in circuits[:2]:
            svc.submit(c, np.zeros(6)).result(timeout=TIMEOUT)
        first = svc.warm(circuits[0], batch_sizes=[1])
        assert svc.warm(circuits[0], batch_sizes=[1]) is first
        svc.submit(circuits[2], np.zeros(6)).result(timeout=TIMEOUT)
        # the LRU kept circuits 0 (used last) and 2; circuit 1 was dropped
        assert svc.program_state(circuits[0])["breaker"] == "closed"
        assert svc.program_state(circuits[1])["breaker"] == "unknown"
        assert svc.warm(circuits[0], batch_sizes=[1]) is first


def test_health_cadence_hooks_into_compiled_run(tenv):
    cc = hea(tq.Circuit, 3).compile(tenv)
    params = {nm: 0.1 for nm in cc.param_names}
    q = tq.createQureg(3, tenv)
    health.reset_stats()
    with health.guarded(cadence=1):
        cc.run(q, params)
        with inject(FaultInjector([FaultSpec("nan", site="circuits.run",
                                             probability=1.0)])):
            with pytest.raises(NumericalFault):
                cc.run(q, params)
    assert health.health_stats()["checks"] >= 2
    tq.initZeroState(q)
    with health.guarded(cadence=0), inject(FaultInjector(
            [FaultSpec("nan", site="circuits.run", probability=1.0)])):
        cc.run(q, params)                            # not guarded
    assert not torch.isfinite(q.state).all()
