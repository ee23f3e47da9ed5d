"""The port's serving and resilience policy against the JAX package's.

The policy modules are host code the port keeps its own copy of
(``serve/coalesce.py``, ``serve/sched.py``, ``resilience/recovery.py``,
``resilience/faults.py``, ``resilience/health.py``); on equal inputs both
packages must make equal decisions:

- ``batch_bucket``, ``coalesce_key`` (but for the program's identity),
  ``split_ready``, ``plan_schedule``, the WFQ order and its virtual time,
  ``plan_wfq_schedule`` with preemption and autoscaling, ``TenantPolicy``
  validation;
- ``classify`` over the shared exception families, ``CircuitBreaker`` on a
  scripted clock, ``ResiliencePolicy.backoff``, a seeded
  ``FaultInjector``'s schedule and its poisoned row, and the health
  screens (``check_planes`` on NaN rows, norm and trace drift, degraded
  renormalisation; ``plane_norms``, ``drifted_rows``);
- the port's own fatal cases: a kernel that fails to build or launch and
  a sticky CUDA error are FATAL, a device out-of-memory error TRANSIENT.
"""

import numpy as np
import pytest
import torch

import quest_tpu as jq
from quest_tpu.resilience import faults as jfaults
from quest_tpu.resilience import health as jhealth
from quest_tpu.resilience import recovery as jrec
from quest_tpu.serve import coalesce as jco
from quest_tpu.serve import sched as jsched
import quest_tpu_torch as tq
from quest_tpu_torch.ops import cuda_build
from quest_tpu_torch.resilience import faults as tfaults
from quest_tpu_torch.resilience import health as thealth
from quest_tpu_torch.resilience import recovery as trec
from quest_tpu_torch.serve import coalesce as tco
from quest_tpu_torch.serve import sched as tsched
from torch_threads import one_blas_thread  # noqa: F401


@pytest.mark.parametrize("floor", [1, 2, 8])
def test_batch_bucket(floor):
    for n in range(1, 140):
        assert tco.batch_bucket(n, floor) == jco.batch_bucket(n, floor)
    for mod in (jco, tco):
        with pytest.raises(ValueError):
            mod.batch_bucket(0)


def test_coalesce_key_matches_but_for_the_program():
    """Every dimension of the key but the program's identity is equal:
    kind, observable key, shot bucket, dtype, tier and tenant."""
    jenv = jq.createQuESTEnv(num_devices=1, precision=jq.DOUBLE, seed=[1])
    tenv = tq.createQuESTEnv(device="cpu", precision=tq.DOUBLE, seed=[1])
    jcc = jq.Circuit(3).h(0).compile(jenv)
    tcc = tq.Circuit(3).h(0).compile(tenv)
    obs = (((0, 3),), (1.0,))
    cases = [(tco.KIND_STATE, (), 0, None, "default"),
             (tco.KIND_EXPECTATION, obs, 0, None, "a"),
             (tco.KIND_SAMPLE, (), 37, None, "default"),
             (tco.KIND_SAMPLE, (), 64, "fast", "default"),
             (tco.KIND_EXPECTATION, obs, 0, "double", "b"),
             (tco.KIND_GRADIENT, obs + (2,), 0, "single", "default")]
    for kind, okey, shots, tier, tenant in cases:
        jt = jq.tier_by_name(tier) if tier else None
        tt = tq.tier_by_name(tier) if tier else None
        jk = jco.coalesce_key(jcc, kind, okey, shots, jt, tenant=tenant)
        tk = tco.coalesce_key(tcc, kind, okey, shots, tt, tenant=tenant)
        assert tk[1:] == jk[1:], (kind, tk, jk)
        assert tk[0] == id(tcc)


def _arrivals(rng, count, classes):
    t = np.cumsum(rng.exponential(4e-4, size=count))
    keys = rng.integers(0, classes, size=count)
    return [(float(a), int(k)) for a, k in zip(t, keys)]


class _Req:
    def __init__(self, t):
        self.submit_t = t


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_ready_and_plan_schedule(seed):
    rng = np.random.default_rng(seed)
    policy = dict(max_batch=int(rng.integers(1, 9)),
                  max_wait_s=float(rng.uniform(0, 3e-3)))
    jpol, tpol = jco.CoalescePolicy(**policy), tco.CoalescePolicy(**policy)
    for _ in range(20):
        times = sorted(rng.uniform(0, 1e-2, size=int(rng.integers(0, 20))))
        pending = [_Req(float(x)) for x in times]
        now = float(rng.uniform(0, 1.2e-2))
        drain = bool(rng.integers(0, 2))
        jb, jr, jd = jco.split_ready(list(pending), now, jpol, drain)
        tb, tr, td = tco.split_ready(list(pending), now, tpol, drain)
        assert [[id(r) for r in b] for b in tb] == \
            [[id(r) for r in b] for b in jb]
        assert [id(r) for r in tr] == [id(r) for r in jr] and td == jd
    trace = _arrivals(rng, 200, 3)
    for mult in (1, 4):
        assert tco.plan_schedule(trace, tpol, mult) == \
            jco.plan_schedule(trace, jpol, mult)


def test_coalesce_policy_validation():
    for kw in ({"max_batch": 0}, {"max_wait_s": -1.0},
               {"max_wait_s": float("inf")}):
        for mod in (jco, tco):
            with pytest.raises(ValueError):
                mod.CoalescePolicy(**kw)
    assert tco.CoalescePolicy(bucket_batches=False).bucket_size(5) == 5


def _tenants(mod):
    return {"interactive": mod.TenantPolicy(weight=1.0, priority=0),
            "heavy": mod.TenantPolicy(weight=3.0, priority=1),
            "light": mod.TenantPolicy(weight=1.0, priority=1,
                                      max_inflight=4, max_queued=8)}


def test_wfq_order_charge_and_snapshot():
    rng = np.random.default_rng(7)
    names = ("interactive", "heavy", "light", "stranger")
    js, ts = jsched.WFQScheduler(_tenants(jsched)), \
        tsched.WFQScheduler(_tenants(tsched))
    for cycle in range(30):
        entries = [(names[int(rng.integers(0, 4))],
                    float(rng.uniform(0.1, 5.0)), f"b{cycle}.{i}")
                   for i in range(int(rng.integers(1, 7)))]
        jo, to = js.order(entries), ts.order(entries)
        assert to == jo
        for tenant, cost, _ in to[:int(rng.integers(0, len(to) + 1))]:
            assert ts.charge(tenant, cost) == js.charge(tenant, cost)
    assert ts.snapshot() == js.snapshot()
    assert ts.policy_for("stranger") == tsched.TenantPolicy()


@pytest.mark.parametrize("segment_s", [None, 2e-3])
def test_plan_wfq_schedule(segment_s):
    rng = np.random.default_rng(11)
    tenants = ("interactive", "heavy", "light")
    arrivals = [(t, tenants[int(k) % 3], int(k) % 2)
                for t, k in _arrivals(rng, 150, 6)]
    kw = dict(request_cost_s=2e-4, num_replicas=2, segment_s=segment_s)
    jout = jsched.plan_wfq_schedule(
        arrivals, jco.CoalescePolicy(max_batch=8, max_wait_s=1e-3),
        _tenants(jsched), autoscale=jrec.AutoscalePolicy(
            max_replicas=3, scale_up_drain_s=1e-3, scale_down_idle_s=5e-3,
            cooldown_s=1e-3), **kw)
    tout = tsched.plan_wfq_schedule(
        arrivals, tco.CoalescePolicy(max_batch=8, max_wait_s=1e-3),
        _tenants(tsched), autoscale=trec.AutoscalePolicy(
            max_replicas=3, scale_up_drain_s=1e-3, scale_down_idle_s=5e-3,
            cooldown_s=1e-3), **kw)
    assert tout == jout
    assert tout["totals"]["dispatches"] > 0


@pytest.mark.parametrize("kw", [{"weight": 0.0}, {"weight": -1.0},
                                {"priority": -1}, {"max_inflight": 0},
                                {"max_queued": 0}])
def test_tenant_policy_validation(kw):
    for mod in (jsched, tsched):
        with pytest.raises(ValueError):
            mod.TenantPolicy(**kw)
    with pytest.raises(TypeError):
        tsched.WFQScheduler({"a": {"weight": 1.0}})


def test_classify_matches_jax():
    shared = [ValueError("x"), TypeError("x"), KeyError("x"),
              IndexError("x"), AttributeError("x"), AssertionError("x"),
              NotImplementedError("x"), ZeroDivisionError("x"),
              RuntimeError("x"), OSError("x"), TimeoutError("x")]
    for e in shared:
        assert trec.classify(e) == jrec.classify(e), e
    assert trec.classify(tq.QuESTError("bad")) == \
        jrec.classify(jq.QuESTError("bad")) == trec.FATAL
    for fmod, hmod, rmod in ((jfaults, jhealth, jrec),
                             (tfaults, thealth, trec)):
        assert rmod.classify(fmod.InjectedFault("x")) == rmod.TRANSIENT
        assert rmod.classify(fmod.SimulatedOOM("x")) == rmod.TRANSIENT
        assert rmod.classify(hmod.NumericalFault("x")) == rmod.POISON
        assert rmod.classify(hmod.NumericalFault(
            "x", kind="precision")) == rmod.PRECISION


def test_the_card_fatal_cases():
    """A kernel that failed to build or launch and a sticky CUDA error are
    FATAL (the JAX package would call the RuntimeError TRANSIENT and retry
    it); a device out-of-memory error is TRANSIENT, as SimulatedOOM."""
    build = cuda_build.KernelBuildError("nvcc failed on layer_kernel.cu")
    launch = cuda_build.KernelLaunchError("layer kernel launch failed")
    assert isinstance(build, RuntimeError) and \
        jrec.classify(RuntimeError(str(build))) == jrec.TRANSIENT
    assert trec.classify(build) == trec.FATAL
    assert trec.classify(launch) == trec.FATAL
    assert trec.classify(torch.AcceleratorError("illegal address")) \
        == trec.FATAL
    assert trec.classify(torch.cuda.OutOfMemoryError("oom")) \
        == trec.TRANSIENT


def test_a_missing_toolkit_raises_the_build_error(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_build.os.path, "exists", lambda p: False)
    with pytest.raises(cuda_build.KernelBuildError, match="nvcc"):
        cuda_build._nvcc()


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_circuit_breaker_script():
    rng = np.random.default_rng(3)
    jc, tc = _Clock(), _Clock()
    jb = jrec.CircuitBreaker(threshold=3, window_s=1.0, cooldown_s=0.5,
                             clock=jc)
    tb = trec.CircuitBreaker(threshold=3, window_s=1.0, cooldown_s=0.5,
                             clock=tc)
    for _ in range(300):
        step = float(rng.uniform(0, 0.2))
        jc.t += step
        tc.t += step
        key = f"p{int(rng.integers(0, 2))}"
        op = int(rng.integers(0, 4))
        if op == 0:
            assert tb.allow(key) == jb.allow(key)
        elif op == 1:
            assert tb.record_failure(key) == jb.record_failure(key)
        elif op == 2:
            tb.record_success(key)
            jb.record_success(key)
        else:
            tb.release(key)
            jb.release(key)
        assert tb.state(key) == jb.state(key)
    assert tb.snapshot() == jb.snapshot() and tb.trips == jb.trips > 0


def test_resilience_policies():
    jr, tr = np.random.default_rng(5), np.random.default_rng(5)
    jp, tp = jrec.ResiliencePolicy(), trec.ResiliencePolicy()
    assert [tp.backoff(k, tr) for k in range(1, 12)] == \
        [jp.backoff(k, jr) for k in range(1, 12)]
    for kw in ({"backoff_base_s": -1.0}, {"backoff_jitter": -0.1},
               {"breaker_threshold": 0}, {"degrade_after": -1}):
        for mod in (jrec, trec):
            with pytest.raises(ValueError):
                mod.ResiliencePolicy(**kw)
    assert [trec.SupervisorPolicy().restart_delay(k) for k in (1, 2, 3)] \
        == [jrec.SupervisorPolicy().restart_delay(k) for k in (1, 2, 3)]


def test_fault_injector_schedule_and_poison():
    specs = [("transient", "serve.*", 0.3, (1, 4)), ("nan", "*", 0.2, ()),
             ("stall", "circuits.run", 0.0, (2,))]
    sites = ("serve.execute", "circuits.run", "serve.execute",
             "router.route") * 20
    out = []
    for mod in (jfaults, tfaults):
        inj = mod.FaultInjector([mod.FaultSpec(*s) for s in specs], seed=9,
                                max_faults=15)
        out.append(([inj.draw(site) for site in sites], inj.snapshot()))
    assert out[0] == out[1]
    arr = np.arange(24.0).reshape(4, 2, 3)
    jp = jfaults.FaultInjector([], seed=4).poison_array(arr)
    tinj = tfaults.FaultInjector([], seed=4)
    tp = tinj.poison_array(arr)
    np.testing.assert_array_equal(tp, jp)
    assert np.isfinite(arr).all()            # the input is left alone
    tt = tfaults.FaultInjector([], seed=4).poison_array(torch.tensor(arr))
    np.testing.assert_array_equal(tt.numpy(), jp)
    with pytest.raises(ValueError):
        tfaults.FaultSpec("unknown")


def test_fire_raises_and_returns_like_jax():
    for mod in (jfaults, tfaults):
        assert mod.fire("serve.execute") is False
        inj = mod.FaultInjector([mod.FaultSpec("oom", at_calls=(0,)),
                                 mod.FaultSpec("precision", at_calls=(1,))])
        with mod.inject(inj):
            with pytest.raises(mod.SimulatedOOM):
                mod.fire("serve.execute")
            assert mod.fire("serve.execute") == "precision"
        assert mod.active() is None


def _planes(rng, batch, n, density=False):
    p = rng.normal(size=(batch, 2, 1 << n))
    if not density:
        p /= np.sqrt((p * p).sum(axis=(1, 2)))[:, None, None]
    return p


def test_health_screens_match_jax():
    rng = np.random.default_rng(17)
    cfg = dict(cadence=1, norm_tol=1e-6)
    good = _planes(rng, 3, 4)
    for planes in (good, good[0]):
        for arr in (planes, torch.tensor(planes)):
            out = thealth.check_planes(arr, config=thealth.HealthConfig(**cfg))
            assert out is arr
    bad = good.copy()
    bad[1, 0, 3] = np.nan
    drift = good.copy()
    drift[2] *= 1.01
    for planes, kind in ((bad, "nan"), (drift, "norm")):
        errs = []
        for mod, arr in ((jhealth, planes), (thealth, planes),
                         (thealth, torch.tensor(planes))):
            with pytest.raises(mod.NumericalFault) as ei:
                mod.check_planes(arr, config=mod.HealthConfig(**cfg))
            errs.append((ei.value.kind, ei.value.rows))
        assert errs[0] == errs[1] == errs[2] == (kind, (1,) if kind == "nan"
                                                  else (2,))
    with pytest.warns(UserWarning, match="renormalizing"):
        j = np.asarray(jhealth.check_planes(
            drift, config=jhealth.HealthConfig(mode="renormalize")))
    with pytest.warns(UserWarning, match="renormalizing"):
        t = thealth.check_planes(torch.tensor(drift), config=thealth.
                                 HealthConfig(mode="renormalize"))
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-15)
    # a density register's trace (logical 2 qubits: 16 flat amplitudes)
    rho = np.zeros((2, 16))
    rho[0, [0, 5, 10, 15]] = [0.4, 0.3, 0.2, 0.1]
    thealth.check_planes(rho, is_density=True, num_qubits=2,
                         config=thealth.HealthConfig())
    for mod in (jhealth, thealth):
        with pytest.raises(mod.NumericalFault, match="trace") as ei:
            mod.check_planes(rho * 1.5, is_density=True, num_qubits=2,
                             config=mod.HealthConfig())
        assert ei.value.kind == "trace"
    norms = thealth.plane_norms(drift)
    np.testing.assert_array_equal(norms, jhealth.plane_norms(drift))
    assert list(thealth.drifted_rows(norms, 1e-3)) == \
        list(jhealth.drifted_rows(norms, 1e-3)) == [2]
    assert list(thealth.bad_plane_rows(bad)) == [1]
    assert list(thealth.bad_value_rows([1.0, np.inf, 2.0])) == [1]
