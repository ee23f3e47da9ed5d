"""The port's optimizer-in-the-loop serving against the JAX package's, on
the CPU.

``VariationalProblem.digest`` hashes what the JAX package's does, byte for
byte: equal wherever the two packages' circuit digests are equal (a
circuit of static gates; a Param gate's digest hashes each package's own
gate code, so there the circuit digests differ and the tests give both
packages one). ``GradientDescent`` and ``Adam`` step as the JAX package's
do at 1e-15; a 6-qubit HEA's iterates through ``service.optimize`` equal
the JAX package's at 1e-12; a run killed by a fault resumes bit for bit;
the digest guards a checkpoint; a progress file crosses packages; and a
trajectory objective's iterate equals a direct ``expectation_grad_batch``
from the same generator state (and the JAX package's at 1e-12 when its
channels have strength 0).
"""

import numpy as np
import pytest
import torch

import quest_tpu as jq
from quest_tpu.serve import SimulationService as JService
from quest_tpu.serve import optimize as jopt
from quest_tpu.serve import warmcache as jwc
import quest_tpu_torch as tq
from quest_tpu_torch.resilience import FaultInjector, FaultSpec, inject
from quest_tpu_torch.serve import optimize as topt
from quest_tpu_torch.serve import warmcache as twc
from torch_threads import one_blas_thread, port_lock_order  # noqa: F401

TOL = 1e-12
TIMEOUT = 30
N = 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def hea(C, n=N, layers=1):
    c = C(n)
    for layer in range(layers):
        for q in range(n):
            c.ry(q, c.parameter(f"y{layer}_{q}"))
            c.rz(q, c.parameter(f"z{layer}_{q}"))
        for q in range(n - 1):
            c.cnot(q, q + 1)
    return c


def ham(n=N):
    terms = [[(q, 3), (q + 1, 3)] for q in range(n - 1)]
    terms += [[(q, 1)] for q in range(n)]
    return terms, [1.0] * (n - 1) + [0.7] * n


def x0(n=N):
    return np.random.default_rng(42).uniform(0, np.pi, size=2 * n)


def tenv(seed=3):
    return tq.createQuESTEnv(device="cpu", precision=tq.DOUBLE, seed=[seed])


def jenv(seed=3):
    return jq.createQuESTEnv(num_devices=1, precision=jq.DOUBLE, seed=[seed])


def tservice(env=None, **kw):
    kw.setdefault("max_wait_s", 1e-3)
    return tq.createSimulationService(env or tenv(), **kw)


def jservice(env=None, **kw):
    kw.setdefault("max_wait_s", 1e-3)
    return JService(env or jenv(), **kw)


@pytest.fixture
def shared_circuit_digest(monkeypatch):
    """Both packages' circuit digests replaced by one package-neutral one
    (the ops' kinds and targets, the parameter names): what their digests
    agree on for a static circuit."""
    def neutral(circuit, is_density=False):
        return repr((circuit.num_qubits, bool(is_density),
                     tuple(circuit.param_names),
                     [(op.kind, tuple(op.targets)) for op in circuit.ops]))

    monkeypatch.setattr(jwc, "circuit_digest", neutral)
    monkeypatch.setattr(twc, "circuit_digest", neutral)


def iterates(handle):
    out = list(handle.iterates())
    return out, handle.result(timeout=TIMEOUT)


def test_problem_digest_is_the_jax_packages():
    """A circuit of static gates with declared parameters digests equally
    in both packages, and so does the problem over it, for every field."""
    def static(C):
        c = C(4)
        c.parameter("a")
        c.parameter("b")
        c.h(0).cnot(0, 1).rz(2, 0.3).swap(1, 3)
        return c

    h = ham(4)
    for kw in ({}, {"trajectories": 64}, {"sampling_budget": 1e-3},
               {"tier": "single"}):
        tp = tq.createVariationalProblem(static(tq.Circuit), h,
                                         {"a": 0.1, "b": 0.2}, **kw)
        jp = jq.createVariationalProblem(static(jq.Circuit), h,
                                         {"a": 0.1, "b": 0.2}, **kw)
        for extra in ("", "adam:0.05:0.9:0.999:1e-08"):
            assert tp.digest(extra) == jp.digest(extra), kw
    base = tq.createVariationalProblem(static(tq.Circuit), h, [0.1, 0.2])
    moved = tq.createVariationalProblem(static(tq.Circuit), h, [0.1, 0.3])
    assert base.digest() != moved.digest()
    assert isinstance(base, tq.VariationalProblem)


def test_problem_digest_of_a_param_circuit(shared_circuit_digest):
    tp = topt.VariationalProblem(hea(tq.Circuit), ham(), x0())
    jp = jopt.VariationalProblem(hea(jq.Circuit), ham(), x0())
    assert tp.digest("gd:0.1") == jp.digest("gd:0.1")
    with pytest.raises(ValueError, match="missing"):
        topt.VariationalProblem(hea(tq.Circuit), ham(), {}).x0_vector()
    with pytest.raises(ValueError, match="shape"):
        topt.VariationalProblem(hea(tq.Circuit), ham(), [0.0]).x0_vector()


@pytest.mark.parametrize("name", ["gd", "adam"])
def test_optimizer_steps_equal_jax(name):
    rng = np.random.default_rng(7)
    t_opt = topt.resolve_optimizer(name, 0.07)
    j_opt = jopt.resolve_optimizer(name, 0.07)
    assert t_opt.config() == j_opt.config()
    xt = xj = rng.normal(size=9)
    st, sj = t_opt.init(xt), j_opt.init(xj)
    for k in range(6):
        g = rng.normal(size=9)
        xt, st = t_opt.update(xt, g, st, k)
        xj, sj = j_opt.update(xj, g, sj, k)
        np.testing.assert_allclose(xt, xj, atol=1e-15, rtol=0)
        for key in sj:
            np.testing.assert_allclose(st[key], sj[key], atol=1e-15, rtol=0)
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.resolve_optimizer("lbfgs")
    with pytest.raises(TypeError):
        topt.resolve_optimizer(object())
    with pytest.raises(ValueError):
        topt.Adam(learning_rate=0.0)


@pytest.mark.parametrize("optimizer", ["adam", "gd"])
def test_iterates_equal_the_jax_packages(optimizer):
    kw = dict(max_iters=5, tol=0.0, learning_rate=0.1)
    with tservice() as svc:
        th = svc.optimize(topt.VariationalProblem(
            hea(tq.Circuit), ham(), x0()), optimizer, **kw)
        t_its, t_res = iterates(th)
        snap = svc.dispatch_stats()["service"]
    with jservice() as svc:
        jh = svc.optimize(jopt.VariationalProblem(
            hea(jq.Circuit), ham(), x0()), optimizer, **kw)
        j_its, j_res = iterates(jh)
    assert [i["iteration"] for i in t_its] == list(range(5))
    for a, b in zip(t_its, j_its):
        assert abs(a["value"] - b["value"]) < TOL
        assert abs(a["grad_norm"] - b["grad_norm"]) < TOL
        np.testing.assert_allclose(a["x"], b["x"], atol=TOL)
        assert a["converged"] == b["converged"]
    np.testing.assert_allclose(t_res["x"], j_res["x"], atol=TOL)
    assert t_res["iterations"] == j_res["iterations"] == 5
    assert t_its[-1]["value"] < t_its[0]["value"]
    assert (snap["optimizer_runs"], snap["optimizer_iterations"],
            snap["gradient_dispatches"]) == (1, 5, 5)


def test_converges_and_cancels():
    with tservice() as svc:
        h = svc.optimize(topt.VariationalProblem(
            hea(tq.Circuit), ham(), x0()), "gd", max_iters=200, tol=2e-2,
            learning_rate=0.15)
        its, res = iterates(h)
        assert res["converged"] and its[-1]["converged"]
        assert res["iterations"] < 200
        assert svc.dispatch_stats()["service"]["optimizer_converged"] == 1
        h = svc.optimize(topt.VariationalProblem(
            hea(tq.Circuit), ham(), x0()), max_iters=10 ** 6, tol=0.0)
        next(h.iterates())
        h.cancel()
        res = h.result(timeout=TIMEOUT)
        assert res["iterations"] < 10 ** 6 and h.done
    with pytest.raises(TypeError):
        topt.run_optimization(None, object())
    with pytest.raises(ValueError, match="no parameters"):
        static = tq.Circuit(3)
        static.h(0)
        topt.run_optimization(None, topt.VariationalProblem(static, ham(3),
                                                            []))


def test_resume_after_a_fault_is_bit_exact(tmp_path):
    """A run killed by a fault at iterate 5 (no restart budget) resumes
    from its checkpoint, and its iterates equal the clean run's bit for
    bit; with a restart budget the same fault re-executes the iterate."""
    problem = topt.VariationalProblem(hea(tq.Circuit), ham(), x0())
    kw = dict(max_iters=8, tol=0.0, learning_rate=0.1)
    with tservice() as svc:
        clean, _ = iterates(svc.optimize(problem, "adam", **kw))
        path = str(tmp_path / "opt.npz")
        fault = FaultInjector([FaultSpec("transient", site="serve.optimize",
                                         at_calls=(5,))], seed=1)
        with inject(fault):
            h = svc.optimize(problem, "adam", checkpoint_path=path,
                             max_restarts=0, **kw)
            first = list(h.iterates())
        assert h.exception is not None and len(first) == 5
        second, res = iterates(svc.optimize(problem, "adam",
                                            checkpoint_path=path, **kw))
        assert res["resumed_from"] == 4
        assert svc.dispatch_stats()["service"]["optimizer_resumes"] == 1
        with inject(FaultInjector([FaultSpec(
                "transient", site="serve.optimize", at_calls=(5,))],
                seed=1)):
            retried, rres = iterates(svc.optimize(problem, "adam", **kw))
    assert rres["restarts"] == 1
    for run in (first + second, retried):
        assert [i["iteration"] for i in run] == list(range(8))
        for a, b in zip(run, clean):
            assert a["value"] == b["value"]
            assert np.array_equal(a["x"], b["x"])


def test_the_digest_guards_the_checkpoint(tmp_path):
    path = str(tmp_path / "opt.npz")
    kw = dict(max_iters=2, tol=0.0, checkpoint_path=path)
    with tservice() as svc:
        _, res = iterates(svc.optimize(topt.VariationalProblem(
            hea(tq.Circuit), ham(), x0()), "adam", **kw))
        assert res["resumed_from"] is None
        _, res = iterates(svc.optimize(topt.VariationalProblem(
            hea(tq.Circuit), ham(), x0() + 0.1), "adam", **kw))
        assert res["resumed_from"] is None          # another x0
        _, res = iterates(svc.optimize(topt.VariationalProblem(
            hea(tq.Circuit), ham(), x0() + 0.1), "gd", **kw))
        assert res["resumed_from"] is None          # another optimizer
        _, res = iterates(svc.optimize(topt.VariationalProblem(
            hea(tq.Circuit), ham(), x0() + 0.1), "gd", **kw))
        assert res["resumed_from"] == 1


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_a_progress_file_crosses_packages(writer, tmp_path,
                                          shared_circuit_digest):
    """Three iterates checkpointed by one package, the rest by the other
    from that file: the iterates equal one package's whole run at
    1e-12."""
    path = str(tmp_path / "opt.npz")
    kw = dict(tol=0.0, learning_rate=0.1, checkpoint_path=path)
    runs = {"jax": (jservice, jopt, jq), "torch": (tservice, topt, tq)}
    reader = "torch" if writer == "jax" else "jax"
    with jservice() as svc:
        whole, _ = iterates(svc.optimize(jopt.VariationalProblem(
            hea(jq.Circuit), ham(), x0()), "adam", max_iters=6, tol=0.0,
            learning_rate=0.1))
    parts = []
    for who, iters in ((writer, 3), (reader, 6)):
        make, mod, pkg = runs[who]
        with make() as svc:
            its, res = iterates(svc.optimize(mod.VariationalProblem(
                hea(pkg.Circuit), ham(), x0()), "adam", max_iters=iters,
                **kw))
        parts += its
    assert res["resumed_from"] == 2
    assert [i["iteration"] for i in parts] == list(range(6))
    for a, b in zip(parts, whole):
        assert abs(a["value"] - b["value"]) < TOL
        np.testing.assert_allclose(a["x"], b["x"], atol=TOL)


def noisy(C, n=4, p=0.0):
    c = C(n)
    for q in range(n):
        c.ry(q, c.parameter(f"a{q}"))
    c.dephase(1, p)
    for q in range(n - 1):
        c.cnot(q, q + 1)
    c.damp(2, p)
    return c


def test_trajectory_objective_held_through_the_generator():
    """A real channel: the optimizer's first iterate equals a direct
    expectation_grad_batch drawn from the same generator state, and the
    gradient is within 5 stderr of the exact density-matrix gradient."""
    n, T = 4, 256
    h = ham(n)
    start = np.linspace(0.2, 1.1, n)
    env = tenv(seed=11)
    circ = noisy(tq.Circuit, n, p=0.2)
    with tservice(env) as svc:
        tq.seedQuEST(env, [11])
        its, _ = iterates(svc.optimize(topt.VariationalProblem(
            circ, h, start, trajectories=T), "gd", max_iters=1))
        snap = svc.dispatch_stats()["service"]
    assert snap["trajectory_dispatches"] == 1
    tq.seedQuEST(env, [11])
    tp = circ.compile_trajectories(env)
    vals, grads, errs, _ = tp.expectation_grad_batch(start[None], h, T,
                                                     live_rows=1)
    it = its[0]
    assert it["value"] == float(vals[0])
    assert np.array_equal(it["x"], start)
    assert np.array_equal(it["stderr"], np.asarray(errs[0]))
    dm = circ.compile(env, density=True)
    exact_v, exact_g = dm.value_and_grad_sweep(start[None], h)
    assert abs(it["value"] - exact_v[0]) <= 5 * errs[0][0] + 1e-12
    g = grads[0]
    assert np.all(np.abs(g - exact_g[0]) <= 5 * np.asarray(errs[0][1:])
                  + 1e-3 * np.abs(exact_g).max())


def test_quiet_trajectory_objective_equals_jax():
    """Channels of strength 0: both packages' trajectory gradients are
    exact, and the optimizer's iterates agree at 1e-12."""
    n = 4
    h = ham(n)
    start = np.linspace(0.3, 1.2, n)
    kw = dict(max_iters=2, tol=0.0, learning_rate=0.1)
    with tservice() as svc:
        t_its, _ = iterates(svc.optimize(topt.VariationalProblem(
            noisy(tq.Circuit, n), h, start, trajectories=16), "adam", **kw))
    with jservice() as svc:
        j_its, _ = iterates(svc.optimize(jopt.VariationalProblem(
            noisy(jq.Circuit, n), h, start, trajectories=16), "adam", **kw))
    for a, b in zip(t_its, j_its):
        assert abs(a["value"] - b["value"]) < TOL
        np.testing.assert_allclose(a["x"], b["x"], atol=TOL)


def test_router_optimize_counts_on_the_router():
    envs = tq.serve.replica_envs(2, precision=tq.DOUBLE, seed=[5],
                                 device="cpu")
    with tq.createServiceRouter(envs, max_wait_s=1e-3) as router:
        its, res = iterates(router.optimize(topt.VariationalProblem(
            hea(tq.Circuit), ham(), x0()), "adam", max_iters=3, tol=0.0))
        snap = router.metrics.snapshot()
    with tservice() as svc:
        want, _ = iterates(svc.optimize(topt.VariationalProblem(
            hea(tq.Circuit), ham(), x0()), "adam", max_iters=3, tol=0.0))
    assert (snap["optimizer_runs"], snap["optimizer_iterations"]) == (1, 3)
    for a, b in zip(its, want):
        assert a["value"] == b["value"]
