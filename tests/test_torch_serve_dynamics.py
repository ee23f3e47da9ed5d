"""The port's streamed Hamiltonian dynamics against the JAX package's, on the
CPU.

``service.evolve`` streams its segments with the JAX package's energies,
Welford carry and planes at 1e-12, and a segmented run equals an
unsegmented one and a direct ``evolve_sweep``; ``service.ground_state``
agrees with the JAX package's, and a run that is pre-empted, faulted and
resumed from its checkpoint ends bit for bit where the uninterrupted run
ends. Programs of 4 qubits at DOUBLE.
"""

import numpy as np
import pytest
import torch

import quest_tpu as jq
from quest_tpu.serve import SimulationService as JService
import quest_tpu_torch as tq
from quest_tpu_torch.ops import dynamics as tdyn
from quest_tpu_torch.resilience import FaultInjector, FaultSpec, inject
from quest_tpu_torch.serve import dynamics as tsd
from torch_threads import one_blas_thread, port_lock_order  # noqa: F401

TOL = 1e-12
TIMEOUT = 30
N = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def prep(C, n=N):
    c = C(n)
    for q in range(n):
        c.ry(q, c.parameter(f"y{q}"))
    for q in range(n - 1):
        c.cnot(q, q + 1)
    return c


def tfim(n=N, h=0.7):
    terms = [[(q, 3), (q + 1, 3)] for q in range(n - 1)]
    terms += [[(q, 1)] for q in range(n)]
    return terms, [1.0] * (n - 1) + [h] * n


PARAMS = np.linspace(0.2, 1.0, N)


def tservice(**kw):
    env = tq.createQuESTEnv(device="cpu", precision=tq.DOUBLE, seed=[3])
    return tq.createSimulationService(env, max_wait_s=1e-3, **kw)


def jservice():
    env = jq.createQuESTEnv(num_devices=1, precision=jq.DOUBLE, seed=[3])
    return JService(env, max_wait_s=1e-3)


def run(handle):
    its = list(handle.iterates())
    return its, handle.result(timeout=TIMEOUT)


def test_evolve_segments_equal_the_jax_packages():
    kw = dict(hamiltonian=tfim(), t=0.6, steps=6, segment_steps=4)
    with tservice() as svc:
        t_its, t_res = run(svc.evolve(prep(tq.Circuit), PARAMS, **kw))
        snap = svc.dispatch_stats()["service"]
    with jservice() as svc:
        j_its, j_res = run(svc.evolve(prep(jq.Circuit), PARAMS, **kw))
    assert [i["steps_done"] for i in t_its] == [4, 6]
    assert [i["segment"] for i in t_its] == [i["segment"] for i in j_its]
    for a, b in zip(t_its, j_its):
        np.testing.assert_allclose(a["energies"], b["energies"], atol=TOL)
        np.testing.assert_allclose(a["welford"], b["welford"], atol=TOL)
    for key in ("energies", "planes", "welford"):
        np.testing.assert_allclose(t_res[key], np.asarray(j_res[key]),
                                   atol=TOL)
    assert abs(t_res["energy"] - j_res["energy"]) < TOL
    assert (t_res["segments"], t_res["steps"]) == (2, 6)
    assert (snap["dynamics_runs"], snap["evolve_dispatches"],
            snap["evolve_steps_fused"]) == (1, 2, 6)


def test_segmented_equals_unsegmented_and_the_direct_sweep():
    kw = dict(hamiltonian=tfim(), t=0.8, steps=8)
    with tservice() as svc:
        _, split = run(svc.evolve(prep(tq.Circuit), PARAMS, segment_steps=3,
                                  **kw))
        _, whole = run(svc.evolve(prep(tq.Circuit), PARAMS,
                                  segment_steps=64, **kw))
    assert (split["segments"], whole["segments"]) == (3, 1)
    np.testing.assert_allclose(split["energies"], whole["energies"],
                               atol=TOL)
    np.testing.assert_allclose(split["planes"], whole["planes"], atol=TOL)
    np.testing.assert_allclose(split["welford"], whole["welford"], atol=TOL)
    env = tq.createQuESTEnv(device="cpu", precision=tq.DOUBLE, seed=[3])
    block = prep(tq.Circuit).compile(env).evolve_sweep(
        PARAMS[None], tfim(), tq.EvolveSpec(t=0.8, steps=8, order=2))
    direct = tdyn.unpack_evolve_block(block, N, 8)
    np.testing.assert_allclose(whole["energies"], direct["energies"][0],
                               atol=TOL)
    np.testing.assert_allclose(whole["planes"],
                               np.asarray(direct["planes"][0]), atol=TOL)


def test_ground_state_equals_the_jax_packages():
    kw = dict(hamiltonian=tfim(), steps=5, tau=0.2, tol=1e-12,
              max_segments=3)
    with tservice() as svc:
        t_its, t_res = run(svc.ground_state(prep(tq.Circuit), PARAMS, **kw))
    with jservice() as svc:
        j_its, j_res = run(svc.ground_state(prep(jq.Circuit), PARAMS, **kw))
    assert len(t_its) == len(j_its) == 3
    for a, b in zip(t_its, j_its):
        np.testing.assert_allclose(a["energies"], b["energies"], atol=TOL)
        assert abs(a["residual"] - b["residual"]) < TOL
    np.testing.assert_allclose(t_res["planes"], np.asarray(j_res["planes"]),
                               atol=TOL)
    assert t_res["converged"] == j_res["converged"] is False
    assert t_its[-1]["energy"] < t_its[0]["energies"][0]


def test_ground_state_converges_and_stops():
    with tservice() as svc:
        its, res = run(svc.ground_state(
            prep(tq.Circuit), PARAMS, hamiltonian=tfim(), steps=8,
            tau=0.3, tol=1e-2, max_segments=20))
        snap = svc.dispatch_stats()["service"]
    assert res["converged"] and res["residual"] <= 1e-2
    assert res["segments"] < 20 and its[-1]["converged"]
    assert snap["ground_converged"] == 1


def test_faulted_preempted_ground_state_resumes_bit_exact(tmp_path):
    """Pre-empted twice at segment boundaries, killed by a fault at the
    third segment with no restart budget, resumed from the checkpoint:
    the run ends where the uninterrupted one ends, bit for bit."""
    kw = dict(hamiltonian=tfim(), steps=4, tau=0.2, tol=1e-14,
              max_segments=4)
    with tservice() as svc:
        _, clean = run(svc.ground_state(prep(tq.Circuit), PARAMS, **kw))
        path = str(tmp_path / "ground.npz")
        pressure = iter([True, False, True, False])
        svc.interactive_pressure = lambda: next(pressure, False)
        with inject(FaultInjector([FaultSpec(
                "transient", site="serve.evolve", at_calls=(2,))], seed=1)):
            h = svc.ground_state(prep(tq.Circuit), PARAMS,
                                 checkpoint_path=path, max_restarts=0,
                                 preempt_hold_s=0.05, **kw)
            first = list(h.iterates())
        del svc.interactive_pressure
        assert h.exception is not None and len(first) == 2
        second, res = run(svc.ground_state(prep(tq.Circuit), PARAMS,
                                           checkpoint_path=path, **kw))
        snap = svc.dispatch_stats()["service"]
    assert res["resumed_from"] == 1 and len(second) == 2
    assert snap["preemptions"] >= 1 and snap["dynamics_resumes"] == 1
    assert np.array_equal(res["planes"], clean["planes"])
    assert np.array_equal(res["energies"], clean["energies"])
    assert np.array_equal(res["welford"], clean["welford"])
    assert res["residual"] == clean["residual"]
    assert [i["segment"] for i in first + second] == [0, 1, 2, 3]


def test_evolve_resume_and_digest_guard(tmp_path):
    path = str(tmp_path / "evolve.npz")
    kw = dict(hamiltonian=tfim(), t=0.6, steps=6, segment_steps=2,
              checkpoint_path=path)
    with tservice() as svc:
        _, clean = run(svc.evolve(prep(tq.Circuit), PARAMS, **kw))
        assert clean["resumed_from"] is None
        _, again = run(svc.evolve(prep(tq.Circuit), PARAMS, **kw))
        assert again["resumed_from"] == 2 and again["segments"] == 0
        assert np.array_equal(again["planes"], clean["planes"])
        _, other = run(svc.evolve(prep(tq.Circuit), PARAMS + 0.1, **kw))
        assert other["resumed_from"] is None


def test_problem_validation():
    with pytest.raises(TypeError, match="EvolveSpec"):
        tsd.DynamicsProblem(prep(tq.Circuit), tfim(), spec=object())
    p = tsd.DynamicsProblem(prep(tq.Circuit), tfim(),
                            tq.EvolveSpec(t=0.1, steps=1))
    with pytest.raises(ValueError, match="binds none"):
        p.params_vector()
    with pytest.raises(ValueError):
        tsd.run_dynamics(None, p, segment_steps=0)
    assert p.kind == "evolve" and isinstance(p, tq.DynamicsProblem)
