"""The PyTorch port's algorithm library (``quest_tpu_torch.algorithms``)
against the JAX package's, on the CPU in float64.

- every builder in both packages at the same arguments, compiled and run
  (the JAX package with ``pallas=False``), gives states within 1e-12, and
  the non-circuit helpers the same values; bad arguments raise the same
  ``ValueError`` with the same message;
- the mirrors of ``tests/test_algor.py`` (QFT and Grover against the
  stored goldens at 1e-10, the inverse QFT, the rotation composition of
  the reference's ``rotate_test``, at 6 qubits) and of
  ``tests/test_algorithms_ext.py`` (phase estimation, Trotter evolution
  against ``expm``, the validations, Shor order finding at 6 qubits,
  parameter sweeps, QAOA optimised through the port's adjoint gradients);
- ``trotter_evolution`` after the prep program, through ``sweep``, against
  ``evolve_sweep`` of the same Hamiltonian at orders 1 and 2 within 1e-12.
"""

import math
import os

import numpy as np
import pytest
import torch
from scipy.linalg import expm

import quest_tpu as jq
from quest_tpu import algorithms as jalg
import quest_tpu_torch as tq
from quest_tpu_torch import algorithms as talg
from quest_tpu_torch.ops import dynamics as tdyn
from torch_threads import one_blas_thread  # noqa: F401

TOL = 1e-12
ALGOR_DIR = os.path.join(os.path.dirname(__file__), "golden", "algor")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def envs():
    return (jq.createQuESTEnv(num_devices=1, precision=jq.DOUBLE, seed=[9]),
            tq.createQuESTEnv(device="cpu", precision=tq.DOUBLE, seed=[9]))


@pytest.fixture(scope="module")
def env(envs):
    return envs[1]


def _eigenphase_unitary(phi, seed=3):
    """A 2-qubit unitary with eigenphase ``phi`` on its eigenvector 0, and
    that eigenvector (tests/test_algorithms_ext.py)."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4))
    evals, evecs = np.linalg.eigh(z + z.conj().T)
    phases = rng.uniform(0, 1, size=4)
    phases[0] = phi
    return (evecs * np.exp(2j * np.pi * phases)) @ evecs.conj().T, evecs


TERMS = [((0, 1), (1, 1)), ((1, 2), (2, 3)), ((3, 3),), ((0, 3), (2, 1))]
COEFFS = [0.7, -0.4, 0.9, 0.25]
EDGES = [(0, 1), (1, 2), (2, 3), (3, 0)]

# case -> (builder, its arguments, start: "zero" | "debug" | a basis
# index, parameters to bind)
BUILDERS = {
    "qft": ("qft", (5,), "debug", None),
    "qft_no_swaps": ("qft", (4, False), "debug", None),
    "inverse_qft": ("inverse_qft", (5,), "debug", None),
    "grover": ("grover", (5, 19), "zero", None),
    "grover_iterations": ("grover", (4, 3, 2), "zero", None),
    "bernstein_vazirani": ("bernstein_vazirani", (6, 0b101101), "zero",
                           None),
    "ghz": ("ghz", (5,), "zero", None),
    "random_circuit": ("random_circuit", (5, 4, 3), "zero", None),
    "random_circuit_haar": ("random_circuit", (4, 3, 1, "haar"), "zero",
                            None),
    "phase_estimation": ("phase_estimation", (4, np.diag(
        [1.0, np.exp(2j * np.pi * 5 / 16)])), 1 << 4, None),
    "phase_estimation_2q": ("phase_estimation",
                            (3, _eigenphase_unitary(0.3)[0]), "debug", None),
    "trotter_evolution": ("trotter_evolution",
                          (4, TERMS, COEFFS, 0.8, 5, 1), "debug", None),
    "trotter_evolution_2": ("trotter_evolution",
                            (4, TERMS, COEFFS, 0.8, 5, 2), "debug", None),
    "order_finding": ("order_finding", (2, 5, 3), "zero", None),
    "qaoa_maxcut": ("qaoa_maxcut", (4, EDGES, 2), "zero",
                    {"gamma0": 0.4, "beta0": 0.3, "gamma1": -0.2,
                     "beta1": 0.9}),
}


def _run(pkg, env, circuit, start, params, **compile_kw):
    q = pkg.createQureg(circuit.num_qubits, env)
    if start == "zero":
        pkg.initZeroState(q)
    elif start == "debug":
        pkg.initDebugState(q)
    else:
        pkg.initClassicalState(q, start)
    circuit.compile(env, **compile_kw).run(q, params)
    return q.to_numpy()


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builders_match_jax(envs, name):
    builder, args, start, params = BUILDERS[name]
    jc = getattr(jalg, builder)(*args)
    tc = getattr(talg, builder)(*args)
    assert tc.num_qubits == jc.num_qubits and len(tc.ops) == len(jc.ops)
    assert tc.param_names == jc.param_names
    want = _run(jq, envs[0], jc, start, params, pallas=False)
    got = _run(tq, envs[1], tc, start, params)
    assert np.abs(got - want).max() <= TOL


def test_helpers_match_jax():
    for a, m, bits in ((7, 15, None), (2, 5, None), (4, 9, 5)):
        np.testing.assert_array_equal(
            talg.modular_multiplication_unitary(a, m, bits),
            jalg.modular_multiplication_unitary(a, m, bits))
    for args in ((64, 8, 15), (192, 8, 15), (0, 8, 15), (5, 4, 7)):
        assert talg.order_from_phase(*args) == jalg.order_from_phase(*args)
    assert talg.qaoa_maxcut_terms(EDGES) == jalg.qaoa_maxcut_terms(EDGES)
    assert talg.__all__ == jalg.__all__


def _message(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("call", [
    lambda a: a.grover(3, 8),
    lambda a: a.random_circuit(3, 2, gate_set="x"),
    lambda a: a.phase_estimation(2, np.eye(4), num_target=1),
    lambda a: a.trotter_evolution(2, [((0, 3),)], [1.0], 1.0, 0),
    lambda a: a.trotter_evolution(2, [((0, 3),)], [1.0], 1.0, 5, order=3),
    lambda a: a.trotter_evolution(2, [((0, 7),)], [1.0], 1.0, 5),
    lambda a: a.trotter_evolution(2, [((0, 0),)], [1.0], 1.0, 5),
    lambda a: a.trotter_evolution(2, [((0, 3),)], [1.0, 2.0], 1.0, 5),
    lambda a: a.modular_multiplication_unitary(3, 15),
    lambda a: a.modular_multiplication_unitary(7, 15, num_bits=3),
    lambda a: a.modular_multiplication_unitary(1, 1),
    lambda a: a.order_from_phase(256, 8, 15),
    lambda a: a.qaoa_maxcut(3, [(0, 3)], 1),
    lambda a: a.qaoa_maxcut(3, [(1, 1)], 1),
    lambda a: a.qaoa_maxcut(3, [(0, 1)], 0),
])
def test_rejections_match_jax(call):
    want = _message(lambda: call(jalg))
    assert want is not None
    assert _message(lambda: call(talg)) == want


# -- tests/test_algor.py ------------------------------------------------------


def _read_states(path):
    with open(path) as f:
        assert f.readline().startswith("# golden-algor")
        n = int(f.readline().split()[0])
        rest = [ln.split() for ln in f if ln.strip()]
    amps = np.array([complex(float(r), float(i)) for r, i in rest])
    return n, amps.reshape(-1, 1 << n)


def test_qft_forward_and_back_vs_golden(env):
    n, states = _read_states(os.path.join(ALGOR_DIR, "QFT.test"))
    q = tq.createQureg(n, env)
    tq.initZeroState(q)
    qft = talg.qft(n).compile(env)
    qft.run(q)
    np.testing.assert_allclose(q.to_numpy(), states[0], atol=1e-10)
    qft.run(q)
    np.testing.assert_allclose(q.to_numpy(), states[1], atol=1e-10)


def test_inverse_qft_restores(env):
    n = 5
    q = tq.createQureg(n, env)
    tq.initDebugState(q)
    want = q.to_numpy()
    talg.qft(n).compile(env).run(q)
    talg.inverse_qft(n).compile(env).run(q)
    np.testing.assert_allclose(q.to_numpy(), want, atol=1e-10)


def test_grover_hit_probability_vs_golden(env):
    with open(os.path.join(ALGOR_DIR, "grover.test")) as f:
        f.readline()
        n, marked = (int(x) for x in f.readline().split())
        want = [float(ln) for ln in f if ln.strip()]
    for iters, p_want in enumerate(want, start=1):
        q = tq.createQureg(n, env)
        tq.initZeroState(q)
        talg.grover(n, marked, num_iterations=iters).compile(env).run(q)
        assert tq.getProbAmp(q, marked) == pytest.approx(p_want, abs=1e-10)
    assert max(want) > 0.95


def _rot_alpha_beta():
    angs = [1.2, -2.4, 0.3]
    alpha = complex(math.cos(angs[0]) * math.cos(angs[1]),
                    math.cos(angs[0]) * math.sin(angs[1]))
    beta = complex(math.sin(angs[0]) * math.cos(angs[2]),
                   math.sin(angs[0]) * math.sin(angs[2]))
    return alpha, beta


def test_rotate_and_back(env):
    """The reference's rotate_test.test, at 6 qubits: rotate every qubit
    with compactUnitary, then back with the conjugate transpose."""
    n = 6
    alpha, beta = _rot_alpha_beta()
    q = tq.createQureg(n, env)
    verif = tq.createQureg(n, env)
    tq.initDebugState(q)
    tq.initDebugState(verif)
    for t in range(n):
        tq.compactUnitary(q, t, alpha, beta)
    assert np.max(np.abs(q.to_numpy() - verif.to_numpy())) > 1e-3
    for t in range(n):
        tq.compactUnitary(q, t, alpha.conjugate(), -beta)
    np.testing.assert_allclose(q.to_numpy(), verif.to_numpy(), atol=1e-10)
    tq.initPlusState(q)
    for t in range(n):
        tq.compactUnitary(q, t, alpha, beta)
    assert tq.calcTotalProb(q) == pytest.approx(1.0, abs=1e-10)


# -- tests/test_algorithms_ext.py ---------------------------------------------


def test_phase_estimation_exact_phase(env):
    nc = 4
    for m in (1, 5, 11):
        u = np.diag([1.0, np.exp(2j * np.pi * m / 16.0)])
        q = tq.createQureg(nc + 1, env)
        tq.initClassicalState(q, 1 << nc)
        talg.phase_estimation(nc, u).compile(env).run(q)
        amps = np.abs(q.to_numpy()) ** 2
        assert amps[(1 << nc) | m] > 1 - 1e-10


def test_phase_estimation_two_qubit_unitary(env):
    """At 4 counting qubits (6 in all): the counting distribution peaks at
    the phase bin nearest 0.3."""
    nc, phi = 4, 0.3
    u, evecs = _eigenphase_unitary(phi)
    q = tq.createQureg(nc + 2, env)
    psi = np.zeros(1 << (nc + 2), complex)
    for t_idx in range(4):
        psi[t_idx << nc] = evecs[t_idx, 0]
    tq.initStateFromAmps(q, psi.real, psi.imag)
    talg.phase_estimation(nc, u).compile(env).run(q)
    counting = (np.abs(q.to_numpy()) ** 2).reshape(4, 1 << nc).sum(axis=0)
    best = int(np.argmax(counting))
    assert abs(best / (1 << nc) - phi) < 1.0 / (1 << nc)
    assert counting[best] > 0.4


def _pauli_mat(code):
    return {1: np.array([[0, 1], [1, 0]], complex),
            2: np.array([[0, -1j], [1j, 0]]),
            3: np.diag([1.0, -1.0]).astype(complex)}[code]


def _hamiltonian(n, terms, coeffs):
    h = np.zeros((1 << n, 1 << n), complex)
    for term, w in zip(terms, coeffs):
        full = np.eye(1, dtype=complex)
        mats = {q: _pauli_mat(c) for q, c in term}
        for q in range(n - 1, -1, -1):
            full = np.kron(full, mats.get(q, np.eye(2, dtype=complex)))
        h += w * full
    return h


@pytest.mark.parametrize("order,steps,tol", [(1, 200, 2e-3), (2, 20, 2e-4)])
def test_trotter_matches_expm(env, order, steps, tol):
    n, t = 4, 0.8
    psi0 = np.arange(1, (1 << n) + 1, dtype=complex)
    psi0 /= np.linalg.norm(psi0)
    want = expm(-1j * _hamiltonian(n, TERMS, COEFFS) * t) @ psi0
    q = tq.createQureg(n, env)
    tq.initStateFromAmps(q, psi0.real, psi0.imag)
    talg.trotter_evolution(n, TERMS, COEFFS, t, steps,
                           order=order).compile(env).run(q)
    assert np.max(np.abs(q.to_numpy() - want)) < tol


def test_trotter_identity_factors_drop_out(env):
    a = talg.trotter_evolution(2, [((0, 0), (1, 1))], [0.4], 1.0, 3)
    b = talg.trotter_evolution(2, [((1, 1),)], [0.4], 1.0, 3)
    out = []
    for c in (a, b):
        q = tq.createQureg(2, env)
        tq.initPlusState(q)
        c.compile(env).run(q)
        out.append(q.to_numpy())
    np.testing.assert_allclose(out[0], out[1], atol=1e-12)


def test_order_finding_shor(env):
    """a = 2 mod 5 has order 4: with 3 counting qubits the distribution
    sits on the multiples of 8/4, and continued fractions recover 4."""
    nc = 3
    c = talg.order_finding(2, 5, num_counting=nc)
    q = tq.createQureg(c.num_qubits, env)
    tq.initZeroState(q)
    c.compile(env).run(q)
    probs = np.sum(np.abs(q.to_numpy().reshape(-1, 1 << nc)) ** 2, axis=0)
    peaks = sorted(int(i) for i in np.argsort(probs)[-4:])
    assert peaks == [0, 2, 4, 6]
    assert probs[peaks].sum() > 1.0 - 1e-9
    assert talg.order_from_phase(2, nc, 5) == 4
    assert talg.order_from_phase(6, nc, 5) == 4


def test_sweep_batches_parameters(env):
    c = tq.Circuit(3)
    th = c.parameter("th")
    for q in range(3):
        c.ry(q, th)
    f = c.compile(env)
    batch = f.sweep(np.linspace(0, np.pi, 5).reshape(5, 1)).numpy()
    assert batch.shape == (5, 2, 8)
    assert abs(batch[0, 0, 0] - 1.0) < 1e-6
    assert abs(batch[-1, 0, 7] ** 2 + batch[-1, 1, 7] ** 2 - 1.0) < 1e-6
    with pytest.raises(ValueError):
        f.sweep(np.zeros((5, 2)))


def test_qaoa_maxcut_optimises(env):
    """2 QAOA layers on the 4-cycle by gradient descent through the
    port's adjoint gradients: the energy approaches -2 (all four edges
    cut); ``expectation_fn``'s backward gives the sweep's gradient."""
    c = talg.qaoa_maxcut(4, EDGES, num_layers=2)
    f = c.compile(env)
    ham = talg.qaoa_maxcut_terms(EDGES)
    params = np.array([0.5, 0.5, 0.3, 0.3])
    theta = torch.tensor(params, requires_grad=True)
    energy = f.expectation_fn(*ham)(theta)
    energy.backward()
    value, grad = f.value_and_grad_sweep(params[None, :], ham)
    assert abs(float(energy.detach()) - value[0]) <= TOL
    assert np.abs(theta.grad.numpy() - grad[0]).max() <= TOL
    for _ in range(150):
        params = params - 0.15 * f.grad_sweep(params[None, :], ham)[0]
    assert f.expectation_sweep(params[None, :], ham)[0] < -1.95


# -- the gate form against evolve_sweep ---------------------------------------


@pytest.mark.parametrize("order", [1, 2])
def test_trotter_evolution_matches_evolve_sweep(env, order):
    n, t, steps = 5, 0.8, 6
    terms = [[(q, 3), (q + 1, 3)] for q in range(n - 1)]
    terms += [[(q, 1)] for q in range(n)] + [[(0, 2), (3, 1)]]
    coeffs = [1.0] * (n - 1) + [0.7] * n + [0.45]
    prep = tq.Circuit(n)
    for q in range(n):
        prep.ry(q, prep.parameter(f"y{q}"))
    for q in range(n - 1):
        prep.cnot(q, q + 1)
    pm = np.random.default_rng(4).normal(size=(3, n)) * 0.3
    block = prep.compile(env).evolve_sweep(
        pm, (terms, coeffs), tdyn.EvolveSpec(t=t, steps=steps, order=order))
    got = tdyn.unpack_evolve_block(block, n, steps)["planes"]
    gate = tq.Circuit(n).extend(prep).extend(talg.trotter_evolution(
        n, terms, coeffs, t, steps, order=order))
    want = gate.compile(env).sweep(pm).numpy()
    assert np.abs(got - want).max() <= TOL
