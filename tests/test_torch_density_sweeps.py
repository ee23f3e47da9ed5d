"""The PyTorch port's batched engine on density programs, and its density
gradients, against the JAX package's, on the CPU in float64.

- ``sweep`` and ``expectation_sweep`` of a density-compiled program (Param
  rotations, static channels) against the JAX engine at 1e-12 (the program
  of ``tests/test_batched_engine.py``'s density oracle);
- ``value_and_grad_sweep`` through a Param dephasing rate against the JAX
  package at 1e-9, and its rate column against a central difference at
  1e-8 (``tests/test_gradients.py``'s density test), on a program without
  layers and on one whose lifted plan puts channels into layers;
- the walk's store and recompute branches equal at 1e-12 (a private cap of
  no state, and of one state, against the default);
- ``sample_sweep`` on a density program raising the JAX package's
  ``ValueError``;
- ``applyPauliSum`` on state vectors and density registers against the JAX
  package at 1e-12, with its validation.
"""

import numpy as np
import pytest
import torch

import quest_tpu as jq
from quest_tpu.circuits import Circuit as JCircuit
import quest_tpu_torch as tq
from quest_tpu_torch.ops import adjoint as adj
from torch_threads import one_blas_thread  # noqa: F401

TOL = 1e-12
GRAD_TOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per worker: the suite runs in several worker
    processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def envs():
    return (jq.createQuESTEnv(num_devices=1, precision=jq.DOUBLE, seed=[3]),
            tq.createQuESTEnv(device="cpu", precision=tq.DOUBLE, seed=[3]))


def _hamiltonian(n, num_terms, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(num_terms, n))
    coeffs = rng.normal(size=num_terms)
    return [[(q, int(codes[t, q])) for q in range(n)]
            for t in range(num_terms)], coeffs


def _noisy_rotations(C, n=4):
    """tests/test_batched_engine.py's density oracle program: a Param ry
    column, two CNOTs, dephasing on qubit 1 and damping on qubit 2."""
    c = C(n)
    for q in range(n):
        c.ry(q, c.parameter(f"a{q}"))
    c.cnot(0, 1).cnot(2, 3)
    c.dephase(1, 0.2)
    c.damp(2, 0.1)
    return c


def _hea_with_rate(C, n, static_noise=False):
    """tests/test_gradients.py's density program: an ry/rz column, a CNOT
    ring, then a Param dephasing rate on qubit 0; ``static_noise`` adds a
    static h column and channels between the rotations and the ring (at
    n = 4 its lifted plan puts them into layers)."""
    c = C(n)
    for q in range(n):
        c.ry(q, c.parameter(f"y0_{q}"))
        c.rz(q, c.parameter(f"z0_{q}"))
    if static_noise:
        for q in range(n):
            c.h(q)
        c.damp(1, 0.15).depolarise(2, 0.1).dephase(3, 0.05)
    for q in range(n):
        c.cnot(q, (q + 1) % n)
    c.dephase(0, c.parameter("rate"))
    return c


def _rate_rows(rng, num_params, batch):
    return np.concatenate(
        [rng.uniform(0, 2 * np.pi, size=(batch, num_params - 1)),
         rng.uniform(0.05, 0.3, size=(batch, 1))], axis=1)


def test_density_sweep_matches_jax_engine(envs):
    n = 4
    jc = _noisy_rotations(JCircuit).compile(envs[0], density=True)
    tc = _noisy_rotations(tq.Circuit).compile(envs[1], density=True)
    pm = np.random.default_rng(20260729).uniform(0, 2 * np.pi, size=(5, n))
    ham = _hamiltonian(n, 6, seed=1)
    want = np.asarray(jc.sweep(pm))
    got = tc.sweep(pm)
    assert got.shape == (5, 2, 1 << (2 * n))
    assert np.abs(got.numpy() - want).max() <= TOL
    e_want = np.asarray(jc.expectation_sweep(pm, ham))
    e_got = tc.expectation_sweep(pm, ham)
    assert e_got.shape == (5,)
    assert np.abs(e_got - e_want).max() <= TOL
    # each row's value is its register's calcExpecPauliSum
    codes = [c for term in ham[0] for _, c in term]
    q = tq.createDensityQureg(n, envs[1])
    q.state = got[2].clone()
    assert abs(tq.calcExpecPauliSum(q, codes, ham[1]) - e_got[2]) <= TOL


@pytest.mark.parametrize("static_noise", [False, True],
                         ids=["no_layers", "channels_in_layers"])
def test_density_gradients_match_jax(envs, static_noise):
    n = 3 if not static_noise else 4
    jc = _hea_with_rate(JCircuit, n, static_noise).compile(envs[0],
                                                            density=True)
    tc = _hea_with_rate(tq.Circuit, n, static_noise).compile(envs[1],
                                                             density=True)
    if static_noise:
        layers = [op for op in tc._ops if op.kind == "layer"]
        assert layers and not all(
            adj.is_unitary(op) for op in layers)
    rng = np.random.default_rng(89 + n)
    pm = _rate_rows(rng, len(tc.param_names), 4)
    ham = _hamiltonian(n, 4, seed=n)
    want_v, want_g = (np.asarray(a) for a in jc.value_and_grad_sweep(pm, ham))
    vals, grads = tc.value_and_grad_sweep(pm, ham)
    assert np.abs(grads - want_g).max() <= GRAD_TOL
    assert np.abs(vals - want_v).max() <= GRAD_TOL
    assert np.abs(vals - tc.expectation_sweep(pm, ham)).max() <= TOL
    eps = 1e-6
    up, dn = pm.copy(), pm.copy()
    up[:, -1] += eps
    dn[:, -1] -= eps
    fd = (tc.expectation_sweep(up, ham) - tc.expectation_sweep(dn, ham)) \
        / (2 * eps)
    assert np.abs(grads[:, -1] - fd).max() <= 1e-8


def test_store_and_recompute_branches_agree(envs):
    """Three channels (one a Param rate): every input stored, one stored
    and two recomputed from it, none stored (recomputed from the start)."""
    n = 4
    tc = _hea_with_rate(tq.Circuit, n, static_noise=True).compile(
        envs[1], density=True)
    walk = tc._adjoint_walk(None)
    assert sum(not u for u in walk.unitary) >= 2
    pm = _rate_rows(np.random.default_rng(7), len(tc.param_names), 2)
    ham = _hamiltonian(n, 5, seed=17)
    stored = tc.value_and_grad_sweep(pm, ham)
    one_state = 2 * 2 * (1 << (2 * n)) * 8
    for cap in (one_state, 0):
        tc._adjoint_store_bytes = cap
        try:
            got = tc.value_and_grad_sweep(pm, ham)
        finally:
            tc._adjoint_store_bytes = None
        for a, b in zip(got, stored):
            assert np.abs(a - b).max() <= TOL


def test_density_sample_sweep_raises_like_jax(envs):
    with pytest.raises(ValueError) as ref:
        JCircuit(2).compile(envs[0], density=True).sample_sweep(
            np.zeros((1, 0)), 4)
    with pytest.raises(ValueError) as mine:
        tq.Circuit(2).compile(envs[1], density=True).sample_sweep(
            np.zeros((1, 0)), 4)
    assert str(mine.value) == str(ref.value)
    assert "statevector" in str(mine.value)


# -- applyPauliSum -----------------------------------------------------------

def _random_register(pkg, env, n, density, seed):
    rng = np.random.default_rng(seed)
    q = (pkg.createDensityQureg if density else pkg.createQureg)(n, env)
    pkg.initPlusState(q)
    for t in range(n):
        pkg.rotateAroundAxis(q, t, float(rng.uniform(0, 2 * np.pi)),
                             tuple(rng.normal(size=3)))
    for t in range(n - 1):
        pkg.controlledNot(q, t, t + 1)
    if density:
        pkg.mixDepolarising(q, 0, 0.2)
    return q


def _amps(q):
    s = np.asarray(q.state)
    return s[0] + 1j * s[1]


@pytest.mark.parametrize("density", [False, True], ids=["statevec",
                                                         "density"])
def test_apply_pauli_sum_matches_jax(envs, density):
    n, num_terms = 4, 5
    rng = np.random.default_rng(5)
    codes = [int(c) for c in rng.integers(0, 4, size=num_terms * n)]
    coeffs = list(rng.normal(size=num_terms))
    out = {}
    for pkg, env in ((jq, envs[0]), (tq, envs[1])):
        q_in = _random_register(pkg, env, n, density, 3)
        q_out = (pkg.createDensityQureg if density else pkg.createQureg)(
            n, env)
        pkg.applyPauliSum(q_in, codes, coeffs, num_terms, q_out)
        out[pkg] = _amps(q_out)
    assert np.abs(out[tq] - out[jq]).max() <= TOL


@pytest.mark.parametrize("case", ["types", "dims", "num_terms", "code"])
def test_apply_pauli_sum_validates_like_jax(envs, case):
    codes = {"code": [0, 4, 1]}.get(case, [1, 2, 3])
    num_terms = 0 if case == "num_terms" else 1
    errs = []
    for pkg, env in ((jq, envs[0]), (tq, envs[1])):
        q_in = pkg.createQureg(3, env)
        q_out = pkg.createDensityQureg(3, env) if case == "types" \
            else pkg.createQureg(4 if case == "dims" else 3, env)
        with pytest.raises(pkg.QuESTError) as err:
            pkg.applyPauliSum(q_in, codes, [1.0], num_terms, q_out)
        errs.append(int(err.value.code))
    assert errs[0] == errs[1]

