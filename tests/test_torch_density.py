"""The PyTorch port's density registers against the JAX package's, on the
CPU: the density half of quest_tpu_torch/api.py, ops/densmatr.py, the
density Pauli reductions of ops/reductions.py and interop.py.

Both packages get the same seeded density matrix (a random mixed state,
set with ``setDensityAmps``) and the same arguments. In DOUBLE every gate,
channel and initialiser is compared element by element of the flat vector
and every ``calc*`` value to 1e-12; at SINGLE (compensated reductions on
both sides) the ``calc*`` values to 1e-6, the float32 register's
rounding. The ops/densmatr.py functions are also held directly against
the JAX module's on the same arrays. Invalid arguments raise QuESTError
with the same code in both packages, and both record the same QASM. This
mirrors tests/test_densmatr_gates.py and tests/test_noise.py.
"""

import numpy as np
import pytest
import torch

import quest_tpu as jq
import jax.numpy as jnp
from quest_tpu.ops import densmatr as jdm
from quest_tpu.ops import reductions as jred
import quest_tpu_torch as tq
from quest_tpu_torch import interop
from quest_tpu_torch.core.packing import pack
from quest_tpu_torch.ops import densmatr as tdm
from quest_tpu_torch.ops import reductions as tred
from torch_threads import one_blas_thread  # noqa: F401

N = 4
TOL = 1e-12


def envs(prec="double"):
    jp, tp = (jq.DOUBLE, tq.DOUBLE) if prec == "double" else \
        (jq.SINGLE, tq.SINGLE)
    return (jq.createQuESTEnv(num_devices=1, precision=jp, seed=[13]),
            tq.createQuESTEnv(device="cpu", precision=tp, seed=[13]))


@pytest.fixture(scope="module")
def double_envs():
    return envs("double")


@pytest.fixture(scope="module")
def single_envs():
    return envs("single")


def _unitary(rng, dim):
    z = rng.normal(size=(dim, dim)) + 1j * rng.normal(size=(dim, dim))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


def random_density(n, seed):
    """A seeded full-rank mixed state: W W^dag / Tr."""
    rng = np.random.default_rng(seed)
    d = 1 << n
    w = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    rho = w @ w.conj().T
    return rho / np.trace(rho).real


def flat(rho):
    """flat[r + c*2^n] = rho[r, c]."""
    return np.asarray(rho).T.reshape(-1)


def _pair(envs_, n=N, seed=1):
    """The same density matrix in a JAX and a port density register."""
    jenv, tenv = envs_
    f = flat(random_density(n, seed))
    jqr, tqr = jq.createDensityQureg(n, jenv), tq.createDensityQureg(n, tenv)
    jq.setDensityAmps(jqr, f.real, f.imag)
    tq.setDensityAmps(tqr, f.real, f.imag)
    return jqr, tqr


def _state_pair(envs_, n=N, seed=2):
    jenv, tenv = envs_
    rng = np.random.default_rng(seed)
    z = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    z /= np.linalg.norm(z)
    jqr, tqr = jq.createQureg(n, jenv), tq.createQureg(n, tenv)
    jq.initStateFromAmps(jqr, z.real, z.imag)
    tq.initStateFromAmps(tqr, z.real, z.imag)
    return jqr, tqr


def _diff(jqr, tqr):
    return np.abs(jqr.to_numpy() - tqr.to_numpy()).max()


_R = np.random.default_rng(7)
U2, U4, U8 = _unitary(_R, 2), _unitary(_R, 4), _unitary(_R, 8)
ALPHA, BETA = 0.6 * np.exp(0.3j), 0.8 * np.exp(-1.1j)
AXIS = (0.3, -1.2, 0.7)

# every gate of the API on a density register, with arguments after it
GATES = [
    ("hadamard", (3,)), ("pauliX", (0,)), ("pauliY", (2,)), ("pauliZ", (1,)),
    ("sGate", (1,)), ("tGate", (3,)), ("phaseShift", (2, 0.7)),
    ("compactUnitary", (0, ALPHA, BETA)), ("unitary", (1, U2)),
    ("rotateX", (0, 0.3)), ("rotateY", (2, -1.4)), ("rotateZ", (3, 2.2)),
    ("rotateAroundAxis", (3, 0.9, AXIS)),
    ("controlledNot", (3, 1)), ("controlledPauliY", (0, 3)),
    ("controlledPhaseShift", (1, 3, 0.4)),
    ("multiControlledPhaseShift", ((0, 2, 3), 1.3)),
    ("controlledPhaseFlip", (2, 0)), ("multiControlledPhaseFlip", ((1, 2, 3),)),
    ("controlledRotateX", (3, 0, 0.5)), ("controlledRotateY", (1, 2, 0.6)),
    ("controlledRotateZ", (0, 2, 0.8)),
    ("controlledRotateAroundAxis", (3, 2, 1.1, AXIS)),
    ("controlledCompactUnitary", (2, 3, ALPHA, BETA)),
    ("controlledUnitary", (0, 3, U2)),
    ("multiControlledUnitary", ((1, 2), 0, U2)),
    ("multiStateControlledUnitary", ((1, 3), (0, 1), 2, U2)),
    ("swapGate", (0, 3)), ("sqrtSwapGate", (3, 1)),
    ("multiRotateZ", ((0, 1, 3), 0.45)),
    ("multiRotatePauli", ((0, 2, 3), (1, 2, 3), 0.37)),
    ("multiRotatePauli", ((3, 1), (0, 2), -0.8)),
    ("twoQubitUnitary", (3, 1, U4)),
    ("controlledTwoQubitUnitary", (0, 3, 2, U4)),
    ("multiControlledTwoQubitUnitary", ((1, 3), 0, 2, U4)),
    ("multiQubitUnitary", ((2, 0, 3), U8)),
    ("controlledMultiQubitUnitary", (3, (1, 2, 0), U8)),
    ("multiControlledMultiQubitUnitary", ((2,), (0, 3, 1), U8)),
]


@pytest.mark.parametrize("name,args", GATES,
                         ids=[f"{g[0]}{i}" for i, g in enumerate(GATES)])
def test_gate_on_density_matches_jax(name, args, double_envs):
    jqr, tqr = _pair(double_envs)
    jq.startRecordingQASM(jqr)
    tq.startRecordingQASM(tqr)
    getattr(jq, name)(jqr, *args)
    getattr(tq, name)(tqr, *args)
    assert _diff(jqr, tqr) <= TOL
    assert jqr.qasm_log.text() == tqr.qasm_log.text()


def _kraus(rng, k, count):
    """A random CPTP set of ``count`` operators on k qubits (columns of a
    random isometry)."""
    d = 1 << k
    v = _unitary(rng, d * count)[:, :d]
    return [v[i * d:(i + 1) * d] for i in range(count)]


_K = np.random.default_rng(3)
CHANNELS = [
    ("mixDephasing", (2, 0.23)), ("mixDephasing", (0, 0.5)),
    ("mixTwoQubitDephasing", (3, 1, 0.4)),
    ("mixTwoQubitDephasing", (0, 2, 0.75)),
    ("mixDepolarising", (1, 0.3)), ("mixDamping", (3, 0.35)),
    ("mixDamping", (0, 1.0)),
    ("mixTwoQubitDepolarising", (2, 0, 0.6)),
    ("mixPauli", (1, 0.1, 0.05, 0.2)),
    ("mixKrausMap", (2, _kraus(_K, 1, 3))),
    ("mixKrausMap", (0, _kraus(_K, 1, 4), 2)),
    ("mixTwoQubitKrausMap", (3, 0, _kraus(_K, 2, 5))),
    ("mixMultiQubitKrausMap", ((1, 3, 0), _kraus(_K, 3, 2))),
]


@pytest.mark.parametrize("name,args", CHANNELS,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(CHANNELS)])
def test_channel_matches_jax(name, args, double_envs):
    if name == "mixKrausMap" and len(args) == 3:
        # num_ops truncates the list: the first two of a non-CPTP four
        # would be rejected, so pass a CPTP pair padded with junk
        args = (args[0], _kraus(np.random.default_rng(5), 1, 2)
                + [np.eye(2)], 2)
    jqr, tqr = _pair(double_envs, seed=3)
    jq.startRecordingQASM(jqr)
    tq.startRecordingQASM(tqr)
    getattr(jq, name)(jqr, *args)
    getattr(tq, name)(tqr, *args)
    assert _diff(jqr, tqr) <= TOL
    assert abs(tq.calcTotalProb(tqr) - 1.0) <= TOL
    assert jqr.qasm_log.text() == tqr.qasm_log.text()


def test_mix_density_matrix_matches_jax(double_envs):
    jqr, tqr = _pair(double_envs, seed=4)
    jo, to = _pair(double_envs, seed=5)
    jq.mixDensityMatrix(jqr, 0.3, jo)
    tq.mixDensityMatrix(tqr, 0.3, to)
    assert _diff(jqr, tqr) <= TOL
    # mixing a register with itself leaves it as it was
    before = tqr.to_numpy()
    tq.mixDensityMatrix(tqr, 0.4, tqr)
    assert np.abs(tqr.to_numpy() - before).max() <= TOL


@pytest.mark.parametrize("init", ["zero", "plus", "classical", "debug",
                                  "pure", "blank"])
def test_initialisers_match_jax(init, double_envs):
    jenv, tenv = double_envs
    jqr, tqr = jq.createDensityQureg(N, jenv), tq.createDensityQureg(N, tenv)
    assert tqr.is_density_matrix and tqr.isDensityMatrix
    assert tqr.num_qubits_in_state_vec == 2 * N
    assert tqr.num_amps_total == jqr.num_amps_total == 1 << (2 * N)
    jq.startRecordingQASM(jqr)
    tq.startRecordingQASM(tqr)
    if init == "pure":
        jp, tp = _state_pair(double_envs)
        jq.initPureState(jqr, jp)
        tq.initPureState(tqr, tp)
    elif init == "classical":
        jq.initClassicalState(jqr, 11)
        tq.initClassicalState(tqr, 11)
    else:
        name = f"init{init.capitalize()}State"
        getattr(jq, name)(jqr)
        getattr(tq, name)(tqr)
    assert _diff(jqr, tqr) <= TOL
    assert jqr.qasm_log.text() == tqr.qasm_log.text()


def test_clone_and_amps(double_envs):
    jenv, tenv = double_envs
    jqr, tqr = _pair(double_envs, seed=6)
    tc = tq.createCloneQureg(tqr, tenv)
    assert tc.is_density_matrix and np.array_equal(tc.to_numpy(),
                                                   tqr.to_numpy())
    tq.hadamard(tc, 0)
    assert not np.array_equal(tc.to_numpy(), tqr.to_numpy())
    tq.cloneQureg(tc, tqr)
    assert np.array_equal(tc.to_numpy(), tqr.to_numpy())
    for r in range(1 << N):
        for c in (0, 5, (1 << N) - 1):
            assert abs(jq.getDensityAmp(jqr, r, c)
                       - tq.getDensityAmp(tqr, r, c)) <= TOL
    assert tq.getNumQubits(tqr) == N
    assert "density-matrix" in repr(tqr)


def _calc_values(m, jqr_or_t, other, pure, sv):
    """Every density calc the API has, on one register (``other``: a
    second density register, ``pure``/``sv``: state vectors)."""
    q = jqr_or_t
    vals = [m.calcTotalProb(q), m.calcPurity(q),
            m.calcFidelity(q, pure),
            m.calcHilbertSchmidtDistance(q, other),
            m.calcDensityInnerProduct(q, other),
            m.calcExpecPauliProd(q, (0, 2, 3), (1, 2, 3)),
            m.calcExpecPauliProd(q, (3, 1), (2, 2)),
            m.calcExpecPauliSum(q, (1, 0, 0, 3, 2, 2, 1, 0, 0, 3, 3, 3),
                                (0.3, -0.7, 1.1)),
            m.calcFidelity(sv, pure),
            m.calcExpecPauliProd(sv, (1, 2), (2, 1))]
    vals += [m.calcProbOfOutcome(q, t, o) for t in range(N) for o in (0, 1)]
    return np.array(vals)


@pytest.mark.parametrize("prec,tol", [("double", TOL), ("single", 1e-6)])
def test_calcs_match_jax(prec, tol, double_envs, single_envs):
    """Both precisions are held against the JAX package's DOUBLE values:
    its SINGLE ``calcFidelity`` of a density register computes
    <psi|rho^T|psi> (ROADMAP), which a complex psi shows."""
    jqr, _ = _pair(double_envs, seed=7)
    jo, _ = _pair(double_envs, seed=8)
    jp, _ = _state_pair(double_envs, seed=9)
    js, _ = _state_pair(double_envs, seed=10)
    envs_ = double_envs if prec == "double" else single_envs
    _, tqr = _pair(envs_, seed=7)
    _, to = _pair(envs_, seed=8)
    _, tp = _state_pair(envs_, seed=9)
    _, ts = _state_pair(envs_, seed=10)
    want = _calc_values(jq, jqr, jo, jp, js)
    got = _calc_values(tq, tqr, to, tp, ts)
    assert np.abs(got - want).max() <= tol
    assert 0.0 < got[1] < 1.0             # a mixed state's purity


@pytest.mark.parametrize("prec,tol", [("double", TOL), ("single", 1e-6)])
def test_fidelity_of_its_own_pure_state_is_one(prec, tol, double_envs,
                                               single_envs):
    """rho = |psi><psi| for a complex psi: <psi|rho|psi> = 1 at either
    precision (the compensated SINGLE form included)."""
    envs_ = double_envs if prec == "double" else single_envs
    _, psi = _state_pair(envs_, seed=14)
    rho = tq.createDensityQureg(N, envs_[1])
    tq.initPureState(rho, psi)
    assert abs(tq.calcFidelity(rho, psi) - 1.0) <= tol


def test_calcs_on_a_non_hermitian_register(double_envs):
    """The debug state is no density matrix; every calc still agrees."""
    jenv, tenv = double_envs
    jqr, tqr = jq.createDensityQureg(3, jenv), tq.createDensityQureg(3, tenv)
    jq.initDebugState(jqr)
    tq.initDebugState(tqr)
    jp, tp = _state_pair(double_envs, n=3, seed=11)
    for name, args in (("calcTotalProb", ()), ("calcPurity", ()),
                       ("calcFidelity", None),
                       ("calcExpecPauliProd", ((0, 1, 2), (2, 1, 2))),
                       ("calcExpecPauliSum", ((1, 2, 0, 3, 3, 2),
                                              (0.4, -0.2))),
                       ("calcProbOfOutcome", (1, 1))):
        ja = (jp,) if args is None else args
        ta = (tp,) if args is None else args
        assert abs(getattr(jq, name)(jqr, *ja)
                   - getattr(tq, name)(tqr, *ta)) <= TOL


@pytest.mark.parametrize("outcome", [0, 1])
def test_collapse_and_measure_on_density(outcome, double_envs):
    jqr, tqr = _pair(double_envs, seed=12)
    jq.startRecordingQASM(jqr)
    tq.startRecordingQASM(tqr)
    pj = jq.collapseToOutcome(jqr, 2, outcome)
    pt = tq.collapseToOutcome(tqr, 2, outcome)
    assert abs(pj - pt) <= TOL
    assert _diff(jqr, tqr) <= TOL
    assert jqr.qasm_log.text() == tqr.qasm_log.text()
    # measure draws from the port's own generator: its post-state is the
    # collapse to the outcome it reported
    jqr, tqr = _pair(double_envs, seed=13)
    got, prob = tq.measureWithStats(tqr, 1)
    assert abs(prob - jq.calcProbOfOutcome(jqr, 1, got)) <= TOL
    jq.collapseToOutcome(jqr, 1, got)
    assert _diff(jqr, tqr) <= TOL
    assert abs(tq.calcTotalProb(tqr) - 1.0) <= TOL
    assert tq.measure(tqr, 1) == got      # a collapsed qubit stays put


def _jz(planes):
    return jnp.asarray(planes[0] + 1j * planes[1])


def test_densmatr_module_matches_jax():
    """ops/densmatr.py function by function against the JAX module on the
    same flat vectors (n = 3)."""
    n = 3
    rng = np.random.default_rng(21)
    fa = flat(random_density(n, 1))
    fb = flat(random_density(n, 2))
    psi = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)

    def planes(z):
        return pack(torch.as_tensor(np.asarray(z)))

    a, b, p = planes(fa), planes(fb), planes(psi)
    ja, jb, jp = jnp.asarray(fa), jnp.asarray(fb), jnp.asarray(psi)
    pairs = [
        (tdm.calc_total_prob(a, n), jdm.calc_total_prob(ja, n)),
        (tdm.calc_purity(a), jdm.calc_purity(ja)),
        (tdm.calc_fidelity(a, n, p), jdm.calc_fidelity(ja, n, jp)),
        (tdm.calc_inner_product(a, b), jdm.calc_inner_product(ja, jb)),
        (tdm.calc_hilbert_schmidt_distance(a, b),
         jdm.calc_hilbert_schmidt_distance(ja, jb)),
    ]
    pairs += [(tdm.calc_prob_of_outcome(a, n, q, o),
               jdm.calc_prob_of_outcome(ja, n, q, o))
              for q in range(n) for o in (0, 1)]
    for got, want in pairs:
        assert abs(float(got) - float(want)) <= TOL
    checks = [
        (tdm.init_pure_state(p), jdm.init_pure_state(jp)),
        (tdm.mix_density_matrix(a.clone(), 0.35, b),
         jdm.mix_density_matrix(ja, 0.35, jb)),
        (tdm.mix_dephasing(a.clone(), n, 1, 0.2),
         jdm.mix_dephasing(ja, n, 1, 0.2)),
        (tdm.mix_two_qubit_dephasing(a.clone(), n, 2, 0, 0.3),
         jdm.mix_two_qubit_dephasing(ja, n, 2, 0, 0.3)),
        (tdm.collapse_to_known_prob_outcome(a.clone(), n, 1, 1, 0.4),
         jdm.collapse_to_known_prob_outcome(ja, n, 1, 1, 0.4)),
    ]
    ops = _kraus(rng, 2, 3)
    s = tdm.kraus_superoperator(ops)
    assert np.abs(s - jdm.kraus_superoperator(ops)).max() <= TOL
    st = tdm.kraus_superoperator_traceable([torch.as_tensor(o) for o in ops])
    assert not st.is_conj() and np.abs(st.numpy() - s).max() <= TOL
    checks.append((tdm.apply_kraus_superoperator(a.clone(), n, (2, 0), s),
                   jdm.apply_kraus_superoperator(ja, n, (2, 0), s)))
    for got, want in checks:
        assert np.abs((got[0] + 1j * got[1]).numpy()
                      - np.asarray(want)).max() <= TOL
    for prob in (0.1, 0.5):
        assert np.array_equal(tdm.dephasing_factors(prob),
                              jdm.dephasing_factors(prob))
        assert np.array_equal(tdm.two_qubit_dephasing_factors(prob),
                              jdm.two_qubit_dephasing_factors(prob))


@pytest.mark.parametrize("compensated", [False, True])
def test_pauli_reductions_dm_match_jax(compensated):
    n = 3
    f = flat(random_density(n, 31))
    codes = np.random.default_rng(32).integers(0, 4, size=(9, n))
    xm, ym, zm = tred.pauli_masks(codes.reshape(-1), n)
    coeffs = np.linspace(-1.0, 1.0, 9)
    got = tred.pauli_sum_expvals_dm(pack(torch.as_tensor(f)), n, xm, ym, zm,
                                    compensated)
    want = jred.pauli_sum_expvals_dm(jnp.asarray(f), n, jnp.asarray(xm),
                                     jnp.asarray(ym), jnp.asarray(zm),
                                     compensated=compensated)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL
    total = tred.pauli_sum_total_dm(pack(torch.as_tensor(f)), n, xm, ym, zm,
                                    coeffs, compensated)
    assert abs(float(total) - float(np.dot(np.asarray(want), coeffs))) \
        <= TOL


def test_interop_carries_density_registers(double_envs):
    jenv, tenv = double_envs
    jqr, _ = _pair(double_envs, seed=14)
    planes = np.asarray(jqr.state)
    q = interop.qureg_from_planes(planes, tenv, is_density=True)
    assert q.is_density_matrix and q.num_qubits_represented == N
    assert np.array_equal(interop.planes_of(q), planes)
    assert abs(tq.calcPurity(q) - jq.calcPurity(jqr)) <= TOL
    with pytest.raises(ValueError, match="square"):
        interop.qureg_from_planes(planes[:, :1 << 7], tenv, is_density=True)


def _code(fn):
    with pytest.raises(Exception) as info:
        fn()
    assert type(info.value).__name__ == "QuESTError"
    return int(info.value.code)


def _sv(m, q):
    return m.createQureg(N, q.env)


def _dm(m, q, n=N):
    return m.createDensityQureg(n, q.env)


PROBES = {
    "dephasing_on_state_vector": lambda m, q: m.mixDephasing(
        _sv(m, q), 0, 0.1),
    "dephasing_prob_over_half": lambda m, q: m.mixDephasing(q, 0, 0.6),
    "negative_prob": lambda m, q: m.mixDamping(q, 0, -0.1),
    "damping_prob_over_one": lambda m, q: m.mixDamping(q, 0, 1.2),
    "depolarising_prob_over_three_quarters": lambda m, q:
        m.mixDepolarising(q, 1, 0.8),
    "two_qubit_dephasing_prob": lambda m, q: m.mixTwoQubitDephasing(
        q, 0, 1, 0.8),
    "two_qubit_dephasing_same_qubit": lambda m, q: m.mixTwoQubitDephasing(
        q, 2, 2, 0.1),
    "two_qubit_depolarising_prob": lambda m, q:
        m.mixTwoQubitDepolarising(q, 0, 1, 0.95),
    "pauli_probs": lambda m, q: m.mixPauli(q, 0, 0.4, 0.3, 0.2),
    "target_out_of_range": lambda m, q: m.mixDamping(q, N, 0.1),
    "non_cptp_kraus": lambda m, q: m.mixKrausMap(q, 0, [np.eye(2) * 0.5]),
    "kraus_size": lambda m, q: m.mixTwoQubitKrausMap(
        q, 0, 1, [np.eye(2)]),
    "too_many_kraus_ops": lambda m, q: m.mixKrausMap(
        q, 0, [np.eye(2) * 0.5] * 5),
    "multi_kraus_repeated_target": lambda m, q: m.mixMultiQubitKrausMap(
        q, (1, 1), [np.eye(4)]),
    "mix_with_state_vector": lambda m, q: m.mixDensityMatrix(
        q, 0.2, _sv(m, q)),
    "mix_mismatched_dims": lambda m, q: m.mixDensityMatrix(
        q, 0.2, _dm(m, q, N - 1)),
    "mix_prob": lambda m, q: m.mixDensityMatrix(q, 1.5, _dm(m, q)),
    "purity_of_state_vector": lambda m, q: m.calcPurity(_sv(m, q)),
    "fidelity_with_density": lambda m, q: m.calcFidelity(q, _dm(m, q)),
    "fidelity_mismatched_dims": lambda m, q: m.calcFidelity(
        q, m.createQureg(N - 1, q.env)),
    "hs_distance_state_vector": lambda m, q: m.calcHilbertSchmidtDistance(
        q, _sv(m, q)),
    "density_inner_product_dims": lambda m, q: m.calcDensityInnerProduct(
        q, _dm(m, q, N - 1)),
    "density_amp_of_state_vector": lambda m, q: m.getDensityAmp(
        _sv(m, q), 0, 0),
    "density_amp_out_of_range": lambda m, q: m.getDensityAmp(q, 1 << N, 0),
    "amp_of_density": lambda m, q: m.getAmp(q, 0),
    "num_amps_of_density": lambda m, q: m.getNumAmps(q),
    "inner_product_of_density": lambda m, q: m.calcInnerProduct(q, q),
    "pure_state_from_density": lambda m, q: m.initPureState(q, _dm(m, q)),
    "amps_into_density": lambda m, q: m.initStateFromAmps(
        q, np.zeros(1 << (2 * N)), np.zeros(1 << (2 * N))),
    "set_amps_on_density": lambda m, q: m.setAmps(q, 0, [1.0], [0.0], 1),
    "single_qubit_state_on_density": lambda m, q:
        m.initStateOfSingleQubit(q, 0, 1),
    "density_amps_wrong_size": lambda m, q: m.setDensityAmps(
        q, [1.0], [0.0]),
    "pauli_prod_bad_code": lambda m, q: m.calcExpecPauliProd(
        q, (0, 1), (1, 4)),
    "pauli_prod_repeated_target": lambda m, q: m.calcExpecPauliProd(
        q, (2, 2), (1, 3)),
    "rotate_pauli_bad_code": lambda m, q: m.multiRotatePauli(
        q, (0, 1), (1, 5), 0.2),
    "rotate_pauli_repeated_target": lambda m, q: m.multiRotatePauli(
        q, (3, 3), (1, 2), 0.2),
    "collapse_to_impossible_outcome": lambda m, q: (
        m.initZeroState(q), m.collapseToOutcome(q, 1, 1)),
    "create_zero_qubits": lambda m, q: m.createDensityQureg(0, q.env),
}


@pytest.mark.parametrize("probe", list(PROBES))
def test_validation_probes_raise_the_same_code(probe, double_envs):
    jqr, tqr = _pair(double_envs)
    code_j = _code(lambda: PROBES[probe](jq, jqr))
    code_t = _code(lambda: PROBES[probe](tq, tqr))
    assert code_t == code_j != 0
