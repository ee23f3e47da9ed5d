"""The PyTorch port's QuEST-named API (quest_tpu_torch/api.py) against the
JAX package's (quest_tpu/api.py), on the CPU.

Both packages get the same seeded states and the same matrices. Gates are
compared amplitude by amplitude to 1e-12 in DOUBLE; the probability
functions at SINGLE (to 1e-6, the float32 register's rounding) and DOUBLE
(1e-12). The two packages draw measurement outcomes from different random
streams (a torch.Generator here, jax.random there), so ``measure`` is
checked through ``collapseToOutcome``: its post-state equals the collapse
to the outcome it reported.
"""

import numpy as np
import pytest

import quest_tpu as jq
from quest_tpu.validation import ErrorCode as JErrorCode
import quest_tpu_torch as tq
from quest_tpu_torch import interop
from torch_threads import one_blas_thread  # noqa: F401

N = 5
TOL = 1e-12


def envs(prec="double"):
    jp, tp = (jq.DOUBLE, tq.DOUBLE) if prec == "double" else \
        (jq.SINGLE, tq.SINGLE)
    return (jq.createQuESTEnv(num_devices=1, precision=jp, seed=[11]),
            tq.createQuESTEnv(device="cpu", precision=tp, seed=[11]))


@pytest.fixture(scope="module")
def double_envs():
    return envs("double")


def _unitary(rng, dim):
    z = rng.normal(size=(dim, dim)) + 1j * rng.normal(size=(dim, dim))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


def _state(n, seed=1):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    return z / np.linalg.norm(z)


def _pair(envs_, n=N, seed=1):
    """The same normalised random state in a JAX and a port register."""
    jenv, tenv = envs_
    z = _state(n, seed)
    jqr, tqr = jq.createQureg(n, jenv), tq.createQureg(n, tenv)
    jq.initStateFromAmps(jqr, z.real, z.imag)
    tq.initStateFromAmps(tqr, z.real, z.imag)
    return jqr, tqr


def _amps(q):
    return q.to_numpy()


_R = np.random.default_rng(42)
U2, U4, U8 = _unitary(_R, 2), _unitary(_R, 4), _unitary(_R, 8)
ALPHA, BETA = 0.6 * np.exp(0.3j), 0.8 * np.exp(-1.1j)
AXIS = (0.3, -1.2, 0.7)

# every state-vector gate of the slice, with arguments after the register
GATES = [
    ("hadamard", (3,)), ("pauliX", (0,)), ("pauliY", (4,)), ("pauliZ", (2,)),
    ("sGate", (1,)), ("tGate", (3,)), ("phaseShift", (2, 0.7)),
    ("compactUnitary", (4, ALPHA, BETA)), ("unitary", (1, U2)),
    ("rotateX", (0, 0.3)), ("rotateY", (2, -1.4)), ("rotateZ", (4, 2.2)),
    ("rotateAroundAxis", (3, 0.9, AXIS)),
    ("controlledNot", (4, 1)), ("controlledPauliY", (0, 3)),
    ("controlledPhaseShift", (1, 3, 0.4)),
    ("multiControlledPhaseShift", ((0, 2, 4), 1.3)),
    ("controlledPhaseFlip", (2, 0)), ("multiControlledPhaseFlip", ((1, 3, 4),)),
    ("controlledRotateX", (3, 0, 0.5)), ("controlledRotateY", (1, 4, 0.6)),
    ("controlledRotateZ", (0, 2, 0.8)),
    ("controlledRotateAroundAxis", (4, 2, 1.1, AXIS)),
    ("controlledCompactUnitary", (2, 3, ALPHA, BETA)),
    ("controlledUnitary", (0, 4, U2)),
    ("multiControlledUnitary", ((1, 2), 0, U2)),
    ("multiStateControlledUnitary", ((1, 4), (0, 1), 3, U2)),
    ("swapGate", (0, 3)), ("sqrtSwapGate", (4, 1)),
    ("multiRotateZ", ((0, 1, 3), 0.45)),
    ("twoQubitUnitary", (3, 1, U4)),
    ("controlledTwoQubitUnitary", (0, 4, 2, U4)),
    ("multiControlledTwoQubitUnitary", ((1, 3), 0, 4, U4)),
    ("multiQubitUnitary", ((2, 0, 4), U8)),
    ("controlledMultiQubitUnitary", (3, (1, 4, 0), U8)),
    ("multiControlledMultiQubitUnitary", ((2,), (0, 3, 1), U8)),
]


@pytest.mark.parametrize("name,args", GATES, ids=[g[0] for g in GATES])
def test_gate_matches_jax(name, args, double_envs):
    jqr, tqr = _pair(double_envs)
    jq.startRecordingQASM(jqr)
    tq.startRecordingQASM(tqr)
    getattr(jq, name)(jqr, *args)
    getattr(tq, name)(tqr, *args)
    assert np.abs(_amps(jqr) - _amps(tqr)).max() <= TOL
    assert jqr.qasm_log.text() == tqr.qasm_log.text()


def tutorial(m, env):
    """The reference's tutorial flow (3 qubits), up to its measurements."""
    q = m.createQureg(3, env)
    m.startRecordingQASM(q)
    m.initZeroState(q)
    m.hadamard(q, 0)
    m.controlledNot(q, 0, 1)
    m.rotateY(q, 2, 0.1)
    m.multiControlledPhaseFlip(q, [0, 1, 2])
    u = np.array([[0.5 + 0.5j, 0.5 - 0.5j], [0.5 - 0.5j, 0.5 + 0.5j]])
    m.unitary(q, 0, u)
    a, b = 0.5 + 0.5j, 0.5 - 0.5j
    m.compactUnitary(q, 1, a, b)
    m.rotateAroundAxis(q, 2, 3.14 / 2, (1.0, 0.0, 0.0))
    m.controlledCompactUnitary(q, 0, 1, a, b)
    m.multiControlledUnitary(q, [0, 1], 2, u)
    toff = m.createComplexMatrixN(3)
    for i in range(6):
        toff[i, i] = 1.0
    toff[6, 7] = toff[7, 6] = 1.0
    m.multiQubitUnitary(q, [0, 1, 2], toff)
    return q


def test_tutorial_flow_matches_jax(double_envs):
    jenv, tenv = double_envs
    jqr, tqr = tutorial(jq, jenv), tutorial(tq, tenv)
    assert np.abs(_amps(jqr) - _amps(tqr)).max() <= TOL
    for i in range(8):
        assert abs(jq.getAmp(jqr, i) - tq.getAmp(tqr, i)) <= TOL
        assert abs(jq.getProbAmp(jqr, i) - tq.getProbAmp(tqr, i)) <= TOL
    assert abs(jq.calcProbOfOutcome(jqr, 2, 1)
               - tq.calcProbOfOutcome(tqr, 2, 1)) <= TOL
    assert jqr.qasm_log.text() == tqr.qasm_log.text()
    assert tqr.qasm_log.text().startswith("OPENQASM 2.0;")
    outcome = tq.measure(tqr, 0)
    assert outcome in (0, 1)
    outcome, prob = tq.measureWithStats(tqr, 2)
    assert outcome in (0, 1) and 0.0 < prob <= 1.0
    assert abs(tq.calcTotalProb(tqr) - 1.0) <= TOL


@pytest.mark.parametrize("prec,tol", [("single", 1e-6), ("double", TOL)])
@pytest.mark.parametrize("qubit,outcome", [(0, 0), (2, 1), (4, 1)])
def test_probabilities_and_collapse_match_jax(prec, tol, qubit, outcome):
    jqr, tqr = _pair(envs(prec), seed=qubit + 3)
    assert abs(jq.calcTotalProb(jqr) - tq.calcTotalProb(tqr)) <= tol
    p_j = jq.calcProbOfOutcome(jqr, qubit, outcome)
    p_t = tq.calcProbOfOutcome(tqr, qubit, outcome)
    assert abs(p_j - p_t) <= tol
    c_j = jq.collapseToOutcome(jqr, qubit, outcome)
    c_t = tq.collapseToOutcome(tqr, qubit, outcome)
    assert abs(c_j - c_t) <= tol and abs(c_t - p_t) <= tol
    assert np.abs(_amps(jqr) - _amps(tqr)).max() <= 10 * tol
    assert abs(tq.calcTotalProb(tqr) - 1.0) <= 10 * tol


@pytest.mark.parametrize("qubit", [0, 3])
def test_measure_equals_collapse_to_its_outcome(qubit, double_envs):
    _, tenv = double_envs
    tq.seedQuEST(tenv, [qubit, 99])
    outcomes = set()
    for seed in range(6):
        _, a = _pair(double_envs, seed=seed)
        _, b = _pair(double_envs, seed=seed)
        outcome, prob = tq.measureWithStats(a, qubit)
        assert abs(prob - tq.calcProbOfOutcome(b, qubit, outcome)) <= TOL
        tq.collapseToOutcome(b, qubit, outcome)
        assert np.abs(_amps(a) - _amps(b)).max() <= TOL
        outcomes.add(outcome)
    assert outcomes == {0, 1}            # both branches were drawn


def test_measure_is_reproducible_from_the_seed(double_envs):
    def draws(seed):
        _, tenv = double_envs
        tq.seedQuEST(tenv, seed)
        out = []
        for s in range(8):
            _, q = _pair(double_envs, seed=s)
            out.append(tq.measure(q, 1))
        return out

    assert draws([5, 6]) == draws([5, 6])


def test_state_setup_matches_jax(double_envs):
    jenv, tenv = double_envs
    for init in ("initBlankState", "initZeroState", "initPlusState",
                 "initDebugState"):
        a, b = jq.createQureg(N, jenv), tq.createQureg(N, tenv)
        getattr(jq, init)(a)
        getattr(tq, init)(b)
        assert np.abs(_amps(a) - _amps(b)).max() <= TOL, init
    a, b = jq.createQureg(N, jenv), tq.createQureg(N, tenv)
    jq.initClassicalState(a, 19)
    tq.initClassicalState(b, 19)
    assert np.abs(_amps(a) - _amps(b)).max() <= TOL
    jq.initStateOfSingleQubit(a, 2, 1)
    tq.initStateOfSingleQubit(b, 2, 1)
    assert np.abs(_amps(a) - _amps(b)).max() <= TOL
    jsrc, tsrc = _pair(double_envs, seed=8)
    jq.initPureState(a, jsrc)
    tq.initPureState(b, tsrc)
    assert np.abs(_amps(a) - _amps(b)).max() <= TOL
    re, im = np.linspace(0, 1, 7), np.linspace(-1, 0, 7)
    jq.setAmps(a, 9, re, im, 7)
    tq.setAmps(b, 9, re, im, 7)
    assert np.abs(_amps(a) - _amps(b)).max() <= TOL
    clone = tq.createCloneQureg(b, tenv)
    tq.hadamard(b, 0)                    # the clone is a deep copy
    jclone = jq.createCloneQureg(a, jenv)
    assert np.abs(_amps(jclone) - _amps(clone)).max() <= TOL
    tq.cloneQureg(clone, b)
    assert np.abs(_amps(clone) - _amps(b)).max() == 0.0


def test_calculations_match_jax(double_envs):
    ja, ta = _pair(double_envs, seed=21)
    jb, tb = _pair(double_envs, seed=22)
    assert abs(jq.calcInnerProduct(ja, jb) - tq.calcInnerProduct(ta, tb)) \
        <= TOL
    for i in (0, 7, 31):
        assert abs(jq.getRealAmp(ja, i) - tq.getRealAmp(ta, i)) <= TOL
        assert abs(jq.getImagAmp(ja, i) - tq.getImagAmp(ta, i)) <= TOL
    assert tq.getNumQubits(ta) == N and tq.getNumAmps(ta) == 1 << N


def test_interop_round_trip(double_envs):
    jenv, tenv = double_envs
    jqr, _ = _pair(double_envs, seed=4)
    planes = np.asarray(jqr.state)
    q = interop.qureg_from_planes(planes, tenv)
    assert q.num_qubits_represented == N
    assert np.array_equal(interop.planes_of(q), planes)
    with pytest.raises(ValueError):
        interop.qureg_from_planes(planes[:, :30], tenv)


def _code(fn):
    with pytest.raises(Exception) as info:
        fn()
    assert type(info.value).__name__ == "QuESTError"
    return int(info.value.code)


PROBES = {
    "non_unitary_matrix": lambda m, q: m.unitary(
        q, 0, np.array([[1.0, 1.0], [0.0, 1.0]])),
    "unnormalised_compact_pair": lambda m, q: m.compactUnitary(
        q, 1, 0.5, 0.5),
    "target_out_of_range": lambda m, q: m.hadamard(q, N),
    "negative_target": lambda m, q: m.rotateX(q, -1, 0.2),
    "control_is_target": lambda m, q: m.controlledNot(q, 2, 2),
    "bad_outcome": lambda m, q: m.calcProbOfOutcome(q, 0, 2),
    "amp_index_out_of_range": lambda m, q: m.getAmp(q, 1 << N),
    "repeated_targets": lambda m, q: m.multiQubitUnitary(
        q, (1, 1), np.eye(4)),
    "collapse_to_impossible_outcome": lambda m, q: (
        m.initZeroState(q), m.collapseToOutcome(q, 0, 1)),
}


@pytest.mark.parametrize("probe", list(PROBES))
def test_validation_probes_raise_the_same_code(probe, double_envs):
    jqr, tqr = _pair(double_envs)
    code_j = _code(lambda: PROBES[probe](jq, jqr))
    code_t = _code(lambda: PROBES[probe](tq, tqr))
    assert code_t == code_j != 0
    assert tq.ErrorCode(code_t).name == JErrorCode(code_j).name
