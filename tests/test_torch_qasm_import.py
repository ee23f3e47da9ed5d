"""The PyTorch port's QASM importer (``quest_tpu_torch.qasm_import``)
against the JAX package's, on the CPU in float64.

The cases of ``tests/test_qasm_import.py``: each QASM text (recorded by
the port's API, written by ``Circuit.to_qasm``, or written by hand) is
parsed by both packages. Their ``measurements`` and ``resets`` agree, their
circuits run to states within 1e-12 of each other, and the port's run
reproduces the recorded evolution up to the global phase the recorder's
uncontrolled ZYZ split drops (1e-10, as there). Bad texts raise the same
exception with the same message in both.
"""

import numpy as np
import pytest
import torch

import quest_tpu as jq
import quest_tpu_torch as tq
from oracle import random_unitary
from torch_threads import one_blas_thread  # noqa: F401

TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def envs():
    return (jq.createQuESTEnv(num_devices=1, precision=jq.DOUBLE, seed=[1]),
            tq.createQuESTEnv(device="cpu", precision=tq.DOUBLE, seed=[1]))


def _phase_aligned(a, b):
    """Max |a - e^{i g} b| over the optimal global phase g."""
    k = int(np.argmax(np.abs(b)))
    if abs(b[k]) < 1e-14:
        return float(np.max(np.abs(a - b)))
    g = a[k] / b[k]
    g /= abs(g)
    return float(np.max(np.abs(a - g * b)))


def _init(pkg, q, init):
    """|0..0> (``"zero"``), |+..+> (``"plus"``) or the given amplitudes."""
    if isinstance(init, str):
        {"zero": pkg.initZeroState, "plus": pkg.initPlusState}[init](q)
    else:
        q.device_put(np.asarray(init, dtype=complex))


def parse_and_run(envs, text, dialect="quest", init="zero"):
    """Parse ``text`` in both packages, check the parses agree, run both
    circuits from ``init`` and check the states agree within 1e-12.
    Returns the port's parse and its state."""
    jp = jq.parse_qasm(text, dialect=dialect)
    tp = tq.parse_qasm(text, dialect=dialect)
    assert isinstance(tp, tq.ParsedQASM) and isinstance(tp.circuit,
                                                        tq.Circuit)
    assert (tp.measurements, tp.resets) == (jp.measurements, jp.resets)
    assert tp.circuit.num_qubits == jp.circuit.num_qubits
    assert tp.circuit.depth == jp.circuit.depth
    n = tp.circuit.num_qubits
    states = []
    for pkg, parsed, env, kw in ((jq, jp, envs[0], {"pallas": False}),
                                 (tq, tp, envs[1], {})):
        q = pkg.createQureg(n, env)
        _init(pkg, q, init)
        parsed.circuit.compile(env, **kw).run(q)
        states.append(q.to_numpy())
    assert np.abs(states[1] - states[0]).max() <= TOL
    return tp, states[1]


def record_and_reparse(envs, build, n):
    """Run ``build(pkg, q)`` on a port register with recording on (and on a
    JAX one: the two logs are the same text), parse the log in both
    packages and run it from |0..0>. Returns (recorded, replayed)."""
    texts, recorded = [], None
    for pkg, env in ((jq, envs[0]), (tq, envs[1])):
        q = pkg.createQureg(n, env)
        pkg.initZeroState(q)
        pkg.startRecordingQASM(q)
        build(pkg, q)
        pkg.stopRecordingQASM(q)
        texts.append(q.qasm_log.text())
        recorded = q.to_numpy()
    assert texts[1] == texts[0]
    _, replayed = parse_and_run(envs, texts[1])
    return recorded, replayed


def _message(fn):
    try:
        fn()
    except Exception as e:          # noqa: BLE001 - type and text compared
        return type(e), str(e)
    return None


def assert_same_error(text, dialect="quest"):
    want = _message(lambda: jq.parse_qasm(text, dialect=dialect))
    assert want is not None and want[0] is ValueError
    assert _message(lambda: tq.parse_qasm(text, dialect=dialect)) == want


def test_roundtrip_named_gates(envs):
    def build(qt, q):
        qt.hadamard(q, 0)
        qt.pauliX(q, 1)
        qt.pauliY(q, 2)
        qt.pauliZ(q, 0)
        qt.sGate(q, 1)
        qt.tGate(q, 2)
        qt.rotateX(q, 0, 0.37)
        qt.rotateY(q, 1, -1.2)
        qt.rotateZ(q, 2, 2.9)
        qt.controlledNot(q, 0, 1)
        qt.controlledPauliY(q, 1, 2)
        qt.controlledPhaseFlip(q, 0, 2)
        qt.swapGate(q, 0, 2)
        qt.sqrtSwapGate(q, 1, 2)
    a, b = record_and_reparse(envs, build, 3)
    assert _phase_aligned(a, b) < 1e-10


def _compact(alpha, beta):
    return np.array([[alpha, -np.conj(beta)], [beta, np.conj(alpha)]])


def test_roundtrip_param_and_unitary(envs):
    cu = _compact(complex(0.6, 0.0), complex(0.0, 0.8))

    def build(qt, q):
        qt.phaseShift(q, 0, 0.7)
        qt.compactUnitary(q, 1, complex(0.6, 0.0), complex(0.0, 0.8))
        qt.controlledCompactUnitary(q, 2, 0, complex(0.28, 0.96), 0j)
        qt.controlledUnitary(q, 2, 0, cu)
        qt.rotateAroundAxis(q, 2, 1.3, (1.0, 1.0, 0.0))
        qt.controlledRotateZ(q, 0, 2, -0.9)
        qt.controlledRotateX(q, 1, 0, 0.55)
        qt.multiStateControlledUnitary(q, [0, 1], [1, 0], 2, cu)
    a, b = record_and_reparse(envs, build, 3)
    assert _phase_aligned(a, b) < 1e-10


def test_controlled_phase_shift_reference_quirk(envs):
    """The recorder restores controlledPhaseShift's dropped phase with an
    uncontrolled Rz on the target, as the reference does: the importer
    reproduces the text's semantics, magnitudes equal, phases not."""
    def build(qt, q):
        qt.hadamard(q, 0)
        qt.hadamard(q, 1)
        qt.controlledPhaseShift(q, 0, 1, 1.1)
    a, b = record_and_reparse(envs, build, 2)
    np.testing.assert_allclose(np.abs(a), np.abs(b), atol=1e-10)
    assert _phase_aligned(a, b) > 1e-3


def test_roundtrip_unitary_global_phase_dropped(envs):
    u = np.exp(0.31j) * random_unitary(1, np.random.default_rng(9))

    def build(qt, q):
        qt.hadamard(q, 0)
        qt.unitary(q, 0, u)
    a, b = record_and_reparse(envs, build, 2)
    assert _phase_aligned(a, b) < 1e-10


def test_standard_dialect(envs):
    text = """
    OPENQASM 2.0;
    include "qelib1.inc";
    qreg qr[3]; creg m[3];
    h qr[0];
    cx qr[0],qr[1];
    crz(pi/2) qr[1],qr[2];
    ccx qr[0],qr[1],qr[2];
    u3(pi/2, 0, pi) qr[0];
    barrier qr;
    id qr[1];
    measure qr[2] -> m[2];
    """
    parsed, psi = parse_and_run(envs, text)
    assert parsed.measurements == [(2, 2)]
    assert abs(np.vdot(psi, psi).real - 1.0) < 1e-10


def test_reset_and_errors(envs):
    ok, _ = parse_and_run(envs, "qreg q[2];\nreset q;\nh q[0];")
    assert ok.resets == 1
    for text in ("qreg q[2];\nh q[0];\nreset q;",
                 "qreg q[1];\nfrobnicate q[0];",
                 "h q[0];",
                 "qreg q[1];\nh q[4];",
                 "qreg q[1];\nrx(__import__) q[0];",
                 "qreg q[2];\nqreg r[2];",
                 "qreg q[2];\ncx q[0];",
                 "qreg q[1];\nrx q[0];",
                 "qreg q[1];\nmeasure q[0];",
                 "OPENQASM 2.0;"):
        assert_same_error(text)


def test_written_file_roundtrip(envs, tmp_path):
    q = tq.createQureg(3, envs[1])
    tq.initZeroState(q)
    tq.startRecordingQASM(q)
    tq.hadamard(q, 0)
    tq.controlledNot(q, 0, 1)
    tq.rotateY(q, 2, 0.25)
    path = tmp_path / "c.qasm"
    tq.writeRecordedQASMToFile(q, str(path))
    jp, tp = jq.load_qasm_file(str(path)), tq.load_qasm_file(str(path))
    assert (tp.measurements, tp.resets) == (jp.measurements, jp.resets)
    _, psi = parse_and_run(envs, path.read_text())
    assert _phase_aligned(q.to_numpy(), psi) < 1e-12


def test_dialect_u_disambiguation(envs):
    text = "qreg q[1];\nU(pi/2,0,pi) q[0];"
    h = np.array([1.0, 1.0]) / np.sqrt(2.0)
    assert _phase_aligned(parse_and_run(envs, text, "openqasm")[1], h) \
        < 1e-10
    assert _phase_aligned(parse_and_run(envs, text, "quest")[1], h) > 1e-3
    assert_same_error(text, dialect="qiskit")


def test_uppercase_builtin_cx(envs):
    _, psi = parse_and_run(envs, "qreg q[2];\nh q[0];\nCX q[0],q[1];")
    bell = np.zeros(4)
    bell[0] = bell[3] = 1 / np.sqrt(2.0)
    assert _phase_aligned(psi, bell.astype(complex)) < 1e-10


@pytest.mark.parametrize("seed", range(8))
def test_roundtrip_random_sweep(envs, seed):
    N = 4

    def build(qt, q):
        rng = np.random.default_rng(100 + seed)
        for _ in range(20):
            kind = int(rng.integers(9))
            t = int(rng.integers(N))
            c_ = int((t + 1 + rng.integers(N - 1)) % N)
            ang = float(rng.uniform(0, 2 * np.pi))
            if kind == 0:
                getattr(qt, ["hadamard", "pauliX", "pauliY", "pauliZ",
                             "sGate", "tGate"][int(rng.integers(6))])(q, t)
            elif kind == 1:
                getattr(qt, ["rotateX", "rotateY", "rotateZ"][
                    int(rng.integers(3))])(q, t, ang)
            elif kind == 2:
                th, p1, p2 = rng.uniform(0, 2 * np.pi, size=3)
                al = complex(np.cos(th) * np.cos(p1),
                             np.cos(th) * np.sin(p1))
                be = complex(np.sin(th) * np.cos(p2),
                             np.sin(th) * np.sin(p2))
                qt.compactUnitary(q, t, al, be)
            elif kind == 3:
                qt.controlledNot(q, c_, t)
            elif kind == 4:
                getattr(qt, ["controlledRotateX", "controlledRotateY",
                             "controlledRotateZ"][int(rng.integers(3))])(
                    q, c_, t, ang)
            elif kind == 5:
                qt.swapGate(q, c_, t)
            elif kind == 6:
                qt.sqrtSwapGate(q, c_, t)
            elif kind == 7:
                qt.controlledPhaseFlip(q, c_, t)
            else:
                qt.rotateAroundAxis(q, t, ang, tuple(rng.normal(size=3)))
    a, b = record_and_reparse(envs, build, N)
    assert _phase_aligned(a, b) < 1e-10


def test_qelib_aliases(envs):
    text = """
    qreg q[2];
    h q[0]; h q[1];
    u1(0.7) q[0];
    p(0.3) q[1];
    cu1(1.1) q[0],q[1];
    rzz(0.9) q[0],q[1];
    u2(0.2, 0.4) q[0];
    """
    _, got = parse_and_run(envs, text)

    def u1(la):
        return np.diag([1.0, np.exp(1j * la)])
    H = np.array([[1, 1], [1, -1]]) / np.sqrt(2)
    rzz = np.diag(np.exp(-0.5j * 0.9 * np.array([1, -1, -1, 1])))
    cu1 = np.diag([1, 1, 1, np.exp(1.1j)])
    u2 = (np.diag([np.exp(-0.1j), np.exp(0.1j)])
          @ np.array([[np.cos(np.pi / 4), -np.sin(np.pi / 4)],
                      [np.sin(np.pi / 4), np.cos(np.pi / 4)]])
          @ np.diag([np.exp(-0.2j), np.exp(0.2j)]))
    I = np.eye(2)
    state = np.zeros(4, complex)
    state[0] = 1.0
    state = np.kron(H, I) @ np.kron(I, H) @ state
    state = np.kron(I, u1(0.7)) @ state
    state = np.kron(u1(0.3), I) @ state
    state = rzz @ (cu1 @ state)
    state = np.kron(I, u2) @ state
    np.testing.assert_allclose(got, state, atol=1e-12)


def test_circuit_to_qasm_roundtrip(envs):
    def build(C):
        c = C(3)
        th = c.parameter("th")
        c.h(0)
        c.rz(1, th)
        c.cnot(0, 2)
        c.gate(np.diag([1.0, 1.0j]), (1,), controls=(2,),
               control_states=(0,))
        c.phase(2, 0.4)
        return c
    jc, tc = build(jq.Circuit), build(tq.Circuit)
    text = tc.to_qasm(params={"th": 0.9})
    assert text == jc.to_qasm(params={"th": 0.9})
    assert text.startswith("OPENQASM 2.0;")
    _, psi = parse_and_run(envs, text)
    q = tq.createQureg(3, envs[1])
    tq.initZeroState(q)
    tc.compile(envs[1]).run(q, params={"th": 0.9})
    assert _phase_aligned(q.to_numpy(), psi) < 1e-10
    with pytest.raises(ValueError):
        tc.to_qasm()


def test_circuit_to_qasm_comments_inexpressible(envs):
    c = tq.Circuit(2)
    c.h(0)
    c.damp(0, 0.2)
    c.gate(np.eye(4), (0, 1))
    text = c.to_qasm()
    assert "Kraus channel" in text
    assert "no single-qubit QASM form" in text
    parsed, _ = parse_and_run(envs, text)
    assert len(parsed.circuit.ops) == 1


def test_circuit_to_qasm_diagonals_and_phases(envs):
    u = np.exp(0.65j) * random_unitary(1, np.random.default_rng(21))
    c = tq.Circuit(3)
    c.z(0)
    c.s(1)
    c.t(2)
    c.phase(0, 0.8)
    c.cz(0, 1)
    c.cphase(1, 2, 0.5)
    c.crz(0, 2, 1.3)
    c.multi_rotate_z([0, 2], 0.7)
    c.gate(u, (1,), controls=(0,))
    c.gate(u, (2,), controls=(0, 1))
    text = c.to_qasm()
    assert "cu1(" in text and "rzz(" in text
    assert "no QASM form" not in text
    _, psi = parse_and_run(envs, text, init="plus")
    q = tq.createQureg(3, envs[1])
    tq.initPlusState(q)
    c.compile(envs[1]).run(q)
    assert _phase_aligned(q.to_numpy(), psi) < 1e-10


def test_circuit_to_qasm_general_diagonal(envs):
    rng = np.random.default_rng(4)
    c = tq.Circuit(3)
    c.h(0)
    c.h(1)
    c.h(2)
    c.diagonal(np.exp(1j * rng.uniform(-np.pi, np.pi, size=(2, 2, 2))),
               (0, 1, 2))
    c.multi_rotate_z([0, 1, 2], 0.9)
    text = c.to_qasm()
    assert "no QASM form" not in text
    _, psi = parse_and_run(envs, text)
    q = tq.createQureg(3, envs[1])
    tq.initZeroState(q)
    c.compile(envs[1]).run(q)
    assert _phase_aligned(q.to_numpy(), psi) < 1e-10


def test_mid_circuit_measure_rejected():
    assert_same_error("OPENQASM 2.0;\nqreg q[1];\ncreg c[1];\n"
                      "h q[0];\nmeasure q[0] -> c[0];\nh q[0];\n")
    with pytest.raises(ValueError, match="mid-circuit measurement"):
        tq.parse_qasm("qreg q[1];\nh q[0];\nmeasure q[0] -> c[0];\n"
                      "h q[0];\n")


def test_gate_on_unmeasured_qubit_after_measure_ok(envs):
    parsed, _ = parse_and_run(envs, "OPENQASM 2.0;\nqreg q[2];\ncreg c[1];\n"
                              "h q[0];\nmeasure q[0] -> c[0];\nh q[1];\n")
    assert parsed.measurements == [(0, 0)]
    assert parsed.circuit.depth == 2


def test_controlled_u3_phase_compensation(envs):
    th, ph, la = 0.7, 0.5, 0.3
    text = f"OPENQASM 2.0;\nqreg q[2];\ncu3({th},{ph},{la}) q[0],q[1];\n"
    c, s = np.cos(th / 2), np.sin(th / 2)
    u3 = np.array([[c, -np.exp(1j * la) * s],
                   [np.exp(1j * ph) * s, np.exp(1j * (ph + la)) * c]])
    cu3 = np.eye(4, dtype=complex)
    cu3[1, 1], cu3[1, 3] = u3[0, 0], u3[0, 1]
    cu3[3, 1], cu3[3, 3] = u3[1, 0], u3[1, 1]
    rng = np.random.default_rng(5)
    psi = rng.normal(size=4) + 1j * rng.normal(size=4)
    psi /= np.linalg.norm(psi)
    _, got = parse_and_run(envs, text, "openqasm", init=psi)
    np.testing.assert_allclose(got, cu3 @ psi, atol=1e-12)


def test_sdg_tdg_and_nested_parens(envs):
    text = ("OPENQASM 2.0;\nqreg q[1];\n"
            "s q[0];\nsdg q[0];\nt q[0];\ntdg q[0];\nu1(-(pi/2)) q[0];\n"
            "u1(pi/2) q[0];\n")
    psi = np.array([0.6, 0.8j])
    _, got = parse_and_run(envs, text, "openqasm", init=psi)
    np.testing.assert_allclose(got, psi, atol=1e-12)


def test_non_real_param_raises_valueerror():
    assert_same_error("OPENQASM 2.0;\nqreg q[1];\nu1(1j) q[0];\n",
                      dialect="openqasm")
    assert_same_error("qreg q[1];\nrx(2**pi**x) q[0];")
