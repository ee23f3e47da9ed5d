"""The port's imperative gate fusion (``startGateFusion``/``stopGateFusion``/
``fusedGates``, ``parallel/pergate.GateFusionBuffer``) and
``CompiledCircuit.dispatch_stats``, on the CPU in float64.

Mirrors the imperative-buffer cases of ``tests/test_fusion.py`` (fused
against eager, flush on every state read, overwrites discarding pending
gates, nesting, density registers), and holds the port's fused registers
against the JAX package's under ``fusedGates`` to 1e-12 on seeded numpy
gates, with the same fused group counts.
"""

import numpy as np
import pytest

import quest_tpu as jq
from quest_tpu import algorithms as jalg
import quest_tpu_torch as tq
from quest_tpu_torch import interop
from torch_threads import one_blas_thread  # noqa: F401

TOL = 1e-12


@pytest.fixture(scope="module")
def envs():
    return (jq.createQuESTEnv(num_devices=1, precision=jq.DOUBLE, seed=[5]),
            tq.createQuESTEnv(num_devices=1, precision=tq.DOUBLE, seed=[5],
                              device="cpu"))


@pytest.fixture(scope="module")
def env(envs):
    return envs[1]


def program(qt, q):
    """tests/test_fusion.py's imperative program."""
    n = q.num_qubits_represented
    for i in range(n):
        qt.hadamard(q, i)
    qt.controlledNot(q, 0, 1)
    qt.tGate(q, 2)
    qt.sGate(q, 0)
    qt.rotateX(q, 1, 0.3)
    qt.controlledPhaseShift(q, 0, 3, 0.5)
    qt.swapGate(q, 0, 2)
    qt.multiRotateZ(q, [0, 2, 3], 0.9)
    qt.pauliY(q, 2)
    qt.rotateAroundAxis(q, 0, 0.6, (1.0, 2.0, -1.0))


def _unitary(rng, dim):
    z = rng.normal(size=(dim, dim)) + 1j * rng.normal(size=(dim, dim))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


def random_program(qt, q, seed, depth=40):
    """Seeded numpy gates through the API: dense 1-3 qubit unitaries,
    (multi-state) controlled gates, phases, rotations and swaps."""
    rng = np.random.default_rng(seed)
    n = q.num_qubits_represented
    for _ in range(depth):
        kind = int(rng.integers(8))
        qs = [int(x) for x in rng.choice(n, size=3, replace=False)]
        if kind == 0:
            qt.unitary(q, qs[0], _unitary(rng, 2))
        elif kind == 1:
            qt.twoQubitUnitary(q, qs[0], qs[1], _unitary(rng, 4))
        elif kind == 2:
            qt.multiQubitUnitary(q, qs, _unitary(rng, 8))
        elif kind == 3:
            qt.multiStateControlledUnitary(q, qs[:2], [0, 1], qs[2],
                                           _unitary(rng, 2))
        elif kind == 4:
            qt.controlledPhaseShift(q, qs[0], qs[1], float(rng.normal()))
        elif kind == 5:
            qt.rotateAroundAxis(q, qs[0], float(rng.normal()),
                                tuple(rng.normal(size=3)))
        elif kind == 6:
            qt.swapGate(q, qs[0], qs[1])
        else:
            qt.multiRotateZ(q, qs[:2], float(rng.normal()))


def _debug_pair(envs, n, density=False):
    make = "createDensityQureg" if density else "createQureg"
    jqr = getattr(jq, make)(n, envs[0])
    tqr = getattr(tq, make)(n, envs[1])
    jq.initDebugState(jqr)
    tq.initDebugState(tqr)
    return jqr, tqr


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("max_qubits", [2, 3])
def test_fused_matches_jax_fused(envs, seed, max_qubits):
    jqr, tqr = _debug_pair(envs, 8)
    with jq.fusedGates(jqr, max_qubits):
        jbuf = jqr._fusion_buffer
        random_program(jq, jqr, seed)
    with tq.fusedGates(tqr, max_qubits):
        tbuf = tqr._fusion_buffer
        random_program(tq, tqr, seed)
        assert tbuf.pending
    np.testing.assert_allclose(tqr.to_numpy(), jqr.to_numpy(), atol=TOL)
    assert (tbuf.gates_in, tbuf.kernels_out) == (jbuf.gates_in,
                                                 jbuf.kernels_out)
    assert tbuf.kernels_out < tbuf.gates_in


def test_fused_density_matches_jax_fused(envs):
    jqr, tqr = _debug_pair(envs, 4, density=True)
    with jq.fusedGates(jqr):
        random_program(jq, jqr, 3, depth=20)
        jq.mixDephasing(jqr, 1, 0.1)     # a channel flushes mid-stream
        random_program(jq, jqr, 4, depth=10)
    with tq.fusedGates(tqr):
        random_program(tq, tqr, 3, depth=20)
        tq.mixDephasing(tqr, 1, 0.1)
        random_program(tq, tqr, 4, depth=10)
    np.testing.assert_allclose(tqr.to_numpy(), jqr.to_numpy(), atol=TOL)


def test_matches_eager(env):
    q1 = tq.createQureg(7, env)
    q2 = tq.createQureg(7, env)
    tq.initDebugState(q1)
    tq.initDebugState(q2)
    program(tq, q1)
    with tq.fusedGates(q2, 3):
        program(tq, q2)
    np.testing.assert_allclose(q2.to_numpy(), q1.to_numpy(), atol=TOL)


def test_mid_fusion_read_flushes(env):
    q = tq.createQureg(5, env)
    tq.initZeroState(q)
    tq.startGateFusion(q)
    tq.hadamard(q, 0)
    # any reader must see the buffered gate applied
    assert abs(tq.calcProbOfOutcome(q, 0, 1) - 0.5) < TOL
    tq.hadamard(q, 0)
    tq.stopGateFusion(q)
    assert q._fusion_buffer is None
    assert abs(tq.getAmp(q, 0) - 1.0) < TOL


@pytest.mark.parametrize("reader", ["state", "to_numpy", "getAmp",
                                    "calcTotalProb", "flush_gates",
                                    "ensure_canonical", "compiled_run"])
def test_every_state_read_flushes(env, reader):
    q = tq.createQureg(3, env)
    tq.initZeroState(q)
    with tq.fusedGates(q):
        tq.pauliX(q, 1)
        assert q._fusion_buffer.pending
        if reader == "state":
            q.state
        elif reader == "to_numpy":
            q.to_numpy()
        elif reader == "getAmp":
            tq.getAmp(q, 0)
        elif reader == "calcTotalProb":
            tq.calcTotalProb(q)
        elif reader == "compiled_run":
            tq.Circuit(3).x(0).compile(env).run(q)
        else:
            getattr(q, reader)()
        assert not q._fusion_buffer.pending
    want = 3 if reader == "compiled_run" else 2
    assert abs(tq.getAmp(q, want) - 1.0) < TOL


@pytest.mark.parametrize("init", ["initZeroState", "initPlusState",
                                  "initDebugState", "initBlankState",
                                  "initClassicalState", "initStateFromAmps",
                                  "cloneQureg"])
def test_init_discards_pending_gates(env, init):
    q = tq.createQureg(2, env)
    ref = tq.createQureg(2, env)
    tq.initZeroState(q)
    tq.startGateFusion(q)
    tq.hadamard(q, 0)
    tq.pauliX(q, 1)
    args = {"initClassicalState": (2,),
            "initStateFromAmps": ([0.6, 0, 0, 0.8], [0, 0, 0, 0])}
    if init == "cloneQureg":
        tq.initPlusState(ref)
        tq.cloneQureg(q, ref)
    else:
        getattr(tq, init)(q, *args.get(init, ()))
        getattr(tq, init)(ref, *args.get(init, ()))
    assert not q._fusion_buffer.pending
    tq.stopGateFusion(q)
    np.testing.assert_allclose(q.to_numpy(), ref.to_numpy(), atol=TOL)


def test_density_with_channel_flush(env):
    d1 = tq.createDensityQureg(3, env)
    d2 = tq.createDensityQureg(3, env)
    tq.initPlusState(d1)
    tq.initPlusState(d2)

    def prog(d):
        tq.hadamard(d, 0)
        tq.tGate(d, 1)
        tq.controlledNot(d, 0, 2)
        tq.mixDephasing(d, 1, 0.1)     # channel: flushes mid-stream
        tq.pauliZ(d, 2)
        tq.hadamard(d, 1)

    prog(d1)
    with tq.fusedGates(d2):
        prog(d2)
    np.testing.assert_allclose(d2.to_numpy(), d1.to_numpy(), atol=TOL)


def test_density_budget_is_halved(env):
    d = tq.createDensityQureg(4, env)
    tq.startGateFusion(d, 4)
    buf = d._fusion_buffer
    assert (buf.max_k, buf.diag_max) == (4, 4)
    tq.stopGateFusion(d)
    d = tq.createDensityQureg(3, env)
    tq.startGateFusion(d, 4)
    assert (d._fusion_buffer.max_k, d._fusion_buffer.diag_max) == (3, 3)


def test_nested_contexts_resume_outer(env):
    q = tq.createQureg(3, env)
    tq.initZeroState(q)
    with tq.fusedGates(q):
        outer = q._fusion_buffer
        tq.hadamard(q, 0)
        with tq.fusedGates(q, max_qubits=2):
            assert q._fusion_buffer is not outer
            tq.hadamard(q, 1)
        # the outer context is still buffering, not eager
        assert q._fusion_buffer is outer
        tq.hadamard(q, 2)
        assert outer.pending
    assert q._fusion_buffer is None
    for i in range(3):
        assert abs(tq.calcProbOfOutcome(q, i, 1) - 0.5) < TOL


def test_restart_at_the_same_budget_keeps_the_buffer(env):
    q = tq.createQureg(4, env)
    tq.startGateFusion(q, 3)
    buf = q._fusion_buffer
    tq.hadamard(q, 0)
    tq.startGateFusion(q, 3)
    assert q._fusion_buffer is buf and buf.pending
    tq.startGateFusion(q, 2)            # a new cap flushes and re-arms
    assert q._fusion_buffer is not buf and not buf.pending
    tq.stopGateFusion(q)
    assert abs(tq.calcProbOfOutcome(q, 0, 1) - 0.5) < TOL


def test_qasm_records_every_buffered_gate(envs):
    jqr, tqr = _debug_pair(envs, 4)
    for pkg, q in ((jq, jqr), (tq, tqr)):
        pkg.startRecordingQASM(q)
        with pkg.fusedGates(q):
            program(pkg, q)
    assert tqr.qasm_log.text() == jqr.qasm_log.text()


@pytest.mark.parametrize("n", [6, 9])
def test_dispatch_stats_match_jax(envs, n):
    jenv, tenv = envs
    jc = jalg.qft(n)
    records = [(op.kind, op.targets, op.ctrl_mask, op.flip_mask,
                op.mat if op.kind == "u" else op.diag) for op in jc.ops]
    tc = interop.circuit_from_records(n, records)
    for fusion in (None, 0, 2):
        jd = jc.compile(jenv, pallas=False, fusion=fusion) \
            .dispatch_stats().as_dict()
        td = tc.compile(tenv, pallas=False, fusion=fusion) \
            .dispatch_stats().as_dict()
        for key in ("gates_in", "kernels_out", "relayouts", "dispatches",
                    "fused_groups", "diag_folds", "commuted_diagonals",
                    "max_group_gates", "precision_tier",
                    "modeled_tier_error", "batch_size"):
            assert td[key] == jd[key], (fusion, key, td[key], jd[key])
        assert set(td) == set(jd)


def test_dispatch_stats_count_layers_and_batches(env):
    c = tq.Circuit(9)
    th = c.parameter("th")
    for q in range(9):
        c.h(q)
    c.ry(8, th).cnot(0, 8)
    cc = c.compile(env)
    ds = cc.dispatch_stats()
    assert ds.gates_in == 11
    assert ds.kernels_out == len(cc.plan.items) >= cc.num_layers >= 1
    assert ds.batch_size == 0 and ds.precision_tier == "env"
    cc.sweep(np.zeros((5, 1)))
    assert cc.dispatch_stats().batch_size == 5
    fast = c.compile(env, tier="single").dispatch_stats()
    assert fast.precision_tier == "single" and fast.modeled_tier_error > 0
