"""The port's mesh registers through the QuEST API, against the JAX
package's 8-device mesh (its 8 virtual CPU devices) and the port's own
single-device env, in float64 at 1e-12.

The port's mesh is ``createQuESTEnv(num_devices=8, device="cpu")``: eight
host shards driven by one process. Mirrors the JAX package's
``test_distributed`` and ``test_pergate``: the mixed local/cross-shard
circuit, reductions, collapse and measurement, the density register with
channels, multi-qubit unitaries on high qubits, the lazy layout (SWAP as
metadata, fewer relayouts than sharded gates, ``getAmp`` under a permuted
layout), compiled programs (a QFT, a density program) and compiled runs
mixed with per-gate calls; plus the chunk-wise ``init*`` functions, the
sampler, the functions the remainder routed, and the whole-register read
that still raises.
"""

import numpy as np
import pytest

import quest_tpu as jq
from quest_tpu import algorithms as jalg
import quest_tpu_torch as tq
from quest_tpu_torch import interop
from quest_tpu_torch.parallel import exchange as tex
from quest_tpu_torch.parallel import pergate as tpg
from torch_threads import one_blas_thread  # noqa: F401

import oracle

TOL = 1e-12
N = 6  # 64 amplitudes over 8 shards: qubits 0-2 local, 3-5 index the shard


@pytest.fixture(scope="module")
def envs():
    return {"j8": jq.createQuESTEnv(num_devices=8, precision=jq.DOUBLE,
                                    seed=[7]),
            "t8": tq.createQuESTEnv(num_devices=8, precision=tq.DOUBLE,
                                    seed=[7], device="cpu"),
            "t1": tq.createQuESTEnv(num_devices=1, precision=tq.DOUBLE,
                                    seed=[7], device="cpu")}


def pkg(env):
    return tq if isinstance(env, tq.QuESTEnv) else jq


def run_circuit(env, n=N):
    """``tests/test_distributed.py``'s circuit: local and cross-shard
    targets, controls on either side, a SWAP across the boundary."""
    qt = pkg(env)
    rng = np.random.default_rng(5)
    q = qt.createQureg(n, env)
    psi = oracle.random_state(n, rng)
    qt.initStateFromAmps(q, psi.real, psi.imag)
    qt.hadamard(q, 0)
    qt.hadamard(q, n - 1)
    qt.controlledNot(q, 0, n - 1)
    qt.controlledNot(q, n - 1, 1)
    qt.rotateY(q, n - 2, 0.7)
    qt.tGate(q, n - 1)
    qt.multiRotateZ(q, [0, n - 1], 0.3)
    qt.swapGate(q, 1, n - 1)
    u = oracle.random_unitary(2, np.random.default_rng(9))
    qt.twoQubitUnitary(q, 2, n - 1, u)
    qt.multiControlledPhaseFlip(q, [0, n - 2, n - 1])
    return q


def test_mesh_env_and_sharded_register(envs):
    env = envs["t8"]
    assert env.num_devices == 8 and env.mesh.size == 8
    assert (env.rank, env.num_ranks, env.is_multihost) == (0, 1, False)
    assert "mesh" in tq.getEnvironmentString(env)
    assert "mesh" in env.report()
    q = tq.createQureg(N, env)
    tq.hadamard(q, N - 1)
    assert q.is_sharded and len(q.chunks) == 8
    assert all(tuple(c.shape) == (2, (1 << N) // 8) for c in q.chunks)
    assert (q.num_amps_per_chunk, q.num_chunks) == (8, 8)
    assert q.sharding().shard_of(37, N) == 37 >> 3
    # a register smaller than the mesh stays whole on the first shard
    small = tq.createQureg(2, env)
    assert not small.is_sharded and small.state.shape == (2, 4)


def test_sharded_state_matches_jax_mesh(envs):
    want = run_circuit(envs["j8"]).to_numpy()
    q8 = run_circuit(envs["t8"])
    assert q8.layout is not None            # the SWAP stayed metadata
    assert np.abs(q8.to_numpy() - want).max() < TOL
    assert np.abs(run_circuit(envs["t1"]).to_numpy() - want).max() < TOL


def test_sharded_reductions(envs):
    j, t = run_circuit(envs["j8"]), run_circuit(envs["t8"])
    assert abs(tq.calcTotalProb(t) - jq.calcTotalProb(j)) < TOL
    for qubit in range(N):
        assert abs(tq.calcProbOfOutcome(t, qubit, 1)
                   - jq.calcProbOfOutcome(j, qubit, 1)) < TOL
    assert abs(tq.calcInnerProduct(t, t) - jq.calcInnerProduct(j, j)) < TOL
    codes = [1, 2, 3, 0, 1, 3, 3, 0, 0, 2, 1, 1]
    assert abs(tq.calcExpecPauliSum(t, codes, [0.3, -0.7])
               - jq.calcExpecPauliSum(j, codes, [0.3, -0.7])) < TOL
    assert abs(tq.calcExpecPauliProd(t, range(N), codes[:N])
               - jq.calcExpecPauliProd(j, range(N), codes[:N])) < TOL
    tp, jp = tq.createQureg(N, envs["t8"]), jq.createQureg(N, envs["j8"])
    tq.initPlusState(tp)
    jq.initPlusState(jp)
    assert abs(tq.calcFidelity(t, tp) - jq.calcFidelity(j, jp)) < TOL


def test_sharded_collapse_and_measure(envs):
    j, t = run_circuit(envs["j8"]), run_circuit(envs["t8"])
    for qubit, outcome in ((N - 1, 1), (0, 0)):
        assert abs(tq.collapseToOutcome(t, qubit, outcome)
                   - jq.collapseToOutcome(j, qubit, outcome)) < TOL
    assert np.abs(t.to_numpy() - j.to_numpy()).max() < TOL
    # measurement: the same seed's uniforms as the single-device env
    t8, t1 = run_circuit(envs["t8"]), run_circuit(envs["t1"])
    tq.seedQuEST(envs["t8"], [11])
    tq.seedQuEST(envs["t1"], [11])
    for qubit in (N - 1, 2, N - 2):
        assert tq.measureWithStats(t8, qubit) == pytest.approx(
            tq.measureWithStats(t1, qubit), abs=TOL)
    assert np.abs(t8.to_numpy() - t1.to_numpy()).max() < TOL


def density_flow(env):
    qt = pkg(env)
    n = 3  # the flat vector has 2n = 6 qubits: 64 amplitudes over 8 shards
    rho = oracle.random_density(n, np.random.default_rng(11))
    d = qt.createDensityQureg(n, env)
    flat = rho.T.reshape(-1)
    qt.setDensityAmps(d, flat.real, flat.imag)
    qt.hadamard(d, n - 1)
    qt.controlledNot(d, n - 1, 0)
    qt.mixDephasing(d, n - 1, 0.2)
    qt.mixDepolarising(d, 0, 0.3)
    qt.mixDamping(d, 1, 0.25)
    qt.mixTwoQubitDephasing(d, 0, 2, 0.1)
    qt.swapGate(d, 0, 2)
    return d


def test_sharded_density_matrix(envs):
    j, t = density_flow(envs["j8"]), density_flow(envs["t8"])
    assert np.abs(t.density_matrix_numpy()
                  - j.density_matrix_numpy()).max() < TOL
    assert abs(tq.calcPurity(t) - jq.calcPurity(j)) < TOL
    assert abs(tq.calcTotalProb(t) - jq.calcTotalProb(j)) < TOL
    for qubit in range(3):
        assert abs(tq.calcProbOfOutcome(t, qubit, 0)
                   - jq.calcProbOfOutcome(j, qubit, 0)) < TOL
    tp, jp = tq.createQureg(3, envs["t8"]), jq.createQureg(3, envs["j8"])
    tq.initPlusState(tp)
    jq.initPlusState(jp)
    assert abs(tq.calcFidelity(t, tp) - jq.calcFidelity(j, jp)) < TOL
    t2, j2 = density_flow(envs["t8"]), density_flow(envs["j8"])
    tq.mixDepolarising(t2, 2, 0.1)
    jq.mixDepolarising(j2, 2, 0.1)
    assert abs(tq.calcHilbertSchmidtDistance(t, t2)
               - jq.calcHilbertSchmidtDistance(j, j2)) < TOL
    assert abs(tq.calcDensityInnerProduct(t, t2)
               - jq.calcDensityInnerProduct(j, j2)) < TOL
    tq.mixDensityMatrix(t, 0.3, t2)
    jq.mixDensityMatrix(j, 0.3, j2)
    assert abs(tq.collapseToOutcome(t, 1, 1)
               - jq.collapseToOutcome(j, 1, 1)) < TOL
    assert np.abs(t.to_numpy() - j.to_numpy()).max() < TOL


def test_multi_qubit_unitary_on_high_qubits(envs):
    rng = np.random.default_rng(13)
    psi = oracle.random_state(N, rng)
    u = oracle.random_unitary(3, rng)
    u2 = oracle.random_unitary(2, rng)
    out = []
    for key in ("j8", "t8"):
        qt = pkg(envs[key])
        q = qt.createQureg(N, envs[key])
        qt.initStateFromAmps(q, psi.real, psi.imag)
        qt.multiQubitUnitary(q, (N - 1, N - 2, 0), u)
        qt.controlledTwoQubitUnitary(q, 1, N - 3, N - 1, u2)
        out.append(q.to_numpy())
    assert np.abs(out[0] - out[1]).max() < TOL


def test_swap_is_metadata_and_getamp_reads_the_layout(envs):
    n = 8
    q = tq.createQureg(n, envs["t8"])
    tq.initDebugState(q)
    before = tpg.RELAYOUT_COUNT
    tex.reset_counts()
    tq.swapGate(q, 0, n - 1)
    assert tpg.RELAYOUT_COUNT == before and tex.COUNTS["relayouts"] == 0
    assert q.layout is not None
    ref = tq.createQureg(n, envs["t1"])
    tq.initDebugState(ref)
    tq.swapGate(ref, 0, n - 1)
    for index in (1, 1 << (n - 1), 77, 200):
        assert tq.getAmp(q, index) == pytest.approx(tq.getAmp(ref, index),
                                                    abs=1e-14)
    assert tpg.RELAYOUT_COUNT == before      # reads did not canonicalise


def test_fewer_relayouts_than_sharded_gates(envs):
    n = 9
    u3 = oracle.random_unitary(3, np.random.default_rng(3))
    out, touches, relayouts = [], 0, 0
    for key in ("t1", "t8", "j8"):
        qt = pkg(envs[key])
        q = qt.createQureg(n, envs[key])
        qt.initDebugState(q)
        count0 = tpg.RELAYOUT_COUNT
        for layer in range(5):
            qt.hadamard(q, n - 1)                 # role-split, no relayout
            qt.controlledNot(q, n - 2, 0)         # sharded control: free
            qt.tGate(q, n - 3)                    # diagonal: free
            qt.multiQubitUnitary(q, (n - 1, n - 2, 1), u3)
            qt.rotateX(q, n - 2, 0.3)
            if key == "t8":
                touches += 5
        if key == "t8":
            relayouts = tpg.RELAYOUT_COUNT - count0
        out.append(q.to_numpy())
    assert relayouts < touches / 3
    assert np.abs(out[1] - out[0]).max() < 1e-9      # debug-state scale
    assert np.abs(out[1] - out[2]).max() < 1e-9


def test_mixed_compiled_and_per_gate(envs):
    n = 9
    circ = {}
    for key in ("t8", "j8"):
        qt = pkg(envs[key])
        c = qt.Circuit(n)
        for layer in range(3):
            for q_ in range(n):
                c.ry(q_, 0.1 * (q_ + layer + 1))
            for q_ in range(layer % 2, n - 1, 2):
                c.cnot(q_, q_ + 1)
            c.swap(1, n - 1)
        circ[key] = c.compile(envs[key])
    out = []
    for key in ("t8", "j8"):
        qt = pkg(envs[key])
        q = qt.createQureg(n, envs[key])
        qt.initPlusState(q)
        qt.swapGate(q, 0, n - 1)                   # a lazy layout
        qt.multiQubitUnitary(q, (n - 1, n - 2), oracle.random_unitary(
            2, np.random.default_rng(4)))
        circ[key].run(q)                           # canonicalises first
        qt.hadamard(q, n - 1)
        qt.swapGate(q, 2, n - 2)
        circ[key].run(q)
        out.append(q.to_numpy())
    assert np.abs(out[0] - out[1]).max() < TOL


@pytest.mark.parametrize("overlap", [False, True])
def test_compiled_qft_equals_jax_mesh(envs, overlap):
    n = 10
    jc = jalg.qft(n)
    tc = interop.circuit_from_records(n, [
        (op.kind, op.targets, op.ctrl_mask, op.flip_mask,
         op.mat if op.kind == "u" else op.diag) for op in jc.ops])
    psi = oracle.random_state(n, np.random.default_rng(8))
    jqr = jq.createQureg(n, envs["j8"])
    oracle.set_sv(jqr, psi)
    jc.compile(envs["j8"]).run(jqr)
    tqr = tq.createQureg(n, envs["t8"])
    tq.initStateFromAmps(tqr, psi.real, psi.imag)
    cc = tc.compile(envs["t8"], overlap=overlap)
    tex.reset_counts()
    cc.run(tqr)
    assert tex.COUNTS["relayouts"] == cc.plan.num_relayouts
    assert np.abs(tqr.to_numpy() - jqr.to_numpy()).max() < TOL
    want = np.fft.ifft(psi, norm="ortho")
    assert np.abs(tqr.to_numpy() - want).max() < 1e-10


def test_compiled_density_program_equals_jax_mesh(envs):
    n = 4
    out = []
    for key in ("j8", "t8"):
        qt = pkg(envs[key])
        c = qt.Circuit(n)
        c.h(0)
        c.cnot(0, 3)
        c.ry(3, 0.4)
        c.damp(3, 0.2)
        c.dephase(1, 0.1)
        c.depolarise(2, 0.3)
        c.swap(0, 3)
        c.cz(1, 3)
        d = qt.createDensityQureg(n, envs[key])
        qt.initPlusState(d)
        c.compile(envs[key], density=True).run(d)
        out.append(d.density_matrix_numpy())
    assert np.abs(out[0] - out[1]).max() < TOL


def test_inits_and_register_functions_chunk_wise(envs):
    n = 7
    t8, t1 = envs["t8"], envs["t1"]

    def both(fn):
        a, b = tq.createQureg(n, t8), tq.createQureg(n, t1)
        fn(a)
        fn(b)
        assert np.abs(a.to_numpy() - b.to_numpy()).max() < TOL, fn
        return a, b

    both(tq.initPlusState)
    both(tq.initBlankState)
    both(lambda q: tq.initClassicalState(q, 101))
    both(tq.initDebugState)
    both(lambda q: tq.initStateOfSingleQubit(q, n - 1, 1))
    both(lambda q: tq.initStateOfSingleQubit(q, 2, 0))
    a, b = both(lambda q: (tq.initDebugState(q), tq.swapGate(q, 0, n - 1),
                           tq.setAmps(q, 10, np.arange(30.0),
                                      -np.arange(30.0), 30)))
    c8, c1 = tq.createCloneQureg(a, t8), tq.createCloneQureg(b, t1)
    assert np.abs(c8.to_numpy() - c1.to_numpy()).max() < TOL
    tq.setWeightedQureg(0.5, a, -0.25j, c8, 2.0, c8)
    tq.setWeightedQureg(0.5, b, -0.25j, c1, 2.0, c1)
    assert np.abs(c8.to_numpy() - c1.to_numpy()).max() < TOL
    tq.cloneQureg(c8, a)
    tq.initPureState(c1, b)
    assert np.abs(c8.to_numpy() - c1.to_numpy()).max() < TOL
    pure8, pure1 = tq.createQureg(3, t8), tq.createQureg(3, t1)
    for p in (pure8, pure1):
        tq.initPlusState(p)
        tq.rotateY(p, 2, 0.3)
        tq.controlledPhaseShift(p, 0, 2, 0.7)
    d8, d1 = tq.createDensityQureg(3, t8), tq.createDensityQureg(3, t1)
    tq.initPureState(d8, pure8)
    tq.initPureState(d1, pure1)
    assert np.abs(d8.to_numpy() - d1.to_numpy()).max() < TOL


def test_fusion_buffer_on_a_mesh_register(envs):
    n = 8
    out = []
    for key in ("t8", "t1"):
        q = tq.createQureg(n, envs[key])
        tq.initPlusState(q)
        with tq.fusedGates(q, max_qubits=3):
            for k in range(n):
                tq.rotateY(q, k, 0.1 * k)
            tq.controlledNot(q, n - 1, 0)
            tq.swapGate(q, 1, n - 1)
            tq.hadamard(q, n - 1)
        out.append(q.to_numpy())
    assert np.abs(out[0] - out[1]).max() < TOL


def test_sample_outcomes_sharded(envs):
    q = run_circuit(envs["t8"])
    tq.seedQuEST(envs["t8"], [5])
    got = tq.sampleOutcomes(q, 20000)
    probs = np.abs(q.to_numpy()) ** 2
    # each qubit's marginal P(1) within 5 standard errors
    for qubit in range(N):
        p1 = probs[(np.arange(1 << N) >> qubit) & 1 == 1].sum()
        freq = np.mean((got >> qubit) & 1)
        assert abs(freq - p1) <= 5 * np.sqrt(p1 * (1 - p1) / got.size)
    packed = tq.sampleOutcomes(q, 100, qubits=[N - 1, 0])
    assert packed.max() < 4


def test_unrouted_functions_raise(envs):
    """The functions the first mesh slices left unrouted now run over the
    chunks: ``applyPauliSum``, a density register's ``calcExpecPauliSum``
    and a QUAD register on a mesh agree with the JAX package's 8 devices
    at 1e-12. A whole-register read of a sharded register still
    raises."""
    got = {}
    for key in ("j8", "t8"):
        env = envs[key]
        qt = pkg(env)
        q = run_circuit(env)
        out = qt.createQureg(N, env)
        qt.applyPauliSum(q, [3] * N + [1, 2, 0, 0, 3, 1], [1.0, -0.4], 2,
                         out)
        d = qt.createDensityQureg(3, env)
        qt.initPlusState(d)
        qt.rotateY(d, 2, 0.3)
        qt.mixDepolarising(d, 2, 0.1)
        quad = qt.createQureg(4, qt.createQuESTEnv(2, qt.QUAD, [1]) if qt
                              is jq else tq.createQuESTEnv(
                                  2, tq.QUAD, [1], device="cpu"))
        qt.hadamard(quad, 3)
        qt.controlledNot(quad, 3, 0)
        got[key] = (out.to_numpy(), qt.calcExpecPauliSum(
            d, [3, 0, 0, 1, 2, 3], [1.0, 0.5]), quad.to_numpy())
        if key == "t8":
            with pytest.raises(NotImplementedError,
                               match="whole-register read"):
                q.state
    for a, b in zip(got["t8"], got["j8"]):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() < TOL
