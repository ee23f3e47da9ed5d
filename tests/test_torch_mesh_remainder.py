"""The single-controller mesh's remainder against the JAX package's 8
virtual CPU devices (and the port's one-device env), in float64 at 1e-12.

Eight host shards (``createQuESTEnv(num_devices=8, device="cpu")``):
``applyPauliSum`` on sharded registers, ``calcExpecPauliProd``/``Sum`` on
sharded density registers (chunks of whole columns and chunks narrower
than one column), dense passes wider than a chunk's local qubits (the
grouped pass, its scratch one group), ``initPureState``/``calcFidelity``
on density chunks narrower than a column, QUAD registers and
``DDProgram`` on a mesh (the JAX package's
``test_quad_register_on_mesh`` and ``test_dd_program_mesh_equivalence``
at their 1e-13), and the ``tier="quad"`` sweeps in ``amp`` and ``batch``
modes.
"""

import warnings

import numpy as np
import pytest

import quest_tpu as jq
from quest_tpu.config import QUAD as JQUAD
import quest_tpu_torch as tq
from quest_tpu_torch.parallel import exchange as tex
from torch_threads import one_blas_thread  # noqa: F401

import oracle

TOL = 1e-12
DD_TOL = 1e-13


@pytest.fixture(scope="module")
def envs():
    return {"j8": jq.createQuESTEnv(num_devices=8, precision=jq.DOUBLE,
                                    seed=[7]),
            "t8": tq.createQuESTEnv(num_devices=8, precision=tq.DOUBLE,
                                    seed=[7], device="cpu"),
            "t1": tq.createQuESTEnv(precision=tq.DOUBLE, seed=[7],
                                    device="cpu")}


def pkg(env):
    return tq if isinstance(env, tq.QuESTEnv) else jq


def state(env, n, seed=5):
    qt = pkg(env)
    q = qt.createQureg(n, env)
    psi = oracle.random_state(n, np.random.default_rng(seed))
    qt.initStateFromAmps(q, psi.real, psi.imag)
    qt.hadamard(q, n - 1)
    qt.controlledNot(q, n - 1, 0)
    qt.swapGate(q, 0, n - 1)           # a lazy layout on the mesh
    qt.rotateY(q, n - 2, 0.7)
    return q


def density(env, n, seed=6):
    qt = pkg(env)
    p = state(env, n, seed)
    d = qt.createDensityQureg(n, env)
    qt.initPureState(d, p)
    qt.mixDepolarising(d, 0, 0.1)
    qt.mixDamping(d, n - 1, 0.2)
    qt.rotateX(d, n - 1, 0.4)
    qt.controlledNot(d, 0, n - 1)
    return d


CODES6 = [3, 1, 2, 0, 1, 3] + [2, 2, 0, 1, 3, 1] + [0, 0, 0, 0, 0, 3]
COEFFS6 = [0.7, -0.3, 0.25]


def test_apply_pauli_sum_on_sharded_registers(envs):
    outs = {}
    for key in ("j8", "t8", "t1"):
        env = envs[key]
        qt = pkg(env)
        q = state(env, 6)
        out = qt.createQureg(6, env)
        qt.startRecordingQASM(out)
        qt.applyPauliSum(q, CODES6, COEFFS6, 3, out)
        d = density(env, 3)
        dout = qt.createDensityQureg(3, env)
        qt.applyPauliSum(d, [1, 0, 3, 2, 2, 0], [0.5, -1.25], 2, dout)
        outs[key] = (out.to_numpy(), dout.to_numpy(), q.to_numpy())
        if key == "t8":
            assert out.is_sharded and len(out.chunks) == 8
            assert out.layout is None and dout.is_sharded
            assert "Pauli-sum image" in out.qasm_log.text()
    for ref in ("j8", "t1"):
        for a, b in zip(outs["t8"], outs[ref]):
            assert np.abs(a - b).max() < TOL


@pytest.mark.parametrize("n", [2, 3, 4])
def test_density_pauli_expectations_sharded(envs, n):
    """2 qubits over 8 shards hold half a column per chunk, 3 one column,
    4 two columns: every Pauli term pairs row ``r`` with column ``r ^
    x``, wherever it lies."""
    rng = np.random.default_rng(n)
    codes = [int(c) for c in rng.integers(0, 4, size=4 * n)]
    coeffs = [float(c) for c in rng.normal(size=4)]
    got = {}
    for key in ("j8", "t8", "t1"):
        env = envs[key]
        qt = pkg(env)
        d = density(env, n)
        got[key] = [qt.calcExpecPauliSum(d, codes, coeffs)] + [
            qt.calcExpecPauliProd(d, list(range(n)), codes[t * n:
                                                           (t + 1) * n], n)
            for t in range(4)]
    for ref in ("j8", "t1"):
        assert np.abs(np.subtract(got["t8"], got[ref])).max() < TOL


def test_density_pauli_expectations_compensated():
    """A SINGLE env's compensated reductions over the chunks agree with
    its one-device reductions at float32's tolerance."""
    vals = []
    for nd in (8, 1):
        env = tq.createQuESTEnv(num_devices=nd, precision=tq.SINGLE,
                                seed=[1], device="cpu")
        assert env.compensated
        d = density(env, 3)
        vals.append([tq.calcExpecPauliSum(d, [1, 2, 3, 3, 0, 1],
                                          [0.4, -0.6]),
                     tq.calcExpecPauliProd(d, [0, 2], [2, 1])])
    assert np.abs(np.subtract(*vals)).max() < 1e-6


def test_wide_passes_on_small_density_registers(envs):
    """A 3-qubit density register over 8 shards has 3 local qubits; a
    two-qubit gate or channel lifts to 4 targets, run on groups of two
    chunks, and a four-target unitary on a 6-qubit state vector on groups
    of two. The scratch is one group: 2^(k - lt) chunks."""
    u2 = oracle.random_unitary(2, np.random.default_rng(3))
    u4 = oracle.random_unitary(4, np.random.default_rng(4))
    outs = {}
    for key in ("j8", "t8"):
        env = envs[key]
        qt = pkg(env)
        tex.reset_counts()
        d = density(env, 3)
        qt.twoQubitUnitary(d, 0, 2, u2)
        qt.mixTwoQubitDepolarising(d, 1, 2, 0.3)
        qt.controlledTwoQubitUnitary(d, 1, 2, 0, u2)
        q = state(env, 6)
        qt.multiQubitUnitary(q, [0, 2, 4, 5], u4)
        outs[key] = (d.to_numpy(), q.to_numpy(), qt.calcPurity(d),
                     qt.calcTotalProb(q))
        if key == "t8":
            chunk_bytes = d.chunks[0].numel() * 8
            assert tex.COUNTS["grouped"] >= 4
            # k - lt = 4 - 3 = 1 device bit left in each group
            assert tex.GROUP_PEAK[0] == 2 * chunk_bytes
    for a, b in zip(outs["t8"], outs["j8"]):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() < TOL


@pytest.mark.parametrize("n,shards", [(2, 8), (3, 16)])
def test_narrow_density_init_pure_and_fidelity(envs, n, shards):
    """Chunks narrower than one column of rho: each holds part of one
    column, ``|psi><psi|`` and ``<psi|rho|psi>`` from the column index of
    its slice. 2 qubits over 8 shards against the JAX package's 8
    devices; 3 over 16 host shards against one device."""
    tenv = tq.createQuESTEnv(num_devices=shards, precision=tq.DOUBLE,
                             seed=[7], device="cpu")
    refs = [envs["t1"]] + ([envs["j8"]] if shards == 8 else [])
    got = {}
    for key, env in [("mesh", tenv)] + [(f"r{i}", e)
                                        for i, e in enumerate(refs)]:
        qt = pkg(env)
        p, p2 = state(env, n, 1), state(env, n, 2)
        d = qt.createDensityQureg(n, env)
        qt.initPureState(d, p)
        f1 = qt.calcFidelity(d, p2)
        qt.mixDephasing(d, 0, 0.2)
        qt.mixDepolarising(d, n - 1, 0.1)
        got[key] = (d.to_numpy(), [f1, qt.calcFidelity(d, p2),
                                   qt.calcFidelity(d, p)])
        if key == "mesh":
            assert d.is_sharded and d.chunks[0].shape[-1] < (1 << n)
    for key in got:
        assert np.abs(got["mesh"][0] - got[key][0]).max() < TOL
        assert np.abs(np.subtract(got["mesh"][1], got[key][1])).max() < TOL


def test_quad_register_on_mesh():
    """The JAX package's ``test_quad_register_on_mesh``: QUAD registers
    shard their (4, 2^n) planes over the mesh; results match the
    single-device QUAD path and the JAX package's 8 devices at 1e-13."""
    rng = np.random.default_rng(11)
    u = np.linalg.qr(rng.normal(size=(4, 4))
                     + 1j * rng.normal(size=(4, 4)))[0]
    n = 7
    outs = {}
    for key, qt, env in (
            ("t1", tq, tq.createQuESTEnv(precision=tq.QUAD, seed=[3],
                                         device="cpu")),
            ("t8", tq, tq.createQuESTEnv(num_devices=8, precision=tq.QUAD,
                                         seed=[3], device="cpu")),
            ("j8", jq, jq.createQuESTEnv(num_devices=8, precision=JQUAD,
                                         seed=[3]))):
        q = qt.createQureg(n, env)
        qt.initPlusState(q)
        qt.hadamard(q, n - 1)
        qt.twoQubitUnitary(q, n - 1, 0, u)
        qt.controlledNot(q, n - 1, 1)
        qt.tGate(q, n - 2)
        outs[key] = (q.to_numpy(), qt.calcTotalProb(q))
        if key == "t8":
            assert q.is_sharded and q.is_quad
            assert tuple(q.chunks[0].shape) == (4, 1 << (n - 3))
    for ref in ("t1", "j8"):
        np.testing.assert_allclose(outs["t8"][0], outs[ref][0],
                                   atol=DD_TOL)
        assert outs["t8"][1] == pytest.approx(outs[ref][1], abs=DD_TOL)


def test_dd_program_mesh_equivalence():
    """The JAX package's ``test_dd_program_mesh_equivalence``: the sharded
    dd program (8 shards, cross-shard targets included) matches the
    single-device dd program, bit for bit here, the JAX package's mesh
    program at 1e-13, and the f64 path at 1e-12."""
    rng = np.random.default_rng(17)
    n = 7
    circs = {"t": tq.Circuit(n), "j": jq.Circuit(n)}
    for i in range(40):
        a, b = (int(x) for x in rng.choice(n, 2, replace=False))
        k = i % 4
        args = (a, float(rng.uniform(0, 6.28)), rng.normal(size=3))
        for c in circs.values():
            if k == 0:
                c.rotate(*args)
            elif k == 1:
                c.cnot(a, b)
            elif k == 2:
                c.cphase(a, b, 0.37)
            else:
                c.swap(a, b)
    psi = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    psi /= np.linalg.norm(psi)
    outs = {}
    for key, c, env in (
            ("t1", circs["t"], tq.createQuESTEnv(device="cpu", seed=[9],
                                                 precision=tq.DOUBLE)),
            ("t8", circs["t"], tq.createQuESTEnv(
                num_devices=8, device="cpu", seed=[9],
                precision=tq.DOUBLE)),
            ("j8", circs["j"], jq.createQuESTEnv(num_devices=8, seed=[9]))):
        prog = c.compile_dd(env, dtype=np.float32)
        planes = prog.run(prog.pack(psi))
        outs[key] = prog.unpack(planes)
        assert abs(prog.total_prob(planes) - 1.0) < 1e-12
        if key == "t8":
            assert isinstance(planes, list) and len(planes) == 8
            assert prog.layout_plan.num_relayouts > 0
    assert np.array_equal(outs["t8"], outs["t1"])
    np.testing.assert_allclose(outs["t8"], outs["j8"], atol=DD_TOL)
    env = tq.createQuESTEnv(device="cpu", seed=[9], precision=tq.DOUBLE)
    q = tq.createQureg(n, env)
    tq.initStateFromAmps(q, psi.real, psi.imag)
    circs["t"].compile(env).run(q)
    np.testing.assert_allclose(outs["t8"], q.to_numpy(), atol=1e-12)


def quad_walk(env, n):
    """Every QUAD-register function on ``env``: the numbers and planes."""
    u3 = oracle.random_unitary(3, np.random.default_rng(8))
    vals = []
    q = tq.createQureg(n, env)
    tq.initDebugState(q)
    tq.initPlusState(q)
    tq.rotateY(q, n - 1, 0.3)
    tq.controlledRotateX(q, n - 1, 0, 0.9)
    tq.multiQubitUnitary(q, [0, n - 2, n - 1], u3)
    tq.multiRotatePauli(q, [1, n - 1], [1, 2], 0.4)
    tq.swapGate(q, 0, n - 1)
    tq.sqrtSwapGate(q, 2, n - 2)
    p = tq.createCloneQureg(q, env)
    tq.pauliY(p, n - 1)
    out = tq.createQureg(n, env)
    tq.applyPauliSum(q, [3, 1] + [0] * (n - 2) + [0] * (n - 1) + [2],
                     [0.5, -0.75], 2, out)
    vals += [tq.calcTotalProb(q), tq.calcInnerProduct(q, p),
             tq.calcFidelity(q, p), tq.getAmp(q, 5),
             tq.calcProbOfOutcome(q, n - 1, 1),
             tq.calcExpecPauliSum(q, [3] * n + [1] * n, [0.3, 0.2]),
             tq.calcExpecPauliProd(q, [0, n - 1], [2, 2]),
             tq.calcTotalProb(out)]
    vals.append(tq.collapseToOutcome(q, n - 1, 0))
    tq.setWeightedQureg(0.5, q, 0.25j, p, -1.0, out)
    tq.setAmps(q, 3, [0.1, 0.2], [0.3, -0.1], 2)
    d = tq.createDensityQureg(n // 2, env)
    pure = tq.createQureg(n // 2, env)
    tq.initPlusState(pure)
    tq.rotateZ(pure, 0, 0.6)
    tq.initPureState(d, pure)
    tq.mixDepolarising(d, 0, 0.1)
    tq.mixTwoQubitDephasing(d, 0, 1, 0.2)
    tq.mixKrausMap(d, 1, [np.sqrt(0.7) * np.eye(2),
                          np.sqrt(0.3) * np.array([[0, 1], [1, 0]])])
    e = tq.createDensityQureg(n // 2, env)
    tq.initClassicalState(e, 1)
    tq.mixDensityMatrix(d, 0.2, e)
    vals += [tq.calcPurity(d), tq.calcFidelity(d, pure),
             tq.calcDensityInnerProduct(d, e),
             tq.calcHilbertSchmidtDistance(d, e), tq.calcTotalProb(d),
             tq.calcProbOfOutcome(d, 1, 0),
             tq.calcExpecPauliSum(d, [1, 3, 0] + [2, 0, 3], [0.6, 0.4]),
             tq.getDensityAmp(d, 2, 5)]
    vals.append(tq.collapseToOutcome(d, 0, 1))
    return vals, [q.to_numpy(), out.to_numpy(), d.to_numpy()]


@pytest.mark.parametrize("prec", ["QUAD", "QUAD64"])
def test_quad_mesh_api_parity(prec):
    """Every QUAD-register function over 8 shards against one device:
    gates (cross-shard targets, a three-qubit unitary, SWAP as layout),
    reductions in dd over the chunks, collapse, Pauli sums, the density
    functions and channels, at 1e-13."""
    n = 6
    got = []
    for nd in (8, 1):
        env = tq.createQuESTEnv(num_devices=nd, precision=getattr(tq, prec),
                                seed=[4], device="cpu")
        got.append(quad_walk(env, n))
    (v8, s8), (v1, s1) = got
    assert np.abs(np.subtract(v8, v1)).max() < DD_TOL
    for a, b in zip(s8, s1):
        assert np.abs(a - b).max() < DD_TOL


def test_quad_mesh_samples_and_inits():
    n = 5
    env = tq.createQuESTEnv(num_devices=8, precision=tq.QUAD, seed=[4],
                            device="cpu")
    q = tq.createQureg(n, env)
    tq.initStateOfSingleQubit(q, n - 1, 1)
    assert abs(tq.calcProbOfOutcome(q, n - 1, 1) - 1.0) < DD_TOL
    tq.initClassicalState(q, 19)
    assert tq.getAmp(q, 19) == 1.0
    assert np.all(tq.sampleOutcomes(q, 50) == 19)
    tq.initDebugState(q)
    ref = tq.createQureg(n, tq.createQuESTEnv(precision=tq.QUAD, seed=[4],
                                              device="cpu"))
    tq.initDebugState(ref)
    assert np.array_equal(q.to_numpy(), ref.to_numpy())


HAM7 = ([[(0, 3), (6, 3)], [(6, 1)], [(3, 2), (6, 2)],
         [(5, 1), (6, 1), (1, 3)]], [0.5, 0.3, -0.2, 0.7])


def hea(qt, n=7, layers=2):
    c = qt.Circuit(n)
    k = 0
    for layer in range(layers):
        for q in range(n):
            c.ry(q, c.parameter(f"t{k}"))
            k += 1
        for q in range(n - 1):
            c.cnot(q, q + 1)
        c.swap(0, n - 1)
        c.rz(n - 1, c.parameter(f"t{k}"))
        k += 1
    return c


@pytest.mark.parametrize("mode", ["amp", "batch"])
def test_quad_tier_sweeps_on_a_mesh(envs, mode, monkeypatch):
    """``tier="quad"`` on a mesh: ``amp`` mode walks the mesh plan on dd
    chunks, ``batch`` mode each shard's rows as whole states. Energies and
    planes equal one device's at 1e-12 and the JAX package's mesh at
    1e-12."""
    if mode == "amp":
        monkeypatch.setenv("QUEST_TPU_BATCH_MEM_BYTES", "1")
    pm = np.random.default_rng(4).uniform(0, 2 * np.pi, size=(5, 16))
    t8 = hea(tq).compile(envs["t8"])
    t1 = hea(tq).compile(envs["t1"])
    j8 = hea(jq).compile(envs["j8"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # batch mode pads 5 rows to 8
        e8 = t8.expectation_sweep(pm, HAM7, tier="quad")
        s8 = t8.sweep(pm, tier="quad").numpy()
        je = np.asarray(j8.expectation_sweep(pm, HAM7, tier="quad"))
    assert t8.dispatch_stats().batch_sharding_mode == mode
    e1 = t1.expectation_sweep(pm, HAM7, tier="quad")
    s1 = t1.sweep(pm, tier="quad").numpy()
    assert np.abs(e8 - e1).max() < TOL and np.abs(s8 - s1).max() < TOL
    assert np.abs(e8 - je).max() < TOL
