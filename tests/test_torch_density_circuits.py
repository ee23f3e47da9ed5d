"""The PyTorch port's density compile (``Circuit.compile(density=True)``)
against the JAX package's and against the port's own imperative density
API, on the CPU in float64.

Gates lift to superoperator form on the flat 2n-qubit vector, Kraus
channels fold in, and the whole noisy program runs through the plan; it
must match the per-gate API path and the JAX package's compiled program
(``pallas="interpret"``, as its own tests run it) to 1e-12. This mirrors
tests/test_density_circuits.py, and adds the noisy QFT on 8 qubits: a
16-qubit lifted program whose plan holds fused layers, with the same
answer with layers on (their plain version here) and off.
"""

import numpy as np
import pytest

import quest_tpu as jq
from quest_tpu.algorithms import _append_qft
from quest_tpu.circuits import Circuit as JCircuit
import quest_tpu_torch as tq
from quest_tpu_torch.circuits import Circuit
from torch_threads import one_blas_thread  # noqa: F401

TOL = 1e-12


@pytest.fixture(scope="module")
def envs():
    return (jq.createQuESTEnv(num_devices=1, precision=jq.DOUBLE, seed=[3]),
            tq.createQuESTEnv(device="cpu", precision=tq.DOUBLE, seed=[3]))


@pytest.fixture(scope="module")
def env(envs):
    return envs[1]


def api_reference(env, n, build):
    d = tq.createDensityQureg(n, env)
    tq.initPlusState(d)
    build(d)
    return d.to_numpy()


def run_compiled(env, n, circ, params=None, **kw):
    d = tq.createDensityQureg(n, env)
    tq.initPlusState(d)
    circ.compile(env, density=True, **kw).run(d, params=params)
    return d.to_numpy()


def run_jax(jenv, n, jc, params=None):
    d = jq.createDensityQureg(n, jenv)
    jq.initPlusState(d)
    jc.compile(jenv, density=True, pallas="interpret").run(d, params=params)
    return d.to_numpy()


def both(build, n):
    """The same program built on both packages' Circuit."""
    return build(JCircuit(n)), build(Circuit(n))


def test_gates_and_channels_match_api_and_jax(envs):
    n = 3

    def build(c):
        c.h(0).cnot(0, 1).rz(2, 0.5).t(1)
        c.dephase(0, 0.2).depolarise(1, 0.15).damp(2, 0.3)
        return c.cz(0, 2)

    def api(d):
        tq.hadamard(d, 0)
        tq.controlledNot(d, 0, 1)
        tq.rotateZ(d, 2, 0.5)
        tq.tGate(d, 1)
        tq.mixDephasing(d, 0, 0.2)
        tq.mixDepolarising(d, 1, 0.15)
        tq.mixDamping(d, 2, 0.3)
        tq.controlledPhaseFlip(d, 0, 2)

    jc, tc = both(build, n)
    got = run_compiled(envs[1], n, tc)
    assert np.abs(got - api_reference(envs[1], n, api)).max() <= TOL
    assert np.abs(got - run_jax(envs[0], n, jc)).max() <= TOL


def test_custom_kraus_matches_mixKrausMap(env):
    n = 2
    rng = np.random.default_rng(4)
    u, _ = np.linalg.qr(rng.normal(size=(2, 2))
                        + 1j * rng.normal(size=(2, 2)))
    k0 = np.sqrt(0.85) * np.eye(2)
    k1 = np.sqrt(0.15) * u
    c = Circuit(n)
    c.h(0).kraus([k0, k1], (1,))

    def api(d):
        tq.hadamard(d, 0)
        tq.mixKrausMap(d, 1, [k0, k1])

    assert np.abs(run_compiled(env, n, c)
                  - api_reference(env, n, api)).max() <= TOL


def test_controlled_and_param_lift(envs):
    n = 3

    def build(c):
        t = c.parameter("t")
        c.h(0).ry(1, t).crz(0, 2, 0.7).phase(2, t)
        return c.gate(np.diag([1.0, 1j]).astype(complex), (1,),
                      controls=(2,), control_states=(0,))

    def api(d):
        tq.hadamard(d, 0)
        tq.rotateY(d, 1, 0.9)
        tq.controlledRotateZ(d, 0, 2, 0.7)
        tq.phaseShift(d, 2, 0.9)
        tq.multiStateControlledUnitary(d, [2], [0], 1, np.diag([1.0, 1j]))

    jc, tc = both(build, n)
    got = run_compiled(envs[1], n, tc, params={"t": 0.9})
    assert np.abs(got - api_reference(envs[1], n, api)).max() <= TOL
    assert np.abs(got - run_jax(envs[0], n, jc, {"t": 0.9})).max() <= TOL


def test_param_channels_and_torch_gate_lift(env):
    """Channels whose strength is a Param lift to traceable
    superoperators, and a gate callable returning a torch tensor lifts
    through a resolved conjugate."""
    import torch
    n = 2
    c = Circuit(n)
    p = c.parameter("p")
    c.h(0).dephase(0, p).damp(1, p).depolarise(0, p)
    c.pauli_channel(1, 0.05, p, 0.1)
    c.gate(lambda prm: torch.as_tensor(
        np.array([[1.0, 0.0], [0.0, np.exp(1j * prm["p"])]])), (1,), (0,))

    def api(d):
        tq.hadamard(d, 0)
        tq.mixDephasing(d, 0, 0.2)
        tq.mixDamping(d, 1, 0.2)
        tq.mixDepolarising(d, 0, 0.2)
        tq.mixPauli(d, 1, 0.05, 0.2, 0.1)
        tq.controlledPhaseShift(d, 0, 1, 0.2)

    assert np.abs(run_compiled(env, n, c, params={"p": 0.2})
                  - api_reference(env, n, api)).max() <= TOL


def test_trace_preserved_under_noise(env):
    n = 4
    c = Circuit(n)
    for q in range(n):
        c.h(q)
        c.depolarise(q, 0.2)
        c.damp(q, 0.1)
    d = tq.createDensityQureg(n, env)
    tq.initZeroState(d)
    c.compile(env, density=True).run(d)
    assert tq.calcTotalProb(d) == pytest.approx(1.0, abs=TOL)
    assert tq.calcPurity(d) < 1.0


def test_kraus_in_statevec_compile_rejected(envs):
    jenv, env = envs
    for mod, e in ((JCircuit, jenv), (Circuit, env)):
        c = mod(2)
        c.h(0).dephase(0, 0.1)
        with pytest.raises(ValueError, match="compile with density=True"):
            c.compile(e)


def test_invalid_kraus_rejected_at_compile(env):
    c = Circuit(2)
    c.kraus([np.eye(2) * 2.0], (0,))       # not trace-preserving
    with pytest.raises(tq.QuESTError):
        c.compile(env, density=True)


def test_register_type_mismatch_rejected(env):
    c = Circuit(2)
    c.h(0)
    dc = c.compile(env, density=True)      # 4-qubit lifted program
    assert dc.is_density and dc.num_qubits == 4
    sv = tq.createQureg(4, env)            # same state-vector size
    with pytest.raises(ValueError, match="density register"):
        dc.run(sv)
    d = tq.createDensityQureg(2, env)
    with pytest.raises(ValueError, match="density=True"):
        c.compile(env).run(d)


def test_density_sweeps_wait_for_a_later_slice(env):
    """Density sweeps came in a later slice: sweep and expectation_sweep
    run on the flat density vector (tests/test_torch_density_sweeps.py
    holds them against the JAX engine); sample_sweep stays for state
    vectors, as in the JAX package."""
    c = Circuit(2)
    th = c.parameter("th")
    c.ry(0, th).dephase(1, 0.1)
    dc = c.compile(env, density=True)
    rho = dc.sweep([[0.1], [0.7]])
    assert tuple(rho.shape) == (2, 2, 16)
    e = dc.expectation_sweep([[0.1], [0.7]], ([[(0, 3)]], [1.0]))
    assert np.abs(e - np.cos([0.1, 0.7])).max() <= TOL
    with pytest.raises(ValueError, match="statevector"):
        dc.sample_sweep([[0.1]], 4)


def test_prob_caps_match_api():
    c = Circuit(2)
    with pytest.raises(tq.QuESTError):
        c.dephase(0, 0.6)                  # cap 1/2
    with pytest.raises(tq.QuESTError):
        c.depolarise(0, 0.8)               # cap 3/4
    with pytest.raises(tq.QuESTError):
        c.damp(0, 1.2)                     # cap 1


@pytest.mark.parametrize("seed", [5, 19, 83])
def test_random_noisy_program(env, seed):
    """Randomized compiled-vs-imperative differential over every channel
    builder the circuit recorder offers, interleaved with gates."""
    rng = np.random.default_rng(seed)
    n = 4
    c = Circuit(n)
    d2 = tq.createDensityQureg(n, env)
    tq.initZeroState(d2)
    for _ in range(20):
        k = rng.integers(0, 8)
        if k == 0:
            q, a = int(rng.integers(0, n)), float(rng.uniform(0, 6))
            c.ry(q, a)
            tq.rotateY(d2, q, a)
        elif k == 1:
            a, b = (int(x) for x in rng.choice(n, 2, replace=False))
            c.cnot(a, b)
            tq.controlledNot(d2, a, b)
        elif k == 2:
            q, p = int(rng.integers(0, n)), float(rng.uniform(0, 0.4))
            c.dephase(q, p)
            tq.mixDephasing(d2, q, p)
        elif k == 3:
            q, p = int(rng.integers(0, n)), float(rng.uniform(0, 0.6))
            c.depolarise(q, p)
            tq.mixDepolarising(d2, q, p)
        elif k == 4:
            q, p = int(rng.integers(0, n)), float(rng.uniform(0, 0.8))
            c.damp(q, p)
            tq.mixDamping(d2, q, p)
        elif k == 5:
            q = int(rng.integers(0, n))
            px, py, pz = (float(x) for x in rng.uniform(0, 0.2, 3))
            c.pauli_channel(q, px, py, pz)
            tq.mixPauli(d2, q, px, py, pz)
        elif k == 6:
            a, b = (int(x) for x in rng.choice(n, 2, replace=False))
            p = float(rng.uniform(0, 0.6))
            c.two_qubit_dephase(a, b, p)
            tq.mixTwoQubitDephasing(d2, a, b, p)
        else:
            a, b = (int(x) for x in rng.choice(n, 2, replace=False))
            p = float(rng.uniform(0, 0.8))
            c.two_qubit_depolarise(a, b, p)
            tq.mixTwoQubitDepolarising(d2, a, b, p)
    d1 = tq.createDensityQureg(n, env)
    tq.initZeroState(d1)
    c.compile(env, density=True).run(d1)
    assert np.abs(d1.to_numpy() - d2.to_numpy()).max() <= TOL


def noisy_qft(c, n):
    """The QFT ladder of the JAX package's ``algorithms._append_qft`` on
    ``n`` qubits, then dephasing (0.01) and damping (0.005) on each."""
    _append_qft(c, range(n))
    for q in range(n):
        c.dephase(q, 0.01)
        c.damp(q, 0.005)
    return c


def records(jc):
    return [(op.kind, op.targets, op.ctrl_mask, op.flip_mask,
             op.mat if op.kind == "u" else op.diag) for op in jc.ops]


def port_noisy_qft(n):
    """:func:`noisy_qft` recorded with the port's own Circuit methods."""
    c = Circuit(n)
    for kind, a, b, angle in _qft_ops(n):
        if kind == "h":
            c.h(a)
        elif kind == "swap":
            c.swap(a, b)
        else:
            c.cphase(a, b, angle)
    for q in range(n):
        c.dephase(q, 0.01).damp(q, 0.005)
    return c


def test_noisy_qft_lifts_like_jax():
    """The port's own lift records the JAX package's lifted ops."""
    n = 5
    jl = noisy_qft(JCircuit(n), n)._lifted_density()
    tl = port_noisy_qft(n)._lifted_density()
    assert len(jl.ops) == len(tl.ops) == n * (n - 1) // 2 + n + n // 2 + 2 * n
    for a, b in zip(records(jl), records(tl)):
        assert a[:4] == b[:4]
        assert np.abs(np.asarray(a[4]) - np.asarray(b[4])).max() <= TOL


def _qft_ops(n):
    """The gate order of ``_append_qft`` as (kind, a, b, angle)."""
    ops = []
    for i in range(n - 1, -1, -1):
        ops.append(("h", i, None, None))
        for k, j in enumerate(range(i - 1, -1, -1), start=2):
            ops.append(("cphase", j, i, 2.0 * np.pi / (1 << k)))
    for i in range(n // 2):
        ops.append(("swap", i, n - 1 - i, None))
    return ops


def test_noisy_qft_through_the_layers(envs):
    """8 qubits: a 16-qubit lifted program whose plan holds fused layers
    (rowdiag stages from the lifted controlled phases). Layers on (their
    plain version on the CPU) and off give the same density matrix, which
    matches the JAX package's compiled program and the port's imperative
    API."""
    jenv, env = envs
    n = 8
    jc = noisy_qft(JCircuit(n), n)
    tc = port_noisy_qft(n)
    on = tc.compile(env, density=True)
    off = tc.compile(env, density=True, layers=False)
    assert on.num_layers >= 1 and off.num_layers == 0
    kinds = {st[0] for op in on._ops if op.kind == "layer"
             for st in op.stages}
    assert "rowdiag" in kinds
    got = []
    for cc in (on, off):
        d = tq.createDensityQureg(n, env)
        tq.initPlusState(d)
        cc.run(d)
        got.append(d.to_numpy())
    assert np.abs(got[0] - got[1]).max() <= TOL
    assert np.abs(got[0] - run_jax(jenv, n, jc)).max() <= TOL

    def api(d):
        for kind, a, b, angle in _qft_ops(n):
            if kind == "h":
                tq.hadamard(d, a)
            elif kind == "swap":
                tq.swapGate(d, a, b)
            else:
                tq.controlledPhaseShift(d, a, b, angle)
        for q in range(n):
            tq.mixDephasing(d, q, 0.01)
            tq.mixDamping(d, q, 0.005)

    assert np.abs(got[0] - api_reference(env, n, api)).max() <= TOL
    d = tq.createDensityQureg(n, env)
    tq.initPlusState(d)
    on.run(d)
    assert tq.calcTotalProb(d) == pytest.approx(1.0, abs=TOL)
    assert 0.0 < tq.calcPurity(d) <= 1.0


def test_noisy_qft_density_at_fast_matches_jax(envs):
    """Density at FAST, held: a 4-qubit noisy QFT compiled with
    ``density=True, tier="fast"`` (its 8-qubit lifted plan holds fused
    layers, whose dense stages take the bf16 FAST branch) agrees with the
    JAX package's FAST program, and with the port's own SINGLE program,
    within ``modeled_tier_error(FAST, ops)`` of the largest amplitude."""
    jenv, env = envs
    n = 4
    tc = port_noisy_qft(n)
    jc = noisy_qft(JCircuit(n), n)
    fast = tc.compile(env, density=True, tier="fast")
    assert fast.num_layers >= 1
    bar = tq.modeled_tier_error(tq.FAST_TIER, len(fast.circuit.ops))
    got = {}
    for name, cc in (("fast", fast),
                     ("single", tc.compile(env, density=True,
                                           tier="single"))):
        d = tq.createDensityQureg(n, env)
        tq.initClassicalState(d, 5)
        cc.run(d)
        got[name] = d.to_numpy()
    jd = jq.createDensityQureg(n, jenv)
    jq.initClassicalState(jd, 5)
    jc.compile(jenv, density=True, tier="fast", pallas="interpret").run(jd)
    want = jd.to_numpy()
    scale = np.abs(want).max()
    assert np.abs(got["fast"] - want).max() <= bar * scale
    assert np.abs(got["fast"] - got["single"]).max() <= bar * scale
    assert got["fast"].dtype == np.complex128
