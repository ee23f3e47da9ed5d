"""The PyTorch port's compiled circuits (quest_tpu_torch/circuits.py) against
the JAX package's, on the CPU in float64.

Each circuit is built once with the JAX package and carried to the port
through ``interop.circuit_from_records``, so both compile exactly the same
matrices. The JAX side compiles with ``pallas="interpret"``, as its own
tests do. Checked, with the packed ``rowmxu`` contraction forced on and
forced off on both sides:

- the collected fused layers: the same stage list, stage by stage
  (at n <= 13 both sides plan with the same highest row target);
- the final planes, to 1e-12, from the same normalised random state.
"""

import numpy as np
import pytest
import torch

import quest_tpu as jq
from quest_tpu import algorithms as jalg
from quest_tpu.circuits import Circuit as JCircuit
import quest_tpu_torch as tq
from quest_tpu_torch import interop
from quest_tpu_torch.ops import layer_kernel as lk
from torch_threads import one_blas_thread  # noqa: F401

TOL = 1e-12


@pytest.fixture(scope="module")
def envs():
    return (jq.createQuESTEnv(num_devices=1, precision=jq.DOUBLE, seed=[3]),
            tq.createQuESTEnv(device="cpu", precision=tq.DOUBLE, seed=[3]))


def brickwork(n, layers=2):
    """The JAX package's benchmark circuit (bench.py build_bench_circuit):
    a random rotation on every qubit, then a CNOT brickwork, per layer."""
    rng = np.random.default_rng(2026)
    c = JCircuit(n)
    for layer in range(layers):
        for q in range(n):
            c.rotate(q, float(rng.uniform(0, 2 * np.pi)), rng.normal(size=3))
        for q in range(layer % 2, n - 1, 2):
            c.cnot(q, q + 1)
    return c


def _unitary(rng, dim):
    z = rng.normal(size=(dim, dim)) + 1j * rng.normal(size=(dim, dim))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


def random_circuit(n, depth, seed):
    """Seeded mixed circuit: named gates, dense 1-3 qubit gates with and
    without (flipped) controls, diagonals over lane and row qubits."""
    rng = np.random.default_rng(seed)
    c = JCircuit(n)

    def qs(k):
        return [int(q) for q in rng.choice(n, size=k, replace=False)]

    for _ in range(depth):
        kind = int(rng.integers(12))
        a = float(rng.uniform(0, 2 * np.pi))
        if kind == 0:
            c.h(qs(1)[0])
        elif kind == 1:
            c.rx(qs(1)[0], a)
        elif kind == 2:
            c.rz(qs(1)[0], a)
        elif kind == 3:
            c.cnot(*qs(2))
        elif kind == 4:
            c.cz(*qs(2))
        elif kind == 5:
            c.cphase(*qs(2), a)
        elif kind == 6:
            c.swap(*qs(2))
        elif kind == 7:
            k = int(rng.integers(1, 4))
            c.gate(_unitary(rng, 1 << k), qs(k))
        elif kind == 8:
            t, ctl = qs(1), qs(int(rng.integers(1, 3)))
            if t[0] in ctl:
                continue
            c.gate(_unitary(rng, 2), t, ctl,
                   [int(b) for b in rng.integers(0, 2, len(ctl))])
        elif kind == 9:
            k = int(rng.integers(1, 4))
            c.diagonal(np.exp(1j * rng.uniform(0, 6, (2,) * k)), qs(k))
        elif kind == 10:
            c.multi_rotate_z(qs(int(rng.integers(2, 4))), a)
        else:
            c.crz(*qs(2), a)
    return c


def records(jc):
    return [(op.kind, op.targets, op.ctrl_mask, op.flip_mask,
             op.mat if op.kind == "u" else op.diag) for op in jc.ops]


def _state(n, seed=5):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    return z / np.linalg.norm(z)


def _same(a, b):
    if isinstance(a, (tuple, list)):
        return (isinstance(b, (tuple, list)) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and np.abs(a - b).max(initial=0) <= TOL
    return a == b


def run_both(jc, envs, mxu, monkeypatch):
    jenv, tenv = envs
    n = jc.num_qubits
    monkeypatch.setenv("QUEST_TPU_MXU_SHAPE", "1" if mxu else "0")
    jcc = jc.compile(jenv, pallas="interpret")
    tcc = interop.circuit_from_records(n, records(jc)).compile(tenv, mxu=mxu)
    z = _state(n)
    jqr = jq.createQureg(n, jenv)
    jq.initStateFromAmps(jqr, z.real, z.imag)
    jcc.run(jqr)
    tqr = tq.createQureg(n, tenv)
    tq.initStateFromAmps(tqr, z.real, z.imag)
    tcc.run(tqr)
    return jcc, tcc, np.asarray(jqr.state), interop.planes_of(tqr)


def layers_of(compiled):
    return [op for op in compiled._ops if op.kind == "layer"]


CIRCUITS = {
    "brickwork10": lambda: brickwork(10),
    "brickwork13": lambda: brickwork(13),
    "qft10": lambda: jalg.qft(10),
    "random9": lambda: random_circuit(9, 60, seed=1),
    "random11": lambda: random_circuit(11, 50, seed=2),
    "random13": lambda: random_circuit(13, 50, seed=3),
}


@pytest.mark.parametrize("mxu", [True, False], ids=["mxu_on", "mxu_off"])
@pytest.mark.parametrize("name", list(CIRCUITS))
def test_compiled_matches_jax(name, mxu, envs, monkeypatch):
    jcc, tcc, jplanes, tplanes = run_both(CIRCUITS[name](), envs, mxu,
                                          monkeypatch)
    jl, tl = layers_of(jcc), layers_of(tcc)
    assert len(jl) == len(tl) >= 1
    for a, b in zip(jl, tl):
        assert a.members == b.members
        assert _same(a.stages, b.stages)
    # the same plan: layers and plain ops in the same order
    assert [jcc._ops[it[1]].kind for it in jcc.plan.items] == \
        [tcc._ops[it[1]].kind for it in tcc.plan.items]
    assert np.abs(jplanes - tplanes).max() <= TOL


def test_stage_kinds_on_the_main_path(envs):
    """The brickwork emits lane and row stages (rowmxu when forced on);
    QFT emits rowdiag: every stage kind of the kernel is live."""
    kinds = set()
    for name, mxu in (("brickwork13", True), ("brickwork13", False),
                      ("qft10", False)):
        jc = CIRCUITS[name]()
        tcc = interop.circuit_from_records(
            jc.num_qubits, records(jc)).compile(envs[1], mxu=mxu)
        kinds |= {st[0] for op in layers_of(tcc) for st in op.stages}
    assert {"lane", "row", "rowmxu", "rowdiag"} <= kinds


def test_circuit_methods_match_jax(envs):
    """The port's own Circuit methods record the same ops as the JAX
    package's for every named gate of the slice."""
    n = 9
    u2 = _unitary(np.random.default_rng(9), 4)

    def build(c):
        c.h(0).x(1).y(2).z(3).s(4).t(5).phase(6, 0.3)
        c.rx(7, 0.1).ry(8, 0.2).rz(0, 0.4).rotate(1, 0.5, (1.0, 2.0, 0.5))
        c.cnot(2, 8).cy(3, 7).cz(8, 1).cphase(0, 7, 0.6).crz(7, 2, 0.7)
        c.swap(1, 8).sqrt_swap(2, 3).multi_rotate_z((0, 4, 8), 0.8)
        c.gate(u2, (5, 8), (1, 2), (1, 0))
        c.diagonal(np.exp(1j * np.arange(8).reshape(2, 2, 2)), (3, 8, 0))
        return c

    jc, tc = build(JCircuit(n)), build(tq.Circuit(n))
    assert len(jc.ops) == len(tc.ops)
    for a, b in zip(records(jc), records(tc)):
        assert a[:4] == b[:4]
        assert _same(a[4], b[4])


def test_parameterised_circuit_matches_jax(envs):
    jenv, tenv = envs
    n = 8

    def build(mod):
        c = mod(n)
        th = c.parameter("theta")
        for q in range(n):
            c.h(q)
        c.rx(3, th).rz(7, th).cphase(0, 5, th).cnot(3, 4).ry(2, th)
        return c

    params = {"theta": 0.37}
    jcc = build(JCircuit).compile(jenv, pallas="interpret")
    tcc = build(tq.Circuit).compile(tenv)
    jqr, tqr = jq.createQureg(n, jenv), tq.createQureg(n, tenv)
    jq.initZeroState(jqr)
    tq.initZeroState(tqr)
    jcc.run(jqr, params)
    tcc.run(tqr, params)
    assert np.abs(np.asarray(jqr.state) - interop.planes_of(tqr)).max() \
        <= TOL
    with pytest.raises(ValueError, match="missing"):
        tcc.run(tqr)


def test_layers_off_runs_gate_by_gate(envs, monkeypatch):
    jc = brickwork(10)
    _, tcc_on, _, want = run_both(jc, envs, False, monkeypatch)
    tenv = envs[1]
    tcc = interop.circuit_from_records(10, records(jc)).compile(
        tenv, layers=False)
    assert tcc.num_layers == 0
    q = interop.qureg_from_planes(np.stack([_state(10).real,
                                            _state(10).imag]), tenv)
    tcc.run(q)
    assert np.abs(interop.planes_of(q) - want).max() <= TOL


def test_tile_height_bounds_the_layers(envs):
    """Row targets above max_mid_qubit(tile_rows) stay plain gates: at
    float64 the tile holds 64 rows, so qubits >= 13 never enter a layer."""
    tenv = envs[1]
    c = tq.Circuit(16)
    for q in range(16):
        c.h(q)
    cc = c.compile(tenv)
    hi = lk.max_mid_qubit(lk.TILE_ROWS[torch.float64])
    assert hi == 12
    (layer,) = layers_of(cc)
    assert max(layer.targets) == hi
    plain = [cc._ops[it[1]] for it in cc.plan.items
             if cc._ops[it[1]].kind != "layer"]
    assert sorted(t for op in plain for t in op.targets) == [13, 14, 15]
