"""The port's ``Circuit`` composition methods (``to_qasm``, ``pauli_string``,
``extend``, ``inverse``, ``depth``), ``CompiledCircuit.precompile`` /
``program_digest``, and ``compile``'s reference switches (``pallas=``,
``donate=``), against the JAX package, on the CPU in float64.

Mirrors the ``inverse``/``extend``/``depth``/``precompile`` cases of
``tests/test_circuits.py``. Circuits are built with the JAX package and
carried across by ``interop.circuit_from_records`` (or recorded through
both packages' ``Circuit`` methods, with the recorded ops checked equal
first), so both sides hold the same matrices: the QASM text and the
digests must then be equal.

The last tests are the port's form of ``tests/test_pallas_benchshapes.py``:
the bench brickwork and the QFT at the bench widths (20-30 qubits),
compiled for the CPU, with every fused layer planned and packed for the
kernel (its stages inside the tile, its descriptors DESC_WIDTH wide), and
no state allocated.
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
    return (jq.createQuESTEnv(num_devices=1, precision=jq.DOUBLE, seed=[4]),
            tq.createQuESTEnv(num_devices=1, precision=tq.DOUBLE, seed=[4],
                              device="cpu"))


def records(circ):
    return [(op.kind, op.targets, op.ctrl_mask, op.flip_mask,
             op.mat if op.kind == "u" else op.diag) for op in circ.ops]


def carried(jc):
    return interop.circuit_from_records(jc.num_qubits, records(jc))


def _unitary(rng, dim):
    z = rng.normal(size=(dim, dim)) + 1j * rng.normal(size=(dim, dim))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


def mixed(n, seed):
    """A static JAX circuit over every op kind to_qasm distinguishes."""
    rng = np.random.default_rng(seed)
    c = JCircuit(n)
    c.h(0).x(1).y(2).z(0).s(1).t(2).cnot(0, 3).cy(1, 2).cz(2, 3)
    c.rx(0, 0.3).ry(1, -1.1).rz(2, 0.7).phase(3, 0.25)
    c.cphase(0, 2, 0.9).crz(1, 3, -0.4).swap(0, 1).sqrt_swap(2, 3)
    c.multi_rotate_z((0, 1), 0.6).multi_rotate_z((0, 2, 3), 0.2)
    c.rotate(3, 0.5, (1.0, 2.0, -1.0))
    c.gate(_unitary(rng, 2), (1,), controls=(0, 2), control_states=(0, 1))
    c.gate(_unitary(rng, 2), (3,), controls=(1,))
    c.gate(_unitary(rng, 4), (0, 2))
    c.diagonal(np.exp(1j * rng.normal(size=(2, 2, 2))), (3, 0, 1))
    c.diagonal(rng.normal(size=(2, 2)) + 2.0, (1, 2))
    c.pauli_string([(0, 1), (2, 2), (3, 3), (1, 0)])
    return c


def named_both(pkg_circuit, n):
    """The same named-gate recording through either package's Circuit."""
    c = pkg_circuit(n)
    for q in range(n):
        c.h(q)
    c.cnot(0, 1).cz(1, 2).t(2).s(0).swap(0, 2).x(1).y(0)
    c.rotate(1, 0.4, (0.0, 1.0, 0.0)).rx(2, 0.3)
    c.pauli_string([(0, 3), (1, 1), (2, 2)])
    return c


def _ops_equal(jc, tc):
    if len(jc.ops) != len(tc.ops):
        return False
    for a, b in zip(jc.ops, tc.ops):
        if (a.kind, a.targets, a.ctrl_mask, a.flip_mask) != \
                (b.kind, b.targets, b.ctrl_mask, b.flip_mask):
            return False
        for x, y in ((a.mat, b.mat), (a.diag, b.diag)):
            if (x is None) != (y is None) or (
                    x is not None and not np.array_equal(x, y)):
                return False
    return True


def _debug_pair(envs, n):
    jqr, tqr = jq.createQureg(n, envs[0]), tq.createQureg(n, envs[1])
    jq.initDebugState(jqr)
    tq.initDebugState(tqr)
    return jqr, tqr


# -- to_qasm, pauli_string, digests ------------------------------------------

@pytest.mark.parametrize("seed", [1, 2])
def test_to_qasm_text_equals_jax(seed):
    jc = mixed(4, seed)
    assert carried(jc).to_qasm() == jc.to_qasm()


def test_to_qasm_binds_params(envs):
    """Bound Param gates print as the same gates recorded with the bound
    angles, and those print as the JAX package's static recording does
    (its Param gates evaluate in float32, so their bound matrices are
    not the same recording)."""
    def build(pkg_circuit, a, b):
        c = pkg_circuit(3)
        c.h(0).ry(1, a).rz(2, b).cphase(0, 2, a).rx(0, b)
        return c
    tc = tq.Circuit(3)
    tc = build(tq.Circuit, tc.parameter("a"), tc.parameter("b"))
    params = {"a": 0.3, "b": -1.2}
    static = build(tq.Circuit, 0.3, -1.2).to_qasm()
    assert tc.to_qasm(params) == static
    assert static == build(JCircuit, 0.3, -1.2).to_qasm()
    with pytest.raises(ValueError, match="missing circuit parameters"):
        tc.to_qasm({"a": 0.1})


def test_to_qasm_channels_are_comments():
    jc = JCircuit(2).h(0).damp(0, 0.1)
    tc = tq.Circuit(2).h(0).damp(0, 0.1)
    assert tc.to_qasm() == jc.to_qasm()
    assert "Kraus channel on qubits [0]" in tc.to_qasm()


def test_pauli_string_records_like_jax():
    jc, tc = JCircuit(4), tq.Circuit(4)
    for c in (jc, tc):
        c.pauli_string([(0, 1), (1, 2), (2, 3), (3, 0)])
    assert _ops_equal(jc, tc) and tc.depth == jc.depth == 3


@pytest.mark.parametrize("n", [3, 5])
def test_program_digest_equals_jax(envs, n):
    jc, tc = named_both(JCircuit, n), named_both(tq.Circuit, n)
    assert _ops_equal(jc, tc)          # the same recording on both sides
    jd = jc.compile(envs[0]).program_digest
    td = tc.compile(envs[1]).program_digest
    assert td == jd and len(td) == 64
    assert tc.compile(envs[1], fusion=0).program_digest == td   # stable
    assert carried(mixed(4, 3)).compile(envs[1]).program_digest == \
        mixed(4, 3).compile(envs[0]).program_digest
    other = named_both(tq.Circuit, n).h(0)
    assert other.compile(envs[1]).program_digest != td


def test_density_program_digest_equals_jax(envs):
    jc = JCircuit(3).h(0).cnot(0, 1).dephase(1, 0.1).damp(2, 0.2)
    tc = tq.Circuit(3).h(0).cnot(0, 1).dephase(1, 0.1).damp(2, 0.2)
    jd = jc.compile(envs[0], density=True).program_digest
    assert tc.compile(envs[1], density=True).program_digest == jd


def test_param_program_digest_is_stable(envs):
    def build():
        c = tq.Circuit(3)
        c.h(0).ry(1, c.parameter("a")).cphase(0, 2, c.parameter("b"))
        return c
    d1 = build().compile(envs[1]).program_digest
    assert d1 == build().compile(envs[1]).program_digest
    assert not d1.startswith("id-")


# -- inverse, extend, depth ----------------------------------------------------

@pytest.mark.parametrize("seed", [3, 4])
def test_inverse_round_trip_and_jax(envs, seed):
    jc = jalg.random_circuit(9, depth=8, seed=seed)
    tc = carried(jc)
    assert _ops_equal(jc.inverse(), tc.inverse())
    jqr, tqr = _debug_pair(envs, 9)
    start = tqr.to_numpy()
    tc.compile(envs[1]).run(tqr)
    tc.inverse().compile(envs[1]).run(tqr)
    np.testing.assert_allclose(tqr.to_numpy(), start, atol=1e-10)


def test_inverse_errors_like_jax():
    for pkg in (jq, tq):
        c = pkg.Circuit(2)
        c.h(0).damp(0, 0.1)
        with pytest.raises(ValueError, match="channels"):
            c.inverse()
        c = pkg.Circuit(2)
        c.h(0).ry(1, c.parameter("t"))
        with pytest.raises(ValueError, match="parameterized"):
            c.inverse()


def test_extend_ops_params_and_depth(envs):
    a, b = tq.Circuit(3), tq.Circuit(3)
    a.h(0).rz(1, a.parameter("x"))
    b.cnot(0, 2).ry(2, b.parameter("y")).rz(1, b.parameter("x"))
    ops_a, ops_b = list(a.ops), list(b.ops)
    assert a.extend(b) is a
    assert a.ops == ops_a + ops_b and a.depth == 5
    assert a.param_names == ("x", "y")
    with pytest.raises(ValueError, match="qubit count"):
        a.extend(tq.Circuit(4))
    ja, jb = JCircuit(3), JCircuit(3)
    ja.h(0).rz(1, ja.parameter("x"))
    jb.cnot(0, 2).ry(2, jb.parameter("y")).rz(1, jb.parameter("x"))
    ja.extend(jb)
    assert ja.param_names == a.param_names and ja.depth == a.depth


def test_extend_with_inverse_is_identity(envs):
    jc = jalg.random_circuit(8, depth=6, seed=5)
    tc = carried(jc)
    both = tq.Circuit(8).extend(tc).extend(tc.inverse())
    assert both.depth == 2 * tc.depth
    q = tq.createQureg(8, envs[1])
    tq.initDebugState(q)
    start = q.to_numpy()
    both.compile(envs[1]).run(q)
    np.testing.assert_allclose(q.to_numpy(), start, atol=1e-10)


# -- compile switches ----------------------------------------------------------

@pytest.mark.parametrize("pallas", ["interpret", False])
@pytest.mark.parametrize("n", [8, 10])
def test_pallas_switch_matches_jax(envs, pallas, n):
    jc = jalg.random_circuit(n, depth=10, seed=n)
    jcc = jc.compile(envs[0], pallas=pallas)
    tcc = carried(jc).compile(envs[1], pallas=pallas)
    assert tcc.num_layers == sum(1 for op in jcc._ops if op.kind == "layer")
    assert (tcc.num_layers > 0) == (pallas == "interpret")
    jqr, tqr = _debug_pair(envs, n)
    jcc.run(jqr)
    tcc.run(tqr)
    np.testing.assert_allclose(tqr.to_numpy(), jqr.to_numpy(), atol=TOL)


def test_pallas_false_is_layers_false(envs):
    c = carried(jalg.random_circuit(9, depth=6, seed=6))
    off = c.compile(envs[1], pallas=False)
    assert off.num_layers == 0
    assert len(off.plan.items) == len(
        c.compile(envs[1], layers=False).plan.items)
    for value in ("off", "0"):
        assert c.compile(envs[1], pallas=value).num_layers == 0


def test_second_positional_is_donate(envs):
    c = carried(jalg.random_circuit(8, depth=6, seed=7))
    cc = c.compile(envs[1], False)
    assert cc.donate is False
    assert cc.fusion_stats is not None          # fusion stayed on
    assert c.compile(envs[1]).donate is True


@pytest.mark.parametrize("donate", [True, False])
def test_donate_and_apply_state_f(envs, donate):
    c = carried(jalg.random_circuit(8, depth=6, seed=8))
    cc = c.compile(envs[1], donate=donate)
    q = tq.createQureg(8, envs[1])
    tq.initDebugState(q)
    x = q.state.clone()
    want = tq.createQureg(8, envs[1])
    tq.initDebugState(want)
    c.compile(envs[1]).run(want)
    out = cc.apply(state_f=x)
    np.testing.assert_allclose(interop.planes_of(want), out.numpy(),
                               atol=TOL)
    if donate:
        assert out is x
    else:
        assert out is not x and torch.equal(x, q.state)
    cc.run(q)                       # the register is updated either way
    np.testing.assert_allclose(q.to_numpy(), want.to_numpy(), atol=TOL)


def test_planner_options_are_accepted(envs):
    c = carried(jalg.random_circuit(8, depth=6, seed=9))
    base = c.compile(envs[1])
    cc = c.compile(envs[1], lookahead=4, comm_planner=False, overlap=True,
                   reorder=False)
    assert len(cc.plan.items) == len(base.plan.items)


def test_compile_trajectories_pallas(envs):
    c = tq.Circuit(8).h(0).cnot(0, 1).damp(0, 0.2).h(7).dephase(7, 0.1)
    u = torch.as_tensor(np.random.default_rng(3).random((16, 2)))
    outs = []
    for pallas in (None, "interpret", False):
        tp = c.compile_trajectories(envs[1], pallas=pallas)
        kinds = {item[0] for item in tp._items}
        assert ("layer" in kinds or "kraus_fused" in kinds) == \
            (pallas is not False)
        outs.append(tp.trajectory_sweep(16, uniforms=u).numpy())
    np.testing.assert_allclose(outs[2], outs[0], atol=TOL)
    np.testing.assert_allclose(outs[1], outs[0], atol=TOL)


# -- precompile ------------------------------------------------------------------

def test_precompile_matches_and_returns_self(envs):
    c = tq.Circuit(8)
    for q in range(8):
        c.h(q)
    c.cnot(0, 7).cz(3, 4).rotate(6, 0.3, (1, 0, 1))
    cc = c.compile(envs[1])
    assert cc.precompile() is cc
    q1, q2 = tq.createQureg(8, envs[1]), tq.createQureg(8, envs[1])
    tq.initDebugState(q1)
    tq.initDebugState(q2)
    cc.run(q1)
    c.compile(envs[1]).run(q2)
    np.testing.assert_allclose(q1.to_numpy(), q2.to_numpy(), atol=TOL)
    # the CPU packs nothing for the kernel
    assert all(not op._packed for op in cc._ops if op.kind == "layer")


def test_precompile_parametrised_repeat_runs(envs):
    c = tq.Circuit(6)
    th = c.parameter("th")
    c.h(0).rz(0, th).cnot(0, 5)
    cc = c.compile(envs[1]).precompile()
    q1, q2 = tq.createQureg(6, envs[1]), tq.createQureg(6, envs[1])
    c2 = c.compile(envs[1])
    for t in (0.3, 0.9):
        cc.run(q1, params={"th": t})
        c2.run(q2, params={"th": t})
    np.testing.assert_allclose(q1.to_numpy(), q2.to_numpy(), atol=TOL)


def test_precompile_density(envs):
    c = tq.Circuit(3)
    c.h(0).dephase(0, 0.3).cnot(0, 2)
    d1, d2 = tq.createDensityQureg(3, envs[1]), \
        tq.createDensityQureg(3, envs[1])
    c.compile(envs[1], density=True).precompile().run(d1)
    c.compile(envs[1], density=True).run(d2)
    np.testing.assert_allclose(d1.to_numpy(), d2.to_numpy(), atol=TOL)


def test_pack_layer_is_what_a_launch_finds(envs):
    cc = carried(jalg.random_circuit(9, depth=8, seed=10)).compile(envs[1])
    layer = next(op for op in cc._ops if op.kind == "layer")
    before = lk._operands.packs
    assert not lk.is_packed(layer, 9, torch.float64, "cpu")
    lk.pack_layer(layer, 9, torch.float64, "cpu")
    assert lk.is_packed(layer, 9, torch.float64, "cpu")
    lk.pack_layer(layer, 9, torch.float64, "cpu")
    assert lk._operands.packs == before + 1
    assert lk._device_operands(layer, 9, torch.float64,
                               torch.device("cpu"))[0] is \
        layer._packed[(9, torch.float64, torch.device("cpu"), False)][0]


# -- the bench shapes, planned and packed without a state -------------------------

def bench_brickwork(n, layers):
    from bench import build_bench_circuit
    return build_bench_circuit(n, layers)[0]


@pytest.mark.parametrize("prec,fast", [("single", False), ("single", True),
                                       ("double", False)])
@pytest.mark.parametrize("name,n", [("brickwork", 20), ("brickwork", 26),
                                    ("brickwork", 30), ("qft", 24),
                                    ("qft", 30)])
def test_bench_shapes_plan_and_pack(name, n, prec, fast):
    precision = tq.SINGLE if prec == "single" else tq.DOUBLE
    env = tq.createQuESTEnv(num_devices=1, precision=precision, seed=[1],
                            device="cpu")
    jc = bench_brickwork(n, 2) if name == "brickwork" else jalg.qft(n)
    cc = carried(jc).compile(env, tier="fast" if fast else None)
    dtype = torch.float32 if fast else precision.real_dtype
    tile_rows = lk.tile_rows_for(dtype)
    hi = lk.max_mid_qubit(tile_rows)
    layers = [op for op in cc._ops if op.kind == "layer"]
    assert layers, "the layer collector produced no layers"
    max_j = 0
    for layer in layers:
        kstages, _, _, xmats, rows, total = lk.layer_kernel_plan(
            layer, n, tile_rows)
        assert rows == tile_rows and total == 1 << (n - lk.LANE_QUBITS)
        for st in kstages:
            if st[0] == "row":
                assert st[1] < tile_rows
            elif st[0] in ("rowk", "rowmxu", "rowdiag"):
                bits = st[1] if st[0] != "rowdiag" else st[2]
                assert all(b + lk.LANE_QUBITS <= n - 1 for b in bits)
                if st[0] != "rowdiag":
                    assert not bits or bits[-1] + lk.LANE_QUBITS <= hi
        lk.pack_layer(layer, n, dtype, "cpu", fast)
        desc = layer._packed[(n, dtype, torch.device("cpu"), fast)][0]
        assert desc.shape == (len(kstages), lk.DESC_WIDTH)
        max_j = max([max_j] + [len(st[1]) for st in kstages
                               if st[0] == "rowmxu"])
    lk.shared_memory_bytes(tile_rows, dtype.itemsize,
                           max_j if fast else None)
