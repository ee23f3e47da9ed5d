"""The PyTorch port's channels (quest_tpu_torch/ops/channels.py and the
channel recording on quest_tpu_torch.Circuit) against the JAX package's.

Checked on the CPU, exactly or to 1e-15 where the math is the same:

- every static Kraus set, and the run-time-strength (``*_traceable``)
  builders at a bound value;
- the op stream each channel method and ``with_noise`` records (kinds,
  targets, masks, matrices; Param channels evaluated at bound values);
- validation failures raise ``QuESTError`` with the same ``ErrorCode``;
- a channel is a barrier to every fusion pass and to layer collection: the
  trajectory walker's items, stage for stage, equal the JAX Pallas
  walker's.
"""

import numpy as np
import pytest
import torch

import quest_tpu as jq
from quest_tpu.circuits import Circuit as JCircuit, Param as JParam
from quest_tpu.core import fusion as jfusion
from quest_tpu.ops import channels as jchan
import quest_tpu_torch as tq
from quest_tpu_torch.circuits import Param as TParam
from quest_tpu_torch.core import fusion as tfusion
from quest_tpu_torch.ops import channels as tchan
from torch_threads import one_blas_thread  # noqa: F401

TOL = 1e-15


def _same_list(a, b, tol=TOL):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape
        assert np.abs(x - y).max(initial=0.0) <= tol


@pytest.mark.parametrize("name,args", [
    ("damping_kraus", (0.0,)), ("damping_kraus", (0.3,)),
    ("damping_kraus", (1.0,)), ("pauli_kraus", (0.1, 0.2, 0.05)),
    ("depolarising_kraus", (0.3,)), ("two_qubit_dephasing_kraus", (0.4,)),
    ("two_qubit_depolarising_kraus", (0.6,))])
def test_static_kraus_sets_match_jax(name, args):
    _same_list(getattr(tchan, name)(*args), getattr(jchan, name)(*args))


@pytest.mark.parametrize("name,args", [
    ("damping_kraus_traceable", (0.3,)),
    ("dephasing_kraus_traceable", (0.2,)),
    ("depolarising_kraus_traceable", (0.45,)),
    ("pauli_kraus_traceable", (0.1, 0.05, 0.2))])
def test_traceable_kraus_sets_match_jax(name, args):
    mine = [m.numpy() for m in getattr(tchan, name)(
        *(torch.tensor(a, dtype=torch.float64) for a in args))]
    _same_list(mine, [np.asarray(m) for m in getattr(jchan, name)(*args)])


def _cptp(rng, num_ops, dim):
    """A random CPTP Kraus set: the blocks of a random isometry."""
    z = rng.normal(size=(num_ops * dim, dim)) \
        + 1j * rng.normal(size=(num_ops * dim, dim))
    q, _ = np.linalg.qr(z)
    return [q[k * dim:(k + 1) * dim] for k in range(num_ops)]


def _record(c, case):
    """Apply one recording case to a circuit of either package."""
    P = TParam if isinstance(c, tq.Circuit) else JParam
    if case == "kraus":
        c.kraus(_cptp(np.random.default_rng(4), 3, 4), (3, 1))
    elif case == "dephase":
        c.dephase(2, 0.3)
    elif case == "depolarise":
        c.depolarise(0, 0.5)
    elif case == "damp":
        c.damp(4, 0.25)
    elif case == "pauli_channel":
        c.pauli_channel(1, 0.1, 0.2, 0.05)
    elif case == "two_qubit_dephase":
        c.two_qubit_dephase(4, 2, 0.6)
    elif case == "two_qubit_depolarise":
        c.two_qubit_depolarise(0, 3, 0.9)
    elif case == "mid_measure":
        c.mid_measure(3)
    elif case == "param_dephase":
        c.dephase(2, P("g"))
    elif case == "param_depolarise":
        c.depolarise(1, P("g"))
    elif case == "param_damp":
        c.damp(0, P("g"))
    elif case == "param_pauli":
        c.pauli_channel(3, 0.1, P("g"), 0.05)
    elif case.startswith("with_noise"):
        c.h(0).cnot(0, 1).rz(2, 0.3).gate(np.eye(4), (1, 3), (4,))
        c.dephase(2, 0.1)
        if case == "with_noise_p1":
            return c.with_noise(p1=0.05)
        if case == "with_noise_all":
            return c.with_noise(p1=0.05, p2=0.1, damping=0.02)
        return c.with_noise(p1=P("a"), p2=0.1, damping=P("b"))
    return c


def _ops_equal(tc, jc, params):
    assert tc.param_names == jc.param_names
    assert len(tc.ops) == len(jc.ops)
    for t, j in zip(tc.ops, jc.ops):
        assert (t.kind, tuple(t.targets), t.ctrl_mask, t.flip_mask) == \
            (j.kind, tuple(j.targets), j.ctrl_mask, j.flip_mask)
        assert t.is_static == j.is_static
        if t.kind == "kraus":
            tk = t.kraus(params) if callable(t.kraus) else t.kraus
            jk = j.kraus(params) if callable(j.kraus) else j.kraus
            _same_list([np.asarray(m) for m in tk], [np.asarray(m)
                                                     for m in jk])
        elif t.kind == "u":
            _same_list([t.mat], [j.mat])
        else:
            _same_list([t.diag], [j.diag])


CASES = ["kraus", "dephase", "depolarise", "damp", "pauli_channel",
         "two_qubit_dephase", "two_qubit_depolarise", "mid_measure",
         "param_dephase", "param_depolarise", "param_damp", "param_pauli",
         "with_noise_p1", "with_noise_all", "with_noise_param"]


@pytest.mark.parametrize("case", CASES)
def test_recorded_ops_match_jax(case):
    tc = _record(tq.Circuit(5), case)
    jc = _record(JCircuit(5), case)
    _ops_equal(tc, jc, {"g": 0.15, "a": 0.07, "b": 0.03})


E = tq.ErrorCode


@pytest.mark.parametrize("call,code", [
    (lambda c, P: c.dephase(0, 0.6), E.E_INVALID_ONE_QUBIT_DEPHASE_PROB),
    (lambda c, P: c.dephase(0, -0.1), E.E_INVALID_PROB),
    (lambda c, P: c.depolarise(0, 0.8), E.E_INVALID_ONE_QUBIT_DEPOL_PROB),
    (lambda c, P: c.damp(0, 1.2), E.E_INVALID_PROB),
    (lambda c, P: c.pauli_channel(0, 0.5, 0.3, 0.1),
     E.E_INVALID_ONE_QUBIT_PAULI_PROBS),
    (lambda c, P: c.pauli_channel(0, 0.6, P("g"), 0.3),
     E.E_INVALID_ONE_QUBIT_PAULI_PROBS),
    (lambda c, P: c.pauli_channel(0, 0.7, P("g"), 0.5), E.E_INVALID_PROB),
    (lambda c, P: c.two_qubit_dephase(0, 1, 0.8),
     E.E_INVALID_TWO_QUBIT_DEPHASE_PROB),
    (lambda c, P: c.two_qubit_depolarise(0, 1, 0.95),
     E.E_INVALID_TWO_QUBIT_DEPOL_PROB),
    (lambda c, P: c.with_noise(p1=0.8), E.E_INVALID_PROB)])
def test_channel_validation_codes_match_jax(call, code):
    codes = []
    for C, P, Err in ((tq.Circuit, TParam, tq.QuESTError),
                      (JCircuit, JParam, jq.QuESTError)):
        c = C(3)
        with pytest.raises(Err) as info:
            call(c, P)
        codes.append(int(info.value.code))
        assert c.param_names == ()        # no orphan parameter names
    assert codes == [int(code)] * 2


@pytest.mark.parametrize("ops,targets,code", [
    ([np.eye(2) * 0.9], (0,), E.E_INVALID_KRAUS_OPS),
    ([np.eye(4)], (0,), E.E_MISMATCHING_NUM_TARGS_KRAUS_SIZE),
    ([np.eye(2) * 0.5] * 5, (0,), E.E_INVALID_NUM_ONE_QUBIT_KRAUS_OPS),
    ([np.eye(4) * 0.5] * 17, (0, 1), E.E_INVALID_NUM_TWO_QUBIT_KRAUS_OPS)])
def test_trajectory_compile_validates_kraus_like_jax(ops, targets, code):
    tenv = tq.createQuESTEnv(device="cpu", precision=tq.DOUBLE)
    jenv = jq.createQuESTEnv(num_devices=1, precision=jq.DOUBLE)
    with pytest.raises(tq.QuESTError) as mine:
        tq.Circuit(2).kraus(ops, targets).compile_trajectories(tenv)
    with pytest.raises(jq.QuESTError) as ref:
        JCircuit(2).kraus(ops, targets).compile_trajectories(jenv)
    assert int(mine.value.code) == int(ref.value.code) == int(code)


def test_state_vector_compile_rejects_channels():
    env = tq.createQuESTEnv(device="cpu", precision=tq.DOUBLE)
    with pytest.raises(ValueError, match="Kraus channels"):
        tq.Circuit(3).h(0).damp(1, 0.1).compile(env)


def _barrier_circuit(C, n, channel_qubit):
    rng = np.random.default_rng(9)
    c = C(n)
    for q in range(n):
        c.ry(q, float(rng.uniform(0.2, 2.8)))
    c.h(0).h(0)                       # peephole fusion merges these two
    c.damp(channel_qubit, 0.2)
    c.h(0)                            # ...but never across the channel
    for q in range(n - 1):
        c.cnot(q, q + 1)
    c.two_qubit_depolarise(1, 5, 0.3)
    c.cz(0, n - 1)
    return c


def _same_stage(a, b):
    if isinstance(a, (tuple, list)):
        return (isinstance(b, (tuple, list)) and len(a) == len(b)
                and all(_same_stage(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and np.abs(a - b).max(initial=0) <= 1e-12
    return a == b


@pytest.mark.parametrize("n,channel_qubit", [(9, 2), (10, 8)])
def test_channels_are_layer_barriers_like_jax(n, channel_qubit):
    """The trajectory walkers of both packages hold the same items: the
    same layers (stage for stage), channels where the circuit has them, a
    fused-kernel channel exactly where its targets are lane qubits."""
    tenv = tq.createQuESTEnv(device="cpu", precision=tq.DOUBLE)
    jenv = jq.createQuESTEnv(num_devices=1, precision=jq.DOUBLE)
    tp = _barrier_circuit(tq.Circuit, n, channel_qubit) \
        .compile_trajectories(tenv)
    jp = _barrier_circuit(JCircuit, n, channel_qubit) \
        .compile_trajectories(jenv, pallas="interpret")
    mine, ref = tp._items, jp._pallas_items
    assert [i[0] for i in mine] == [i[0] for i in ref]
    assert "layer" in [i[0] for i in mine]
    damp = next(i for i in mine if i[0].startswith("kraus"))
    assert (damp[0] == "kraus_fused") == (channel_qubit < 7)
    for a, b in zip(mine, ref):
        if a[0] == "layer":
            assert _same_stage(a[1].stages, b[1].stages)
        else:
            assert tuple(a[1]) == tuple(b[1]) and a[-1] == b[-1]


def test_channel_is_a_fusion_barrier_like_jax():
    """Gate fusion and super-gate grouping pass a channel through and
    never fuse across it, in both packages."""
    for C, fusion in ((tq.Circuit, tfusion), (JCircuit, jfusion)):
        c = C(3).h(0).cnot(0, 1).damp(1, 0.2).h(1).cnot(1, 2)
        out, _ = fusion.fuse_ops(c.ops, max_k=3)
        assert [o.kind for o in out] == ["u", "kraus", "u"]
    from quest_tpu.circuits import _group_supergates as jgroup
    from quest_tpu_torch.circuits import _group_supergates as tgroup
    for C, group in ((tq.Circuit, tgroup), (JCircuit, jgroup)):
        c = C(3).h(0).cnot(0, 1).damp(1, 0.2).h(1).cnot(1, 2)
        assert [o.kind for o in group(list(c.ops), 4)] == \
            ["u", "kraus", "u"]
