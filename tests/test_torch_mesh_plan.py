"""The port's mesh planners (quest_tpu_torch/parallel/layout.py, multihost.py,
exchange.plan_exchange) against the JAX package's, item for item.

Random circuits are recorded with the JAX package and carried to the port
through ``interop.circuit_from_records``, so both planners see the same
ops. Checked, at shard bits 1-3:

- ``plan_layout``'s items (relayout permutations, op and cross-shard
  items with their physical masks and axis orders) and its counters, in
  the count-based mode and the communication-aware mode (the default
  model, a pinned measured-style model, one and two inter-host bits,
  reordering on and off, two lookahead windows);
- ``plan_comm_stats``, ``relayout_comm_tiered`` and
  ``choose_batch_sharding`` under a pinned cost model;
- ``plan_exchange``'s groups and residual permutation, and its local maps
  against the JAX package's transpose axes;
- the host topology of a forced multi-host mesh;
- a whole compile on an 8-shard CPU mesh: ``dispatch_stats`` against the
  JAX package's on its 8 virtual CPU devices.
"""

import itertools

import numpy as np
import pytest

import quest_tpu as jq
from quest_tpu.circuits import Circuit as JCircuit
from quest_tpu.parallel import exchange as jex
from quest_tpu.parallel import layout as jlay
from quest_tpu.parallel import multihost as jmh
from quest_tpu import profiling as jprof
import quest_tpu_torch as tq
from quest_tpu_torch import interop
from quest_tpu_torch.parallel import exchange as tex
from quest_tpu_torch.parallel import layout as tlay
from quest_tpu_torch.parallel import multihost as tmh
from quest_tpu_torch.parallel.mesh import Mesh
from quest_tpu_torch import profiling as tprof
from torch_threads import one_blas_thread  # noqa: F401


def records(jc):
    return [(op.kind, op.targets, op.ctrl_mask, op.flip_mask,
             op.mat if op.kind == "u" else op.diag) for op in jc.ops]


def rand_u(rng, k):
    m = rng.normal(size=(1 << k, 1 << k)) + 1j * rng.normal(
        size=(1 << k, 1 << k))
    return np.linalg.qr(m)[0]


def random_circuit(n, depth, seed):
    """A JAX-package circuit mixing every planner case: high and low 1q
    gates, controls on any qubit, 2-3 qubit dense gates, SWAPs (the
    absorbable case), diagonals and multi-qubit phases."""
    rng = np.random.default_rng(seed)
    c = JCircuit(n)
    for _ in range(depth):
        kind = rng.integers(0, 8)
        qs = [int(q) for q in rng.permutation(n)[:3]]
        if kind == 0:
            c.h(qs[0])
        elif kind == 1:
            c.ry(qs[0], float(rng.uniform(0, 3)))
        elif kind == 2:
            c.cnot(qs[0], qs[1])
        elif kind == 3:
            c.swap(qs[0], qs[1])
        elif kind == 4:
            c.gate(rand_u(rng, 2), qs[:2])
        elif kind == 5:
            c.gate(rand_u(rng, 3), qs[:3])
        elif kind == 6:
            c.rz(qs[0], float(rng.uniform(0, 3)))
        else:
            c.cz(qs[0], qs[1])
    return c


def assert_plans_equal(jp, tp):
    assert (tp.num_qubits, tp.shard_bits, tp.num_relayouts, tp.num_xshard,
            tp.swaps_absorbed, tp.collectives_fused) == (
        jp.num_qubits, jp.shard_bits, jp.num_relayouts, jp.num_xshard,
        jp.swaps_absorbed, jp.collectives_fused)
    assert (tp.num_kernels, tp.num_dispatches) == (jp.num_kernels,
                                                   jp.num_dispatches)
    assert len(tp.items) == len(jp.items)
    for ji, ti in zip(jp.items, tp.items):
        assert ti[0] == ji[0]
        if ji[0] == "relayout":
            assert np.array_equal(ti[1], ji[1])
            assert np.array_equal(ti[2], ji[2])
        else:
            assert tuple(ti) == tuple(ji)


MODES = {
    "count": dict(cost=False, host_bits=0, reorder=True),
    "comm": dict(cost=True, host_bits=0, reorder=True),
    "comm_pinned": dict(cost="pinned", host_bits=0, reorder=True),
    "host1_reorder": dict(cost=True, host_bits=1, reorder=True),
    "host1_plain": dict(cost=True, host_bits=1, reorder=False),
    "host2_reorder": dict(cost=True, host_bits=2, reorder=True),
}


def models(cost):
    if cost is False:
        return None, None
    if cost == "pinned":
        return (jprof.CommCostModel(alpha_s=2e-5, beta_s_per_byte=3e-10,
                                    inter_alpha_s=1e-4,
                                    inter_beta_s_per_byte=2e-9),
                tprof.CommCostModel(alpha_s=2e-5, beta_s_per_byte=3e-10,
                                    inter_alpha_s=1e-4,
                                    inter_beta_s_per_byte=2e-9))
    return jprof.DEFAULT_COMM_MODEL, tprof.DEFAULT_COMM_MODEL


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("shard_bits", [1, 2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_plan_layout_equals_jax(seed, shard_bits, mode):
    n = 8
    jc = random_circuit(n, 40, seed * 10 + shard_bits)
    tc = interop.circuit_from_records(n, records(jc))
    m = MODES[mode]
    jm, tm = models(m["cost"])
    for lookahead in (4, 32):
        kw = dict(lookahead=lookahead, host_bits=m["host_bits"],
                  reorder=m["reorder"])
        jp = jlay.plan_layout(jc.ops, n, shard_bits, cost_model=jm, **kw)
        tp = tlay.plan_layout(tc.ops, n, shard_bits, cost_model=tm, **kw)
        assert_plans_equal(jp, tp)
        if jm is not None:
            chunk = 16.0 * (1 << (n - shard_bits))
            assert tlay.plan_comm_stats(
                tp, chunk, tm, 1 << shard_bits,
                host_bits=m["host_bits"]) == jlay.plan_comm_stats(
                jp, chunk, jm, 1 << shard_bits, host_bits=m["host_bits"])


def test_plan_layout_one_device_is_identity():
    jc = random_circuit(6, 20, 7)
    tc = interop.circuit_from_records(6, records(jc))
    assert_plans_equal(jlay.plan_layout(jc.ops, 6, 0),
                       tlay.plan_layout(tc.ops, 6, 0))


def test_too_large_unitary_rejected_like_jax():
    jc = JCircuit(5)
    jc.gate(rand_u(np.random.default_rng(1), 3), (0, 1, 4))
    tc = interop.circuit_from_records(5, records(jc))
    with pytest.raises(ValueError, match="cannot be localised"):
        jlay.plan_layout(jc.ops, 5, 3)
    with pytest.raises(ValueError, match="cannot be localised"):
        tlay.plan_layout(tc.ops, 5, 3)


@pytest.mark.parametrize("host_bits", [0, 1, 2])
def test_relayout_accounting_equals_jax(host_bits):
    """Every physical permutation of 5 positions over 2 shard bits: the
    tiered accounting of both packages agrees, under a pinned model."""
    jm, tm = models("pinned")
    n, s = 5, 2
    chunk = 16.0 * (1 << (n - s))
    for sig in itertools.permutations(range(n)):
        sigma = np.asarray(sig)
        assert tlay.relayout_comm_tiered(
            sigma, n - s, chunk, tm, host_bits) == \
            jlay.relayout_comm_tiered(sigma, n - s, chunk, jm, host_bits)


def jax_pos_map(axes, lt):
    """The position map a JAX transpose-axes tuple realises."""
    if axes is None:
        return None
    pos = [0] * lt
    for out_axis, in_axis in enumerate(axes):
        pos[lt - 1 - in_axis] = lt - 1 - out_axis
    return tuple(pos)


@pytest.mark.parametrize("n,s", [(5, 2), (6, 3)])
def test_plan_exchange_equals_jax(n, s):
    rng = np.random.default_rng(n * 10 + s)
    before = tuple(range(n))
    perms = list(itertools.permutations(range(n)))
    for idx in rng.choice(len(perms), size=120, replace=False):
        after = perms[int(idx)]
        jp = jex.plan_exchange(n, s, before, after)
        tp = tex.plan_exchange(n, s, before, after)
        assert (tp.local_top, tp.k, tp.groups, tp.device_perm) == (
            jp.local_top, jp.k, jp.groups, jp.device_perm)
        assert tp.pre_map == jax_pos_map(jp.pre_axes, n - s)
        assert tp.post_map == jax_pos_map(jp.post_axes, n - s)


@pytest.mark.parametrize("host_bits", [0, 1])
@pytest.mark.parametrize("mem_factor", [1.0, 2.0])
def test_choose_batch_sharding_equals_jax(host_bits, mem_factor):
    jm, tm = models("pinned")
    for n, batch, D, itemsize, relayouts, limit in itertools.product(
            (10, 20, 24), (1, 7, 64), (1, 2, 8), (4, 8), (0, 3),
            (None, 1 << 20, 1 << 34)):
        args = (n, batch, D, itemsize, relayouts)
        kw = dict(mem_limit_bytes=limit, host_bits=host_bits,
                  mem_factor=mem_factor)
        assert tlay.choose_batch_sharding(*args, cost_model=tm, **kw) == \
            jlay.choose_batch_sharding(*args, cost_model=jm, **kw)


@pytest.mark.parametrize("hosts", [None, 1, 2, 4, 3])
def test_host_topology_equals_jax(hosts, mesh_env):
    jt = jmh.host_topology(mesh_env.mesh, num_hosts=hosts)
    tt = tmh.host_topology(Mesh(["cpu"] * 8), num_hosts=hosts)
    assert (tt.num_hosts, tt.num_devices, tt.host_bits,
            tt.devices_per_host, tt.is_multihost) == (
        jt.num_hosts, jt.num_devices, jt.host_bits, jt.devices_per_host,
        jt.is_multihost)
    assert tt.inter_positions(12) == jt.inter_positions(12)
    for n, s, h in itertools.product((8, 12), (1, 3), (0, 1, 4)):
        assert tmh.inter_host_positions(n, s, h) == \
            jmh.inter_host_positions(n, s, h)


def test_forced_hosts_from_the_environment(monkeypatch):
    monkeypatch.setenv("QUEST_TPU_FORCE_HOSTS", "2")
    tt = tmh.host_topology(Mesh(["cpu"] * 8))
    assert (tt.num_hosts, tt.host_bits) == (2, 1)


def bench_like(n, layers, seed):
    rng = np.random.default_rng(seed)
    c = JCircuit(n)
    for layer in range(layers):
        for q in range(n):
            c.ry(q, float(rng.uniform(0, 2 * np.pi)))
        for q in range(layer % 2, n - 1, 2):
            c.cnot(q, q + 1)
        c.swap(0, n - 1)
        c.h(n - 1)
    return c


@pytest.mark.parametrize("comm_planner", [None, False])
@pytest.mark.parametrize("which", ["brickwork", "qft", "random"])
def test_compiled_dispatch_stats_equal_jax(which, comm_planner, mesh_env):
    from quest_tpu import algorithms as jalg
    n = 10
    jc = {"brickwork": lambda: bench_like(n, 4, 3),
          "qft": lambda: jalg.qft(n),
          "random": lambda: random_circuit(n, 60, 11)}[which]()
    tenv = tq.createQuESTEnv(8, tq.DOUBLE, [3], device="cpu")
    js = jc.compile(mesh_env, comm_planner=comm_planner).dispatch_stats()
    ts = interop.circuit_from_records(n, records(jc)).compile(
        tenv, comm_planner=comm_planner, layers=False).dispatch_stats()
    for key in ("gates_in", "kernels_out", "relayouts",
                "cross_shard_exchanges", "swaps_absorbed",
                "collectives_fused", "comm_bytes_planned",
                "comm_bytes_saved", "fused_groups", "num_hosts"):
        assert getattr(ts, key) == getattr(js, key), key
