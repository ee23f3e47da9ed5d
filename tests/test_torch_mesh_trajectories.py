"""Trajectory ensembles on a mesh env (8 host shards) at DOUBLE: the
``batch`` mode (whole states per shard) and the ``amp`` mode (every
trajectory spanning the shards' chunks, forced by
``QUEST_TPU_BATCH_MEM_BYTES=1``) against one device on the same uniforms.

Checked: equal draws; planes bit for bit in ``batch`` mode and within
1e-12 in ``amp`` mode (channels on lane, local and sharded positions, a
parametrised channel, layers on the chunks); a wave the mesh does not
divide padded and masked with one warning; ``expectation`` and
``expectation_grad`` against one device; the JAX package's
``traj_cross_shard_ops`` and ``_policy`` (mode and ``amp_comm_seconds``)
for the same programs; the ``ValueError`` of ``shard_trajectories=True``
off a mesh; two amp-mode calls on one program from two threads; the
pad-and-mask split and the start chunks of ``parallel/shards.py``.
"""

import warnings

import numpy as np
import pytest
import torch

import quest_tpu as jq
import quest_tpu_torch as tq
from quest_tpu.ops.trajectories import TrajectoryProgram as JTraj
from quest_tpu.parallel import layout as jlayout
from quest_tpu_torch.ops.trajectories import _Tape
from quest_tpu_torch.parallel import layout as tlayout
from torch_threads import one_blas_thread  # noqa: F401

TOL = 1e-12
N = 11          # 8 local qubits per chunk on 8 shards: layers and lane
                # channels run on the chunks


def noisy(qt, n=N):
    c = qt.Circuit(n)
    a = c.parameter("a")
    b = c.parameter("b")
    g = c.parameter("g")
    for q in range(n):
        c.h(q)
    for q in range(n - 1):
        c.cnot(q, q + 1)
    c.ry(n - 1, a)
    c.damp(n - 1, 0.2)              # a sharded target
    c.dephase(0, 0.15)              # a lane target
    c.rx(2, b)
    c.cnot(n - 2, 1)
    c.depolarise(n - 3, 0.1)        # sharded
    c.damp(8, g)                    # parametrised, local off the lanes
    c.kraus([np.sqrt(0.8) * np.eye(4),
             np.sqrt(0.2) * np.kron(np.array([[0, 1], [1, 0]]),
                                    np.diag([1, -1]))], [3, n - 2])
    c.dephase(5, 0.3)
    for q in range(0, n, 2):
        c.rz(q, a)
    c.cnot(0, n - 1)
    return c


PARAMS = {"a": 0.3, "b": -0.7, "g": 0.25}
HAM = ([[(0, 3), (N - 1, 3)], [(N - 1, 1)], [(4, 2), (N - 2, 2)],
        [(1, 1), (2, 3)]], [0.5, 0.3, -0.2, 0.4])


@pytest.fixture(scope="module")
def progs():
    one = tq.createQuESTEnv(num_devices=1, device="cpu", precision=tq.DOUBLE,
                            seed=[3])
    mesh = tq.createQuESTEnv(num_devices=8, device="cpu",
                             precision=tq.DOUBLE, seed=[3])
    return (noisy(tq).compile_trajectories(one),
            noisy(tq).compile_trajectories(mesh))


def uniforms(num, channels, seed=1):
    return np.random.default_rng(seed).random((num, channels))


def test_batch_mode_equals_one_device_bit_for_bit(progs):
    p1, pm = progs
    u = uniforms(16, p1.num_channels)
    ref = p1.trajectory_sweep(16, params=PARAMS, uniforms=u)
    got = pm.trajectory_sweep(16, params=PARAMS, uniforms=u)
    assert pm.dispatch_stats().batch_sharding_mode == "batch"
    assert torch.equal(got, ref)


def test_amp_mode_draws_and_planes(progs, monkeypatch):
    p1, pm = progs
    u = uniforms(12, p1.num_channels, seed=2)
    start = p1._start(None)
    pm_rows = np.repeat(p1._param_matrix(PARAMS), 12, axis=0)
    tape = _Tape(1 << 40)
    ref = start.expand(12, 2, start.shape[1]).clone()
    p1._apply_batch(ref, torch.as_tensor(u), pm_rows, tape)
    monkeypatch.setenv("QUEST_TPU_BATCH_MEM_BYTES", "1")
    got = pm.trajectory_sweep(12, params=PARAMS, uniforms=u)
    assert pm.dispatch_stats().batch_sharding_mode == "amp"
    wave = pm._mesh_walk().wave(torch.as_tensor(u))
    again = torch.cat(wave.run_rows(pm._start(None), pm_rows), dim=-1)
    assert torch.equal(again, got)
    draws = wave.draws
    assert set(draws) == set(tape.draws) == set(range(p1.num_channels))
    differ = sum(int((draws[i][0].cpu() != tape.draws[i][0].cpu()).sum())
                 for i in draws)
    assert differ == 0
    assert (got - ref).abs().max().item() < TOL


def test_amp_waves_on_two_threads_keep_their_own_draws(progs,
                                                       monkeypatch):
    """Two amp-mode calls on one program at once: the first stops at its
    first Kraus launch while the second runs a whole wave with other
    uniforms; each still returns what it returns alone."""
    import threading

    from quest_tpu_torch.ops import kraus_kernel as kk
    p1, pm = progs
    monkeypatch.setenv("QUEST_TPU_BATCH_MEM_BYTES", "1")
    ua = uniforms(8, p1.num_channels, seed=7)
    ub = uniforms(8, p1.num_channels, seed=8)
    want_a = pm.trajectory_sweep(8, params=PARAMS, uniforms=ua)
    want_b = pm.trajectory_sweep(8, params=PARAMS, uniforms=ub)
    paused, resume = threading.Event(), threading.Event()
    real = kk.fused_kraus_apply_batched
    stalled = []
    got = {}

    def stall(*args):
        if threading.get_ident() in stalled and not paused.is_set():
            paused.set()
            assert resume.wait(60)
        return real(*args)

    def run_a():
        stalled.append(threading.get_ident())
        got["a"] = pm.trajectory_sweep(8, params=PARAMS, uniforms=ua)

    monkeypatch.setattr(kk, "fused_kraus_apply_batched", stall)
    t = threading.Thread(target=run_a)
    t.start()
    assert paused.wait(60)
    got["b"] = pm.trajectory_sweep(8, params=PARAMS, uniforms=ub)
    resume.set()
    t.join(60)
    assert not t.is_alive()
    assert torch.equal(got["b"], want_b)
    assert torch.equal(got["a"], want_a)


def test_amp_mode_runs_channels_through_the_kraus_wrapper(progs,
                                                          monkeypatch):
    """A lane channel (and a sharded one swapped onto a lane position) is
    one call of the fused Kraus wrapper per chunk; the parametrised channel
    off the lanes goes through the gate engine."""
    from quest_tpu_torch.ops import kraus_kernel as kk
    p1, pm = progs
    monkeypatch.setenv("QUEST_TPU_BATCH_MEM_BYTES", "1")
    calls = []
    real = kk.fused_kraus_apply_batched

    def spy(states, num_qubits, *args):
        calls.append((tuple(states.shape), num_qubits))
        return real(states, num_qubits, *args)

    monkeypatch.setattr(kk, "fused_kraus_apply_batched", spy)
    pm.trajectory_sweep(8, params=PARAMS,
                        uniforms=uniforms(8, p1.num_channels, seed=3))
    local = N - 3
    assert calls and all(c == ((8, 2, 1 << local), local) for c in calls)
    # damp(n-1), dephase(0), depolarise(n-3), kraus([3, n-2]),
    # dephase(5): five lane channels after the swaps, one launch per chunk
    assert len(calls) == 5 * 8


@pytest.mark.parametrize("mode", ["batch", "amp"])
def test_expectation_against_one_device(progs, mode, monkeypatch):
    p1, pm = progs
    if mode == "amp":
        monkeypatch.setenv("QUEST_TPU_BATCH_MEM_BYTES", "1")
    want = p1.expectation(*HAM, num_trajectories=40, params=PARAMS,
                          seed=11)
    got = pm.expectation(*HAM, num_trajectories=40, params=PARAMS, seed=11)
    assert pm.dispatch_stats().batch_sharding_mode == mode
    if mode == "batch":
        assert got == want
    else:
        assert abs(got[0] - want[0]) < TOL and abs(got[1] - want[1]) < TOL


@pytest.mark.parametrize("mode", ["batch", "amp"])
def test_expectation_grad_against_one_device(progs, mode, monkeypatch):
    p1, pm = progs
    if mode == "amp":
        monkeypatch.setenv("QUEST_TPU_BATCH_MEM_BYTES", "1")
    v1, g1, e1 = p1.expectation_grad(*HAM, num_trajectories=24,
                                     params=PARAMS, seed=5, wave_size=8)
    v, g, e = pm.expectation_grad(*HAM, num_trajectories=24, params=PARAMS,
                                  seed=5, wave_size=8)
    assert pm.dispatch_stats().batch_sharding_mode == mode
    assert pm.last_traj_stats["waves"] == 3
    assert abs(v - v1) < TOL
    assert np.abs(g - g1).max() < TOL
    assert np.abs(e - e1).max() < TOL


def test_non_divisible_wave_is_padded_and_masked_once(progs):
    p1 = progs[0]
    mesh = tq.createQuESTEnv(num_devices=8, device="cpu",
                             precision=tq.DOUBLE, seed=[3])
    pm = noisy(tq).compile_trajectories(mesh)
    u = uniforms(13, p1.num_channels, seed=4)
    ref = p1.trajectory_sweep(13, params=PARAMS, uniforms=u)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = pm.trajectory_sweep(13, params=PARAMS, uniforms=u)
        again = pm.trajectory_sweep(13, params=PARAMS, uniforms=u)
    padding = [w for w in caught if "padding to 16" in str(w.message)]
    assert len(padding) == 1
    assert tuple(got.shape) == (13, 2, 1 << N)
    assert torch.equal(got, ref) and torch.equal(again, ref)
    assert pm.dispatch_stats().batch_size == 13


def test_split_rows_pads_with_the_first_row_and_warns_once():
    """The pad-and-mask split both kinds of program share
    (``parallel/shards.py``): rows padded with copies of the first to a
    multiple of the mesh, the caller's rows first, one warning per owner;
    a divisible batch passes untouched."""
    import threading
    import types

    from quest_tpu_torch.parallel import shards
    owner = types.SimpleNamespace(
        env=types.SimpleNamespace(num_devices=8),
        _stats_lock=threading.Lock(), _warned_nondivisible=False)
    pm = np.arange(13 * 2, dtype=np.float64).reshape(13, 2)
    u = torch.arange(13 * 3, dtype=torch.float64).reshape(13, 3)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        per, (pm_p, u_p) = shards.split_rows(owner, "a batch", 13, pm, u)
        again = shards.split_rows(owner, "a batch", 13, pm, u)[0]
    assert per == again == 2
    assert [str(w.message) for w in caught] == [
        "a batch of 13 is not divisible by the 8-device mesh; padding to "
        "16 and masking the 3 extra rows"]
    assert np.array_equal(pm_p[:13], pm) and u_p.shape == (16, 3)
    assert np.array_equal(pm_p[13:], np.repeat(pm[:1], 3, axis=0))
    assert torch.equal(u_p[:13], u) and torch.equal(u_p[13:],
                                                    u[:1].expand(3, 3))
    per, (same,) = shards.split_rows(owner, "a batch", 16, pm_p)
    assert per == 2 and same is pm_p


def test_start_chunks_split_shared_planes():
    from quest_tpu_torch.parallel import shards
    planes = torch.arange(2 * 16, dtype=torch.float64).reshape(2, 16)
    devs = [torch.device("cpu")] * 4
    chunks = shards.start_chunks(planes, devs, 2)
    assert torch.equal(torch.cat(chunks, dim=-1), planes)
    batch = shards.start_chunks(planes, devs, 2, batch=3,
                                dtype=torch.float32)
    assert all(c.shape == (3, 2, 4) and c.dtype == torch.float32
               and c.is_contiguous() for c in batch)
    batch[0][0, 0, 0] = -1.0
    assert batch[0][1, 0, 0] == 0.0 and planes[0, 0] == 0.0
    assert torch.equal(torch.cat(batch, dim=-1)[2], planes.float())


def test_shard_trajectories_overrides(progs, monkeypatch):
    p1, pm = progs
    monkeypatch.setenv("QUEST_TPU_BATCH_MEM_BYTES", "1")
    u = uniforms(8, p1.num_channels, seed=6)
    ref = p1.trajectory_sweep(8, params=PARAMS, uniforms=u)
    forced = pm.trajectory_sweep(8, params=PARAMS, uniforms=u,
                                 shard_trajectories=True)
    assert pm.dispatch_stats().batch_sharding_mode == "batch"
    assert torch.equal(forced, ref)
    pm.run_batch(None, 8, uniforms=u, shard_trajectories=False,
                 params=PARAMS)
    assert pm.dispatch_stats().batch_sharding_mode == "none"


def test_shard_trajectories_off_a_mesh_raises(progs):
    p1 = progs[0]
    for call in (lambda: p1.trajectory_sweep(4, params=PARAMS,
                                             shard_trajectories=True),
                 lambda: p1.expectation(*HAM, num_trajectories=4,
                                        params=PARAMS,
                                        shard_trajectories=True)):
        with pytest.raises(ValueError, match="multi-device mesh"):
            call()


@pytest.mark.parametrize("supports,n,d", [
    ([(0,), (5,), (9, 1), (10,)], 11, 8), ([(3,), (2, 1)], 4, 2),
    ([(7,)], 8, 1), ([(0, 1), (6, 7), (5,)], 8, 4)])
def test_traj_cross_shard_ops_matches(supports, n, d):
    assert tlayout.traj_cross_shard_ops(supports, n, d) == \
        jlayout.traj_cross_shard_ops(supports, n, d)


@pytest.mark.parametrize("limit", [None, "1", str(1 << 20), str(1 << 26)])
def test_policy_matches_the_jax_package(limit, monkeypatch):
    if limit is not None:
        monkeypatch.setenv("QUEST_TPU_BATCH_MEM_BYTES", limit)
    jenv = jq.createQuESTEnv(num_devices=8, precision=jq.DOUBLE, seed=[3])
    tenv = tq.createQuESTEnv(num_devices=8, device="cpu",
                             precision=tq.DOUBLE, seed=[3])
    jp = JTraj(noisy(jq), jenv)
    tp = noisy(tq).compile_trajectories(tenv)
    for batch in (8, 13, 64, 512):
        for factor in (1.0, 2.0):
            want = jp._policy(batch, mem_factor=factor)
            got = tp._policy(batch, mem_factor=factor)
            assert got["mode"] == want["mode"], (batch, factor)
            assert got["amp_comm_seconds"] == pytest.approx(
                want["amp_comm_seconds"], rel=1e-12, abs=0.0)
            assert tp._resolve_mode(batch, None, factor) == \
                jp._resolve_mode(batch, None, factor)
