"""The port's batched engine on a mesh against the JAX package's on its 8
virtual CPU devices, in float64 at 1e-12.

``choose_batch_sharding`` picks the mode in both packages from the same
inputs: ``batch`` (each shard runs whole states), ``amp`` (forced here by
``QUEST_TPU_BATCH_MEM_BYTES=1``, which both packages read: every state
spans the mesh) and the padded ``batch`` mode of a batch the mesh does not
divide. Checked: the energies of ``expectation_sweep``, the planes of
``sweep``, the values and gradients of ``value_and_grad_sweep`` (in both
modes), a density
program's energies, ``sample_sweep``'s norms and draws, and
``dispatch_stats`` (the mode and the planner's fields) against the JAX
package's.
"""

import warnings

import numpy as np
import pytest

import quest_tpu as jq
import quest_tpu_torch as tq
from quest_tpu_torch.ops import layer_kernel as lk
from torch_threads import one_blas_thread  # noqa: F401

TOL = 1e-12
N = 9


@pytest.fixture(scope="module")
def envs():
    return (jq.createQuESTEnv(num_devices=8, precision=jq.DOUBLE, seed=[2]),
            tq.createQuESTEnv(num_devices=8, precision=tq.DOUBLE, seed=[2],
                              device="cpu"))


def hea(qt, n=N, layers=2):
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


HAM = ([[(0, 3), (N - 1, 3)], [(N - 1, 1)], [(3, 2), (N - 1, 2)],
        [(N - 2, 1), (N - 1, 1), (1, 3)]], [0.5, 0.3, -0.2, 0.7])


@pytest.fixture(scope="module")
def programs(envs):
    jenv, tenv = envs
    return hea(jq).compile(jenv), hea(tq).compile(tenv)


def params(batch, seed=4, num=2 * (N + 1)):
    return np.random.default_rng(seed).uniform(0, 2 * np.pi,
                                               size=(batch, num))


def same_stats(jcc, tcc):
    js, ts = jcc.dispatch_stats(), tcc.dispatch_stats()
    for key in ("batch_sharding_mode", "batch_size", "host_syncs_avoided",
                "relayouts", "cross_shard_exchanges", "swaps_absorbed"):
        assert getattr(ts, key) == getattr(js, key), key
    return ts.batch_sharding_mode


@pytest.mark.parametrize("mode,batch", [("batch", 16), ("batch", 13),
                                        ("amp", 16), ("amp", 5)])
def test_expectation_sweep_modes(programs, mode, batch, monkeypatch):
    if mode == "amp":
        monkeypatch.setenv("QUEST_TPU_BATCH_MEM_BYTES", "1")
    jcc, tcc = programs
    pm = params(batch)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = tcc.expectation_sweep(pm, HAM)
    want = np.asarray(jcc.expectation_sweep(pm, HAM))
    assert np.abs(got - want).max() < TOL
    assert same_stats(jcc, tcc) == mode
    padded = mode == "batch" and batch % 8
    assert any("padding" in str(w.message) for w in caught) == bool(padded)


@pytest.mark.parametrize("mode", ["batch", "amp"])
def test_sweep_planes(programs, mode, monkeypatch):
    if mode == "amp":
        monkeypatch.setenv("QUEST_TPU_BATCH_MEM_BYTES", "1")
    jcc, tcc = programs
    pm = params(8, seed=6)
    got = tcc.sweep(pm).numpy()
    want = np.asarray(jcc.sweep(pm))
    assert got.shape == want.shape
    assert np.abs(got - want).max() < TOL
    assert same_stats(jcc, tcc) == mode


def test_value_and_grad_sweep_batch_mode(programs):
    jcc, tcc = programs
    pm = params(9, seed=8)
    tv, tg = tcc.value_and_grad_sweep(pm, HAM)
    jv, jg = jcc.value_and_grad_sweep(pm, HAM)
    assert np.abs(tv - np.asarray(jv)).max() < TOL
    assert np.abs(tg - np.asarray(jg)).max() < 1e-11
    assert same_stats(jcc, tcc) == "batch"


def test_value_and_grad_sweep_amp_mode(programs, monkeypatch):
    """The adjoint walk over the mesh plan with every row spanning the
    shards (relayouts un-computed by their inverses)."""
    monkeypatch.setenv("QUEST_TPU_BATCH_MEM_BYTES", "1")
    jcc, tcc = programs
    pm = params(5, seed=8)
    tv, tg = tcc.value_and_grad_sweep(pm, HAM)
    jv, jg = jcc.value_and_grad_sweep(pm, HAM)
    assert np.abs(tv - np.asarray(jv)).max() < TOL
    assert np.abs(tg - np.asarray(jg)).max() < 1e-11
    assert same_stats(jcc, tcc) == "amp"


@pytest.mark.parametrize("mode", ["batch", "amp"])
def test_sample_sweep(programs, mode, monkeypatch):
    if mode == "amp":
        monkeypatch.setenv("QUEST_TPU_BATCH_MEM_BYTES", "1")
    _, tcc = programs
    pm = params(3, seed=9)
    import torch
    idx, totals = tcc.sample_sweep(pm, 4000,
                                   generator=torch.Generator().manual_seed(1))
    assert idx.shape == (3, 4000)
    assert np.abs(totals - 1.0).max() < 1e-12
    planes = tcc.sweep(pm).numpy()
    probs = planes[:, 0] ** 2 + planes[:, 1] ** 2
    for b in range(3):
        # each qubit's marginal P(1) within 5 standard errors
        for q in range(N):
            p1 = probs[b][(np.arange(1 << N) >> q) & 1 == 1].sum()
            freq = np.mean((idx[b] >> q) & 1)
            assert abs(freq - p1) <= 5 * np.sqrt(p1 * (1 - p1) / 4000) \
                + 1e-12
    assert tcc.dispatch_stats().batch_sharding_mode == mode


def test_density_program_expectation_batch_mode(envs):
    jenv, tenv = envs
    n = 5
    progs = []
    for qt, env in ((jq, jenv), (tq, tenv)):
        c = qt.Circuit(n)
        for q in range(n):
            c.ry(q, c.parameter(f"a{q}"))
        c.cnot(0, n - 1)
        c.damp(n - 1, 0.1)
        c.dephase(2, 0.2)
        progs.append(c.compile(env, density=True))
    ham = ([[(0, 3)], [(n - 1, 1), (1, 1)], [(2, 2), (n - 1, 2)]],
           [0.4, -0.6, 0.3])
    pm = params(10, seed=3, num=n)
    want = np.asarray(progs[0].expectation_sweep(pm, ham))
    got = progs[1].expectation_sweep(pm, ham)
    assert np.abs(got - want).max() < TOL
    assert same_stats(progs[0], progs[1]) == "batch"


def test_batch_mode_runs_whole_states_through_the_batched_layer(envs):
    _, tenv = envs
    n = 10
    c = tq.Circuit(n)
    for q in range(n):
        c.ry(q, c.parameter(f"t{q}"))
    for q in range(n - 1):
        c.cnot(q, q + 1)
    cc = c.compile(tenv)
    one = c.compile(tq.createQuESTEnv(1, tq.DOUBLE, [2], device="cpu"))
    pm = params(8, seed=2, num=n)
    calls = []
    real = lk.apply_layer_batched

    def spy(states, num_qubits, layer, fast=False):
        calls.append((tuple(states.shape), num_qubits))
        return real(states, num_qubits, layer, fast=fast)

    lk.apply_layer_batched = spy
    try:
        got = cc.expectation_sweep(pm, ([[(0, 3)]], [1.0]))
    finally:
        lk.apply_layer_batched = real
    want = one.expectation_sweep(pm, ([[(0, 3)]], [1.0]))
    assert np.abs(got - want).max() < TOL
    # one sub-batch of whole 10-qubit states per shard
    assert calls and all(shape == (1, 2, 1 << n) and nq == n
                         for shape, nq in calls)
    assert len(calls) % 8 == 0
