"""The port's ``amp``-mode dynamics sweeps and density-program energies and
gradients on 8 host shards, against the JAX package's ``amp`` mode on its 8
virtual CPU devices, in float64.

``QUEST_TPU_BATCH_MEM_BYTES=1`` (read by both packages) forces the ``amp``
mode: every row spans the mesh. Checked: ``evolve_sweep`` (Trotter orders 1
and 2) and ``ground_sweep`` (power and Lanczos) blocks, with the Hamiltonian's
X/Y bits on shard positions so the term sweeps pair chunks; a density
program's ``expectation_sweep`` and ``value_and_grad_sweep`` through its
channels, Param-bound rates included. Energies within 1e-12, gradients
within 1e-9, and the ``dispatch_stats()`` records equal.
"""

import numpy as np
import pytest

import quest_tpu as jq
import quest_tpu_torch as tq
from quest_tpu.ops import dynamics as jdyn
from quest_tpu_torch.ops import dynamics as tdyn
from torch_threads import one_blas_thread  # noqa: F401

TOL = 1e-12
GRAD_TOL = 1e-9
N = 7


@pytest.fixture(scope="module")
def envs():
    return (jq.createQuESTEnv(num_devices=8, precision=jq.DOUBLE, seed=[2]),
            tq.createQuESTEnv(num_devices=8, precision=tq.DOUBLE, seed=[2],
                              device="cpu"))


@pytest.fixture(autouse=True)
def amp_mode(monkeypatch):
    monkeypatch.setenv("QUEST_TPU_BATCH_MEM_BYTES", "1")


def prep(qt, n=N):
    c = qt.Circuit(n)
    for q in range(n):
        c.ry(q, c.parameter(f"t{q}"))
    for q in range(n - 1):
        c.cnot(q, q + 1)
    c.rz(n - 1, c.parameter("z"))
    return c


# a TFIM chain with extra terms whose X/Y bits sit on shard positions
HAM = ([[(q, 3), (q + 1, 3)] for q in range(N - 1)]
       + [[(q, 1)] for q in range(N)]
       + [[(N - 1, 2), (0, 2)], [(N - 2, 1), (N - 1, 3), (2, 2)]],
       [-1.0] * (N - 1) + [-0.7] * N + [0.3, -0.25])


def params(batch, seed=4, num=N + 1):
    return np.random.default_rng(seed).uniform(0, 2 * np.pi,
                                               size=(batch, num))


def same_stats(jcc, tcc):
    js, ts = jcc.dispatch_stats(), tcc.dispatch_stats()
    for key in ("batch_sharding_mode", "batch_size", "host_syncs_avoided",
                "evolve_steps_fused"):
        assert getattr(ts, key) == getattr(js, key), key
    return ts.batch_sharding_mode


@pytest.fixture(scope="module")
def programs(envs):
    jenv, tenv = envs
    return prep(jq).compile(jenv), prep(tq).compile(tenv)


@pytest.mark.parametrize("order,batch", [(2, 4), (1, 3)])
def test_evolve_sweep_amp(programs, order, batch):
    jcc, tcc = programs
    spec_t = tdyn.EvolveSpec(t=0.6, steps=3, order=order)
    spec_j = jdyn.EvolveSpec(t=0.6, steps=3, order=order)
    pm = params(batch)
    got = tdyn.unpack_evolve_block(tcc.evolve_sweep(pm, HAM, spec_t), N, 3)
    want = jdyn.unpack_evolve_block(
        np.asarray(jcc.evolve_sweep(pm, HAM, spec_j)), N, 3)
    for key in ("energies", "welford", "planes"):
        assert np.abs(got[key] - want[key]).max() < TOL, key
    assert same_stats(jcc, tcc) == "amp"


@pytest.mark.parametrize("method,steps", [("power", 3), ("power", 1),
                                          ("lanczos", 6)])
def test_ground_sweep_amp(programs, method, steps):
    jcc, tcc = programs
    pm = params(4, seed=7)
    got = tdyn.unpack_ground_block(tcc.ground_sweep(
        pm, HAM, tdyn.GroundSpec(steps=steps, tau=0.15, method=method)),
        N, steps)
    want = jdyn.unpack_ground_block(np.asarray(jcc.ground_sweep(
        pm, HAM, jdyn.GroundSpec(steps=steps, tau=0.15, method=method))),
        N, steps)
    for key in ("energies", "residual", "welford"):
        assert np.abs(got[key] - want[key]).max() < TOL, key
    # a Ritz vector is defined up to a sign per row
    for g, w in zip(got["planes"], want["planes"]):
        sign = 1.0 if np.sum(g * w) >= 0 else -1.0
        assert np.abs(g - sign * w).max() < 1e-10
    assert same_stats(jcc, tcc) == "amp"


def test_ground_sweep_from_a_shared_start(programs):
    """Segments chain: a power segment's planes start the next one."""
    jcc, tcc = programs
    pm = params(2, seed=9)
    spec_t = tdyn.GroundSpec(steps=2, tau=0.1)
    spec_j = jdyn.GroundSpec(steps=2, tau=0.1)
    start = tdyn.unpack_ground_block(tcc.ground_sweep(pm[:1], HAM, spec_t),
                                     N, 2)["planes"][0]
    got = tdyn.unpack_ground_block(tcc.ground_sweep(
        pm, HAM, spec_t, state_f=start), N, 2)
    want = jdyn.unpack_ground_block(np.asarray(jcc.ground_sweep(
        pm, HAM, spec_j, state_f=start)), N, 2)
    assert np.abs(got["energies"] - want["energies"]).max() < TOL


def density_programs(envs, n=4):
    jenv, tenv = envs
    out = []
    for qt, env in ((jq, jenv), (tq, tenv)):
        c = qt.Circuit(n)
        for q in range(n):
            c.ry(q, c.parameter(f"a{q}"))
        c.cnot(0, n - 1)
        c.damp(n - 1, c.parameter("g"))
        c.dephase(2, 0.2)
        c.cnot(n - 1, 1)
        c.rx(n - 1, c.parameter("b"))
        c.depolarise(1, 0.05)
        out.append(c.compile(env, density=True))
    return out


DHAM = ([[(0, 3)], [(3, 1), (1, 1)], [(2, 2), (3, 2)], [(3, 3), (0, 1)]],
        [0.4, -0.6, 0.3, 0.2])


def density_params(batch, seed):
    pm = params(batch, seed=seed, num=6)
    pm[:, 4] = np.random.default_rng(seed).uniform(0.05, 0.4, size=batch)
    return pm


@pytest.mark.parametrize("batch", [3, 8])
def test_density_energies_amp(envs, batch):
    jcc, tcc = density_programs(envs)
    pm = density_params(batch, seed=3)
    got = tcc.expectation_sweep(pm, DHAM)
    want = np.asarray(jcc.expectation_sweep(pm, DHAM))
    assert np.abs(got - want).max() < TOL
    assert same_stats(jcc, tcc) == "amp"


def test_density_value_and_grad_amp(envs):
    jcc, tcc = density_programs(envs)
    pm = density_params(3, seed=5)
    tv, tg = tcc.value_and_grad_sweep(pm, DHAM)
    jv, jg = jcc.value_and_grad_sweep(pm, DHAM)
    assert np.abs(tv - np.asarray(jv)).max() < TOL
    assert np.abs(tg - np.asarray(jg)).max() < GRAD_TOL
    assert same_stats(jcc, tcc) == "amp"


def test_density_amp_matches_one_device(envs):
    """The chunked ``Tr(H rho)`` against the port's own one-device walk,
    on a register whose chunks hold one density column each."""
    _, tenv = envs
    one = tq.createQuESTEnv(num_devices=1, device="cpu", precision=tq.DOUBLE)
    progs = []
    for env in (tenv, one):
        c = tq.Circuit(3)
        c.ry(0, c.parameter("a")).cnot(0, 2).damp(2, c.parameter("g"))
        c.cnot(2, 1)
        progs.append(c.compile(env, density=True))
    pm = np.array([[0.3, 0.2], [1.1, 0.05]])
    ham = ([[(0, 3)], [(2, 1), (0, 2)], [(1, 2), (2, 3)]], [0.5, -0.3, 0.8])
    got = progs[0].expectation_sweep(pm, ham)
    want = progs[1].expectation_sweep(pm, ham)
    assert np.abs(got - want).max() < TOL
    tv, tg = progs[0].value_and_grad_sweep(pm, ham)
    ov, og = progs[1].value_and_grad_sweep(pm, ham)
    assert np.abs(tv - ov).max() < TOL and np.abs(tg - og).max() < GRAD_TOL
    assert progs[0].dispatch_stats().batch_sharding_mode == "amp"
