"""The PyTorch port's trajectory programs (quest_tpu_torch/ops/trajectories.py)
and fused Kraus step (quest_tpu_torch/ops/kraus_kernel.py) against the JAX
package's, on the CPU in float64.

- ``fused_kraus_apply_batched_plain`` against JAX
  ``fused_kraus_apply_batched(..., interpret=True)`` on the same numpy
  probabilities and uniforms, edge uniforms and zero-probability branches
  included, for K = 1, 2, 4, 16, 64 (bound 1e-12, and the drawn indices equal the
  inverse-CDF rule's);
- the whole program on the bench.py:2110 circuit, fed the JAX Pallas
  walker's own uniforms (``uniform(fold_in(split(key, T)[t], channel))``),
  against that walker (bound 1e-12);
- ``expectation`` within 5 standard errors of the JAX density path;
- the wave plan, the Welford statistics, seeds, norms and the
  ``average_density`` guard.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quest_tpu as jq
from quest_tpu.circuits import Circuit as JCircuit
from quest_tpu.ops import pallas_kernels as pk
from quest_tpu.ops import reductions as jred
from quest_tpu.ops import trajectories as jtraj
import quest_tpu_torch as tq
from quest_tpu_torch.circuits import Param as TParam
from quest_tpu_torch.ops import kraus_kernel as kk
from quest_tpu_torch.ops import layer_kernel as lk
from quest_tpu_torch.ops import reductions as tred
from quest_tpu_torch.ops import trajectories as ttraj
from torch_threads import one_blas_thread  # noqa: F401

TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; one intra-op
    thread per worker keeps this module's small torch ops from
    oversubscribing the cores the other workers use."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def envs():
    return (jq.createQuESTEnv(num_devices=1, precision=jq.DOUBLE, seed=[3]),
            tq.createQuESTEnv(device="cpu", precision=tq.DOUBLE, seed=[3]))


def _states(rng, num, n):
    z = rng.normal(size=(num, 1 << n)) + 1j * rng.normal(size=(num, 1 << n))
    return z / np.linalg.norm(z, axis=1, keepdims=True)


def _planes(z):
    return torch.as_tensor(np.stack([z.real, z.imag], axis=1),
                           dtype=torch.float64)


def _complex(planes):
    p = planes.numpy()
    return p[:, 0] + 1j * p[:, 1]


# -- the fused Kraus step ----------------------------------------------------

def _kraus_case(num_ops, num_traj=6, n=8, seed=0):
    rng = np.random.default_rng(seed + num_ops)
    kemb = np.stack([lk.embed_lane_matrix(
        rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4)), (2, 5))
        for _ in range(num_ops)])
    probs = rng.uniform(0.05, 1.0, size=(num_traj, num_ops))
    probs /= probs.sum(axis=1, keepdims=True)
    u = rng.uniform(size=num_traj)
    u[0] = 0.0                          # a leading zero branch is skipped
    u[1] = np.nextafter(1.0, 0.0)       # a trailing zero branch is not drawn
    u[2] = 1.0 - 1e-12
    if num_ops > 1:
        probs[0, 0] = 0.0
        probs[1, -1] = 0.0
        probs[3, num_ops // 2] = 0.0
    return kemb, probs, u, _states(rng, num_traj, n)


def _draw_reference(probs, u):
    """The inverse-CDF rule in numpy, term by term."""
    out = []
    for p, x in zip(probs, u):
        total = 0.0
        for v in p:
            total += v
        uu = min(x * total, total - total * np.finfo(np.float64).eps)
        cum, cnt = 0.0, 0
        for v in p:
            cum += v
            cnt += cum <= uu
        out.append(min(cnt, len(p) - 1))
    return np.asarray(out)


@pytest.mark.parametrize("num_ops", [1, 2, 4, 16, 64])
def test_fused_kraus_plain_matches_pallas_interpret(num_ops):
    n = 8
    kemb, probs, u, z = _kraus_case(num_ops)
    want = np.asarray(pk.fused_kraus_apply_batched(
        jnp.asarray(z), n, kemb, jnp.asarray(probs), jnp.asarray(u),
        interpret=True))
    states = _planes(z)
    pt, ut = torch.as_tensor(probs), torch.as_tensor(u)
    before = kk.fused_kraus_apply_batched.launches
    out = kk.fused_kraus_apply_batched(states, n, kemb, pt, ut)
    assert out is states
    assert kk.fused_kraus_apply_batched.launches == before
    assert np.abs(_complex(states) - want).max() <= TOL
    j = kk.draw_plain(pt, ut)[0].numpy()
    assert np.array_equal(j, _draw_reference(probs, u))
    assert (probs[np.arange(len(j)), j] > 0).all()


@pytest.mark.parametrize("num_ops", [1, 2, 16, 64])
def test_fused_kraus_index_output_is_the_draw(num_ops):
    """The optional index output (what the gradient walk records its
    branches from) holds draw_plain's indices, and asking for it changes
    nothing else."""
    n = 8
    kemb, probs, u, z = _kraus_case(num_ops)
    pt, ut = torch.as_tensor(probs), torch.as_tensor(u)
    index = torch.full((len(u),), -1, dtype=torch.int32)
    with_index = kk.fused_kraus_apply_batched(_planes(z), n, kemb, pt, ut,
                                              index)
    without = kk.fused_kraus_apply_batched(_planes(z), n, kemb, pt, ut)
    assert torch.equal(with_index, without)
    assert np.array_equal(index.numpy(), kk.draw_plain(pt, ut)[0].numpy())
    assert np.array_equal(index.numpy(), _draw_reference(probs, u))


def test_fused_kraus_wrapper_checks_its_inputs():
    kemb, probs, u, z = _kraus_case(2)
    states = _planes(z)
    pt, ut = torch.as_tensor(probs), torch.as_tensor(u)
    with pytest.raises(ValueError, match="at least one operator"):
        kk.fused_kraus_apply_batched(states, 8, np.zeros((0, 128, 128)),
                                     torch.zeros(6, 0, dtype=torch.float64),
                                     ut)
    with pytest.raises(ValueError, match="probabilities"):
        kk.fused_kraus_apply_batched(states, 8, kemb, pt[:, :1], ut)
    with pytest.raises(ValueError, match="float64"):
        kk.fused_kraus_apply_batched(states, 8, kemb, pt.float(), ut)
    with pytest.raises(ValueError, match="7 qubits"):
        kk.fused_kraus_apply_batched(states, 6, kemb, pt, ut)


@pytest.mark.parametrize("index", [
    torch.zeros(6, dtype=torch.int64), torch.zeros(5, dtype=torch.int32),
    torch.zeros(12, dtype=torch.int32)[::2]])
def test_fused_kraus_index_output_is_checked(index):
    kemb, probs, u, z = _kraus_case(2)
    with pytest.raises(ValueError, match="index_out"):
        kk.fused_kraus_apply_batched(_planes(z), 8, kemb,
                                     torch.as_tensor(probs),
                                     torch.as_tensor(u), index)


# -- whole programs -----------------------------------------------------------

def _bench_circuit(C, n, seed=5):
    """The "Pallas trajectory waves" circuit of bench.py: a ry column,
    damp(2, 0.2), a CNOT chain, dephase(4, 0.15), a ry column."""
    rng = np.random.default_rng(seed)
    c = C(n)
    for q in range(n):
        c.ry(q, float(rng.uniform(0.2, 2.8)))
    c.damp(2, 0.2)
    for q in range(n - 1):
        c.cnot(q, q + 1)
    c.dephase(4, 0.15)
    for q in range(n):
        c.ry(q, float(rng.uniform(0.2, 2.8)))
    return c


def _jax_uniforms(key, num_traj, num_channels):
    """The uniforms the JAX Pallas walker draws (trajectories.py:396-400
    and :538): channel c of trajectory t reads
    uniform(fold_in(split(key, T)[t], c))."""
    keys = jax.random.split(key, num_traj)
    return np.array([[float(jax.random.uniform(
        jax.random.fold_in(keys[t], c), dtype=jnp.float64))
        for c in range(num_channels)] for t in range(num_traj)])


@pytest.mark.parametrize("seed", [11, 12])
def test_trajectory_sweep_matches_the_pallas_walker(envs, seed):
    n, num_traj = 8, 12
    jp = _bench_circuit(JCircuit, n).compile_trajectories(
        envs[0], pallas="interpret")
    tp = _bench_circuit(tq.Circuit, n).compile_trajectories(envs[1])
    assert [i[0] for i in tp._items] == [i[0] for i in jp._pallas_items] \
        == ["layer", "kraus_fused", "layer", "kraus_fused", "layer"]
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jp.trajectory_sweep(num_traj, key=key,
                                          shard_trajectories=False))
    u = _jax_uniforms(key, num_traj, tp.num_channels)
    got = tp.trajectory_sweep(num_traj, uniforms=u).numpy()
    assert np.abs(got - want).max() <= TOL
    # ... and the run differs from trajectory to trajectory
    assert np.abs(got - got[:1]).max() > 1e-3


def _wide_channel_circuit(C, n, seed=7):
    """A three-qubit Pauli channel of 64 operators on lane qubits between
    two ry columns: more operators than any built-in channel has."""
    rng = np.random.default_rng(seed)
    paulis = [np.eye(2), np.array([[0, 1], [1, 0]]),
              np.array([[0, -1j], [1j, 0]]), np.diag([1.0, -1.0])]
    w = rng.uniform(0.1, 1.0, size=64)
    w /= w.sum()
    ops = [np.sqrt(w[i]) * np.kron(np.kron(paulis[i >> 4],
                                           paulis[(i >> 2) & 3]),
                                   paulis[i & 3]) for i in range(64)]
    c = C(n)
    for q in range(n):
        c.ry(q, float(rng.uniform(0.2, 2.8)))
    c.kraus(ops, [0, 3, 5])
    for q in range(n):
        c.ry(q, float(rng.uniform(0.2, 2.8)))
    return c


def test_wide_lane_channel_takes_the_fused_kraus_step(envs):
    """Every static channel on lane qubits goes through the fused Kraus
    step, whatever its operator count, as in the JAX walker."""
    n, num_traj = 8, 10
    jp = _wide_channel_circuit(JCircuit, n).compile_trajectories(
        envs[0], pallas="interpret")
    tp = _wide_channel_circuit(tq.Circuit, n).compile_trajectories(envs[1])
    assert [i[0] for i in tp._items] == [i[0] for i in jp._pallas_items] \
        == ["layer", "kraus_fused", "layer"]
    key = jax.random.PRNGKey(4)
    want = np.asarray(jp.trajectory_sweep(num_traj, key=key,
                                          shard_trajectories=False))
    u = _jax_uniforms(key, num_traj, tp.num_channels)
    got = tp.trajectory_sweep(num_traj, uniforms=u).numpy()
    assert np.abs(got - want).max() <= TOL


def _density_expectation(jenv, circuit, terms, coeffs):
    cc = circuit.compile(jenv, density=True, pallas=False)
    return float(np.asarray(cc.expectation_sweep(
        np.zeros((1, 0)), (terms, coeffs)))[0])


def _noisy_small(C, n):
    """A with_noise circuit at 6 qubits (below the layer kernel's width:
    every op takes the plain path) with a channel on two qubits."""
    c = C(n)
    for q in range(n):
        c.h(q)
    for q in range(n - 1):
        c.cnot(q, q + 1)
    c.ry(3, 0.7).two_qubit_depolarise(1, 4, 0.2)
    return c.with_noise(p1=0.03, p2=0.06, damping=0.04)


@pytest.mark.parametrize("which", ["bench8", "noisy6", "row_channel9"])
def test_expectation_within_5_stderr_of_density_path(envs, which):
    jenv, tenv = envs
    if which == "bench8":
        n = 8
        jc, tc = _bench_circuit(JCircuit, n), _bench_circuit(tq.Circuit, n)
    elif which == "noisy6":
        n = 6
        jc, tc = _noisy_small(JCircuit, n), _noisy_small(tq.Circuit, n)
    else:
        # a channel on a row qubit: the plain channel path beside layers
        n = 9
        jc = _bench_circuit(JCircuit, n).damp(8, 0.3).h(8)
        tc = _bench_circuit(tq.Circuit, n).damp(8, 0.3).h(8)
    terms = [[(q, 3)] for q in range(n)] + [[(0, 1), (1, 1)],
                                            [(2, 2), (n - 1, 2)]]
    coeffs = list(np.random.default_rng(n).normal(size=len(terms)))
    oracle = _density_expectation(jenv, jc, terms, coeffs)
    tp = tc.compile_trajectories(tenv)
    mean, err = tp.expectation(terms, coeffs, num_trajectories=384,
                               seed=21)
    assert err > 0.0
    assert abs(mean - oracle) <= 5.0 * err
    stats = tp.last_traj_stats
    assert stats["trajectories_run"] == 384 and stats["waves"] == 12


def test_param_channels_and_batch_rows_within_5_stderr(envs):
    """expectation_batch binds a Param damping strength and a Param angle
    per row; each row's mean lies within 5 stderr of the density path at
    that row's values."""
    jenv, tenv = envs
    n = 7

    def build(C, P, g, a):
        c = C(n)
        for q in range(n):
            c.h(q)
        c.damp(1, P("g") if P else g).rx(5, P("a") if P else a)
        c.cnot(1, 5).dephase(5, 0.2)
        return c
    tp = build(tq.Circuit, TParam, None, None).compile_trajectories(tenv)
    assert tp.param_names == ("g", "a")
    terms = [[(1, 3)], [(5, 3)], [(1, 1), (5, 2)]]
    coeffs = [0.8, -0.5, 0.3]
    pm = np.array([[0.1, 0.4], [0.6, 1.9]])
    means, errs, info = tp.expectation_batch(pm, (terms, coeffs), 256,
                                             seed=4)
    assert info["batch_rows"] == 2 and info["trajectories_run"] == 256
    for b, (g, a) in enumerate(pm):
        oracle = _density_expectation(jenv, build(JCircuit, None, g, a),
                                      terms, coeffs)
        assert abs(means[b] - oracle) <= 5.0 * errs[b]


@pytest.mark.parametrize("max_t,wave,mult", [
    (1, 1, 1), (100, 32, 1), (96, 32, 1), (10, 4, 3), (1024, 128, 1)])
def test_plan_waves_matches_jax(max_t, wave, mult):
    assert ttraj.plan_waves(max_t, wave, mult) == \
        jtraj.plan_waves(max_t, wave, mult)


def test_plan_waves_rejects_empty():
    for args in ((0, 4), (4, 0)):
        with pytest.raises(ValueError):
            ttraj.plan_waves(*args)


def test_welford_statistics_match_jax():
    rng = np.random.default_rng(8)
    vals = rng.normal(size=(2, 12))
    mask = np.ones(12, dtype=bool)
    mask[9:] = False
    mine = tred.welford_wave(torch.as_tensor(vals), torch.as_tensor(mask))
    ref = jred.welford_wave(jnp.asarray(vals), jnp.asarray(mask))
    for a, b in zip(mine, ref):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= TOL
    other = tuple(torch.as_tensor(np.array(x)) for x in
                  jred.welford_wave(jnp.asarray(vals[:, ::-1]),
                                    jnp.asarray(mask)))
    merged = tred.welford_merge(mine, other)
    ref_m = jred.welford_merge(ref, tuple(jnp.asarray(x.numpy())
                                          for x in other))
    for a, b in zip(merged, ref_m):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= TOL
    assert np.allclose(tred.welford_stderr(merged[0].numpy(),
                                           merged[2].numpy()),
                       jred.welford_stderr(np.asarray(ref_m[0]),
                                           np.asarray(ref_m[2])),
                       rtol=1e-14)
    assert np.isinf(tred.welford_stderr(1.0, 0.0))


def test_same_seed_same_estimate(envs):
    tp = _bench_circuit(tq.Circuit, 8).compile_trajectories(envs[1])
    terms, coeffs = [[(q, 3)] for q in range(8)], [1.0] * 8
    runs = []
    for _ in range(2):
        mean, err = tp.expectation(terms, coeffs, num_trajectories=256,
                                   seed=3, wave_size=32,
                                   sampling_budget=0.2)
        runs.append((mean, err, tp.last_traj_stats["trajectories_run"]))
    assert runs[0] == runs[1]
    assert runs[0][2] < 256 and tp.last_traj_stats["early_stopped"]
    other = tp.expectation(terms, coeffs, num_trajectories=256, seed=4,
                           wave_size=32, sampling_budget=0.2)
    assert other != runs[0][:2]


def test_trajectories_keep_unit_norm(envs):
    tp = _noisy_small(tq.Circuit, 6).compile_trajectories(envs[1])
    planes = tp.trajectory_sweep(64)
    norms = (planes ** 2).sum(dim=(1, 2))
    assert torch.allclose(norms, torch.ones(64, dtype=torch.float64),
                          atol=1e-12)


def test_run_is_one_row_of_the_sweep(envs):
    tp = _bench_circuit(tq.Circuit, 8).compile_trajectories(envs[1])
    u = np.random.default_rng(2).uniform(size=(5, tp.num_channels))
    sweep = tp.trajectory_sweep(5, uniforms=u)
    q = tq.createQureg(8, envs[1])
    tq.initZeroState(q)
    tp.run(q, uniforms=u[3])
    assert torch.equal(q.state, sweep[3])


def test_sample_follows_the_mixture(envs):
    """Shots from sample() follow the average |amp|^2 of the ensemble they
    were stratified over (chi-square with a fixed seed)."""
    from scipy import stats
    tp = _noisy_small(tq.Circuit, 6).compile_trajectories(envs[1])
    u = np.random.default_rng(6).uniform(size=(40, tp.num_channels))
    idx, totals = tp.sample(6000, 40, seed=9, uniforms=u)
    assert idx.shape == (6000,) and np.allclose(totals, 1.0, atol=1e-12)
    probs = (np.abs(_complex(tp.trajectory_sweep(40, uniforms=u))) ** 2
             ).mean(axis=0)
    counts = np.bincount(idx, minlength=64)
    keep = probs * 6000 >= 5
    chi2 = float(((counts[keep] - probs[keep] * 6000) ** 2
                  / (probs[keep] * 6000)).sum())
    assert stats.chi2.sf(chi2, keep.sum() - 1) > 1e-4


def test_average_density_and_its_guard(envs, monkeypatch):
    tp = _bench_circuit(tq.Circuit, 8).compile_trajectories(envs[1])
    rho = tp.average_density(None, 16)
    assert rho.shape == (256, 256)
    assert abs(np.trace(rho) - 1.0) <= 1e-12
    assert np.abs(rho - rho.conj().T).max() <= 1e-14
    monkeypatch.setenv(ttraj.DENSITY_DEBUG_QUBITS_ENV, "7")
    with pytest.raises(ttraj.DensityMaterialisationError, match="8 qubits"):
        tp.average_density(None, 4)


def test_expectation_checks_its_inputs(envs):
    tp = _bench_circuit(tq.Circuit, 8).compile_trajectories(envs[1])
    with pytest.raises(ValueError, match=">= 2"):
        tp.expectation([[(0, 3)]], [1.0], num_trajectories=1)
    with pytest.raises(tq.QuESTError):
        tp.expectation([[(9, 3)]], [1.0], num_trajectories=4)
    with pytest.raises(ValueError, match="uniforms"):
        tp.trajectory_sweep(4, uniforms=np.zeros((4, 5)))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the fused Kraus kernel runs only on the "
                    "card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("num_ops", [2, 16, 64])
def test_kraus_kernel_matches_plain_on_card(card, dtype, tol, num_ops):
    n = 16
    kemb, probs, u, z = _kraus_case(num_ops, num_traj=8, n=n)
    base = torch.as_tensor(np.stack([z.real, z.imag], axis=1), dtype=dtype,
                           device=card)
    pt = torch.as_tensor(probs, dtype=dtype, device=card)
    ut = torch.as_tensor(u, dtype=dtype, device=card)
    want = kk.fused_kraus_apply_batched_plain(base.clone(), n, kemb, pt, ut)
    before = kk.fused_kraus_apply_batched.launches
    got = kk.fused_kraus_apply_batched(base.clone(), n, kemb, pt, ut)
    torch.cuda.synchronize()
    assert kk.fused_kraus_apply_batched.launches == before + 1
    assert float((got - want).abs().max() / want.abs().max()) <= tol
