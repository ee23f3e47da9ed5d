"""The PyTorch port's trajectory gradients (``TrajectoryProgram.
expectation_grad``/``expectation_grad_batch``, an adjoint walk over each
wave, ``quest_tpu_torch/ops/trajectories.py``) against the JAX package's,
on the CPU in float64.

- ``reductions.score_surrogate`` against the JAX package's: value and
  gradient, with and without a baseline (1e-12);
- per trajectory: the port's gradient rows against ``jax.value_and_grad``
  through the JAX package's surrogate, built from its own functions in
  ``_apply_core_lp``'s op order with the port's recorded branches
  (1e-10 of max|g|, with and without a baseline);
- exact: on a two-channel circuit, the sum over every branch sequence of
  its probability times its gradient row is the JAX package's density
  gradient (1e-10), whatever the baseline;
- the ensemble within max(5 stderr, 1e-3 max|g|) of the JAX package's and
  the port's density gradients, on ``tests/test_gradients.py``'s noisy
  circuit. The floor: a component whose estimated variance is near zero
  can sit several of its own stderrs off an exact gradient (the
  reference's own 5-stderr check fails that way on one component);
- the value column is ``expectation``'s mean bit for bit; replays; early
  stopping on every component; the typed errors; ``apply``,
  ``program_digest`` and ``dispatch_stats``; the kernel items against the
  plain walk; the walk's replay past its memory cap.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quest_tpu as jq
from quest_tpu.circuits import Circuit as JCircuit
from quest_tpu.core import apply as japply
from quest_tpu.ops import reductions as jred
import quest_tpu_torch as tq
from quest_tpu_torch.ops import reductions as tred
from torch_threads import one_blas_thread  # noqa: F401

TOL = 1e-12
ROW_TOL = 1e-10
HAM = ([[(0, 3)], [(1, 1), (2, 1)], [(0, 2), (1, 3)]], [0.7, -0.4, 0.25])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per worker: the suite runs in several worker
    processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def envs():
    return (jq.createQuESTEnv(num_devices=1, precision=jq.DOUBLE, seed=[3]),
            tq.createQuESTEnv(device="cpu", precision=tq.DOUBLE, seed=[3]))


def _noisy(C):
    """tests/test_gradients.py's TestTrajectoryGradients._noisy."""
    c = C(3)
    for q in range(3):
        c.ry(q, c.parameter(f"a{q}"))
    c.cnot(0, 1)
    c.cnot(1, 2)
    for q in range(3):
        c.rz(q, c.parameter(f"b{q}"))
    return c.with_noise(p1=0.05, damping=0.02)


def _noisy_params():
    names = _noisy(tq.Circuit).param_names
    vals = np.random.default_rng(1234).uniform(0, 2 * np.pi, len(names))
    return dict(zip(names, vals)), vals


def _density_grad(env, circuit, pv, ham):
    vals, grads = circuit.compile(env, density=True).value_and_grad_sweep(
        np.asarray(pv)[None], ham)
    return float(np.asarray(vals)[0]), np.asarray(grads)[0]


def _grad_rows(tp, uniforms, pv, ham, baseline):
    """The port's per-trajectory rows of one gradient wave: (values,
    grads, draws (T, C) branch indices, (T,) probabilities of the drawn
    sequences)."""
    num_traj = len(uniforms)
    n = tp.num_qubits
    terms, coeffs = tred.validated_pauli_terms(*ham, n)
    operands = tred.pauli_terms_operands(terms, coeffs, n)
    vals, grads, tape = tp._grad_rows(
        tp._start(None), torch.as_tensor(uniforms), np.repeat(
            np.asarray(pv)[None], num_traj, axis=0),
        torch.full((num_traj,), float(baseline), dtype=torch.float64),
        operands)
    draws = np.stack([tape.draws[c][0].numpy()
                      for c in range(tp.num_channels)], axis=1)
    prob = np.prod(np.stack([tape.draws[c][1].numpy()
                             for c in range(tp.num_channels)], axis=1),
                   axis=1)
    return vals.numpy(), grads.numpy(), draws, prob


# -- (a) the surrogate ---------------------------------------------------------

@pytest.mark.parametrize("baseline", [0.0, 0.3])
def test_score_surrogate_matches_jax(baseline):
    theta = np.array([0.4, -1.1, 2.3])

    def value(xp, t):
        return xp.sin(t[0]) * xp.cos(t[1]) + t[2] ** 2

    def logq(xp, t):
        return xp.log(0.2 + xp.cos(t[0] + t[2]) ** 2) + 0.5 * t[1]

    def jfn(t):
        return jred.score_surrogate(value(jnp, t), logq(jnp, t),
                                    baseline=baseline)

    want_v, want_g = jax.value_and_grad(jfn)(jnp.asarray(theta))
    t = torch.tensor(theta, requires_grad=True)
    got = tred.score_surrogate(value(torch, t), logq(torch, t),
                               baseline=baseline)
    got.backward()
    assert abs(float(got.detach()) - float(want_v)) <= TOL
    assert np.abs(t.grad.numpy() - np.asarray(want_g)).max() <= TOL
    # the value is the primal, the gradient pathwise plus score term
    with torch.no_grad():
        v = value(torch, torch.tensor(theta))
    assert abs(float(got.detach()) - float(v)) <= TOL


# -- (b) per trajectory, against jax.value_and_grad ------------------------------

def _jax_surrogate_fn(jp, ham):
    """``jax.value_and_grad`` of the JAX package's score surrogate for one
    trajectory whose branches ``js`` are given, from its own functions in
    ``_apply_core_lp``'s op order (trajectories.py:296-367)."""
    n = jp.num_qubits
    terms, coeffs = ham
    _, xm, ym, zm, cf = jp._pauli_operands(
        [tuple((int(q), int(c)) for q, c in t) for t in terms], coeffs)
    xm, ym, zm, cf = (jnp.asarray(a) for a in (xm, ym, zm, cf))
    cdtype = jnp.complex128

    def surrogate(v, js, b):
        params = {nm: v[i] for i, nm in enumerate(jp.param_names)}
        psi = jnp.zeros((1 << n,), cdtype).at[0].set(1.0)
        logq = jnp.zeros((), jnp.float64)
        for kind, targets, data, extra in jp._ops:
            if kind in ("u", "u_fn"):
                u = data(params) if kind == "u_fn" else data
                psi = japply.apply_unitary(psi, n, jnp.asarray(u, cdtype),
                                           targets, *extra)
            elif kind in ("diag", "diag_fn"):
                d = data(params) if kind == "diag_fn" else data
                psi = japply.apply_diagonal(psi, n, targets,
                                            jnp.asarray(d, cdtype))
            else:
                if kind == "kraus_fn":
                    kstack = jnp.stack([jnp.asarray(m).astype(cdtype)
                                        for m in data(params)])
                    estack = jnp.einsum("kba,kbc->kac", jnp.conj(kstack),
                                        kstack)
                else:
                    kstack = jnp.asarray(data[0], cdtype)
                    estack = jnp.asarray(data[1], cdtype)
                probs = jp._channel_probs(psi, targets, estack)
                j = js[extra]
                tiny = jnp.finfo(probs.dtype).tiny
                logp = jnp.log(jnp.maximum(probs, tiny))
                logq = logq + logp[j] - jnp.log(
                    jnp.maximum(jnp.sum(probs), tiny))
                psi = japply.apply_unitary(psi, n, kstack[j], targets) \
                    * jax.lax.rsqrt(jnp.maximum(probs[j], tiny))
        val = jred.pauli_sum_total_sv(psi, xm, ym, zm, cf)
        return jred.score_surrogate(val, logq, baseline=b), val

    return jax.jit(jax.value_and_grad(surrogate, has_aux=True))


@pytest.fixture(scope="module")
def noisy_programs(envs):
    jenv, tenv = envs
    jp = _noisy(JCircuit).compile_trajectories(jenv)
    tp = _noisy(tq.Circuit).compile_trajectories(tenv)
    assert [op[0] for op in tp._ops] == [op[0] for op in jp._ops]
    assert tp.param_names == jp.param_names
    return jp, tp, _jax_surrogate_fn(jp, HAM)


@pytest.mark.parametrize("baseline", [0.0, 0.4])
def test_rows_match_jax_value_and_grad_on_the_same_branches(
        noisy_programs, baseline):
    jp, tp, fn = noisy_programs
    _, pv = _noisy_params()
    uniforms = np.random.default_rng(7).uniform(size=(12, tp.num_channels))
    vals, grads, draws, _ = _grad_rows(tp, uniforms, pv, HAM, baseline)
    # branches other than 0 were drawn, so the score term is exercised
    assert draws.max() > 0
    for t in range(len(uniforms)):
        (_, want_v), want_g = fn(jnp.asarray(pv), jnp.asarray(draws[t]),
                                 jnp.float64(baseline))
        want_g = np.asarray(want_g)
        assert abs(vals[t] - float(want_v)) <= TOL
        scale = max(np.abs(want_g).max(), 1e-12)
        assert np.abs(grads[t] - want_g).max() <= ROW_TOL * scale, t


# -- (c) exact, by enumerating every branch sequence -------------------------------

def _rx(xp, angle):
    """rx(angle) built with ``xp`` (torch or jax.numpy) ops."""
    cos, sin = xp.cos(angle / 2), xp.sin(angle / 2)
    return xp.stack([xp.stack([cos + 0j, -1j * sin]),
                     xp.stack([-1j * sin, cos + 0j])])


def _two_channels(C, xp):
    """Params before and between two K = 2 channels: a controlled Param
    gate conditioned on 0, a two-qubit Param diagonal, and a Param rate
    on the first channel (its operators' own derivative enters)."""
    c = C(2)
    c.ry(0, c.parameter("a")).ry(1, c.parameter("b"))
    c.cnot(0, 1)
    c.damp(0, c.parameter("g"))
    name = c.parameter("c").name
    c.gate(lambda p: _rx(xp, p[name]), (0,), (1,), control_states=[0])
    c.cnot(1, 0).crz(0, 1, c.parameter("d"))
    c.dephase(1, 0.2)
    c.h(0)
    return c


TWO_HAM = ([[(0, 3)], [(1, 1)], [(0, 1), (1, 2)], [(0, 2), (1, 3)]],
           [0.6, -0.35, 0.45, 0.2])
TWO_PV = np.array([0.7, 1.9, 0.3, -0.8, 2.2])


@pytest.fixture(scope="module")
def two_channel_density(envs):
    return _density_grad(envs[0], _two_channels(JCircuit, jnp), TWO_PV,
                         TWO_HAM)


@pytest.mark.parametrize("baseline", [0.0, 0.3])
def test_enumeration_equals_the_density_gradient(envs, two_channel_density,
                                                 baseline):
    tp = _two_channels(tq.Circuit, torch).compile_trajectories(envs[1])
    assert tp.param_names == ("a", "b", "g", "c", "d")
    assert [item[0] for item in tp._items] == [
        "u_fn", "u_fn", "u", "kraus_fn", "u_fn", "u", "diag_fn", "kraus", "u"]
    assert tp.num_channels == 2
    # u = 0 draws branch 0 and u -> 1 the last, whatever the probabilities
    hi = np.nextafter(1.0, 0.0)
    uniforms = np.array([[0.0, 0.0], [0.0, hi], [hi, 0.0], [hi, hi]])
    vals, grads, draws, prob = _grad_rows(tp, uniforms, TWO_PV, TWO_HAM,
                                          baseline)
    assert draws.tolist() == [[0, 0], [0, 1], [1, 0], [1, 1]]
    assert abs(prob.sum() - 1.0) <= TOL
    want_v, want_g = two_channel_density
    assert abs(float(prob @ vals) - want_v) <= ROW_TOL
    assert np.abs(prob @ grads - want_g).max() <= ROW_TOL
    # every parameter moves the objective
    assert np.abs(want_g).min() > 1e-3


# -- (d) the ensemble ------------------------------------------------------------

def test_ensemble_within_stderr_of_the_density_gradients(envs):
    jenv, tenv = envs
    params, pv = _noisy_params()
    _, g_jax = _density_grad(jenv, _noisy(JCircuit), pv, HAM)
    _, g_port = _density_grad(tenv, _noisy(tq.Circuit), pv, HAM)
    assert np.abs(g_port - g_jax).max() <= 1e-12
    tp = _noisy(tq.Circuit).compile_trajectories(tenv)
    _, grad, err = tp.expectation_grad(HAM[0], HAM[1], num_trajectories=2400,
                                       params=params, seed=11, wave_size=600)
    assert grad.shape == (6,) and err.shape == (7,)
    assert np.all(err > 0)
    bar = np.maximum(5.0 * err[1:], 1e-3 * np.abs(g_jax).max())
    assert np.all(np.abs(grad - g_jax) <= bar)
    assert np.all(np.abs(grad - g_port) <= bar)
    stats = tp.last_traj_stats
    assert stats["kind"] == "gradient" and stats["waves"] == 4


# -- (e) the value column, replay ----------------------------------------------------

def test_value_column_is_the_expectation_mean_bit_for_bit(envs):
    params, _ = _noisy_params()
    tp = _noisy(tq.Circuit).compile_trajectories(envs[1])
    kw = dict(num_trajectories=96, params=params, seed=5, wave_size=32)
    val, grad, err = tp.expectation_grad(HAM[0], HAM[1], **kw)
    mean, stderr = tp.expectation(HAM[0], HAM[1], **kw)
    assert val == mean and err[0] == stderr
    val2, grad2, err2 = tp.expectation_grad(HAM[0], HAM[1], **kw)
    assert val2 == val
    assert np.array_equal(grad2, grad) and np.array_equal(err2, err)
    # a caller's uniform block: the same block as the seed's
    u = torch.rand((96, tp.num_channels), dtype=torch.float64,
                   generator=torch.Generator().manual_seed(5))
    val3, grad3, _ = tp.expectation_grad(
        HAM[0], HAM[1], num_trajectories=96, params=params, wave_size=32,
        uniforms=u.numpy())
    assert val3 == val and np.array_equal(grad3, grad)


# -- (f) the (B, T) form ---------------------------------------------------------------

def _light(C):
    c = C(2)
    c.ry(0, c.parameter("a"))
    c.cnot(0, 1)
    c.ry(1, c.parameter("b"))
    return c.with_noise(p1=0.08)


def test_batch_early_stop_against_budget_and_determinism(envs):
    ham = ([[(0, 3)], [(1, 1)]], [1.0, -0.5])
    tp = _light(tq.Circuit).compile_trajectories(envs[1])
    pm = np.full((2, len(tp.param_names)), 0.3)
    kw = dict(sampling_budget=0.25, wave_size=150, seed=3)
    vals, grads, errs, info = tp.expectation_grad_batch(pm, ham, 2000, **kw)
    assert info["kind"] == "gradient"
    assert info["early_stopped"]
    assert info["trajectories_run"] < 2000
    # the stop decision covered EVERY component of every live row
    assert errs.shape == (2, 3) and np.all(errs <= 0.25)
    assert vals.shape == (2,) and grads.shape == (2, len(tp.param_names))
    # the rows draw their own uniforms
    assert vals[0] != vals[1]
    vals2, grads2, errs2, info2 = tp.expectation_grad_batch(pm, ham, 2000,
                                                            **kw)
    assert info2["trajectories_run"] == info["trajectories_run"]
    assert np.array_equal(vals, vals2) and np.array_equal(grads, grads2)
    assert np.array_equal(errs, errs2)


def test_batch_rows_are_their_own_ensembles(envs):
    """Row b of the batch is the single-row loop at row b's parameters
    and uniforms."""
    ham = ([[(0, 3)], [(1, 1)]], [1.0, -0.5])
    tp = _light(tq.Circuit).compile_trajectories(envs[1])
    pm = np.array([[0.3, 1.2], [2.0, -0.4]])
    vals, grads, _, info = tp.expectation_grad_batch(pm, ham, 64,
                                                     wave_size=32, seed=9)
    assert info["trajectories_run"] == 64 and info["waves"] == 2
    u = torch.rand((2, 64, tp.num_channels), dtype=torch.float64,
                   generator=torch.Generator().manual_seed(9))
    for b in range(2):
        v, g, _ = tp.expectation_grad(ham[0], ham[1], num_trajectories=64,
                                      params=pm[b], wave_size=32,
                                      uniforms=u[b].numpy())
        assert abs(v - vals[b]) <= TOL
        assert np.abs(g - grads[b]).max() <= TOL


# -- (g) the typed errors ---------------------------------------------------------------

def _message(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_rejections_carry_the_references_messages(envs):
    jenv, tenv = envs
    ham = ([[(0, 3)]], [1.0])

    def paramless(C):
        return C(2).h(0).with_noise(p1=0.05)

    jpl = paramless(JCircuit).compile_trajectories(jenv)
    tpl = paramless(tq.Circuit).compile_trajectories(tenv)
    jp = _light(JCircuit).compile_trajectories(jenv)
    tp = _light(tq.Circuit).compile_trajectories(tenv)
    cases = [
        lambda p: p.expectation_grad(*ham, num_trajectories=16),
        # the paramless rejection comes before the shape check
        lambda p: p.expectation_grad_batch(np.zeros((2, 3)), ham, 16),
        lambda p: p.expectation_grad_batch(np.zeros((1, 0)), ham, 16),
    ]
    for case in cases:
        want = _message(lambda: case(jpl))
        assert "nothing to differentiate" in want
        assert _message(lambda: case(tpl)) == want
    for case in (
            lambda p: p.expectation_grad_batch(np.zeros((2, 3)), ham, 16),
            lambda p: p.expectation_grad_batch(np.zeros(2), ham, 16),
            lambda p: p.expectation_grad_batch(np.zeros((1, 2)), ham, 1),
            lambda p: p.expectation_grad(*ham, num_trajectories=1,
                                         params={"a": 0.1, "b": 0.2}),
            lambda p: p.expectation_grad(*ham, num_trajectories=None)):
        assert _message(lambda: case(tp)) == _message(lambda: case(jp))
    with pytest.raises(ValueError, match="pauli qubit 5"):
        tp.expectation_grad([[(5, 3)]], [1.0], num_trajectories=4,
                            params=[0.1, 0.2])


# -- (h) apply, program_digest, dispatch_stats ----------------------------------------------

def test_apply_is_run_on_the_same_uniforms(envs):
    tenv = envs[1]
    tp = _noisy(tq.Circuit).compile_trajectories(tenv)
    params, _ = _noisy_params()
    u = np.random.default_rng(2).uniform(size=tp.num_channels)
    q = tq.createQureg(3, tenv)
    tq.initPlusState(q)
    start = q.state.clone()
    out = tp.apply(start, u, params)
    assert torch.equal(start, q.state)           # the pure form copies
    tp.run(q, params=params, uniforms=u)
    assert torch.equal(out, q.state)
    assert out.shape == (2, 8)
    with pytest.raises(ValueError, match="uniforms"):
        tp.apply(start, np.zeros(3), params)


def _static_noisy(C):
    c = C(8)
    for q in range(8):
        c.ry(q, 0.1 + 0.3 * q)
    for q in range(7):
        c.cnot(q, q + 1)
    c.damp(2, 0.2).dephase(5, 0.1).rz(7, 0.4)
    return c.with_noise(p1=0.01)


def test_program_digest_and_dispatch_stats(envs):
    jenv, tenv = envs
    jp = _static_noisy(JCircuit).compile_trajectories(jenv)
    tp = _static_noisy(tq.Circuit).compile_trajectories(tenv)
    assert tp.program_digest == jp.program_digest
    assert tp.program_digest == tp.program_digest          # cached
    other = _static_noisy(tq.Circuit).h(0).compile_trajectories(tenv)
    assert other.program_digest != tp.program_digest
    js, ts = jp.dispatch_stats(), tp.dispatch_stats()
    assert (ts.gates_in, ts.kernels_out, ts.relayouts) == \
        (js.gates_in, js.kernels_out, 0)
    assert ts.batch_size == 0 and ts.batch_sharding_mode == "none"
    tp.expectation([[(0, 3)]], [1.0], num_trajectories=24, wave_size=8,
                   seed=1)
    ts = tp.dispatch_stats()
    assert (ts.batch_size, ts.host_syncs_avoided) == (24, 21)
    tp.trajectory_sweep(5)
    assert (tp.dispatch_stats().batch_size,
            tp.dispatch_stats().host_syncs_avoided) == (5, 4)


# -- (i) the kernel items against the plain walk -------------------------------------------------

def _param_noisy(C, n=8):
    """bench.py's trajectory-wave circuit with its ry columns as Params,
    plus a channel on a row qubit and a Param rate."""
    c = C(n)
    for q in range(n):
        c.ry(q, c.parameter(f"a{q}"))
    c.damp(2, 0.2)
    for q in range(n - 1):
        c.cnot(q, q + 1)
    c.dephase(4, 0.15).damp(n - 1, c.parameter("g"))
    for q in range(n):
        c.ry(q, c.parameter(f"b{q}"))
    return c


def _param_noisy_pv(tp):
    rng = np.random.default_rng(33)
    pv = rng.uniform(0.2, 2.8, len(tp.param_names))
    pv[tp.param_names.index("g")] = 0.3
    return pv


def test_kernel_items_equal_the_plain_walk(envs):
    tenv = envs[1]
    kernel = _param_noisy(tq.Circuit).compile_trajectories(
        tenv, pallas="interpret")
    plain = _param_noisy(tq.Circuit).compile_trajectories(tenv,
                                                          pallas=False)
    kinds = [item[0] for item in kernel._items]
    assert "layer" in kinds and kinds.count("kraus_fused") == 2 \
        and "kraus_fn" in kinds
    assert "layer" not in [item[0] for item in plain._items]
    pv = _param_noisy_pv(kernel)
    terms = [[(q, 3)] for q in range(8)] + [[(0, 1), (3, 1)]]
    coeffs = list(np.random.default_rng(8).normal(size=len(terms)))
    kw = dict(num_trajectories=24, params=pv, wave_size=12, seed=6)
    a = kernel.expectation_grad(terms, coeffs, **kw)
    b = plain.expectation_grad(terms, coeffs, **kw)
    assert abs(a[0] - b[0]) <= TOL
    assert np.abs(a[1] - b[1]).max() <= TOL * max(1.0, np.abs(b[1]).max())
    assert np.abs(a[1]).max() > 1e-3


def test_replay_past_the_memory_cap_is_exact(envs):
    """With no room to store channel inputs the reverse replays the
    recorded branches from the start: the same rows, bit for bit."""
    tenv = envs[1]
    tp = _param_noisy(tq.Circuit).compile_trajectories(tenv,
                                                       pallas="interpret")
    pv = _param_noisy_pv(tp)
    uniforms = np.random.default_rng(4).uniform(size=(6, tp.num_channels))
    ham = ([[(q, 3)] for q in range(8)], list(np.linspace(-1, 1, 8)))
    stored = _grad_rows(tp, uniforms, pv, ham, 0.2)
    tp._grad_store_bytes = 0
    try:
        replayed = _grad_rows(tp, uniforms, pv, ham, 0.2)
    finally:
        tp._grad_store_bytes = None
    for a, b in zip(stored, replayed):
        assert np.array_equal(a, b)
