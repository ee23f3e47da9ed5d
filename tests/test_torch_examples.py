"""The port's examples (``quest_tpu_torch/examples/``) against the same
quantities computed through the JAX package in this process, at DOUBLE on
the host.

Each test calls a port script's ``main(device="cpu")`` (the Adam loops of
``vqe`` and the trajectory ensemble at fewer steps than the scripts run)
and recomputes its numbers with the JAX package: deterministic values
within 1e-12; the Adam loops' final parameters within 1e-8 of optax's over
the same steps, and the energies at the port's parameters within 1e-12;
results that depend on the random stream (the packages draw from different
generators) as facts: Shor's factors, the QAOA cut, shot totals, the
trajectory ensemble within 5 standard errors of the exact density. The JAX
scripts themselves run in ``tests/test_examples.py``.
"""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import optax
import pytest

import quest_tpu as jq
from quest_tpu import algorithms as jalg
from quest_tpu.core.packing import pack as jpack
from quest_tpu_torch.examples import (bernstein_vazirani, damping_example,
                                      noise_fitting, noisy_trajectories,
                                      production_workflow, qaoa,
                                      quad_precision, shor, tpu_features,
                                      tutorial_example, vqe)
from torch_threads import one_blas_thread  # noqa: F401

TOL = 1e-12
ADAM_TOL = 1e-8


def quiet(fn, *args, **kwargs):
    """Run an example's ``main`` with its printout swallowed."""
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


def jenv(seed=1, **kw):
    return jq.createQuESTEnv(num_devices=1, precision=jq.DOUBLE, seed=[seed],
                             **kw)


def optax_adam(vg, start, steps, lr, clip=None):
    """optax.adam's loop as the JAX package's examples run it."""
    opt = optax.adam(lr)
    p = jnp.asarray(start)
    state = opt.init(p)
    for _ in range(steps):
        _, g = vg(p)
        updates, state = opt.update(g, state)
        p = optax.apply_updates(p, updates)
        if clip is not None:
            p = jnp.clip(p, *clip)
    return np.asarray(p)


def test_every_script_raises_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA|none is available"):
        quiet(tutorial_example.main)


def test_tutorial_example():
    out = quiet(tutorial_example.main, device="cpu")
    env = jenv()
    q = jq.createQureg(3, env)
    jq.initZeroState(q)
    jq.hadamard(q, 0)
    jq.controlledNot(q, 0, 1)
    jq.rotateY(q, 2, 0.1)
    jq.multiControlledPhaseFlip(q, [0, 1, 2])
    u = np.array([[0.5 + 0.5j, 0.5 - 0.5j], [0.5 - 0.5j, 0.5 + 0.5j]])
    jq.unitary(q, 0, u)
    a, b = 0.5 + 0.5j, 0.5 - 0.5j
    jq.compactUnitary(q, 1, a, b)
    jq.rotateAroundAxis(q, 2, 3.14 / 2, (1.0, 0.0, 0.0))
    jq.controlledCompactUnitary(q, 0, 1, a, b)
    jq.multiControlledUnitary(q, [0, 1], 2, u)
    toff = np.eye(8, dtype=complex)
    toff[6:, 6:] = [[0, 1], [1, 0]]
    jq.multiQubitUnitary(q, [0, 1, 2], toff)
    assert abs(out["prob_amp_111"] - jq.getProbAmp(q, 7)) < TOL
    assert abs(out["prob_q2_is_1"] - jq.calcProbOfOutcome(q, 2, 1)) < TOL
    # the measurements: the same collapse on the JAX side, then the same
    # probability of the port's second outcome
    assert out["outcome_q0"] in (0, 1) and out["outcome_q2"] in (0, 1)
    jq.collapseToOutcome(q, 0, out["outcome_q0"])
    p2 = jq.calcProbOfOutcome(q, 2, out["outcome_q2"])
    assert abs(out["prob_q2_outcome"] - p2) < TOL


def test_damping_example():
    out = quiet(damping_example.main, device="cpu")
    env = jenv()
    d = jq.createDensityQureg(1, env)
    jq.initPlusState(d)
    want = []
    for step in range(11):
        if step:
            jq.mixDamping(d, 0, 0.1)
        want.append(np.array([[complex(jq.getDensityAmp(d, r, c))
                               for c in range(2)] for r in range(2)]))
    assert len(out["states"]) == 11
    for got, ref in zip(out["states"], want):
        assert np.abs(got - ref).max() < TOL


def test_bernstein_vazirani():
    out = quiet(bernstein_vazirani.main, device="cpu")
    env = jenv()
    q = jq.createQureg(10, env)
    jalg.bernstein_vazirani(10, out["secret"]).compile(env).run(q)
    assert out["measured"] == out["secret"]
    assert abs(out["prob_secret"] - jq.getProbAmp(q, out["secret"])) < TOL


def test_shor():
    out = quiet(shor.main, device="cpu")
    assert sorted(out["factors"]) == [3, 5]
    assert out["num_gates"] == len(jalg.order_finding(7, 15, 8).ops)


def test_quad_precision():
    out = quiet(quad_precision.main, device="cpu")
    n, depth = 5, 300
    rng = np.random.default_rng(7)
    gates = []
    for _ in range(depth):
        m = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
        gates.append((np.linalg.qr(m)[0], int(rng.integers(0, n))))
    env = jq.createQuESTEnv(num_devices=1, precision=jq.QUAD, seed=[1])
    q = jq.createQureg(n, env)
    jq.initZeroState(q)
    for u, t in gates:
        jq.unitary(q, t, u)
    ref = q.to_numpy()
    assert np.abs(out["quad"]["amps"] - ref).max() < TOL
    assert abs(out["quad"]["total_prob"] - jq.calcTotalProb(q)) < TOL
    assert out["quad"]["max_err"] < 1e-12
    # plain float32 drifts; the facts the script prints
    assert 1e-9 < out["single"]["max_err"] < 1e-4


def test_vqe():
    steps, noisy_steps = 25, 10
    out = quiet(vqe.main, device="cpu", steps=steps,
                noisy_steps=noisy_steps)
    import jax
    env = jenv(7)
    terms, coeffs = vqe.hamiltonian_terms()

    def jansatz():
        c = jq.Circuit(vqe.N)
        for layer in range(vqe.LAYERS):
            for q in range(vqe.N):
                c.ry(q, c.parameter(f"t{layer}_{q}"))
            for q in range(vqe.N - 1):
                c.cnot(q, q + 1)
        return c

    energy = jansatz().compile(env).expectation_fn(terms, coeffs)
    loss = jax.jit(jax.value_and_grad(energy))
    rng = np.random.default_rng(0)
    params = optax_adam(loss, rng.uniform(-0.1, 0.1, size=12), steps,
                        vqe.LEARNING_RATE)
    assert np.abs(out["params"] - params).max() < ADAM_TOL
    assert abs(out["energy"] - float(energy(out["params"]))) < TOL
    assert abs(out["exact"] - vqe.exact_ground_energy(terms, coeffs)) < TOL
    noisy = jansatz().with_noise(p1=0.01, damping=0.02)
    nenergy = noisy.compile(env, density=True).expectation_fn(terms, coeffs)
    nparams = optax_adam(jax.jit(jax.value_and_grad(nenergy)),
                         rng.uniform(-0.1, 0.1, size=12), noisy_steps,
                         vqe.LEARNING_RATE)
    assert np.abs(out["noisy_params"] - nparams).max() < ADAM_TOL
    assert abs(out["noisy_energy"]
               - float(nenergy(out["noisy_params"]))) < TOL


def test_qaoa():
    steps = 40
    out = quiet(qaoa.main, device="cpu", steps=steps)
    import jax
    env = jenv(2026)
    compiled = jalg.qaoa_maxcut(qaoa.N, qaoa.EDGES,
                                num_layers=qaoa.LAYERS).compile(env)
    terms, coeffs = jalg.qaoa_maxcut_terms(qaoa.EDGES)
    energy = compiled.expectation_fn(terms, coeffs)
    params = optax_adam(jax.value_and_grad(energy),
                        np.array([0.5, 0.5, 0.3, 0.3]), steps, 0.1)
    assert np.abs(out["params"] - params).max() < ADAM_TOL
    want_cut = len(qaoa.EDGES) / 2.0 - float(energy(out["params"]))
    assert abs(out["expected_cut"] - want_cut) < TOL
    # the sampled cut depends on the generator: compared as facts
    assert out["max_cut"] == 8 and out["best_drawn"] == out["max_cut"]
    assert out["num_draws"] == 256


def test_noise_fitting():
    steps = 100
    out = quiet(noise_fitting.main, device="cpu", steps=steps)
    import jax
    env = jenv(11)
    dev = jq.Circuit(2)
    dev.h(0).cnot(0, 1)
    dev.damp(0, noise_fitting.TRUE_DAMP).dephase(
        1, noise_fitting.TRUE_DEPHASE)
    d = jq.createDensityQureg(2, env)
    jq.initZeroState(d)
    dev.compile(env, density=True).run(d)
    observables = [[3, 0], [0, 3], [1, 1], [2, 2]]
    data = [jq.calcExpecPauliSum(d, codes, [1.0]) for codes in observables]
    assert np.abs(np.array(out["data"]) - np.array(data)).max() < TOL
    model = jq.Circuit(2)
    g = model.parameter("damp")
    p = model.parameter("dephase")
    model.h(0).cnot(0, 1).damp(0, g).dephase(1, p)
    cc = model.compile(env, density=True)
    fns = [cc.expectation_fn(
        [[(q, c) for q, c in enumerate(codes) if c]], [1.0])
        for codes in observables]

    def loss(pv):
        return sum((f(pv) - t) ** 2 for f, t in zip(fns, data))

    rates = optax_adam(jax.jit(jax.value_and_grad(loss)),
                       np.array([0.5, 0.5]), steps, 0.05,
                       clip=(1e-4, 0.49))
    assert np.abs(out["rates"] - rates).max() < ADAM_TOL


def test_noisy_trajectories():
    out = quiet(noisy_trajectories.main, device="cpu", trajectories=256)
    env = jenv(2026)
    n = 10
    c = jq.Circuit(n)
    c.h(0)
    for q in range(1, n):
        c.cnot(q - 1, q)
    for q in range(n):
        c.damp(q, 0.08)
        c.dephase(q, 0.05)
    d = jq.createDensityQureg(n, env)
    jq.initZeroState(d)
    c.compile(env, density=True).run(d)
    exact = jq.calcProbOfOutcome(d, n - 1, 1)
    assert abs(out["exact"] - exact) < TOL
    assert 0.0 <= out["one_trajectory"] <= 1.0 + TOL
    assert abs(out["ensemble"] - exact) <= 5 * out["ensemble_stderr"]
    assert abs(out["z_mean"] - (1.0 - 2.0 * exact)) <= 5 * out["z_stderr"]


def test_production_workflow():
    out = quiet(production_workflow.main, device="cpu")
    env = jenv(11)
    n = 16
    c = jq.Circuit(n)
    theta = c.parameter("theta")
    for i in range(n):
        c.h(i)
    for i in range(n - 1):
        c.cnot(i, i + 1)
    c.rz(n // 2, theta)
    for i in range(n):
        c.rx(i, 0.1 + 0.05 * i)
    q = jq.createQureg(n, env)
    jq.initZeroState(q)
    c.compile(env).precompile().run(q, params={"theta": 0.37})
    assert np.abs(out["amps"] - q.to_numpy()).max() < TOL
    assert abs(out["prob_q0_is_0"] - jq.calcProbOfOutcome(q, 0, 0)) < TOL
    assert abs(out["total_prob"] - jq.calcTotalProb(q)) < TOL
    assert int(out["counts"].sum()) == 4096 and len(out["counts"]) == 8


def test_tpu_features():
    out = quiet(tpu_features.main, device="cpu")
    import jax
    env = jenv(7)
    n = 20
    q = jq.createQureg(n, env)
    jq.initClassicalState(q, 0b1011)
    jalg.qft(n).compile(env).run(q)
    assert np.abs(out["qft_amps"] - q.to_numpy()).max() < TOL
    assert abs(out["qft_total_prob"] - jq.calcTotalProb(q)) < TOL

    c = jq.Circuit(4)
    theta = c.parameter("theta")
    for i in range(4):
        c.ry(i, theta)
    c.cnot(0, 1).cnot(2, 3)
    f = c.compile(env)
    for t, got in zip((0.1, 0.7, 2.4), out["param_probs"]):
        reg = jq.createQureg(4, env)
        f.run(reg, params={"theta": t})
        assert abs(got - jq.calcProbOfOutcome(reg, 0, 0)) < TOL

    ham = [[(0, 3)], [(1, 3)], [(0, 1)]]
    energy = f.expectation_fn(ham, [1.0, 1.0, 0.5])
    grad = jax.grad(energy)
    params = np.array([0.3])
    for _ in range(5):
        params = params - 0.4 * np.asarray(grad(params))
    assert abs(out["descent_theta"] - float(params[0])) < TOL
    assert abs(out["descent_energy"] - float(energy(params))) < TOL

    angles = np.linspace(0.0, np.pi, 16).reshape(16, 1)
    zero = np.zeros(16, dtype=np.complex128)
    zero[0] = 1.0
    batch = np.asarray(jax.vmap(f.apply, in_axes=(None, 0))(jpack(zero),
                                                            angles))
    p0 = batch[:, 0, 0] ** 2 + batch[:, 1, 0] ** 2
    assert np.abs(out["sweep_p0"] - p0).max() < TOL

    mesh_env = jq.createQuESTEnv(num_devices=8, precision=jq.DOUBLE,
                                 seed=[7])
    qm = jq.createQureg(10, mesh_env)
    cc = jalg.random_circuit(10, depth=6, seed=3).compile(mesh_env)
    cc.run(qm)
    # the planners fuse differently (the port collects layers), so the
    # relayout counts are each package's own; the states agree
    assert out["mesh_relayouts"] >= 0
    assert abs(out["mesh_total_prob"] - jq.calcTotalProb(qm)) < TOL
    assert np.abs(out["mesh_amps"][0] + 1j * out["mesh_amps"][1]
                  - qm.to_numpy()).max() < TOL
