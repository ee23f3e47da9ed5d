"""The port's ``Circuit.compile_dd`` and the batched engine's
``tier="quad"`` rung against the JAX package's, on the CPU.

- ``compile_dd`` against the JAX package's ``DDProgram`` at float32 and
  float64 planes (rotations, CNOTs, controlled phases, SWAPs).
- ``sweep``/``expectation_sweep``/``sample_sweep(tier="quad")`` on a
  DOUBLE environment against the JAX package's, on a state-vector HEA and a
  density-compiled noisy program, within 1e-13 of the largest amplitude
  (energy); the energies also against the port's DOUBLE rung (1e-12);
  ``sample_sweep`` by distribution (the two packages draw from different
  generators); ``dispatch_stats()`` after each dispatch equal to the JAX
  package's, the jit-cache fields aside (the port caches no executables).
"""

import numpy as np
import pytest
import torch

import quest_tpu as jq
from quest_tpu.circuits import Circuit as JCircuit
import quest_tpu_torch as tq
from torch_threads import one_blas_thread  # noqa: F401

TOL = 1e-13
JIT_FIELDS = ("batched_cache_size", "batched_cache_evictions")


def _envs(prec: str, seed: int = 7):
    return (jq.createQuESTEnv(num_devices=1, precision=getattr(jq, prec),
                              seed=[seed]),
            tq.createQuESTEnv(device="cpu", precision=getattr(tq, prec),
                              seed=[seed]))


def _dd_circuit(C, n, rng):
    c = C(n)
    for i in range(12):
        a, b = (int(x) for x in rng.choice(n, 2, replace=False))
        k = i % 4
        if k == 0:
            c.rotate(a, float(rng.uniform(0, 6.28)), rng.normal(size=3))
        elif k == 1:
            c.cnot(a, b)
        elif k == 2:
            c.cphase(a, b, 0.37)
        else:
            c.swap(a, b)
    return c


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_compile_dd_matches_jax(dtype):
    n = 5
    jenv, tenv = _envs("QUAD64")
    tc = _dd_circuit(tq.Circuit, n, np.random.default_rng(17))
    jc = _dd_circuit(JCircuit, n, np.random.default_rng(17))
    rng = np.random.default_rng(3)
    psi = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    psi /= np.linalg.norm(psi)
    prog, jprog = tc.compile_dd(tenv, dtype=dtype), jc.compile_dd(jenv,
                                                                  dtype=dtype)
    assert prog.num_steps == 3 + 3 * 3 + 3 + 3    # each SWAP is three
    planes = prog.run(prog.pack(psi))
    jplanes = jprog.run(jprog.pack(psi))
    assert planes.dtype == (torch.float32 if dtype == np.float32
                            else torch.float64)
    assert np.abs(prog.unpack(planes) - jprog.unpack(jplanes)).max() <= TOL
    assert abs(prog.total_prob(planes) - jprog.total_prob(jplanes)) <= TOL
    # the env's dtype is the default: QUAD64's float64 planes
    assert tc.compile_dd(tenv).dtype == np.float64


def _hea(C, n, layers=2):
    c = C(n)
    for layer in range(layers):
        for q in range(n):
            c.ry(q, c.parameter(f"y{layer}_{q}"))
            c.rz(q, c.parameter(f"z{layer}_{q}"))
        for q in range(n):
            c.cnot(q, (q + 1) % n)
    return c


def _stats(cc):
    import dataclasses
    s = dataclasses.asdict(cc.dispatch_stats())
    return {k: v for k, v in s.items() if k not in JIT_FIELDS}


@pytest.fixture(scope="module")
def double_envs():
    return (jq.createQuESTEnv(num_devices=1, precision=jq.DOUBLE, seed=[5]),
            tq.createQuESTEnv(device="cpu", precision=tq.DOUBLE, seed=[5]))


def test_quad_sweeps_match_jax(double_envs):
    """The QUAD rung on a DOUBLE env: planes, energies (against the JAX
    package's and the port's DOUBLE rung) and dispatch records."""
    jenv, tenv = double_envs
    n = 4
    jc, tc = (_hea(JCircuit, n, 1).compile(jenv),
              _hea(tq.Circuit, n, 1).compile(tenv))
    rng = np.random.default_rng(8)
    pm = rng.uniform(0, 2 * np.pi, size=(3, len(tc.param_names)))
    got = tc.sweep(pm, tier="quad")
    want = np.asarray(jc.sweep(pm, tier="quad"))
    assert got.dtype == torch.float64 and got.shape == (3, 2, 1 << n)
    assert np.abs(got.numpy() - want).max() <= TOL * np.abs(want).max()
    assert _stats(tc) == _stats(jc)
    # an owned batch is updated in place, to the same planes
    owned = torch.zeros((3, 2, 1 << n), dtype=torch.float64)
    owned[:, 0, 0] = 1.0
    assert tc.sweep(pm, state_f=owned, tier="quad") is owned
    assert torch.equal(owned, got)

    terms = [[(q, int(rng.integers(0, 4))) for q in range(n)]
             for _ in range(6)]
    coeffs = rng.normal(size=6)
    e_got = tc.expectation_sweep(pm, (terms, coeffs), tier="quad")
    e_want = np.asarray(jc.expectation_sweep(pm, (terms, coeffs),
                                             tier="quad"))
    scale = max(np.abs(e_want).max(), 1.0)
    assert np.abs(e_got - e_want).max() <= TOL * scale
    e_double = tc.expectation_sweep(pm, (terms, coeffs), tier="double")
    assert np.abs(e_got - e_double).max() <= 1e-12 * scale
    assert _stats(tc) == _stats(jc)

    idx, totals = tc.sample_sweep(pm, 4000, tier="quad")
    jidx, jtotals = jc.sample_sweep(pm, 4000, tier="quad")
    assert idx.shape == np.asarray(jidx).shape == (3, 4000)
    assert np.abs(totals - np.asarray(jtotals)).max() <= TOL
    assert _stats(tc) == _stats(jc)
    probs = (want[:, 0] ** 2 + want[:, 1] ** 2)
    for b in range(3):
        for draws in (idx[b], np.asarray(jidx[b])):
            hist = np.bincount(draws, minlength=1 << n) / 4000
            stderr = np.sqrt(probs[b] * (1 - probs[b]) / 4000)
            assert np.all(np.abs(hist - probs[b]) <= 5 * stderr + 1e-9)


def test_quad_density_program_sweep_matches_jax(double_envs):
    """A density-compiled noisy program at the QUAD rung: its lifted
    channels are dense superoperator items of the dd walk."""
    jenv, tenv = double_envs
    n = 3
    progs = []
    for C in (JCircuit, tq.Circuit):
        c = C(n)
        c.h(0).cnot(0, 1).ry(2, c.parameter("a"))
        c.dephase(1, 0.05).damp(2, 0.1).cz(1, 2)
        progs.append(c.compile(jenv if C is JCircuit else tenv,
                               density=True))
    jc, tc = progs
    pm = np.array([[0.3], [1.7]])
    want = np.asarray(jc.sweep(pm, tier="quad"))
    got = tc.sweep(pm, tier="quad").numpy()
    assert np.abs(got - want).max() <= TOL
    ham = ([[(0, 3), (2, 1)], [(1, 2)]], [0.7, -0.4])
    assert np.abs(tc.expectation_sweep(pm, ham, tier="quad")
                  - np.asarray(jc.expectation_sweep(pm, ham, tier="quad"))
                  ).max() <= TOL
    with pytest.raises(ValueError, match="sample density registers"):
        tc.sample_sweep(pm, 10, tier="quad")
