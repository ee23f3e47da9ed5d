"""The PyTorch port's Hamiltonian dynamics against the JAX package's, on the
CPU in float64.

- the step functions of ``ops/dynamics.py`` (``trotter_sweep`` both ways,
  ``trotter_step`` at orders 1 and 2, ``imag_time_step``,
  ``lanczos_ground``) and ``reductions.pauli_apply_sv`` /
  ``pauli_sum_apply_sv`` on one batch, against the JAX functions per row;
- ``CompiledCircuit.evolve_sweep`` (orders 1 and 2) and ``ground_sweep``
  (power iteration and Lanczos, with a breakdown case whose start vector
  is an eigenvector) at the env tier, SINGLE and DOUBLE, from |0..0> and
  from a given ``state_f``, and chained segments: every packed block
  within 1e-12 (Lanczos planes up to one real sign per row); at SINGLE the
  two packages round float32 arithmetic in different orders, so there the
  bar is 1e-5;
- the non-serving checks of ``tests/test_dynamics.py``: the dense ``expm``
  oracle, the Trotter order slopes, the Welford stream, determinism, and
  the one-block accounting;
- ``dispatch_stats()`` field for field against the JAX package's after
  every batched dispatch (``sweep``, ``expectation_sweep``,
  ``value_and_grad_sweep``, ``sample_sweep``, ``evolve_sweep``,
  ``ground_sweep``), but for the executable-cache fields;
- the rejections, with the JAX package's exception types: spec
  validation, density programs, QUAD, a ``(B, 2, N)`` ``state_f``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

import quest_tpu as jq
from quest_tpu.ops import dynamics as jdyn
from quest_tpu.ops import reductions as jred
import quest_tpu_torch as tq
from quest_tpu_torch.ops import dynamics as tdyn
from quest_tpu_torch.ops import reductions as tred
from torch_threads import one_blas_thread  # noqa: F401

TOL = 1e-12
SINGLE_TOL = 1e-5
B = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def envs():
    return (jq.createQuESTEnv(num_devices=1, precision=jq.DOUBLE, seed=[7]),
            tq.createQuESTEnv(device="cpu", precision=tq.DOUBLE, seed=[7]))


def prep_circuit(C, n):
    """tests/test_dynamics.py's prep: an ry column of Params, a CNOT
    chain."""
    c = C(n)
    for q in range(n):
        c.ry(q, c.parameter(f"y{q}"))
    for q in range(n - 1):
        c.cnot(q, q + 1)
    return c


def tfim(n, h=0.7):
    terms = [[(q, 3), (q + 1, 3)] for q in range(n - 1)]
    terms += [[(q, 1)] for q in range(n)]
    return terms, [1.0] * (n - 1) + [h] * n


def ham_with_y(n):
    """The TFIM plus a Y.X term and a Y-only term (every i^|y| phase)."""
    terms, coeffs = tfim(n)
    return (terms + [[(0, 2), (1, 1)], [(1, 2), (2, 2), (n - 1, 2)]],
            coeffs + [0.35, -0.2])


def prep_params(n, batch=B, seed=20260807):
    return np.random.default_rng(seed).normal(size=(batch, n)) * 0.3


_COMPILED = {}


def compiled(envs, n):
    if n not in _COMPILED:
        _COMPILED[n] = (prep_circuit(jq.Circuit, n).compile(envs[0],
                                                            pallas=False),
                        prep_circuit(tq.Circuit, n).compile(envs[1]))
    return _COMPILED[n]


def continuation(envs, n):
    """The identity program a segment chain continues from (no gates, no
    parameters), as the JAX package's serving layer chains segments."""
    return (jq.Circuit(n).compile(envs[0], pallas=False),
            tq.Circuit(n).compile(envs[1]))


def random_state(n, seed):
    z = np.random.default_rng(seed).normal(size=(2, 1 << n))
    return z / np.linalg.norm(z)


def masks(n, ham):
    """The padded mask operands both packages build."""
    codes = np.zeros((len(ham[0]), n), np.int64)
    for t, term in enumerate(ham[0]):
        for q, c in term:
            codes[t, q] = c
    return tred.pauli_sum_operands(codes.reshape(-1), n, ham[1])


def jax_rows(fn, planes):
    """Apply a per-row JAX function of a complex state (jitted once) to
    each row of a ``(B, 2, N)`` numpy batch; returns the outputs."""
    fn = jax.jit(fn)
    return [fn(jnp.asarray(p[0] + 1j * p[1])) for p in planes]


def as_planes(z):
    z = np.asarray(z)
    return np.stack([z.real, z.imag])


def batch_of(n, seed):
    return np.stack([random_state(n, seed + b) for b in range(B)])


def close_up_to_sign(a, b):
    """max over rows of min(|a - b|, |a + b|)."""
    a, b = np.asarray(a), np.asarray(b)
    axes = tuple(range(1, a.ndim))
    return float(np.max(np.minimum(np.abs(a - b).max(axis=axes),
                                   np.abs(a + b).max(axis=axes))))


# -- (a) the step functions on one batch --------------------------------------


@pytest.mark.parametrize("case", ["sweep", "sweep_reverse", "step1", "step2",
                                  "imag", "apply", "sum_apply"])
def test_step_functions_match_jax(case):
    n = 5
    xm, ym, zm, cf = masks(n, ham_with_y(n))
    planes = batch_of(n, 11)
    states = torch.as_tensor(planes.copy())
    theta = 0.37
    if case in ("sweep", "sweep_reverse"):
        rev = case == "sweep_reverse"
        got = tdyn.trotter_sweep(states, xm, ym, zm, cf, theta, reverse=rev)
        want = jax_rows(lambda z: jdyn.trotter_sweep(
            z, xm, ym, zm, cf, theta, reverse=rev), planes)
    elif case in ("step1", "step2"):
        order = int(case[-1])
        got = tdyn.trotter_step(states, xm, ym, zm, cf, theta, order=order)
        want = jax_rows(lambda z: jdyn.trotter_step(
            z, xm, ym, zm, cf, jnp.asarray(theta), order=order), planes)
    elif case == "imag":
        got = tdyn.imag_time_step(states, xm, ym, zm, cf, theta)
        want = jax_rows(lambda z: jdyn.imag_time_step(
            z, xm, ym, zm, cf, theta), planes)
    elif case == "apply":
        t = len(ham_with_y(n)[0]) - 2          # the Y.X term
        got = tred.pauli_apply_sv(states, xm[t], ym[t], zm[t])
        want = jax_rows(lambda z: jred.pauli_apply_sv(
            z, xm[t], ym[t], zm[t]), planes)
    else:
        got = tred.pauli_sum_apply_sv(states, xm, ym, zm, cf)
        want = jax_rows(lambda z: jred.pauli_sum_apply_sv(
            z, xm, ym, zm, cf), planes)
    want = np.stack([as_planes(w) for w in want])
    assert np.abs(got.numpy() - want).max() <= TOL


def test_xor_gather_without_flip_is_the_same(monkeypatch):
    """A mask of more runs than one flip takes gathers by index: both
    routes give the same steps bit for bit."""
    n = 6
    ham = ham_with_y(n)
    ham = (ham[0] + [[(0, 1), (2, 2), (4, 1)]], ham[1] + [0.3])
    xm, ym, zm, cf = masks(n, ham)
    planes = batch_of(n, 31)

    def run():
        z = tdyn.trotter_step(torch.tensor(planes), xm, ym, zm, cf, 0.2)
        return z, [tred.pauli_sum_expvals_sv(z, xm, ym, zm, compensated=c)
                   for c in (False, True)]

    flipped, e_flipped = run()
    monkeypatch.setattr(tred, "_FLIP_RUNS", 0)
    indexed, e_indexed = run()
    assert torch.equal(flipped, indexed)
    assert all(torch.equal(a, b) for a, b in zip(e_flipped, e_indexed))


def test_steps_update_the_batch_in_place():
    n = 4
    xm, ym, zm, cf = masks(n, tfim(n))
    states = torch.as_tensor(batch_of(n, 3))
    assert tdyn.trotter_step(states, xm, ym, zm, cf, 0.1) is states
    assert tdyn.imag_time_step(states, xm, ym, zm, cf, 0.1) is states
    before = states.clone()
    ritz, _, _ = tdyn.lanczos_ground(states, xm, ym, zm, cf, 4)
    assert ritz is not states and torch.equal(states, before)


@pytest.mark.parametrize("m", [2, 6, 12])
def test_lanczos_ground_matches_jax(m):
    n = 5
    xm, ym, zm, cf = masks(n, ham_with_y(n))
    planes = batch_of(n, 21)
    ritz, energy, residual = tdyn.lanczos_ground(
        torch.as_tensor(planes), xm, ym, zm, cf, num_vectors=m)
    want = jax_rows(lambda z: jdyn.lanczos_ground(z, xm, ym, zm, cf,
                                                  num_vectors=m), planes)
    for b, (jr, je, jres) in enumerate(want):
        assert abs(float(energy[b]) - float(je)) <= TOL
        assert abs(float(residual[b]) - float(jres)) <= TOL
        assert close_up_to_sign(ritz[b:b + 1].numpy(),
                                as_planes(jr)[None]) <= TOL
    with pytest.raises(ValueError, match="num_vectors"):
        tdyn.lanczos_ground(torch.as_tensor(planes), xm, ym, zm, cf, 1)


def test_lanczos_breakdown_matches_jax():
    """A Z-only Hamiltonian from a basis state: the start vector is an
    eigenvector, the Krylov space dies at the first step, and the dead
    diagonals are pinned above the spectrum."""
    n = 4
    ham = ([[(0, 3), (1, 3)], [(2, 3)], [(3, 3)]], [0.8, -0.5, 0.3])
    xm, ym, zm, cf = masks(n, ham)
    planes = np.zeros((2, 2, 1 << n))
    planes[0, 0, 5] = 1.0
    planes[1, 0, 0] = planes[1, 0, 3] = np.sqrt(0.5)   # a mix of two
    ritz, energy, residual = tdyn.lanczos_ground(
        torch.as_tensor(planes), xm, ym, zm, cf, num_vectors=6)
    want = jax_rows(lambda z: jdyn.lanczos_ground(z, xm, ym, zm, cf,
                                                  num_vectors=6), planes)
    for b, (jr, je, jres) in enumerate(want):
        assert abs(float(energy[b]) - float(je)) <= TOL
        assert abs(float(residual[b]) - float(jres)) <= TOL
        assert close_up_to_sign(ritz[b:b + 1].numpy(),
                                as_planes(jr)[None]) <= TOL
    # |5> = bits 0 and 2 set: E = 0.8 * (-1)(+1) - 0.5 * (-1) + 0.3 = 0
    assert abs(float(energy[0]) - 0.0) <= TOL
    assert float(residual[0]) <= TOL


# -- (b) the dispatches against the JAX package -------------------------------


def _spec_pair(kind, **kw):
    if kind == "evolve":
        return jdyn.EvolveSpec(**kw), tdyn.EvolveSpec(**kw)
    return jdyn.GroundSpec(**kw), tdyn.GroundSpec(**kw)


def _unpack(kind, block, n, steps):
    fn = tdyn.unpack_evolve_block if kind == "evolve" \
        else tdyn.unpack_ground_block
    return fn(block, n, steps)


def _assert_blocks_close(kind, jblock, tblock, n, steps, tol,
                         sign_free=False):
    jb = _unpack(kind, np.asarray(jblock), n, steps)
    tb = _unpack(kind, tblock, n, steps)
    for key in jb:
        if key == "planes" and sign_free:
            err = close_up_to_sign(tb[key], jb[key])
        else:
            err = float(np.abs(tb[key] - jb[key]).max())
        assert err <= tol, (key, err)


CASES = {"evolve1": ("evolve", dict(t=0.8, steps=6, order=1)),
         "evolve2": ("evolve", dict(t=0.8, steps=6, order=2)),
         "power": ("ground", dict(steps=5, tau=0.15)),
         "power1": ("ground", dict(steps=1, tau=0.2)),
         "lanczos": ("ground", dict(steps=8, method="lanczos"))}
# every case from |0..0> at the env tier and DOUBLE and from a given
# state_f; at SINGLE (float32, a JAX compile of its own each) one case of
# each kind
DISPATCH = [(c, start, tier) for c in CASES
            for start, tier in (("zero", None), ("zero", "double"),
                                ("state_f", None))] \
    + [(c, "zero", "single") for c in ("evolve2", "power", "lanczos")]


@pytest.mark.parametrize("case,start,tier", DISPATCH,
                         ids=[f"{c}-{s}-{t}" for c, s, t in DISPATCH])
def test_dispatch_matches_jax(envs, case, start, tier):
    kind, kw = CASES[case]
    n = 5
    jc, tc = compiled(envs, n)
    ham = ham_with_y(n)
    pm = prep_params(n)
    state_f = random_state(n, 5) if start == "state_f" else None
    jspec, tspec = _spec_pair(kind, **kw)
    jout = getattr(jc, f"{kind}_sweep")(pm, ham, jspec, state_f=state_f,
                                        tier=tier)
    tout = getattr(tc, f"{kind}_sweep")(pm, ham, tspec, state_f=state_f,
                                        tier=tier)
    assert isinstance(tout, torch.Tensor) and tout.dtype == torch.float64
    assert tuple(tout.shape) == np.asarray(jout).shape
    _assert_blocks_close(kind, jout, tout, n, tspec.steps,
                         SINGLE_TOL if tier == "single" else TOL,
                         sign_free=kw.get("method") == "lanczos")


def test_lanczos_dispatch_breakdown_matches_jax(envs):
    """ground_sweep's Lanczos from an eigenvector of a Z-only Hamiltonian
    (prep parameters 0 keep |0..0>)."""
    n = 5
    jc, tc = compiled(envs, n)
    ham = ([[(0, 3), (1, 3)], [(4, 3)]], [0.6, -1.1])
    pm = np.zeros((2, n))
    jspec, tspec = _spec_pair("ground", steps=6, method="lanczos")
    jout = jc.ground_sweep(pm, ham, jspec)
    tout = tc.ground_sweep(pm, ham, tspec)
    _assert_blocks_close("ground", jout, tout, n, 6, TOL, sign_free=True)
    res = tdyn.unpack_ground_block(tout, n, 6)
    np.testing.assert_allclose(res["energies"], 0.6 - 1.1, atol=TOL)
    assert np.abs(res["residual"]).max() <= TOL


@pytest.mark.parametrize("method", ["power", "lanczos"])
def test_chained_segments_match_jax(envs, method):
    """Two ground segments, the second from the identity continuation
    seeded with the first's row-0 planes as its shared state_f."""
    n = 4
    jc, tc = compiled(envs, n)
    jcont, tcont = continuation(envs, n)
    ham = ham_with_y(n)
    pm = prep_params(n, batch=2)
    jspec, tspec = _spec_pair("ground", steps=4, tau=0.2, method=method)
    jfirst = jdyn.unpack_ground_block(np.asarray(jc.ground_sweep(
        pm, ham, jspec)), n, 4)
    tfirst = tdyn.unpack_ground_block(tc.ground_sweep(pm, ham, tspec), n, 4)
    jsecond = jcont.ground_sweep(np.zeros((1, 0)), ham, jspec,
                                 state_f=jfirst["planes"][0])
    tsecond = tcont.ground_sweep(np.zeros((1, 0)), ham, tspec,
                                 state_f=torch.as_tensor(
                                     tfirst["planes"][0]))
    _assert_blocks_close("ground", jsecond, tsecond, n, 4, TOL,
                         sign_free=method == "lanczos")
    if method == "power":
        # imaginary time only descends across the chain
        e = np.concatenate([tfirst["energies"][:1], tdyn.unpack_ground_block(
            tsecond, n, 4)["energies"]], axis=1)
        assert (np.diff(e[0]) <= 1e-12).all()


# -- (c) tests/test_dynamics.py's non-serving checks --------------------------

_PAULI = {1: np.array([[0, 1], [1, 0]], dtype=complex),
          2: np.array([[0, -1j], [1j, 0]], dtype=complex),
          3: np.diag([1.0, -1.0]).astype(complex)}


def dense_hamiltonian(n, terms, coeffs):
    H = np.zeros((1 << n, 1 << n), dtype=complex)
    for term, c in zip(terms, coeffs):
        ops = [np.eye(2, dtype=complex)] * n
        for q, p in term:
            ops[q] = _PAULI[p]
        M = np.array([[1.0]], dtype=complex)
        for q in range(n - 1, -1, -1):
            M = np.kron(M, ops[q])
        H += float(c) * M
    return H


def as_complex(planes):
    planes = np.asarray(planes)
    return planes[0] + 1j * planes[1]


def evolved_oracle(tc, x, ham, t):
    psi0 = as_complex(tc.sweep(x[None, :])[0].numpy())
    return sla.expm(-1j * dense_hamiltonian(tc.num_qubits, *ham) * t) @ psi0


def evolve_planes(tc, x, ham, spec):
    return tdyn.unpack_evolve_block(
        tc.evolve_sweep(np.asarray(x)[None, :], ham, spec), tc.num_qubits,
        spec.steps)


def test_evolve_matches_dense_expm(envs):
    n = 5
    _, tc = compiled(envs, n)
    x = prep_params(n, batch=1)[0]
    ham = tfim(n)
    out = evolve_planes(tc, x, ham, tdyn.EvolveSpec(t=0.6, steps=40,
                                                    order=2))
    psi = as_complex(out["planes"][0])
    assert np.abs(psi - evolved_oracle(tc, x, ham, 0.6)).max() < 5e-4
    assert abs(np.vdot(psi, psi).real - 1.0) < 1e-12


@pytest.mark.parametrize("order,lo,hi", [(1, 0.8, 1.25), (2, 1.7, 2.4)])
def test_trotter_order_error_slopes(envs, order, lo, hi):
    n = 4
    _, tc = compiled(envs, n)
    x = prep_params(n, batch=1)[0]
    ham = tfim(n)
    ref = evolved_oracle(tc, x, ham, 0.8)
    errs = [np.abs(as_complex(evolve_planes(
        tc, x, ham, tdyn.EvolveSpec(t=0.8, steps=s, order=order))[
            "planes"][0]) - ref).max() for s in (8, 16)]
    slope = np.log2(errs[0] / errs[1])
    assert lo < slope < hi, (errs, slope)


def test_energy_stream_and_welford(envs):
    n = 4
    _, tc = compiled(envs, n)
    x = prep_params(n, batch=1)[0]
    ham = tfim(n)
    S = 12
    out = evolve_planes(tc, x, ham, tdyn.EvolveSpec(t=0.5, steps=S))
    es = out["energies"][0]
    cnt, mean, m2 = out["welford"][0]
    assert es.shape == (S,) and cnt == S
    np.testing.assert_allclose(mean, es.mean(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(m2, ((es - es.mean()) ** 2).sum(),
                               rtol=1e-10, atol=1e-12)
    H = dense_hamiltonian(n, *ham)
    psi0 = as_complex(tc.sweep(x[None, :])[0].numpy())
    e0 = float(np.vdot(psi0, H @ psi0).real)
    assert np.abs(es - e0).max() < 5e-2


def test_evolve_is_deterministic(envs):
    n = 4
    _, tc = compiled(envs, n)
    x = prep_params(n, batch=1)
    spec = tdyn.EvolveSpec(t=0.4, steps=10)
    a = tc.evolve_sweep(x, tfim(n), spec)
    b = tc.evolve_sweep(x, tfim(n), spec)
    assert torch.equal(a, b)


def test_one_transfer_per_segment_accounting(envs):
    """tests/test_dynamics.py:183: a B-row, S-step segment accounts
    B*S - 1 avoided syncs and B*S fused steps."""
    n = 4
    _, tc = compiled(envs, n)
    pm = np.stack([prep_params(n, 1)[0], prep_params(n, 1)[0] * 0.5])
    tc.evolve_sweep(pm, tfim(n), tdyn.EvolveSpec(t=0.4, steps=10))
    st = tc.dispatch_stats()
    assert st.host_syncs_avoided >= 2 * 10 - 1
    assert st.evolve_steps_fused == 2 * 10


def test_power_iteration_descends_to_ground(envs):
    """Chained power segments approach numpy's ground energy within the
    O(tau^2) Trotter bias; Lanczos lands on it to solver precision."""
    n = 4
    _, tc = compiled(envs, n)
    _, cont = continuation(envs, n)
    ham = tfim(n)
    w = np.linalg.eigh(dense_hamiltonian(n, *ham))[0]
    x = prep_params(n, batch=1)
    spec = tdyn.GroundSpec(steps=16, tau=0.1)
    seg = tdyn.unpack_ground_block(tc.ground_sweep(x, ham, spec), n, 16)
    last = seg["energies"][0, -1]
    for _ in range(11):
        seg = tdyn.unpack_ground_block(cont.ground_sweep(
            np.zeros((1, 0)), ham, spec, state_f=seg["planes"][0]), n, 16)
        assert seg["energies"][0, -1] <= last + 1e-9
        last = seg["energies"][0, -1]
    assert abs(last - w[0]) < 5e-2
    lz = tdyn.unpack_ground_block(tc.ground_sweep(
        x, ham, tdyn.GroundSpec(steps=16, method="lanczos")), n, 16)
    assert abs(lz["energies"][0, 0] - w[0]) < 1e-8


def test_unpack_takes_numpy_or_a_tensor(envs):
    n = 3
    _, tc = compiled(envs, n)
    block = tc.evolve_sweep(prep_params(n, 2), tfim(n),
                            tdyn.EvolveSpec(t=0.3, steps=4))
    a = tdyn.unpack_evolve_block(block, n, 4)
    b = tdyn.unpack_evolve_block(block.numpy(), n, 4)
    for key in a:
        assert isinstance(a[key], np.ndarray)
        np.testing.assert_array_equal(a[key], b[key])
    assert tdyn.evolve_block_width(n, 4) == jdyn.evolve_block_width(n, 4)
    assert tdyn.ground_block_width(n, 4) == jdyn.ground_block_width(n, 4)
    with pytest.raises(ValueError, match="packed evolve block"):
        tdyn.unpack_evolve_block(block[:, 1:], n, 4)
    with pytest.raises(ValueError, match="packed ground block"):
        tdyn.unpack_ground_block(block, n, 4)


# -- (d) dispatch_stats against the JAX package -------------------------------

# the JAX package caches one jit executable per (form, mode, dtype, tier);
# the port runs eagerly and caches none
CACHE_FIELDS = ("batched_cache_size", "batched_cache_evictions")


def _dispatches(pkg, cc, n):
    ham = ham_with_y(n)
    pm = prep_params(n)
    spec = pkg.EvolveSpec(t=0.4, steps=3)
    gspec = pkg.GroundSpec(steps=4, method="lanczos")
    return [("sweep", lambda: cc.sweep(pm)),
            ("expectation_sweep", lambda: cc.expectation_sweep(pm, ham)),
            ("expectation_sweep_empty",
             lambda: cc.expectation_sweep(pm, ([], []))),
            ("value_and_grad_sweep",
             lambda: cc.value_and_grad_sweep(pm[:2], ham)),
            ("evolve_sweep", lambda: cc.evolve_sweep(pm, ham, spec)),
            ("sample_sweep", lambda: cc.sample_sweep(pm, 16)),
            ("ground_sweep", lambda: cc.ground_sweep(pm[:1], ham, gspec))]


def test_dispatch_stats_match_jax_after_every_dispatch(envs):
    n = 4
    jc = prep_circuit(jq.Circuit, n).compile(envs[0], pallas=False)
    tc = prep_circuit(tq.Circuit, n).compile(envs[1], pallas=False)
    assert tc.dispatch_stats().as_dict()["evolve_steps_fused"] == 0
    for (name, jrun), (_, trun) in zip(_dispatches(jq, jc, n),
                                       _dispatches(tq, tc, n)):
        jrun()
        trun()
        jd = jc.dispatch_stats().as_dict()
        td = tc.dispatch_stats().as_dict()
        assert set(jd) == set(td)
        for key in jd:
            if key not in CACHE_FIELDS:
                assert td[key] == jd[key], (name, key, td[key], jd[key])


def test_expectation_fn_records_no_dispatch(envs):
    n = 3
    _, tc = compiled(envs, n)
    tc.sweep(prep_params(n, 2))
    before = tc.dispatch_stats().as_dict()
    theta = torch.tensor(prep_params(n, 1)[0], requires_grad=True)
    tc.expectation_fn(*tfim(n))(theta).backward()
    assert tc.dispatch_stats().as_dict() == before


# -- (e) rejections -----------------------------------------------------------


def _error_type(fn):
    try:
        fn()
    except Exception as e:          # noqa: BLE001 - the type is compared
        return type(e)
    return None


@pytest.mark.parametrize("kind,kw", [
    ("evolve", dict(t=1.0, steps=0)), ("evolve", dict(t=1.0, steps=2,
                                                      order=3)),
    ("evolve", dict(t=float("inf"), steps=2)),
    ("ground", dict(steps=0)), ("ground", dict(method="qr")),
    ("ground", dict(tau=0.0)), ("ground", dict(tau=float("nan"))),
    ("ground", dict(tol=-1.0))])
def test_spec_validation_matches_jax(kind, kw):
    jcls = jdyn.EvolveSpec if kind == "evolve" else jdyn.GroundSpec
    tcls = tdyn.EvolveSpec if kind == "evolve" else tdyn.GroundSpec
    want = _error_type(lambda: jcls(**kw))
    assert want is ValueError
    assert _error_type(lambda: tcls(**kw)) is want


def test_specs_match_jax():
    for kw in (dict(t=0.7, steps=7, order=1), dict(t=-1.5, steps=3)):
        j, t = jdyn.EvolveSpec(**kw), tdyn.EvolveSpec(**kw)
        assert (t.dt, t.contract()) == (j.dt, j.contract())
    for kw in (dict(), dict(steps=4, tau=0.3, method="lanczos", tol=0.0)):
        j, t = jdyn.GroundSpec(**kw), tdyn.GroundSpec(**kw)
        assert t.contract() == j.contract()


def test_rejections_match_jax(envs):
    n = 3
    jc, tc = compiled(envs, n)
    ham = tfim(n)
    pm = prep_params(n, 2)
    cases = [
        lambda cc, d: cc.evolve_sweep(pm, ham, d.GroundSpec()),
        lambda cc, d: cc.ground_sweep(pm, ham, d.EvolveSpec(t=1, steps=2)),
        lambda cc, d: cc.evolve_sweep(pm, ham, d.EvolveSpec(t=1, steps=2),
                                      tier="quad"),
        lambda cc, d: cc.ground_sweep(pm, ham, d.GroundSpec(), tier="quad"),
        lambda cc, d: cc.evolve_sweep(pm, ham, d.EvolveSpec(t=1, steps=2),
                                      state_f=np.zeros((2, 2, 1 << n))),
        lambda cc, d: cc.ground_sweep(pm, ham, d.GroundSpec(),
                                      state_f=np.zeros((2, 4))),
        lambda cc, d: cc.evolve_sweep(np.zeros((2, n + 1)), ham,
                                      d.EvolveSpec(t=1, steps=2)),
        lambda cc, d: cc.evolve_sweep(pm, ([[(n, 3)]], [1.0]),
                                      d.EvolveSpec(t=1, steps=2)),
        lambda cc, d: cc.ground_sweep(pm, ham, d.GroundSpec(), tier="bogus"),
    ]
    for i, case in enumerate(cases):
        want = _error_type(lambda: case(jc, jdyn))
        assert want in (ValueError, TypeError), (i, want)
        assert _error_type(lambda: case(tc, tdyn)) is want, i


def test_density_program_is_rejected(envs):
    for pkg, dyn, env in ((jq, jdyn, envs[0]), (tq, tdyn, envs[1])):
        c = pkg.Circuit(2).h(0).cnot(0, 1)
        dc = c.compile(env, density=True)
        with pytest.raises(ValueError, match="statevector"):
            dc.evolve_sweep(np.zeros((1, 0)), ([[(0, 3)]], [1.0]),
                            dyn.EvolveSpec(t=0.1, steps=1))
        with pytest.raises(ValueError, match="statevector"):
            dc.ground_sweep(np.zeros((1, 0)), ([[(0, 3)]], [1.0]),
                            dyn.GroundSpec(), tier="quad")
