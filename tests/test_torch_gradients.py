"""The PyTorch port's gradient sweeps against the JAX package's, on the CPU
in float64.

- ``value_and_grad_sweep`` (the port's adjoint walk, ``ops/adjoint.py``)
  against the JAX package's ``value_and_grad_sweep`` (``jax.value_and_grad``
  over its layer-free twin) at 1e-9, the reference's bar, on a 5-qubit
  hardware-efficient ansatz and on a 9-qubit one whose plan has layers;
  its values against the port's ``expectation_sweep`` at 1e-12;
- ``adjoint_layer`` undoing its layer at 1e-12 for every stage kind, single
  and batched, and being the adjoint (``<a, L b> = <L^dag a, b>``) of a
  layer of non-unitary stages;
- ``expectation_fn(...)(theta).backward()`` against the sweep's row;
- the typed rejections: QUAD, no parameters, a numpy-only callable, a
  non-shared ``state_f``;
- ``tier="fast"`` gradients within the bound the tier model gives of
  SINGLE's.
"""

import numpy as np
import pytest
import torch

import quest_tpu as jq
from quest_tpu.circuits import Circuit as JCircuit
import quest_tpu_torch as tq
from quest_tpu_torch.ops import layer_kernel as lk
from torch_threads import one_blas_thread  # noqa: F401

TOL = 1e-12
GRAD_TOL = 1e-9          # tests/test_gradients.py's bar
B = 3


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


def _hea(C, n, layers):
    """bench.py build_hea_circuit: per layer an ry+rz column of named
    parameters and a CNOT ring."""
    c = C(n)
    for layer in range(layers):
        for q in range(n):
            c.ry(q, c.parameter(f"y{layer}_{q}"))
            c.rz(q, c.parameter(f"z{layer}_{q}"))
        for q in range(n):
            c.cnot(q, (q + 1) % n)
    return c


def _hamiltonian(n, num_terms=6, seed=2026):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(num_terms, n))
    coeffs = rng.normal(size=num_terms)
    return [[(q, int(codes[t, q])) for q in range(n)]
            for t in range(num_terms)], coeffs


def _rows(n_params, seed, batch=B):
    return np.random.default_rng(seed).uniform(0, 2 * np.pi,
                                               size=(batch, n_params))


_COMPILED = {}


def _compiled(envs, n, layers):
    key = (n, layers)
    if key not in _COMPILED:
        _COMPILED[key] = (_hea(JCircuit, n, layers).compile(envs[0]),
                          _hea(tq.Circuit, n, layers).compile(envs[1]))
    return _COMPILED[key]


@pytest.mark.parametrize("n,layers", [(5, 1), (9, 2)])
def test_gradients_match_jax(envs, n, layers):
    jc, tc = _compiled(envs, n, layers)
    if n >= 9:
        assert tc.num_layers > 0
    pm = _rows(len(tc.param_names), n)
    ham = _hamiltonian(n)
    want_v, want_g = (np.asarray(a) for a in jc.value_and_grad_sweep(pm, ham))
    before = lk.apply_layer_batched.launches
    vals, grads = tc.value_and_grad_sweep(pm, ham)
    assert lk.apply_layer_batched.launches == before   # no kernel on the CPU
    assert vals.shape == (B,) and grads.shape == (B, len(tc.param_names))
    assert vals.dtype == grads.dtype == np.float64
    assert np.abs(grads - want_g).max() <= GRAD_TOL
    assert np.abs(vals - want_v).max() <= GRAD_TOL
    # the values are the expectation_sweep energies
    assert np.abs(vals - tc.expectation_sweep(pm, ham)).max() <= TOL
    assert np.array_equal(tc.grad_sweep(pm, ham), grads)


def test_gradients_from_a_shared_start_state(envs):
    n = 5
    jc, tc = _compiled(envs, n, 1)
    rng = np.random.default_rng(11)
    z = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    z /= np.linalg.norm(z)
    sf = np.stack([z.real, z.imag])
    pm = _rows(len(tc.param_names), 12)
    ham = _hamiltonian(n, seed=4)
    import jax.numpy as jnp
    _, want = jc.value_and_grad_sweep(pm, ham, state_f=jnp.asarray(sf))
    _, got = tc.value_and_grad_sweep(pm, ham, state_f=torch.as_tensor(sf))
    assert np.abs(got - np.asarray(want)).max() <= GRAD_TOL


def test_gradients_of_every_parametrised_gate_kind(envs):
    """rx/ry/rotate (a matrix per row), rz, phase, cphase, crz and
    multi_rotate_z (diagonals), a controlled torch-callable gate (the
    identity off its control subspace) and one parameter read by two ops,
    against the JAX package."""
    n = 4

    def build(C):
        c = C(n)
        a, b, t = c.parameter("a"), c.parameter("b"), c.parameter("t")
        c.h(0).h(1).h(2).h(3)
        c.rx(0, a).ry(1, b).rotate(2, t, (0.3, -0.5, 0.8)).rz(3, a)
        c.phase(1, b).cphase(0, 2, t).crz(3, 1, a)
        c.multi_rotate_z((0, 2, 3), b)
        c.cnot(0, 3).cnot(2, 1)
        if C is tq.Circuit:
            c.gate(lambda p: torch.stack([
                torch.stack([torch.cos(p["t"]), -torch.sin(p["t"])]),
                torch.stack([torch.sin(p["t"]), torch.cos(p["t"])])]
            ).to(torch.complex128), (2,), (1,))
        else:
            import jax.numpy as jnp
            c.gate(lambda p: jnp.array(
                [[jnp.cos(p["t"]), -jnp.sin(p["t"])],
                 [jnp.sin(p["t"]), jnp.cos(p["t"])]], dtype=jnp.complex128),
                (2,), (1,))
        return c

    jc, tc = build(JCircuit).compile(envs[0]), build(tq.Circuit).compile(
        envs[1])
    pm = _rows(3, 5, batch=4)
    ham = _hamiltonian(n, num_terms=5, seed=9)
    _, want = jc.value_and_grad_sweep(pm, ham)
    vals, got = tc.value_and_grad_sweep(pm, ham)
    assert np.abs(got - np.asarray(want)).max() <= GRAD_TOL
    assert np.abs(vals - tc.expectation_sweep(pm, ham)).max() <= TOL


def test_expectation_fn_backward_is_the_sweep_row(envs):
    _, tc = _compiled(envs, 5, 1)
    terms, coeffs = _hamiltonian(5, seed=8)
    pm = _rows(len(tc.param_names), 21, batch=1)
    vals, grads = tc.value_and_grad_sweep(pm, (terms, coeffs))
    energy = tc.expectation_fn(terms, coeffs)
    theta = torch.tensor(pm[0], dtype=torch.float64, requires_grad=True)
    e = energy(theta)
    assert e.dim() == 0 and e.dtype == torch.float64
    e.backward()
    assert abs(float(e.detach()) - vals[0]) <= TOL
    assert np.abs(theta.grad.numpy() - grads[0]).max() <= TOL


# -- adjoint layers -----------------------------------------------------------

N = 14
TILE = lk.TILE_ROWS[torch.float64]
TOP = lk.max_mid_qubit(TILE) - lk.LANE_QUBITS
FAR = N - 8


def _unitary(rng, dim):
    z = rng.normal(size=(dim, dim)) + 1j * rng.normal(size=(dim, dim))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


def _stages(rng, kind, unitary=True):
    """One layer per stage kind (row bits in row-bit coordinates, FAR a row
    bit above the tile); ``unitary=False`` draws every operator and table
    as a plain complex matrix."""
    def m(dim):
        if unitary:
            return _unitary(rng, dim)
        return rng.normal(size=(dim, dim)) + 1j * rng.normal(size=(dim, dim))

    def tab(k):
        t = rng.uniform(0, 2 * np.pi, (1 << k, 128))
        return np.exp(1j * t) if unitary else \
            rng.normal(size=t.shape) * np.exp(1j * t)
    return {
        "lane": [("lane", m(128))],
        "clane": [("clane", m(128), 0b101 | (1 << FAR), 0b001 | (1 << FAR))],
        "row": [("row", 7 + TOP, m(2), 0b1000010, 0b0000010, 0, 0),
                ("row", 8, m(2), 0, 0, 0b100 | (1 << FAR), 0b100)],
        "rowk": [("rowk", (0, TOP), m(4), 0b11, 0b01, 1 << FAR, 1 << FAR),
                 ("rowk", (0, 2, TOP), m(8), 0, 0, 0, 0)],
        "rowdiag": [("rowdiag", tab(1), (FAR,)),
                    ("rowdiag", tab(3), (0, 3, FAR))],
        "rowmxu": [("rowmxu", (TOP,), m(256)),
                   ("rowmxu", (1, TOP), m(512))],
        "mixed": [("lane", m(128)),
                  ("row", 8, m(2), 0b10, 0b10, 1 << FAR, 0),
                  ("rowdiag", tab(2), (1, FAR)),
                  ("rowmxu", (TOP,), m(256)),
                  ("clane", m(128), 1 << FAR, 1 << FAR)],
    }[kind]


KINDS = ["lane", "clane", "row", "rowk", "rowdiag", "rowmxu", "mixed"]


def _random_planes(seed, batch):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(batch, 2, 1 << N))
    return torch.as_tensor(z / np.abs(z).max())


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
@pytest.mark.parametrize("kind", KINDS)
def test_adjoint_layer_undoes_the_layer(kind, batched):
    layer = lk.LayerOp(N, 1, _stages(np.random.default_rng(KINDS.index(
        kind)), kind))
    back = lk.adjoint_layer(layer)
    assert [st[0] for st in back.stages] == \
        [st[0] for st in reversed(layer.stages)]
    base = _random_planes(KINDS.index(kind), B)
    states = base.clone()
    if batched:
        lk.apply_layer_batched(states, N, layer)
        lk.apply_layer_batched(states, N, back)
    else:
        for b in range(B):
            lk.apply_layer(states[b], N, layer)
            lk.apply_layer(states[b], N, back)
    assert float((states - base).abs().max()) <= TOL


@pytest.mark.parametrize("kind", KINDS)
def test_adjoint_layer_is_the_adjoint(kind):
    """<a, L b> = <L^dag a, b> for a layer of non-unitary stages (a
    channel's lane stage in a density plan is one)."""
    rng = np.random.default_rng(40 + KINDS.index(kind))
    layer = lk.LayerOp(N, 1, _stages(rng, kind, unitary=False))
    a, b = _random_planes(50, 1), _random_planes(51, 1)
    lb = lk.apply_layer_batched(b.clone(), N, layer)
    la = lk.apply_layer_batched(a.clone(), N, lk.adjoint_layer(layer))

    def inner(x, y):
        xc = x[0, 0] + 1j * x[0, 1]
        yc = y[0, 0] + 1j * y[0, 1]
        return complex(torch.vdot(xc, yc))
    want = inner(a, lb)
    assert abs(inner(la, b) - want) <= TOL * max(1.0, abs(want))


# -- typed rejections --------------------------------------------------------

def test_quad_is_rejected_before_it_is_not_ported(envs):
    _, tc = _compiled(envs, 5, 1)
    pm = np.zeros((1, len(tc.param_names)))
    ham = _hamiltonian(5)
    with pytest.raises(ValueError, match="QUAD") as mine:
        tc.value_and_grad_sweep(pm, ham, tier="quad")
    jc, _ = _compiled(envs, 5, 1)
    with pytest.raises(ValueError, match="QUAD") as ref:
        jc.value_and_grad_sweep(pm, ham, tier="quad")
    assert str(mine.value) == str(ref.value)
    with pytest.raises(ValueError, match="QUAD"):
        tc.grad_sweep(pm, ham, tier="quad")


def test_parameterless_circuit_is_rejected(envs):
    ham = ([[(0, 3)]], [1.0])
    for C, env in ((JCircuit, envs[0]), (tq.Circuit, envs[1])):
        with pytest.raises(ValueError, match="nothing to differentiate"):
            C(3).h(0).compile(env).value_and_grad_sweep(np.zeros((1, 0)),
                                                        ham)


def test_owned_state_batch_is_rejected(envs):
    _, tc = _compiled(envs, 5, 1)
    pm = np.zeros((2, len(tc.param_names)))
    with pytest.raises(ValueError, match="must be shared"):
        tc.value_and_grad_sweep(pm, _hamiltonian(5),
                                state_f=torch.zeros(2, 2, 32))


@pytest.mark.parametrize("rows", [1, 2])
def test_numpy_callable_cannot_be_differentiated(envs, rows):
    """A numpy-only callable runs the forward at one binding, but its
    derivative (and a per-row binding) raises TypeError naming the op:
    never a silent zero."""
    c = tq.Circuit(2)
    a = c.parameter("a")
    c.h(0).ry(1, a)
    c.gate(lambda p: np.array([[np.cos(p["a"]), -np.sin(p["a"])],
                               [np.sin(p["a"]), np.cos(p["a"])]]), (0,))
    cc = c.compile(envs[1])
    pm = np.array([[0.3], [1.1]])[:rows]
    with pytest.raises(TypeError, match=r"qubits \(0,\).*torch-traceable"):
        cc.value_and_grad_sweep(pm, ([[(0, 1)], [(1, 3)]], [0.5, 1.0]))


# -- tiers -------------------------------------------------------------------

def test_fast_gradients_within_the_modeled_bound(envs):
    """FAST against SINGLE: the walk's gradients are 2 Re <lam, mu> with
    |lam| <= sum |c_t| and |mu| <= 1/2 (a rotation's generator); the tier
    model bounds each state's error by e = modeled_tier_error(FAST, gates),
    the forward and the reverse pass each add e to psi and lam, so
    |g_FAST - g_SINGLE| <= 2 (2e sum|c_t| / 2 + sum|c_t| 2e / 2)
    = 4 e sum|c_t|."""
    n = 9
    _, tc = _compiled(envs, n, 2)
    pm = _rows(len(tc.param_names), 30, batch=2)
    terms, coeffs = _hamiltonian(n, seed=31)
    before = lk.apply_layer_batched.fast_launches
    _, g_fast = tc.value_and_grad_sweep(pm, (terms, coeffs), tier="fast")
    _, g_single = tc.value_and_grad_sweep(pm, (terms, coeffs),
                                          tier="single")
    assert lk.apply_layer_batched.fast_launches == before
    e = tq.modeled_tier_error(tq.FAST_TIER, len(tc.circuit.ops))
    bound = 4.0 * e * float(np.abs(coeffs).sum())
    diff = float(np.abs(g_fast - g_single).max())
    assert 0.0 < diff <= bound


def test_gradients_on_several_threads_at_once(envs):
    """torch keeps one forward-AD level per process: gradient sweeps on
    several threads at once (a service dispatching while a front door
    warms the same program) each get their own derivatives."""
    import threading
    _, tenv = envs
    cc = _hea(tq.Circuit, 3, 1).compile(tenv)
    terms, coeffs = [[(0, 3)], [(1, 1), (2, 1)]], [1.0, 0.5]
    pm = np.random.default_rng(3).uniform(0, 2 * np.pi, size=(4, 6))
    want = [np.asarray(t) for t in
            cc.value_and_grad_sweep(pm, (terms, coeffs))]
    got, errors = [], []

    def work():
        try:
            for _ in range(10):
                got.append([np.asarray(t) for t in cc.value_and_grad_sweep(
                    pm, (terms, coeffs))])
        except Exception as e:   # noqa: BLE001 (the test reports it)
            errors.append(e)

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors[:1]
    assert len(got) == 40
    for vals, grads in got:
        np.testing.assert_array_equal(vals, want[0])
        np.testing.assert_array_equal(grads, want[1])
