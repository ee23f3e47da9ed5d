"""The PyTorch port's batched ensemble engine against the JAX package's, on
the CPU in float64.

- ``apply_layer_batched_plain`` (the batched layer kernel's plain version)
  against JAX ``apply_layer_batched(..., interpret=True)`` for every stage
  kind (grouped into six layers), on B = 3 distinct states of 14 qubits
  (two tiles per state, so a row coordinate taken from the wrong state
  would show);
- the gate engine's batched form (``core/apply.py``) with shared and
  per-row operators on each of its paths, against the JAX engine per state;
- ``CompiledCircuit.sweep`` (shared and owned start planes) and
  ``expectation_sweep`` against the JAX engine on a hardware-efficient
  ansatz, and ``calcExpecPauliSum`` against the JAX API;
- ``sample_sweep`` against the exact ``|amp|^2`` distribution (chi-square).

Deterministic bounds: 1e-12 on normalised states.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import quest_tpu as jq
from quest_tpu.circuits import Circuit as JCircuit
from quest_tpu.core import apply as japply
from quest_tpu.ops import pallas_kernels as pk
from quest_tpu.ops import reductions as jred
import quest_tpu_torch as tq
from quest_tpu_torch.core import apply as tapply
from quest_tpu_torch.ops import layer_kernel as lk
from quest_tpu_torch.ops import reductions as tred
from torch_threads import one_blas_thread  # noqa: F401

TOL = 1e-12
N = 14
B = 3
TILE = lk.TILE_ROWS[torch.float64]
TOP = lk.max_mid_qubit(TILE) - lk.LANE_QUBITS
FAR = N - 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; one intra-op
    thread per worker keeps this module's small torch ops from
    oversubscribing the cores the other workers use."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _unitary(rng, dim):
    z = rng.normal(size=(dim, dim)) + 1j * rng.normal(size=(dim, dim))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


def _states(seed, n=N, batch=B):
    rng = np.random.default_rng(500 + seed)
    z = rng.normal(size=(batch, 1 << n)) + 1j * rng.normal(
        size=(batch, 1 << n))
    return z / np.linalg.norm(z, axis=1, keepdims=True)


def _planes(z):
    return torch.as_tensor(np.stack([z.real, z.imag], axis=-2),
                           dtype=torch.float64)


def _complex(planes):
    p = planes.numpy()
    return p[..., 0, :] + 1j * p[..., 1, :]


def _stage_cases(rng):
    """Every stage kind, grouped into six layers (one JAX interpret-mode
    call each): row bits in row-bit coordinates (qubit = bit + 7), FAR a
    row bit above the tile."""
    ph = lambda k: np.exp(1j * rng.uniform(0, 2 * np.pi, (1 << k, 128)))
    return {
        "lane_clane": [("lane", _unitary(rng, 128)),
                       ("clane", _unitary(rng, 128), 0b101 | (1 << FAR),
                        0b001 | (1 << FAR))],
        "row": [("row", 7 + TOP, _unitary(rng, 2), 0, 0, 0, 0),
                ("row", 7 + TOP, _unitary(rng, 2), 0b1000010, 0b0000010,
                 0, 0),
                ("row", 8, _unitary(rng, 2), 0, 0, 0b100 | (1 << FAR),
                 0b100)],
        "rowk": [("rowk", (0, TOP), _unitary(rng, 4), 0b11, 0b01,
                  1 << FAR, 1 << FAR),
                 ("rowk", (0, 2, TOP), _unitary(rng, 8), 0, 0, 0, 0)],
        "rowdiag": [("rowdiag", ph(1), (FAR,)),
                    ("rowdiag", ph(2), (1, FAR)),
                    ("rowdiag", ph(3), (0, 3, FAR))],
        "rowmxu": [("rowmxu", (TOP,), _unitary(rng, 256)),
                   ("rowmxu", (1, TOP), _unitary(rng, 512))],
        "mixed": [("lane", _unitary(rng, 128)),
                  ("row", 8, _unitary(rng, 2), 0b10, 0b10, 1 << FAR, 0),
                  ("rowdiag", ph(2), (1, FAR)),
                  ("clane", _unitary(rng, 128), 1 << FAR, 1 << FAR)],
    }


STAGE_NAMES = list(_stage_cases(np.random.default_rng(0)))


@pytest.mark.parametrize("name", STAGE_NAMES)
def test_batched_plain_layer_matches_pallas_interpret(name):
    stages = _stage_cases(np.random.default_rng(
        STAGE_NAMES.index(name)))[name]
    z = _states(STAGE_NAMES.index(name))
    want = np.asarray(pk.apply_layer_batched(
        jnp.asarray(z), N, pk.LayerOp(N, 1, stages), block_rows=TILE,
        interpret=True))
    states = _planes(z)
    before = lk.apply_layer_batched.launches
    out = lk.apply_layer_batched(states, N, lk.LayerOp(N, 1, stages))
    assert out is states                            # in place
    assert lk.apply_layer_batched.launches == before  # no kernel on the CPU
    assert np.abs(_complex(states) - want).max() <= TOL


def test_batched_layer_wrapper_checks_its_inputs():
    layer = lk.LayerOp(N, 1, [("lane", np.eye(128))])
    states = _planes(_states(0))
    with pytest.raises(ValueError, match="shape"):
        lk.apply_layer_batched(states[0], N, layer)
    with pytest.raises(ValueError, match="contiguous"):
        lk.apply_layer_batched(states.transpose(0, 1).contiguous()
                               .transpose(0, 1), N, layer)
    with pytest.raises(ValueError, match="collected for"):
        lk.apply_layer_batched(_planes(_states(0, N + 1)), N + 1, layer)


# -- the gate engine's batched form ----------------------------------------

def _ref_apply(z, n, u, targets, cmask=0, fmask=0, diag=None):
    """The JAX engine, state by state."""
    out = []
    for b in range(z.shape[0]):
        if diag is not None:
            d = diag[b] if diag.ndim > len(targets) else diag
            out.append(np.asarray(japply.apply_diagonal(
                jnp.asarray(z[b]), n, targets, jnp.asarray(d))))
        else:
            ub = u[b] if u.ndim == 3 else u
            out.append(np.asarray(japply.apply_unitary(
                jnp.asarray(z[b]), n, jnp.asarray(ub), targets, cmask,
                fmask)))
    return np.stack(out)


@pytest.mark.parametrize("case", [
    "lowest_shared", "lowest_per_row", "lowest_permuted_per_row",
    "block_shared", "block_per_row", "controlled_per_row",
    "controlled_flip_shared", "scattered_per_row"])
def test_batched_apply_unitary_matches_jax(case):
    n = 7
    rng = np.random.default_rng(len(case))
    targets, cmask, fmask = {
        "lowest_shared": ((0, 1), 0, 0),
        "lowest_per_row": ((0, 1, 2), 0, 0),
        "lowest_permuted_per_row": ((1, 0), 0, 0),
        "block_shared": ((3, 4), 0, 0),
        "block_per_row": ((5, 4, 6), 0, 0),
        "controlled_per_row": ((2,), 0b1000001, 0),
        "controlled_flip_shared": ((4, 1), 0b100, 0b100),
        "scattered_per_row": ((6, 1), 0, 0)}[case]
    d = 1 << len(targets)
    u = np.stack([_unitary(rng, d) for _ in range(B)]) \
        if "per_row" in case else _unitary(rng, d)
    z = _states(len(case), n)
    want = _ref_apply(z, n, u, targets, cmask, fmask)
    states = _planes(z)
    tapply.apply_unitary(states, n, u, targets, cmask, fmask)
    assert np.abs(_complex(states) - want).max() <= TOL


@pytest.mark.parametrize("per_row", [False, True])
def test_batched_apply_diagonal_matches_jax(per_row):
    n = 7
    rng = np.random.default_rng(3)
    qubits = (6, 3, 0)
    shape = ((B,) if per_row else ()) + (2, 2, 2)
    diag = np.exp(1j * rng.uniform(0, 2 * np.pi, shape))
    z = _states(9, n)
    want = _ref_apply(z, n, None, qubits, diag=diag)
    states = _planes(z)
    tapply.apply_diagonal(states, n, qubits, diag)
    assert np.abs(_complex(states) - want).max() <= TOL


# -- the engine ---------------------------------------------------------------

def _hea(C, n, layers=2):
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


@pytest.fixture(scope="module")
def envs():
    return (jq.createQuESTEnv(num_devices=1, precision=jq.DOUBLE, seed=[3]),
            tq.createQuESTEnv(device="cpu", precision=tq.DOUBLE, seed=[3]))


_COMPILED = {}


def _compiled(envs, n):
    if n not in _COMPILED:
        _COMPILED[n] = (_hea(JCircuit, n).compile(envs[0], pallas="interpret"),
                        _hea(tq.Circuit, n).compile(envs[1]))
    return _COMPILED[n]


def _hamiltonian(n, num_terms=6, seed=2026):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(num_terms, n))
    coeffs = rng.normal(size=num_terms)
    return [[(q, int(codes[t, q])) for q in range(n)]
            for t in range(num_terms)], coeffs


@pytest.mark.parametrize("n", [8, 10])
@pytest.mark.parametrize("start", ["zero", "shared", "owned"])
def test_sweep_matches_jax_engine(envs, n, start):
    jc, tc = _compiled(envs, n)
    assert tc.num_layers > 0
    rng = np.random.default_rng(n)
    pm = rng.uniform(0, 2 * np.pi, size=(B, len(tc.param_names)))
    if start == "zero":
        want = np.asarray(jc.sweep(pm))
        got = tc.sweep(pm)
    elif start == "shared":
        z = _states(n, n, 1)[0]
        sf = np.stack([z.real, z.imag])
        want = np.asarray(jc.sweep(pm, state_f=jnp.asarray(sf)))
        got = tc.sweep(pm, state_f=torch.as_tensor(sf))
    else:
        z = _states(n, n)
        sf = np.stack([z.real, z.imag], axis=1)
        want = np.asarray(jc.sweep(pm, state_f=jnp.asarray(sf)))
        owned = torch.as_tensor(sf.copy())
        got = tc.sweep(pm, state_f=owned)
        assert got.data_ptr() == owned.data_ptr()    # updated in place
    assert got.shape == (B, 2, 1 << n)
    assert np.abs(got.numpy() - want).max() <= TOL


@pytest.mark.parametrize("n", [8, 10])
def test_expectation_sweep_matches_jax_engine(envs, n):
    jc, tc = _compiled(envs, n)
    pm = np.random.default_rng(7 + n).uniform(
        0, 2 * np.pi, size=(B, len(tc.param_names)))
    ham = _hamiltonian(n)
    want = np.asarray(jc.expectation_sweep(pm, ham))
    got = tc.expectation_sweep(pm, ham)
    assert got.shape == (B,)
    assert np.abs(got - want).max() <= TOL


def test_sweep_checks_its_inputs(envs):
    _, tc = _compiled(envs, 8)
    p = len(tc.param_names)
    with pytest.raises(ValueError, match="param_matrix"):
        tc.sweep(np.zeros((2, p + 1)))
    with pytest.raises(ValueError, match="state_f"):
        tc.sweep(np.zeros((2, p)), state_f=torch.zeros(3, 2, 256))
    with pytest.raises(ValueError, match="shared"):
        tc.expectation_sweep(np.zeros((2, p)), _hamiltonian(8),
                             state_f=torch.zeros(2, 2, 256))
    with pytest.raises(ValueError, match="repeats qubit"):
        tc.expectation_sweep(np.zeros((2, p)), ([[(0, 1), (0, 3)]], [1.0]))


# -- Pauli sums ------------------------------------------------------------

@pytest.mark.parametrize("n,num_terms", [(5, 1), (6, 9), (9, 20)])
def test_calc_expec_pauli_sum_matches_jax(n, num_terms):
    z = _states(n, n, 1)[0]
    rng = np.random.default_rng(num_terms)
    codes = [int(c) for c in rng.integers(0, 4, size=num_terms * n)]
    coeffs = list(rng.normal(size=num_terms))
    jenv = jq.createQuESTEnv(num_devices=1, precision=jq.DOUBLE)
    tenv = tq.createQuESTEnv(device="cpu", precision=tq.DOUBLE)
    jqr = jq.createQureg(n, jenv)
    jq.initStateFromAmps(jqr, z.real, z.imag)
    tqr = tq.createQureg(n, tenv)
    tq.initStateFromAmps(tqr, z.real, z.imag)
    want = jq.calcExpecPauliSum(jqr, codes, coeffs, num_terms)
    got = tq.calcExpecPauliSum(tqr, codes, coeffs, num_terms)
    assert abs(got - want) <= TOL


@pytest.mark.parametrize("codes,coeffs,num_terms,code", [
    ([0, 4, 0], [1.0], 1, tq.ErrorCode.E_INVALID_PAULI_CODE),
    ([0, 1, 0], [], 0, tq.ErrorCode.E_INVALID_NUM_SUM_TERMS)])
def test_calc_expec_pauli_sum_validates_like_jax(codes, coeffs, num_terms,
                                                 code):
    jqr = jq.createQureg(3, jq.createQuESTEnv(num_devices=1))
    tqr = tq.createQureg(3, tq.createQuESTEnv(device="cpu"))
    with pytest.raises(jq.QuESTError) as ref:
        jq.calcExpecPauliSum(jqr, codes, coeffs, num_terms)
    with pytest.raises(tq.QuESTError) as mine:
        tq.calcExpecPauliSum(tqr, codes, coeffs, num_terms)
    assert int(mine.value.code) == int(ref.value.code) == int(code)


@pytest.mark.parametrize("num_terms", [1, 8, 9, 30])
def test_pauli_sum_operands_match_jax(num_terms):
    n = 6
    rng = np.random.default_rng(num_terms)
    codes = rng.integers(0, 4, size=num_terms * n)
    coeffs = rng.normal(size=num_terms)
    assert tred.pauli_term_bucket(num_terms) == \
        jred.pauli_term_bucket(num_terms)
    for a, b in zip(tred.pauli_sum_operands(codes, n, coeffs),
                    jred.pauli_sum_operands(codes, n, coeffs)):
        assert np.array_equal(a, b)


# -- shots ------------------------------------------------------------------

def test_sample_sweep_matches_the_amplitudes(envs):
    """Each point's shots follow its own |amp|^2 (chi-square, p > 1e-4 for
    every point, with a fixed seed)."""
    n, shots = 4, 4000
    tc = _hea(tq.Circuit, n).compile(envs[1])
    pm = np.random.default_rng(4).uniform(0, 2 * np.pi,
                                          size=(B, len(tc.param_names)))
    gen = torch.Generator().manual_seed(12)
    idx, totals = tc.sample_sweep(pm, shots, generator=gen)
    assert idx.shape == (B, shots) and idx.dtype == np.int64
    assert np.allclose(totals, 1.0, atol=1e-12)
    probs = np.abs(_complex(tc.sweep(pm))) ** 2
    for b in range(B):
        counts = np.bincount(idx[b], minlength=1 << n)
        keep = probs[b] * shots >= 5
        expect = probs[b][keep] * shots
        observed = counts[keep]
        chi2 = float(((observed - expect) ** 2 / expect).sum())
        assert stats.chi2.sf(chi2, keep.sum() - 1) > 1e-4
        assert counts[~keep].sum() <= 5 * max(probs[b][~keep].sum() * shots,
                                              1.0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the batched layer kernel runs only on "
                    "the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
def test_batched_kernel_matches_plain_on_card(card, dtype, tol):
    n = 20
    rng = np.random.default_rng(5)
    stages = _stage_cases(rng)["mixed"]
    layer = lk.LayerOp(n, len(stages), stages)
    z = _states(3, n, 4)
    base = torch.as_tensor(np.stack([z.real, z.imag], axis=1), dtype=dtype,
                           device=card)
    want = lk.apply_layer_batched_plain(base.clone(), n, layer)
    before = lk.apply_layer_batched.launches
    got = lk.apply_layer_batched(base.clone(), n, layer)
    torch.cuda.synchronize()
    assert lk.apply_layer_batched.launches == before + 1
    assert float((got - want).abs().max()) <= tol
