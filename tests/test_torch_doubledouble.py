"""The port's double-double arithmetic (``ops/doubledouble.py``) against the
JAX package's, on the CPU.

Mirrors the single-device dd tests of ``tests/test_doubledouble.py`` with
the same bars (1e-11 drift after 1000 gates, ``DDProgram`` at 1e-12,
dd-f64 below 1e-28 against a 60-digit oracle), and runs the same
numpy-seeded inputs through the JAX package's functions beside the port's.
Its ``TestQuadTier`` (the golden corpus on QUAD registers, controlled
k-qubit gates, inner products) is ``tests/test_torch_quad_golden.py``: the
JAX side compiles one executable per dd signature, and the two halves keep
each file's time down.

Each error-free transformation and dd primitive is held against the JAX
function on the same random float32 and float64 inputs: every dd value of
the port's output within 2^-45 (float32 planes) or 2^-100 (float64 planes)
of the JAX value, relative to the largest. The two packages run the same
IEEE operations in the same order, so they agree far inside those bars.
The scalar reductions leave both packages as Python floats combined in
double precision, so those are held to the same bar of the inputs' unit
scale, or two double ulps of the value where that is larger.
"""

import contextlib
from decimal import Decimal, getcontext

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quest_tpu as jq
from quest_tpu.circuits import Circuit as JCircuit
from quest_tpu.ops import doubledouble as jdd
from quest_tpu.ops import reductions as jred
import quest_tpu_torch as tq
from quest_tpu_torch import algorithms as talg
from quest_tpu_torch.ops import doubledouble as tdd
from quest_tpu_torch.ops import reductions as tred
from torch_threads import one_blas_thread  # noqa: F401

N = 10
# dd agreement bars per plane dtype, relative to the largest value
BARS = {np.float32: 2.0 ** -45, np.float64: 2.0 ** -100}


def _random_u(rng, dim=2):
    z = rng.standard_normal((dim, dim)) + 1j * rng.standard_normal((dim, dim))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


def _oracle_apply(psi, n, u, t):
    pre = 1 << (n - 1 - t)
    post = 1 << t
    v = psi.reshape(pre, 2, post)
    return np.einsum("rc,pcq->prq", u, v).reshape(-1)


def _dd_rel(got_hi, got_lo, want_hi, want_lo) -> float:
    """max |dd(got) - dd(want)| / max |dd(want)|, the difference formed
    plane by plane in float64 (exact while the hi parts agree)."""
    gh, gl, wh, wl = (np.asarray(a, dtype=np.float64) for a in
                      (got_hi, got_lo, want_hi, want_lo))
    diff = np.abs((gh - wh) + (gl - wl))
    return float(diff.max() / max(np.abs(wh).max(), 1e-300))


def _planes_rel(got, want) -> float:
    """:func:`_dd_rel` over both components of (4, ...) dd planes."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return max(_dd_rel(got[0], got[1], want[0], want[1]),
               _dd_rel(got[2], got[3], want[2], want[3]))


def _scalar_close(got: float, want: float, bar: float) -> bool:
    """Two double ulps of the value, or ``bar`` of the inputs' unit scale
    (the states are normalised, so every sum of products is bounded by 1
    and a cancelling sum keeps the absolute bar)."""
    return abs(got - want) <= max(2 * np.spacing(abs(want)), bar)


def _both(planes_np):
    """The same host planes as a torch tensor and a jnp array."""
    return torch.from_numpy(planes_np), jnp.asarray(planes_np)


def _random_planes(rng, n, dtype):
    psi = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    psi /= np.linalg.norm(psi)
    # a genuine lo part: perturb below the hi dtype's resolution
    eps = np.finfo(dtype).eps
    psi = psi + eps * 1e-3 * (rng.standard_normal(1 << n)
                              + 1j * rng.standard_normal(1 << n))
    return jdd._dd_split_host(psi, dtype)


# ---------------------------------------------------------------------------
# error-free transformations and primitives against the JAX functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_eft_match_jax(dtype):
    rng = np.random.default_rng(11)
    bar = BARS[dtype]
    a, b, c, d = (rng.standard_normal(4096).astype(dtype) for _ in range(4))
    c = c * np.finfo(dtype).eps         # lo parts
    d = d * np.finfo(dtype).eps
    ta, tb, tc_, td = (torch.from_numpy(x) for x in (a, b, c, d))
    ja, jb, jc_, jd = (jnp.asarray(x) for x in (a, b, c, d))
    s_t, e_t = tred._two_sum(ta, tb)
    s_j, e_j = jred._two_sum(ja, jb)
    assert _dd_rel(s_t, e_t, s_j, e_j) <= bar
    # the transformations are exact: s + e == a + b in exact arithmetic
    exact = np.asarray(a, np.float64) + np.asarray(b, np.float64)
    if dtype == np.float32:
        assert np.array_equal(s_t.numpy().astype(np.float64)
                              + e_t.numpy().astype(np.float64), exact)
    for fn in ("_two_prod", "_quick_two_sum"):
        got = getattr(tdd, fn)(ta, tb * 1e-3 if fn == "_quick_two_sum"
                               else tb)
        want = getattr(jdd, fn)(ja, jb * 1e-3 if fn == "_quick_two_sum"
                                else jb)
        assert _dd_rel(*got, *want) <= bar, fn
    p_t, e_t = tdd._two_prod(ta, tb)
    if dtype == np.float32:
        assert np.array_equal(p_t.numpy().astype(np.float64)
                              + e_t.numpy().astype(np.float64),
                              np.asarray(a, np.float64)
                              * np.asarray(b, np.float64))
    for fn in ("_dd_add", "_dd_mul"):
        got = getattr(tdd, fn)(ta, tc_, tb, td)
        want = getattr(jdd, fn)(ja, jc_, jb, jd)
        assert _dd_rel(*got, *want) <= bar, fn
    hi_t, lo_t = tred._split(ta)
    hi_j, lo_j = jred._split(ja)
    assert np.array_equal(hi_t.numpy(), np.asarray(hi_j))
    assert np.array_equal(lo_t.numpy(), np.asarray(lo_j))
    # the Veltkamp constant: 2^12 + 1 for float32, 2^27 + 1 for float64
    bits = 12 if dtype == np.float32 else 27
    x = torch.tensor([1.0 + 2.0 ** -20], dtype=ta.dtype)
    want_hi = (x * float((1 << bits) + 1))
    want_hi = want_hi - (want_hi - x)
    assert tred._split(x)[0].item() == want_hi.item()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_gate_primitives_match_jax(dtype):
    rng = np.random.default_rng(12)
    n = 7
    bar = BARS[dtype]
    host = _random_planes(rng, n, dtype)
    tp, jp = _both(host)
    u1 = _random_u(rng)
    u3 = _random_u(rng, 8)
    assert _planes_rel(tdd.dd_apply_1q(tp, n, u1, 3),
                       jdd.dd_apply_1q(jp, n, u1, 3)) <= bar
    # k = 1 with controls, k = 2 (the JAX package's unrolled form, run
    # without jit: its compile takes ~4 s), k = 3 (its scanned form)
    for targets, cm, fm, jit in (((0,), 0b1010000, 0b10000, True),
                                 ((6, 2), 1, 1, False),
                                 ((5, 1, 2), 0, 0, True)):
        u = u3 if len(targets) == 3 else _random_u(rng, 1 << len(targets))
        got = tdd.dd_apply_kq(tp, n, u, targets, cm, fm)
        with (contextlib.nullcontext() if jit else jax.disable_jit()):
            want = jdd.dd_apply_kq(jp, n, u, targets, cm, fm)
        assert _planes_rel(got, want) <= bar, targets
        got = tdd.dd_apply_kq_traced(tp, n, torch.from_numpy(u), targets,
                                     cm, fm)
        assert _planes_rel(got, want) <= bar, targets
    for t, c in ((2, -1), (0, 5)):
        got = tdd.dd_apply_perm_1q(tp, n, t, c)
        want = jdd.dd_apply_perm_1q(jp, n, t, c)
        assert np.array_equal(got.numpy(), np.asarray(want))
    diag = np.exp(1j * rng.uniform(0, 6.3, size=(2, 2, 2)))
    got = tdd.dd_apply_diag(tp, n, diag, (6, 3, 1))
    want = jdd.dd_apply_diag(jp, n, diag, (6, 3, 1))
    assert _planes_rel(got, want) <= bar
    got = tdd.dd_apply_diag_traced(tp, n, torch.from_numpy(diag), (6, 3, 1))
    assert _planes_rel(got, want) <= bar
    # a batch of two rows, each with its own operator, equals the rows alone
    u_rows = np.stack([_random_u(rng), _random_u(rng)])
    batch = torch.stack([tp, tdd.dd_apply_1q(tp, n, u1, 0)])
    got = tdd.dd_apply_kq_traced(batch, n, torch.from_numpy(u_rows), (4,))
    for b in range(2):
        assert torch.equal(got[b], tdd.dd_apply_kq(batch[b], n, u_rows[b],
                                                   (4,)))
    before, after = rng.permutation(n), rng.permutation(n)
    got = tdd.dd_relayout(tp, n, before, after)
    want = jdd.dd_relayout(jp, n, before, after)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_register_primitives_match_jax(dtype):
    rng = np.random.default_rng(13)
    n = 6                                      # a 3-qubit density register
    bar = BARS[dtype]
    tp, jp = _both(_random_planes(rng, n, dtype))
    tq_, jq_ = _both(_random_planes(rng, n, dtype))
    small_t, small_j = _both(_random_planes(rng, 3, dtype))
    for conj_left in (False, True):
        assert _planes_rel(tdd.dd_outer(small_t, conj_left),
                           jdd.dd_outer(small_j, conj_left)) <= bar
    got = tdd.dd_weighted(0.3 - 0.2j, tp, 1.1, tq_, -0.4j, tp)
    want = jdd.dd_weighted(0.3 - 0.2j, jp, 1.1, jq_, -0.4j, jp)
    assert _planes_rel(got, want) <= bar
    for density, qubit in ((False, 4), (True, 1)):
        got = tdd.dd_collapse(tp, n, qubit, 1, 0.37, density=density)
        want = jdd.dd_collapse(jp, n, qubit, 1, 0.37, density=density)
        assert _planes_rel(got, want) <= bar
    z = rng.standard_normal((3, 4)) + 1j * rng.standard_normal((3, 4))
    got = tdd.dd_split_traceable(torch.from_numpy(z), dtype=tp.dtype)
    want = jdd.dd_split_traceable(jnp.asarray(z), dtype=jnp.dtype(dtype))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(tdd.dd_join_traceable(got).numpy(),
                          np.asarray(jdd.dd_join_traceable(want)))
    assert np.array_equal(tdd.dd_unpack(tp), jdd.dd_unpack(np.asarray(jp)))
    scalars = [
        (tdd.dd_total_prob(tp), jdd.dd_total_prob(jp)),
        (tdd.dd_total_prob_dm(tp, 3), jdd.dd_total_prob_dm(jp, 3)),
        (tdd.dd_prob_zero_sv(tp, n, 2), jdd.dd_prob_zero_sv(jp, n, 2)),
        (tdd.dd_prob_zero_dm(tp, 3, 1), jdd.dd_prob_zero_dm(jp, 3, 1)),
    ]
    for conj_a in (True, False):
        got, want = tdd.dd_vdot(tp, tq_, conj_a), jdd.dd_vdot(jp, jq_, conj_a)
        scalars += [(got.real, want.real), (got.imag, want.imag)]
    for got, want in scalars:
        assert _scalar_close(got, want, bar), (got, want)


# ---------------------------------------------------------------------------
# the mirrored tests of tests/test_doubledouble.py
# ---------------------------------------------------------------------------

def test_dd_1000_gates_matches_f64():
    rng = np.random.default_rng(7)
    psi = rng.standard_normal(1 << N) + 1j * rng.standard_normal(1 << N)
    psi /= np.linalg.norm(psi)

    # the oracle is the bar here, as in the JAX package's test; the dd
    # gates' parity with the JAX package is test_gate_primitives_match_jax
    state_t = tdd.dd_pack(psi)
    oracle = psi.copy()
    for i in range(1000):
        if i % 7 == 3:
            c, t = int(rng.integers(N)), int(rng.integers(N))
            if c == t:
                continue
            idx = np.arange(1 << N)
            oracle = oracle[np.where(((idx >> c) & 1) == 1,
                                     idx ^ (1 << t), idx)]
            state_t = tdd.dd_apply_perm_1q(state_t, N, t, c)
        else:
            u, t = _random_u(rng), int(rng.integers(N))
            oracle = _oracle_apply(oracle, N, u, t)
            state_t = tdd.dd_apply_1q(state_t, N, u, t)

    got = tdd.dd_unpack(state_t)
    err_dd = float(np.max(np.abs(got - oracle)))
    assert err_dd < 1e-11, f"dd amplitude drift {err_dd:.2e}"
    p = tdd.dd_total_prob(state_t)
    assert abs(p - float(np.sum(np.abs(oracle) ** 2))) < 1e-10


def test_dd_roundtrip_and_perm():
    rng = np.random.default_rng(3)
    psi = rng.standard_normal(64) + 1j * rng.standard_normal(64)
    planes = tdd.dd_pack(psi)
    assert np.array_equal(planes.numpy(), np.asarray(jdd.dd_pack(psi)))
    np.testing.assert_allclose(tdd.dd_unpack(planes), psi, atol=1e-14)
    # X then X is identity, exactly (permutations are error-free)
    out = tdd.dd_apply_perm_1q(tdd.dd_apply_perm_1q(planes, 6, 2), 6, 2)
    assert torch.equal(out, planes)
    with pytest.raises(ValueError, match="control qubit must differ"):
        tdd.dd_apply_perm_1q(planes, 6, 2, 2)


def _brickwork(C, n, layers):
    """bench.py ``build_bench_circuit``, built on either package's
    Circuit."""
    rng = np.random.default_rng(2026)
    c = C(n)
    for layer in range(layers):
        for q in range(n):
            c.rotate(q, float(rng.uniform(0, 2 * np.pi)), rng.normal(size=3))
        for q in range(layer % 2, n - 1, 2):
            c.cnot(q, q + 1)
    return c


def test_dd_program_brickwork():
    """compile_dd on the bench workload tracks the float64 compiled path
    below 1e-12 (``tests/test_torch_quad.py`` holds compile_dd against the
    JAX package's)."""
    n = 8
    tenv = tq.createQuESTEnv(device="cpu", seed=[9], precision=tq.DOUBLE)
    q = tq.createQureg(n, tenv)
    _brickwork(tq.Circuit, n, 4).compile(tenv).run(q)
    ref = q.to_numpy()

    prog = _brickwork(tq.Circuit, n, 4).compile_dd(tenv, dtype=np.float32)
    assert prog.device.type == "cpu" and prog.dtype == np.float32
    planes = prog.run(prog.init_zero())
    got = prog.unpack(planes)
    assert np.max(np.abs(got - ref)) < 1e-12
    assert abs(prog.total_prob(planes) - 1.0) < 1e-12


def test_dd_program_qft_phase_family():
    """QFT exercises the dd diagonal path (cphase) and the SWAP
    decomposition."""
    from quest_tpu import algorithms as jalg
    n = 5
    tenv = tq.createQuESTEnv(device="cpu", seed=[9], precision=tq.DOUBLE)
    jenv = jq.createQuESTEnv(num_devices=1, seed=[9], precision=jq.DOUBLE)
    q = tq.createQureg(n, tenv)
    tq.initDebugState(q)
    talg.qft(n).compile(tenv).run(q)
    ref = q.to_numpy()

    prog = talg.qft(n).compile_dd(tenv, dtype=np.float32)
    q2 = tq.createQureg(n, tenv)
    tq.initDebugState(q2)
    planes = prog.run(prog.pack(q2.to_numpy()))
    assert np.max(np.abs(prog.unpack(planes) - ref)) < 1e-12
    jprog = jalg.qft(n).compile_dd(jenv, dtype=np.float32)
    jplanes = jprog.run(jprog.pack(q2.to_numpy()))
    assert np.max(np.abs(prog.unpack(planes) - jprog.unpack(jplanes))) \
        <= 1e-13 * np.max(np.abs(ref))


def test_dd_program_rejects_unsupported():
    """The same ValueErrors as the JAX package's DDProgram, with its
    messages."""
    tenv = tq.createQuESTEnv(device="cpu", seed=[9])
    jenv = jq.createQuESTEnv(num_devices=1, seed=[9])
    cases = [
        (lambda c: c.gate(np.kron(np.eye(2), np.eye(2)), (0, 1)),
         "multi-target dense gates"),
        (lambda c: c.ry(0, c.parameter("a")), "parameterised gates"),
    ]
    for build, msg in cases:
        for C, env in ((tq.Circuit, tenv), (JCircuit, jenv)):
            c = C(3)
            build(c)
            with pytest.raises(ValueError, match=msg):
                c.compile_dd(env)


def test_dd_f64_quad_tier_beats_plain_f64():
    """Double-double over float64 planes against a 60-digit Decimal oracle
    over 120 random rotations at 3 qubits: plain f64 drifts ~1e-15, dd-f64
    stays below 1e-28, and its planes match the JAX package's dd gates on
    float64 planes within 2^-100 of the largest."""
    getcontext().prec = 60
    n, depth = 3, 120
    rng = np.random.default_rng(23)
    c = tq.Circuit(n)
    mats = []
    for i in range(depth):
        th, ax = float(rng.uniform(0, 6.28)), rng.normal(size=3)
        c.rotate(i % n, th, ax)
        mats.append((i % n, c.ops[-1].mat))

    def d(x):
        return Decimal(float(x))

    state = [(Decimal(0), Decimal(0)) for _ in range(1 << n)]
    state[0] = (Decimal(1), Decimal(0))
    for t, u in mats:
        ud = [[(d(u[r, cc].real), d(u[r, cc].imag)) for cc in range(2)]
              for r in range(2)]
        new = list(state)
        for base in range(1 << n):
            if (base >> t) & 1:
                continue
            i0, i1 = base, base | (1 << t)
            z0, z1 = state[i0], state[i1]
            for r, out_i in ((0, i0), (1, i1)):
                (ar, ai), (br, bi) = ud[r][0], ud[r][1]
                re = ar * z0[0] - ai * z0[1] + br * z1[0] - bi * z1[1]
                im = ar * z0[1] + ai * z0[0] + br * z1[1] + bi * z1[0]
                new[out_i] = (re, im)
        state = new

    env64 = tq.createQuESTEnv(device="cpu", seed=[1], precision=tq.DOUBLE)
    q = tq.createQureg(n, env64)
    c.compile(env64).run(q)
    f64_out = q.to_numpy()

    prog = tdd.DDProgram(list(c.ops), n, dtype=np.float64, device="cpu")
    dd_planes = prog.run(prog.init_zero()).numpy()
    jplanes = jdd.dd_pack(np.eye(1 << n)[0], dtype=np.float64)
    for t, u in mats:
        jplanes = jdd.dd_apply_1q(jplanes, n, u, t)
    assert _planes_rel(dd_planes, jplanes) <= 2.0 ** -100

    def err_vs_oracle(planes):
        worst = Decimal(0)
        for i, (orc_re, orc_im) in enumerate(state):
            dr = abs(d(planes[0][i]) + d(planes[1][i]) - orc_re)
            di = abs(d(planes[2][i]) + d(planes[3][i]) - orc_im)
            worst = max(worst, dr, di)
        return float(worst)

    err_f64 = err_vs_oracle([f64_out.real, np.zeros(1 << n),
                             f64_out.imag, np.zeros(1 << n)])
    err_dd = err_vs_oracle(dd_planes)
    assert err_f64 > 1e-16, f"oracle sanity: f64 drift {err_f64:.2e}"
    assert err_dd < 1e-28, f"dd-f64 drift {err_dd:.2e}"
    assert err_dd < err_f64 * 1e-10
