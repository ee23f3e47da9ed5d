"""The PyTorch port's precision-tier ladder against the JAX package's.

Covered, on the CPU, with the same numpy-seeded inputs on both sides:

- the ladder (``config.py``) and the error model and budget selector
  (``profiling.py``): fields, modeled errors and runtime tolerances to
  1e-15, and the rung ``choose_tier`` picks over the whole ladder, QUAD
  included on a float64 environment (the compile-time ladder leaves QUAD
  out in both packages);
- the FAST function itself: the port's plain FAST dense stages against a
  float64 numpy oracle that rounds hi, lo and the operator to bf16 with
  ``jnp.bfloat16`` (round to nearest even, as torch and CUDA round), to
  1e-6 of the largest amplitude;
- FAST against the JAX package: its FAST branch runs near float32 on the
  CPU (``Precision.DEFAULT`` is full f32 there) while the port's rounds
  to bf16, so they agree within the tier's own budget
  (``modeled_tier_error``, absolute; for energies the JAX suite's own
  energy bar), never bitwise, and FAST must differ from SINGLE;
- SINGLE and DOUBLE: env-dtype planes out of every tier, DOUBLE to 1e-12
  of the JAX package, compensated Pauli energies to 2 ulp of the JAX
  package's compensated ones on the same float32 states;
- the calibration compiles WITH layers, so it measures the FAST drift that
  lives in the layer kernel.

The JAX side compiles with ``pallas="interpret"`` (the Pallas kernels in
interpret mode), as ``tests/test_precision_tiers.py`` does. The error
model's seeds are pinned (``QUEST_TPU_TIER_MODEL=default``) except where
the calibration itself is under test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quest_tpu as jq
from quest_tpu import profiling as jprof
from quest_tpu.circuits import Circuit as JCircuit
from quest_tpu.ops import pallas_kernels as pk
from quest_tpu.ops import reductions as jred
import quest_tpu_torch as tq
from quest_tpu_torch import interop
from quest_tpu_torch import profiling as tprof
from quest_tpu_torch.ops import layer_kernel as lk
from quest_tpu_torch.ops import reductions as tred
from torch_threads import one_blas_thread  # noqa: F401

GATE_COUNTS = (1, 7, 89, 144, 1000, 100000)


@pytest.fixture(autouse=True)
def _seed_model(monkeypatch):
    for name in ("QUEST_TPU_TIER_CALIBRATE", "QUEST_TPU_TIER_SILICON"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("QUEST_TPU_TIER_MODEL", "default")


@pytest.fixture(scope="module")
def envs():
    return {
        "double": (jq.createQuESTEnv(num_devices=1, precision=jq.DOUBLE,
                                     seed=[5]),
                   tq.createQuESTEnv(device="cpu", precision=tq.DOUBLE,
                                     seed=[5])),
        "single": (jq.createQuESTEnv(num_devices=1, precision=jq.SINGLE,
                                     seed=[5]),
                   tq.createQuESTEnv(device="cpu", precision=tq.SINGLE,
                                     seed=[5])),
    }


def _unitary(rng, dim):
    z = rng.normal(size=(dim, dim)) + 1j * rng.normal(size=(dim, dim))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


# ---------------------------------------------------------------------------
# the ladder, the model and the selector
# ---------------------------------------------------------------------------

def test_ladder_matches_jax():
    assert len(tq.TIER_LADDER) == len(jq.TIER_LADDER) == 4
    for j, t in zip(jq.TIER_LADDER, tq.TIER_LADDER):
        assert (t.name, t.rank, t.drift_per_gate, t.matmul_precision,
                t.compensated) == (j.name, j.rank, j.drift_per_gate,
                                   j.matmul_precision, j.compensated)
        assert str(t.real_dtype) == f"torch.{np.dtype(j.real_dtype)}"
    drifts = [t.drift_per_gate for t in tq.TIER_LADDER]
    assert drifts == sorted(drifts, reverse=True)


def test_tier_by_name_round_trips():
    for t in tq.TIER_LADDER:
        assert tq.tier_by_name(t.name) is t
        assert tq.tier_by_name(t.name.upper()) is t
        assert tq.tier_by_name(t) is t
    with pytest.raises(ValueError, match="unknown precision tier"):
        tq.tier_by_name("quintuple")


def test_modeled_error_and_runtime_tol_match_jax():
    for j, t in zip(jq.TIER_LADDER, tq.TIER_LADDER):
        for g in GATE_COUNTS:
            assert abs(tq.modeled_tier_error(t, g)
                       - jq.modeled_tier_error(j, g)) <= 1e-15
            assert abs(tq.tier_runtime_tol(t, g)
                       - jq.tier_runtime_tol(j, g)) <= 1e-15


@pytest.mark.parametrize("prec", ["single", "double"])
def test_choose_tier_matches_jax(prec, envs):
    jenv, tenv = envs[prec]
    ladder = jprof.engine_tiers(jenv)
    assert [t.name for t in tq.engine_tiers(tenv)] == \
        [t.name for t in ladder]
    for budget in np.logspace(-1, -16, 31):
        for g in GATE_COUNTS:
            try:
                want = jq.choose_tier(float(budget), g, jenv).name
            except ValueError:
                want = None
            try:
                got = tq.choose_tier(float(budget), g, tenv).name
            except ValueError:
                got = None
            assert got == want, (budget, g)


def test_choose_tier_is_monotone(envs):
    tenv = envs["double"][1]
    prev, rejected = -1, False
    for budget in np.logspace(-1, -14, 40):
        try:
            t = tq.choose_tier(float(budget), 200, tenv)
        except ValueError:
            rejected = True
            continue
        assert not rejected and t.rank >= prev
        prev = t.rank
    assert tq.choose_tier(1e-1, 200, tenv).name == "fast"
    assert tq.choose_tier(1e-12, 200, tenv).name == "double"
    with pytest.raises(ValueError):
        tq.choose_tier(0.0, 10, tenv)


def test_quad_is_data_only(envs):
    """QUAD in both packages: a budget only QUAD meets picks it, a
    compile-time QUAD tier raises the same ValueError, a per-dispatch QUAD
    sweep runs and agrees with the JAX package's, and a compile-time
    budget (whose ladder leaves QUAD out) below DOUBLE's is unmeetable."""
    jenv, tenv = envs["double"]
    assert jq.choose_tier(1e-14, 100, jenv).name == "quad"
    assert tq.choose_tier(1e-14, 100, tenv) is tq.QUAD_TIER
    c = tq.Circuit(3).h(0).cnot(0, 2)
    jcirc = JCircuit(3).h(0).cnot(0, 2)
    for circ, env in ((c, tenv), (jcirc, jenv)):
        with pytest.raises(ValueError, match="per-DISPATCH rung"):
            circ.compile(env, tier="quad")
        with pytest.raises(ValueError, match="unmeetable"):
            circ.compile(env, error_budget=1e-18)
    got = c.compile(tenv).sweep(np.zeros((1, 0)), tier=tq.QUAD_TIER)
    want = np.asarray(jcirc.compile(jenv).sweep(np.zeros((1, 0)),
                                                tier="quad"))
    assert np.abs(got.numpy() - want).max() <= 1e-15


def test_compile_selects_and_reports_the_tier(envs):
    tenv64, tenv32 = envs["double"][1], envs["single"][1]
    c = tq.Circuit(4)
    for q in range(4):
        c.h(q)
    cc = c.compile(tenv64, error_budget=1e-2)
    assert cc.tier is tq.FAST_TIER and cc.error_budget == 1e-2
    assert cc._modeled_tier_error() == tq.modeled_tier_error(tq.FAST_TIER, 4)
    assert c.compile(tenv64, error_budget=1e-12).tier is tq.DOUBLE_TIER
    plain = c.compile(tenv64)
    assert plain.tier is None and plain._modeled_tier_error() == 0.0
    with pytest.raises(ValueError, match="f64-storage"):
        c.compile(tenv32, tier="double")
    with pytest.raises(ValueError, match="f64-storage"):
        c.compile(tenv32).sweep(np.zeros((1, 0)), tier="double")


# ---------------------------------------------------------------------------
# the FAST function
# ---------------------------------------------------------------------------

def _bf16(x):
    """float64 value of x (float32 values) rounded to bf16, by JAX."""
    return np.asarray(jnp.asarray(np.asarray(x, np.float32)).astype(
        jnp.bfloat16).astype(jnp.float32), np.float64)


def _oracle(planes, n, bits, m, row_mask=0, row_want=0):
    """The FAST dense stage in float64 numpy: groups of the packed (row
    bits, lanes) axis, hi = bf16(v), lo = bf16(v - hi), a bf16 operator
    (rounded through float32, as the port rounds it), every product exact
    and every sum in float64."""
    amps = np.arange(1 << n)
    row, lane = amps >> 7, amps & 127
    e = lane.copy()
    rest = row.copy()
    for m_, b in enumerate(bits):
        e |= ((row >> b) & 1) << (7 + m_)
        rest &= ~(1 << b)
    dim = 128 << len(bits)
    groups = {r: i for i, r in enumerate(np.unique(rest))}
    g = np.array([groups[r] for r in rest])
    re = np.zeros((len(groups), dim))
    im = np.zeros((len(groups), dim))
    re[g, e], im[g, e] = planes[0], planes[1]
    m32 = np.asarray(m, np.complex128).astype(np.complex64)
    mr, mi = _bf16(m32.real), _bf16(m32.imag)
    h_re, h_im = _bf16(re), _bf16(im)
    l_re = _bf16(np.float32(re) - np.float32(h_re))
    l_im = _bf16(np.float32(im) - np.float32(h_im))
    new_re = (h_re @ mr.T - h_im @ mi.T) + (l_re @ mr.T - l_im @ mi.T)
    new_im = (h_re @ mi.T + h_im @ mr.T) + (l_re @ mi.T + l_im @ mr.T)
    out = np.array(planes, np.float64)
    sel = (row & row_mask) == row_want
    out[0, sel] = new_re[g, e][sel]
    out[1, sel] = new_im[g, e][sel]
    return out


FAST_STAGES = {
    "lane": lambda rng: ("lane", _unitary(rng, 128)),
    "clane": lambda rng: ("clane", _unitary(rng, 128), 0b101, 0b001),
    "rowmxu1": lambda rng: ("rowmxu", (2,), _unitary(rng, 256)),
    "rowmxu2": lambda rng: ("rowmxu", (0, 3), _unitary(rng, 512)),
}


@pytest.mark.parametrize("name", list(FAST_STAGES))
def test_fast_plain_stage_is_the_bf16_function(name):
    n = 11
    rng = np.random.default_rng(len(name))
    st = FAST_STAGES[name](rng)
    z = rng.normal(size=(2, 1 << n))
    planes = (z / np.linalg.norm(z)).astype(np.float32)
    got = lk.apply_layer_plain(torch.as_tensor(planes.copy()), n,
                               lk.LayerOp(n, 1, [st]), fast=True)
    if st[0] == "rowmxu":
        want = _oracle(planes, n, st[1], st[2])
    else:
        want = _oracle(planes, n, (), st[1], *st[2:])
    assert np.abs(got.double().numpy() - want).max() \
        <= 1e-6 * np.abs(want).max()
    # and it is not the full-precision function
    full = lk.apply_layer_plain(torch.as_tensor(planes.copy()), n,
                                lk.LayerOp(n, 1, [st]))
    assert float((got - full).abs().max()) > 1e-6


def test_fast_layer_matches_jax_within_budget():
    n = 10
    rng = np.random.default_rng(4)
    stages = [("lane", _unitary(rng, 128)),
              ("row", 9, _unitary(rng, 2), 0, 0, 0, 0),
              ("rowmxu", (0, 1), _unitary(rng, 512)),
              ("rowdiag", np.exp(1j * rng.uniform(0, 6, (2, 128))), (2,))]
    z = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    z = (z / np.linalg.norm(z)).astype(np.complex64)
    want = np.asarray(pk.apply_layer(
        jnp.asarray(z), n, pk.LayerOp(n, len(stages), stages),
        interpret=True, fast=True))
    planes = torch.as_tensor(np.stack([z.real, z.imag]))
    layer = lk.LayerOp(n, len(stages), stages)
    got = lk.apply_layer_plain(planes.clone(), n, layer, fast=True).numpy()
    full = lk.apply_layer_plain(planes.clone(), n, layer).numpy()
    dev = np.abs(got[0] + 1j * got[1] - want).max()
    assert dev <= tq.modeled_tier_error(tq.FAST_TIER, len(stages))
    assert np.abs(got - full).max() > 0.0


def _brickwork(mod, n, layers=2, seed=2026):
    rng = np.random.default_rng(seed)
    c = mod(n)
    for layer in range(layers):
        for q in range(n):
            c.rotate(q, float(rng.uniform(0, 2 * np.pi)),
                     tuple(float(a) for a in rng.normal(size=3)))
        for q in range(layer % 2, n - 1, 2):
            c.cnot(q, q + 1)
    return c


def _hea(mod, n, layers=2):
    c = mod(n)
    for layer in range(layers):
        for q in range(n):
            c.ry(q, c.parameter(f"y{layer}_{q}"))
            c.rz(q, c.parameter(f"z{layer}_{q}"))
        for q in range(n):
            c.cnot(q, (q + 1) % n)
    return c


def test_fast_program_matches_jax_within_budget(envs):
    """``run`` at a compile-time FAST tier and ``sweep(tier="fast")`` on a
    float64 environment: both cast to float32 planes and back."""
    jenv, tenv = envs["double"]
    n = 10
    jc, tc = _brickwork(JCircuit, n), _brickwork(tq.Circuit, n)
    bound = tq.modeled_tier_error(tq.FAST_TIER, len(tc.ops))
    jcc = jc.compile(jenv, pallas="interpret", tier="fast")
    tcc = tc.compile(tenv, tier="fast")
    assert tcc.num_layers >= 1
    jqr, tqr = jq.createQureg(n, jenv), tq.createQureg(n, tenv)
    jq.initZeroState(jqr)
    tq.initZeroState(tqr)
    jcc.run(jqr)
    tcc.run(tqr)
    got = interop.planes_of(tqr)
    assert got.dtype == np.float64
    assert np.abs(got - np.asarray(jqr.state)).max() <= bound
    single = tc.compile(tenv, tier="single")
    sq = tq.createQureg(n, tenv)
    tq.initZeroState(sq)
    single.run(sq)
    assert np.abs(got - interop.planes_of(sq)).max() > 0.0

    pm = np.zeros((2, 0))
    want = np.asarray(jcc.sweep(pm))
    swept = tc.compile(tenv).sweep(pm, tier="fast")
    assert swept.dtype == torch.float64
    assert np.abs(swept.numpy() - want).max() <= bound


def test_fast_energies_match_jax_within_budget(envs):
    jenv, tenv = envs["double"]
    n = 8
    rng = np.random.default_rng(8)
    jc, tc = _hea(JCircuit, n), _hea(tq.Circuit, n)
    pm = rng.uniform(0, 2 * np.pi, size=(3, len(tc.param_names)))
    terms = [[(q, 3)] for q in range(n)] + [[(0, 1), (1, 1)],
                                           [(2, 2), (5, 2)]]
    coeffs = list(rng.normal(size=len(terms)))
    jcc = jc.compile(jenv, pallas="interpret")
    tcc = tc.compile(tenv)
    bound = tq.modeled_tier_error(tq.FAST_TIER, len(tc.ops)) \
        * (np.abs(coeffs).sum() * 64)
    want = np.asarray(jcc.expectation_sweep(pm, (terms, coeffs),
                                            tier=jq.FAST_TIER))
    got = tcc.expectation_sweep(pm, (terms, coeffs), tier="fast")
    single = tcc.expectation_sweep(pm, (terms, coeffs), tier="single")
    assert np.abs(got - want).max() <= bound
    assert np.abs(got - single).max() > 0.0


# ---------------------------------------------------------------------------
# SINGLE and DOUBLE
# ---------------------------------------------------------------------------

def test_every_tier_returns_env_dtype_planes(envs):
    tenv = envs["double"][1]
    c = _hea(tq.Circuit, 8, layers=1)
    cc = c.compile(tenv)
    pm = np.random.default_rng(1).uniform(0, 6, (2, len(c.param_names)))
    ref = cc.sweep(pm)
    for tier in ("fast", "single", "double"):
        out = cc.sweep(pm, tier=tier)
        assert out.dtype == torch.float64 and out.shape == ref.shape
    # an owned batch is updated in place whatever the tier computes in
    owned = torch.zeros_like(ref)
    owned[:, 0, 0] = 1.0
    assert cc.sweep(pm, state_f=owned, tier="single") is owned
    assert float((owned - ref).abs().max()) <= 1e-5


def test_double_tier_matches_jax(envs):
    jenv, tenv = envs["double"]
    n = 9
    jc, tc = _hea(JCircuit, n), _hea(tq.Circuit, n)
    pm = np.random.default_rng(2).uniform(0, 6, (3, len(tc.param_names)))
    want = np.asarray(jc.compile(jenv, pallas="interpret").sweep(
        pm, tier=jq.DOUBLE_TIER))
    got = tc.compile(tenv).sweep(pm, tier="double")
    assert np.abs(got.numpy() - want).max() <= 1e-12


def test_compensated_energies_match_jax():
    """On the same float32 states, the port's compensated Pauli energies
    and the JAX package's agree to 2 ulp of the largest energy, and are
    nearer the float64 truth than a naive float32 reduce."""
    n, batch = 12, 3
    rng = np.random.default_rng(12)
    z = rng.normal(size=(batch, 1 << n)) + 1j * rng.normal(size=(batch, 1 << n))
    z = (z / np.linalg.norm(z, axis=1, keepdims=True)).astype(np.complex64)
    codes = rng.integers(0, 4, size=(6, n))
    coeffs = rng.normal(size=6)
    xm, ym, zm, cf = tred.pauli_sum_operands(codes.reshape(-1), n, coeffs)
    cf32 = np.float32(cf)
    want = np.array([float(jred.pauli_sum_total_sv(
        jnp.asarray(z[b]), jnp.asarray(xm), jnp.asarray(ym), jnp.asarray(zm),
        jnp.asarray(cf32), compensated=True)) for b in range(batch)])
    planes = torch.as_tensor(np.stack([z.real, z.imag], axis=1))
    got = tred.pauli_sum_total_sv(planes, xm, ym, zm, cf32,
                                  compensated=True).numpy()
    ulp = np.spacing(np.float32(np.abs(want).max()))
    assert np.abs(got - want).max() <= 2 * ulp
    truth = tred.pauli_sum_total_sv(planes.double(), xm, ym, zm, cf).numpy()
    naive = tred.pauli_sum_total_sv(planes, xm, ym, zm, cf32).numpy()
    assert np.abs(got - truth).max() <= np.abs(naive - truth).max()


def test_single_tier_reduces_compensated(envs, monkeypatch):
    tenv = envs["single"][1]
    c = _hea(tq.Circuit, 8, layers=1)
    cc = c.compile(tenv)
    pm = np.random.default_rng(3).uniform(0, 6, (2, len(c.param_names)))
    seen = []
    real = tred.pauli_sum_total_sv

    def spy(*args, compensated=False):
        seen.append(compensated)
        return real(*args, compensated=compensated)

    monkeypatch.setattr(tred, "pauli_sum_total_sv", spy)
    ham = ([[(0, 3)], [(1, 1), (2, 1)]], [0.5, -1.0])
    for tier in ("single", "fast", None):
        cc.expectation_sweep(pm, ham, tier=tier)
    assert seen == [True, False, False]


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

def test_calibration_measures_the_fast_layers(envs, monkeypatch):
    """The calibration compiles with fused layers: its FAST sweep runs the
    layer kernel's FAST branch (here its plain version), where the port's
    bf16 products live. Cached per device fingerprint and silicon flag."""
    tenv = envs["single"][1]
    monkeypatch.delenv("QUEST_TPU_TIER_MODEL")
    monkeypatch.setattr(tprof, "_TIER_MODEL_CACHE", {})
    fast_calls = []
    real = lk.apply_layer_batched_plain

    def spy(states, n, layer, fast=False):
        fast_calls.append(fast)
        return real(states, n, layer, fast)

    monkeypatch.setattr(lk, "apply_layer_batched_plain", spy)
    model = tprof.measure_tier_model(tenv, silicon=False)
    assert model.source == "measured" and model.cost_source == "none"
    assert True in fast_calls and False in fast_calls
    assert 0.0 < model.drift_per_gate["fast"] <= 1e-3
    key = ("cpu", "", 1, "torch.float32", False)
    assert tprof._TIER_MODEL_CACHE[key] is model
    assert tprof.measure_tier_model(tenv, silicon=False) is model
    timed = tprof.measure_tier_model(tenv, silicon=True)
    assert timed.cost_source == "silicon"
    assert set(timed.cost_per_gate) == {"fast", "single"}
    # on the CPU neither calibration nor timing runs unasked
    assert tprof.tier_error_model(tenv) is tprof.DEFAULT_TIER_MODEL
    monkeypatch.setenv("QUEST_TPU_TIER_MODEL", "default")
    assert tprof.measure_tier_model(tenv) is tprof.DEFAULT_TIER_MODEL


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the FAST kernel runs only on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3])
def test_fast_kernel_matches_plain_on_card(card, batch):
    n = 20
    rng = np.random.default_rng(20)
    stages = [FAST_STAGES[name](rng) for name in FAST_STAGES]
    stages.insert(2, ("row", 9, _unitary(rng, 2), 0b10, 0b10, 0, 0))
    layer = lk.LayerOp(n, len(stages), stages)
    z = rng.normal(size=(batch, 2, 1 << n))
    base = torch.as_tensor(z / np.linalg.norm(z), dtype=torch.float32,
                           device=card)
    want = lk.apply_layer_batched_plain(base.clone(), n, layer, fast=True)
    before = lk.apply_layer_batched.fast_launches
    got = lk.apply_layer_batched(base.clone(), n, layer, fast=True)
    torch.cuda.synchronize()
    assert lk.apply_layer_batched.fast_launches == before + 1
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5
