"""The port's QUAD tier against the JAX package's, on the CPU: QUAD and
QUAD64 state-vector registers through the public API.

- Every ``is_quad`` branch of the API on a state vector (dense, controlled,
  state-controlled and diagonal gates, the swap, the initialisers,
  ``setAmps``, ``setWeightedQureg``, the Pauli functions, the measurement
  functions, ``getAmp`` and the reductions), at QUAD and QUAD64: the same
  calls on both packages, the states after every call and every returned
  value within 1e-13 of the largest amplitude (of its square, for
  probabilities and energies). ``sampleOutcomes`` and ``measure`` draw
  from different generators (a ``torch.Generator``, the JAX package's
  threefry keys), so they are held by distribution and by the branch they
  took: the collapsed state equals the JAX package's
  ``collapseToOutcome`` on the same outcome.
- The typed errors, each with the JAX package's type and message, and
  ``choose_tier`` picking QUAD in both packages.

Density registers are ``tests/test_torch_quad_density.py``;
``compile_dd`` and the batched engine's QUAD rung
``tests/test_torch_quad_engine.py``. The JAX side compiles one executable
per gate signature, so each file keeps to a few signatures.
"""

import numpy as np
import pytest

import quest_tpu as jq
from quest_tpu.circuits import Circuit as JCircuit
import quest_tpu_torch as tq
from torch_threads import one_blas_thread  # noqa: F401

TOL = 1e-13
PRECISIONS = ("QUAD", "QUAD64")
JIT_FIELDS = ("batched_cache_size", "batched_cache_evictions")


def _unitary(rng, dim):
    z = rng.normal(size=(dim, dim)) + 1j * rng.normal(size=(dim, dim))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


def _envs(prec: str, seed: int = 7):
    return (jq.createQuESTEnv(num_devices=1, precision=getattr(jq, prec),
                              seed=[seed]),
            tq.createQuESTEnv(device="cpu", precision=getattr(tq, prec),
                              seed=[seed]))


class Pair:
    """The same register on both packages, driven call by call."""

    def __init__(self, jenv, tenv, n, density=False):
        make = "createDensityQureg" if density else "createQureg"
        self.j = getattr(jq, make)(n, jenv)
        self.t = getattr(tq, make)(n, tenv)

    def scale(self) -> float:
        return max(float(np.abs(self.j.to_numpy()).max()), 1e-300)

    def call(self, name, *args, others=()):
        """``name(register, *args, *others)`` on both; returns both
        values. ``others`` are Pairs passed as further registers."""
        want = getattr(jq, name)(self.j, *args, *(o.j for o in others))
        got = getattr(tq, name)(self.t, *args, *(o.t for o in others))
        return got, want

    def check(self, what=""):
        got, want = self.t.to_numpy(), self.j.to_numpy()
        assert self.t.state.shape == (4, self.t.num_amps_total), what
        err = float(np.abs(got - want).max())
        assert err <= TOL * self.scale(), (what, err)

    def value(self, name, *args, others=(), scale=None):
        got, want = self.call(name, *args, others=others)
        bar = TOL * (scale if scale is not None else self.scale() ** 2)
        assert abs(complex(got) - complex(want)) <= max(bar, TOL), \
            (name, got, want)
        return got


SV_GATES = [
    ("hadamard", (1,)),
    ("pauliX", (1,)), ("pauliY", (1,)), ("rotateX", (1, 0.3)),
    ("rotateY", (1, -1.1)), ("rotateZ", (1, 0.8)),
    ("rotateAroundAxis", (1, 0.7, (0.3, -0.2, 0.9))),
    ("compactUnitary", (1, 0.6 + 0.0j, 0.8j)),
    ("unitary", (1, "u1")),
    ("controlledNot", (0, 1)), ("controlledPauliY", (0, 1)),
    ("controlledRotateX", (0, 1, 0.4)),
    ("controlledRotateAroundAxis", (0, 1, 0.2, (1.0, 1.0, 0.0))),
    ("controlledCompactUnitary", (0, 1, 0.8, 0.6j)),
    ("controlledUnitary", (0, 1, "u1")),
    ("multiControlledUnitary", ((0, 2), 1, "u1")),
    ("multiStateControlledUnitary", ((0, 2), (1, 0), 1, "u1")),
    ("pauliZ", (1,)), ("sGate", (1,)), ("tGate", (1,)),
    ("phaseShift", (1, 0.4)),
    ("controlledPhaseShift", (0, 1, 0.3)), ("controlledPhaseFlip", (0, 1)),
    ("multiControlledPhaseShift", ((0, 1, 2), 1.3)),
    ("multiControlledPhaseFlip", ((0, 1, 2),)),
    ("multiRotateZ", ((0, 1, 2), 0.5)),
    ("swapGate", (1, 2)), ("sqrtSwapGate", (1, 2)),
    ("twoQubitUnitary", (1, 2, "u2")),
    ("multiQubitUnitary", ((1, 2, 3), "u3")),
    ("controlledMultiQubitUnitary", (0, (1, 2, 3), "u3")),
    ("multiControlledMultiQubitUnitary", ((0,), (1, 2, 3), "u3")),
    ("multiRotatePauli", ((1, 2), (1, 2), 0.45)),
]


def _args(args, mats):
    return tuple(mats[a] if isinstance(a, str) else a for a in args)


@pytest.mark.parametrize("prec", PRECISIONS)
def test_statevector_api_matches_jax(prec):
    jenv, tenv = _envs(prec)
    rng = np.random.default_rng(31)
    mats = {"u1": _unitary(rng, 2), "u2": _unitary(rng, 4),
            "u3": _unitary(rng, 8)}
    n = 4
    q = Pair(jenv, tenv, n)
    assert q.t.is_quad and q.j.is_quad
    q.call("initDebugState")
    q.check("initDebugState")
    for name, args in SV_GATES:
        q.call(name, *_args(args, mats))
        q.check(name)

    # the initialisers
    for name, args in (("initBlankState", ()), ("initZeroState", ()),
                       ("initPlusState", ()), ("initClassicalState", (6,)),
                       ("initStateOfSingleQubit", (2, 1)),
                       ("initDebugState", ())):
        q.call(name, *args)
        q.check(name)
    re, im = rng.normal(size=4), rng.normal(size=4)
    q.call("setAmps", 3, re, im, 4)
    q.check("setAmps")
    other = Pair(jenv, tenv, n)
    psi = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    other.call("initStateFromAmps", psi.real, psi.imag)
    other.check("initStateFromAmps")
    out = Pair(jenv, tenv, n)
    out.call("initPlusState")
    jq.setWeightedQureg(0.3 - 0.1j, q.j, -1.2, other.j, 0.5j, out.j)
    tq.setWeightedQureg(0.3 - 0.1j, q.t, -1.2, other.t, 0.5j, out.t)
    out.check("setWeightedQureg")
    clone = Pair(jenv, tenv, n)
    clone.call("cloneQureg", others=(q,))
    clone.check("cloneQureg")

    # reductions, the Pauli functions and amplitude reads
    q.value("calcTotalProb")
    for outcome in (0, 1):
        q.value("calcProbOfOutcome", 2, outcome)
    for name in ("getAmp", "getRealAmp", "getImagAmp"):
        q.value(name, 13, scale=q.scale())
    q.value("getProbAmp", 13)
    q.value("calcExpecPauliProd", (0, 2, 3), (1, 3, 2))
    codes = [1, 2, 3, 0, 3, 3, 0, 1, 0, 2, 2, 1]
    coeffs = [0.5, -0.3, 1.1]
    q.value("calcExpecPauliSum", codes, coeffs)
    q.call("applyPauliSum", codes, coeffs, 3, others=(out,))
    out.check("applyPauliSum")
    q.value("calcInnerProduct", others=(other,),
            scale=q.scale() * other.scale() * (1 << n))
    q.value("calcFidelity", others=(other,),
            scale=(q.scale() * other.scale()) ** 2 * (1 << 2 * n))

    # measurement: the collapse, and a draw held by its branch
    q.call("initStateFromAmps", psi.real / np.linalg.norm(psi),
           psi.imag / np.linalg.norm(psi))
    q.value("collapseToOutcome", 1, 1)
    q.check("collapseToOutcome")
    q.call("hadamard", 1)
    outcome, prob = tq.measureWithStats(q.t, 1)
    want = jq.calcProbOfOutcome(q.j, 1, outcome)
    assert abs(prob - want) <= TOL
    jq.collapseToOutcome(q.j, 1, outcome)
    q.check("measureWithStats")

    with pytest.raises(tq.QuESTError, match="gate fusion is not supported"):
        tq.startGateFusion(q.t)
    with pytest.raises(jq.QuESTError, match="gate fusion is not supported"):
        jq.startGateFusion(q.j)


@pytest.mark.parametrize("prec", PRECISIONS)
def test_sample_outcomes_by_distribution(prec):
    """Both packages' draws follow |amp|^2 of the same QUAD state: every
    bin within 5 standard errors."""
    jenv, tenv = _envs(prec, seed=11)
    rng = np.random.default_rng(5)
    psi = rng.normal(size=8) + 1j * rng.normal(size=8)
    psi /= np.linalg.norm(psi)
    q = Pair(jenv, tenv, 3)
    q.call("initStateFromAmps", psi.real, psi.imag)
    probs = np.abs(psi) ** 2
    shots = 20000
    for idx in (tq.sampleOutcomes(q.t, shots),
                np.asarray(jq.sampleOutcomes(q.j, shots))):
        hist = np.bincount(idx, minlength=8) / shots
        stderr = np.sqrt(probs * (1 - probs) / shots)
        assert np.all(np.abs(hist - probs) <= 5 * stderr + 1e-12)
    marg = tq.sampleOutcomes(q.t, shots, qubits=[2, 0])
    assert marg.max() <= 3
    q.check("sampleOutcomes leaves the register")


@pytest.fixture(scope="module")
def double_envs():
    return (jq.createQuESTEnv(num_devices=1, precision=jq.DOUBLE, seed=[5]),
            tq.createQuESTEnv(device="cpu", precision=tq.DOUBLE, seed=[5]))


def test_quad_typed_errors_match_jax(double_envs):
    """Each error with the JAX package's type and message."""
    jenv64, tenv64 = double_envs
    jenv32 = jq.createQuESTEnv(num_devices=1, precision=jq.SINGLE, seed=[5])
    tenv32 = tq.createQuESTEnv(device="cpu", precision=tq.SINGLE, seed=[5])
    jqd, tqd = _envs("QUAD")
    pm = np.zeros((1, 1))
    ham = ([[(0, 3)]], [1.0])
    for pkg, C, e64, e32, eq in ((jq, JCircuit, jenv64, jenv32, jqd),
                                 (tq, tq.Circuit, tenv64, tenv32, tqd)):
        c = C(2)
        c.h(0).ry(1, c.parameter("a"))
        with pytest.raises(ValueError, match="per-DISPATCH rung"):
            c.compile(e64, tier="quad")
        with pytest.raises(ValueError,
                           match="needs .*f64-storage environment"):
            c.compile(e32).sweep(pm, tier="quad")
        with pytest.raises(ValueError, match="f64-storage environment"):
            c.compile(e32).expectation_sweep(pm, ham, tier="quad")
        cc = c.compile(e64)
        with pytest.raises(ValueError, match="cannot run at the QUAD tier"):
            cc.value_and_grad_sweep(pm, ham, tier="quad")
        with pytest.raises(ValueError, match="cannot run at the QUAD tier"):
            cc.grad_sweep(pm, ham, tier="quad")
        reg = pkg.createQureg(2, eq)
        static = C(2).h(0).cnot(0, 1)
        with pytest.raises(ValueError, match="QUAD registers hold "
                                             "double-double planes"):
            static.compile(eq).run(reg)
        assert pkg.choose_tier(1e-14, 100, e64).name == "quad"
        assert [t.name for t in pkg.engine_tiers(e32)] == ["fast", "single"]


def test_quad_precision_objects_match_jax():
    for name in PRECISIONS:
        t, j = getattr(tq, name), getattr(jq, name)
        assert (t.quest_prec, t.eps, t.name) == (j.quest_prec, j.eps, j.name)
        assert str(t.real_dtype) == f"torch.{np.dtype(j.real_dtype)}"
        env = tq.createQuESTEnv(device="cpu", precision=t)
        assert env.compensated is False
        assert f"precision: {name.lower()}" in env.report()
