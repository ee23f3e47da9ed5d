"""The port's QUAD and QUAD64 density registers against the JAX package's,
on the CPU.

Every ``is_quad`` branch of the API on a density register: the lifted
dense gates (one pass uncontrolled, two passes controlled), the lifted
diagonals, the swap, the initialisers (``initPureState`` as a dd outer
product), the channels (``mixDephasing``, ``mixTwoQubitDephasing``, every
Kraus channel through the superoperator, ``mixDensityMatrix``),
``setWeightedQureg``, the Pauli functions, the measurement functions,
``getDensityAmp`` and the reductions (``calcPurity``, ``calcFidelity``,
``calcDensityInnerProduct``, ``calcHilbertSchmidtDistance``): the same
calls on both packages, the states after every call and every returned
value within 1e-13 of the largest amplitude (of its square, for the
quadratic reductions). ``sampleOutcomes`` and ``measure`` draw from
different generators, so they are held by distribution and by the branch
they took.
"""

import numpy as np
import pytest

import quest_tpu as jq
import quest_tpu_torch as tq
from torch_threads import one_blas_thread  # noqa: F401

TOL = 1e-13


def _unitary(rng, dim):
    z = rng.normal(size=(dim, dim)) + 1j * rng.normal(size=(dim, dim))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


def _kraus(rng, k, count):
    """``count`` Kraus operators on k qubits (a CPTP map)."""
    dim = 1 << k
    big = _unitary(rng, dim * count)[:, :dim]
    return [big[i * dim:(i + 1) * dim] for i in range(count)]


class Pair:
    """The same register on both packages, driven call by call."""

    def __init__(self, jenv, tenv, n, density=True):
        make = "createDensityQureg" if density else "createQureg"
        self.j = getattr(jq, make)(n, jenv)
        self.t = getattr(tq, make)(n, tenv)

    def scale(self) -> float:
        return max(float(np.abs(self.j.to_numpy()).max()), 1e-300)

    def call(self, name, *args, others=()):
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
        bar = TOL * (scale if scale is not None else self.scale())
        assert abs(complex(got) - complex(want)) <= max(bar, TOL), \
            (name, got, want)
        return got


@pytest.mark.parametrize("prec", ["QUAD", "QUAD64"])
def test_density_api_matches_jax(prec):
    jenv = jq.createQuESTEnv(num_devices=1, precision=getattr(jq, prec),
                             seed=[3])
    tenv = tq.createQuESTEnv(device="cpu", precision=getattr(tq, prec),
                             seed=[3])
    rng = np.random.default_rng(41)
    u1 = _unitary(rng, 2)
    n = 3
    dim = 1 << n
    d = Pair(jenv, tenv, n)
    for name, args in (("initBlankState", ()), ("initZeroState", ()),
                       ("initClassicalState", (5,)), ("initDebugState", ()),
                       ("initPlusState", ())):
        d.call(name, *args)
        d.check(name)
    psi = rng.normal(size=dim) + 1j * rng.normal(size=dim)
    psi /= np.linalg.norm(psi)
    pure = Pair(jenv, tenv, n, density=False)
    pure.call("initStateFromAmps", psi.real, psi.imag)
    d.call("initPureState", others=(pure,))
    d.check("initPureState")

    steps = [
        ("hadamard", (1,)), ("rotateY", (1, 0.3)), ("unitary", (1, u1)),
        ("controlledNot", (0, 1)),
        ("multiStateControlledUnitary", ((0, 2), (1, 0), 1, u1)),
        ("tGate", (1,)), ("controlledPhaseShift", (0, 1, 0.3)),
        ("swapGate", (0, 2)),
        ("mixDephasing", (1, 0.1)), ("mixTwoQubitDephasing", (0, 2, 0.1)),
        ("mixDepolarising", (1, 0.05)), ("mixDamping", (1, 0.1)),
        ("mixPauli", (1, 0.05, 0.02, 0.1)),
        ("mixKrausMap", (1, _kraus(rng, 1, 3))),
        ("mixTwoQubitDepolarising", (0, 2, 0.05)),
        ("mixTwoQubitKrausMap", (0, 2, _kraus(rng, 2, 2))),
        ("mixMultiQubitKrausMap", ((0, 1, 2), _kraus(rng, 3, 2))),
    ]
    for name, args in steps:
        d.call(name, *args)
        d.check(name)

    other = Pair(jenv, tenv, n)
    other.call("initDebugState")
    noise = Pair(jenv, tenv, n)
    noise.call("initClassicalState", 3)
    noise.call("mixDepolarising", 1, 0.3)
    d.call("mixDensityMatrix", 0.25, others=(noise,))
    d.check("mixDensityMatrix")
    out = Pair(jenv, tenv, n)
    jq.setWeightedQureg(0.5, d.j, -0.2j, other.j, 0.1, out.j)
    tq.setWeightedQureg(0.5, d.t, -0.2j, other.t, 0.1, out.t)
    out.check("setWeightedQureg")

    # the reductions
    d.value("calcTotalProb")
    for outcome in (0, 1):
        d.value("calcProbOfOutcome", 1, outcome)
    d.value("getDensityAmp", 2, 5)
    d.value("calcPurity")
    d.value("calcFidelity", others=(pure,))
    d.value("calcDensityInnerProduct", others=(other,),
            scale=other.scale() * dim * dim)
    d.value("calcHilbertSchmidtDistance", others=(other,),
            scale=other.scale() * dim)
    d.value("calcExpecPauliProd", (0, 2), (1, 3))
    codes = [1, 0, 3, 2, 2, 0, 0, 3, 1]
    coeffs = [0.4, -1.1, 0.7]
    d.value("calcExpecPauliSum", codes, coeffs)
    d.call("applyPauliSum", codes, coeffs, 3, others=(out,))
    out.check("applyPauliSum")

    # measurement: the collapse, and a draw held by its branch
    d.value("collapseToOutcome", 1, 0)
    d.check("collapseToOutcome")
    d.call("hadamard", 1)
    outcome, prob = tq.measureWithStats(d.t, 1)
    assert abs(prob - jq.calcProbOfOutcome(d.j, 1, outcome)) <= TOL
    jq.collapseToOutcome(d.j, 1, outcome)
    d.check("measureWithStats")

    with pytest.raises(tq.QuESTError, match="gate fusion is not supported"):
        tq.startGateFusion(d.t)


@pytest.mark.parametrize("prec", ["QUAD", "QUAD64"])
def test_density_sample_outcomes_by_distribution(prec):
    tenv = tq.createQuESTEnv(device="cpu", precision=getattr(tq, prec),
                             seed=[13])
    d = tq.createDensityQureg(3, tenv)
    tq.initPlusState(d)
    tq.rotateY(d, 0, 0.7)
    tq.mixDamping(d, 1, 0.3)
    probs = np.real(np.diag(d.density_matrix_numpy()))
    shots = 20000
    hist = np.bincount(tq.sampleOutcomes(d, shots), minlength=8) / shots
    stderr = np.sqrt(probs * (1 - probs) / shots)
    assert np.all(np.abs(hist - probs) <= 5 * stderr + 1e-12)
