"""Golden-file runner: the port's replay of the JAX package's corpus.

A copy of the JAX package's ``testing/golden.py`` (its argument schemas,
codecs, register preparation and replay), importing only
``quest_tpu_torch``. The corpus under ``tests/golden/`` was written by the
JAX package's trusted float64 path and ``tests/golden_ref/`` by the
reference's own serial build; every entry names the API function, the
register kind (lowercase: state vector, uppercase: density matrix) and
the checks, and replays here through the same QuEST-named functions. File
format (one file per API function)::

    # golden <function>
    <numTests>
    <quregType>-<checks> <numQubits> <arg> <arg> ...
    P <totalProb>
    M <P(q0=0)> <P(q1=0)> ...
    S
    <re> <im>
    ...

- quregType: z=zero p=plus d=debug b=bitstring(0b101) r=random;
  lowercase = state-vector, uppercase = density matrix.
- checks: P total probability, M per-qubit zero-outcome probabilities,
  S full state amplitudes (the flat vector of a density register), R
  scalar return value(s) of the function, E a validation rejection.
- args: floats/ints space-separated; matrix/vector args are expanded
  inline (re im pairs) and rebuilt from the function's spec.

The runner takes any environment: on a ``QUAD`` or ``QUAD64`` one it
replays the corpus through the double-double registers.

The entries of ``reseed=True`` specs (``measure``, ``measureWithStats``)
are skipped: they check the JAX package's own threefry key stream, which
the port does not reproduce (its draws come from a ``torch.Generator``);
:func:`run_file` counts them. There is no generator here: the corpus is
the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

import quest_tpu_torch as qt

__all__ = ["GATE_SPECS", "run_file", "GoldenFailure"]


# ---------------------------------------------------------------------------
# argument schemas
# ---------------------------------------------------------------------------

def _unitary(k: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(1000 + seed)
    m = rng.normal(size=(1 << k, 1 << k)) + 1j * rng.normal(size=(1 << k, 1 << k))
    u, _ = np.linalg.qr(m)
    return u


def _kraus_pair(seed: int) -> list[np.ndarray]:
    p = 0.1 + 0.05 * (seed % 3)
    flip = _unitary(1, seed)
    return [np.sqrt(1 - p) * np.eye(2, dtype=np.complex128),
            np.sqrt(p) * flip.astype(np.complex128)]


@dataclasses.dataclass
class Spec:
    """How to sweep and encode one API function's arguments.

    ``cases(n)`` yields argument tuples (python values, matrices included);
    ``encode``/``decode`` map them to/from flat text tokens; ``density_only``
    restricts to density registers (noise channels); ``returns`` marks
    value-returning functions (checked with R); ``aux`` names a deterministic
    auxiliary-register builder (appended as the trailing argument and NOT
    encoded — rebuilt identically at replay): one of ``"pure_plus"``,
    ``"pure_debug"``, ``"same_kind_debug"``, ``"density_plus"``."""
    cases: Callable[[int], list[tuple]]
    encode: Callable[[tuple], list[str]]
    decode: Callable[[list[str]], tuple]
    density_only: bool = False
    statevec_only: bool = False
    returns: bool = False
    aux: Optional[str] = None
    # deterministically re-seed the env's RNG before each call — makes
    # sampling functions (measure/measureWithStats) golden-testable, the
    # reference's broadcast-seeded-mt19937 strategy (`QuEST_common.c:181`).
    # reseed-spec goldens are consistency tests of the JAX package's own
    # threefry key stream, not cross-implementation oracles (they are
    # absent from tests/golden_ref/); the port skips them
    reseed: bool = False


def _build_aux(kind: str, qtype: str, n: int, env):
    """Deterministic auxiliary register per Spec.aux."""
    if kind == "pure_plus":
        p = qt.createQureg(n, env)
        qt.initPlusState(p)
        return p
    if kind == "pure_debug":
        p = qt.createQureg(n, env)
        qt.initDebugState(p)
        return p
    if kind == "same_kind_debug":
        p = qt.createDensityQureg(n, env) if qtype.isupper() \
            else qt.createQureg(n, env)
        qt.initDebugState(p)
        return p
    if kind == "density_plus":
        p = qt.createDensityQureg(n, env)
        qt.initPlusState(p)
        return p
    raise ValueError(kind)


def _enc_simple(args: tuple) -> list[str]:
    out = []
    for a in args:
        if isinstance(a, (list, tuple, np.ndarray)):
            arr = np.asarray(a)
            if np.iscomplexobj(arr):
                flat = arr.astype(np.complex128).reshape(-1)
                out.append(f"[{len(flat)}")
                for z in flat:
                    out += [repr(float(z.real)), repr(float(z.imag))]
            elif arr.dtype.kind == "f":
                flat = arr.reshape(-1)
                out.append(f"f{len(flat)}")
                out += [repr(float(v)) for v in flat]
            else:
                flat = arr.reshape(-1)
                out.append(f"i{len(flat)}")
                out += [str(int(v)) for v in flat]
        elif isinstance(a, complex):
            out += ["(", repr(a.real), repr(a.imag)]
        elif isinstance(a, float):
            out.append(repr(a))
        else:
            out.append(str(int(a)))
    return out


def _dec_simple(tokens: list[str]) -> tuple:
    args = []
    i = 0
    while i < len(tokens):
        t = tokens[i]
        if t.startswith("["):
            count = int(t[1:])
            vals = np.array([complex(float(tokens[i + 1 + 2 * j]),
                                     float(tokens[i + 2 + 2 * j]))
                             for j in range(count)])
            dim = int(round(np.sqrt(count)))
            if dim * dim == count and dim >= 2:
                vals = vals.reshape(dim, dim)
            args.append(vals)
            i += 1 + 2 * count
        elif t.startswith("f") and t[1:].isdigit():
            count = int(t[1:])
            args.append(tuple(float(x) for x in tokens[i + 1:i + 1 + count]))
            i += 1 + count
        elif t.startswith("i") and t[1:].isdigit():
            count = int(t[1:])
            args.append(tuple(int(x) for x in tokens[i + 1:i + 1 + count]))
            i += 1 + count
        elif t == "(":
            args.append(complex(float(tokens[i + 1]), float(tokens[i + 2])))
            i += 3
        elif ("." in t or "e" in t or "inf" in t) and not t.lstrip("-").isdigit():
            args.append(float(t))
            i += 1
        else:
            args.append(int(t))
            i += 1
    return tuple(args)


def _spec(cases, **kw) -> Spec:
    return Spec(cases=cases, encode=_enc_simple, decode=_dec_simple, **kw)


_ANGLE = 0.37
_AXIS = (1.0, -2.0, 0.5)


def _targets(n):
    return [(t,) for t in range(n)]


def _target_angle(n):
    return [(t, _ANGLE + 0.1 * t) for t in range(n)]


def _ctrl_target(n):
    return [(c, t) for c in range(n) for t in range(n) if c != t]


def _ctrl_target_angle(n):
    return [(c, t, _ANGLE + 0.05 * (c + n * t))
            for c in range(n) for t in range(n) if c != t]


def _pairs(n):
    return [(a, b) for a in range(n) for b in range(n) if a != b]


def _amp_indices(n):
    return [(i,) for i in range(1 << n)]


GATE_SPECS: dict[str, Spec] = {
    # 1-qubit gates
    "hadamard": _spec(_targets),
    "pauliX": _spec(_targets),
    "pauliY": _spec(_targets),
    "pauliZ": _spec(_targets),
    "sGate": _spec(_targets),
    "tGate": _spec(_targets),
    "phaseShift": _spec(_target_angle),
    "rotateX": _spec(_target_angle),
    "rotateY": _spec(_target_angle),
    "rotateZ": _spec(_target_angle),
    "rotateAroundAxis": _spec(
        lambda n: [(t, _ANGLE + 0.1 * t, _AXIS) for t in range(n)]),
    "compactUnitary": _spec(
        lambda n: [(t, complex(0.6, 0.0), complex(0.0, 0.8)) for t in range(n)]),
    "unitary": _spec(
        lambda n: [(t, _unitary(1, t)) for t in range(n)]),
    # controlled
    "controlledNot": _spec(_ctrl_target),
    "controlledPauliY": _spec(_ctrl_target),
    "controlledPhaseShift": _spec(_ctrl_target_angle),
    "controlledPhaseFlip": _spec(_pairs),
    "controlledRotateX": _spec(_ctrl_target_angle),
    "controlledRotateY": _spec(_ctrl_target_angle),
    "controlledRotateZ": _spec(_ctrl_target_angle),
    "controlledRotateAroundAxis": _spec(
        lambda n: [(c, t, _ANGLE, _AXIS)
                   for c in range(n) for t in range(n) if c != t]),
    "controlledCompactUnitary": _spec(
        lambda n: [(c, t, complex(0.6, 0.0), complex(0.0, 0.8))
                   for c in range(n) for t in range(n) if c != t]),
    "controlledUnitary": _spec(
        lambda n: [(c, t, _unitary(1, c + n * t))
                   for c in range(n) for t in range(n) if c != t]),
    "multiControlledUnitary": _spec(
        lambda n: [(tuple(c for c in range(n) if c != t), t, _unitary(1, t))
                   for t in range(n)]),
    "multiStateControlledUnitary": _spec(
        lambda n: [(tuple(c for c in range(n) if c != t),
                    tuple((c + t) % 2 for c in range(n) if c != t),
                    t, _unitary(1, t))
                   for t in range(n)]),
    "multiControlledPhaseShift": _spec(
        lambda n: [(tuple(range(n)), _ANGLE)]),
    "multiControlledPhaseFlip": _spec(
        lambda n: [(tuple(range(n)),)]),
    # swaps / multi-qubit
    "swapGate": _spec(lambda n: [(a, b) for a in range(n)
                                 for b in range(a + 1, n)]),
    "sqrtSwapGate": _spec(lambda n: [(a, b) for a in range(n)
                                     for b in range(a + 1, n)]),
    "multiRotateZ": _spec(
        lambda n: [(tuple(range(n)), _ANGLE), ((0, n - 1), 0.8)]),
    "multiRotatePauli": _spec(
        lambda n: [(tuple(range(3)), (1, 2, 3), _ANGLE)]),
    "twoQubitUnitary": _spec(
        lambda n: [(a, b, _unitary(2, a + n * b)) for a, b in _pairs(n)]),
    "controlledTwoQubitUnitary": _spec(
        lambda n: [(2, 0, 1, _unitary(2, 5))]),
    "multiQubitUnitary": _spec(
        lambda n: [((0, 1, 2), _unitary(3, 9))]),
    "multiControlledMultiQubitUnitary": _spec(
        lambda n: [((2,), (0, 1), _unitary(2, 11))]),
    # measurement-adjacent (deterministic only)
    "collapseToOutcome": _spec(
        lambda n: [(t, 0) for t in range(n)] + [(t, 1) for t in range(n)],
        returns=True),
    "calcProbOfOutcome": _spec(
        lambda n: [(t, o) for t in range(n) for o in (0, 1)], returns=True),
    # calculations
    "calcTotalProb": _spec(lambda n: [()], returns=True),
    "calcPurity": _spec(lambda n: [()], returns=True, density_only=True),
    "calcExpecPauliProd": _spec(
        lambda n: [((0, 1), (1, 3)), ((0, 1, 2), (2, 2, 1))], returns=True),
    "calcExpecPauliSum": _spec(
        lambda n: [((1, 0, 0, 3, 3, 0), (0.3, -0.7))], returns=True),
    # noise channels (density only)
    "mixDephasing": _spec(
        lambda n: [(t, 0.2) for t in range(n)], density_only=True),
    "mixDepolarising": _spec(
        lambda n: [(t, 0.2) for t in range(n)], density_only=True),
    "mixDamping": _spec(
        lambda n: [(t, 0.3) for t in range(n)], density_only=True),
    "mixTwoQubitDephasing": _spec(
        lambda n: [(a, b, 0.25) for a, b in _pairs(n)], density_only=True),
    "mixTwoQubitDepolarising": _spec(
        lambda n: [(a, b, 0.4) for a, b in _pairs(n)], density_only=True),
    "mixPauli": _spec(
        lambda n: [(t, 0.1, 0.05, 0.15) for t in range(n)],
        density_only=True),
    "mixKrausMap": _spec(
        lambda n: [(t, _kraus_pair(t)) for t in range(n)],
        density_only=True),
}

# Kraus-map functions take a *list* of matrices after some plain int/tuple
# args: encode the leading args normally, then a "k<count>" marker and the
# matrices; decode re-splits.
def _kraus_codec(n_lead: int):
    def enc(args):
        lead, ops = args[:n_lead], args[n_lead]
        out = _enc_simple(lead) + [f"k{len(ops)}"]
        for m in ops:
            out += _enc_simple((m,))
        return out

    def dec(tokens):
        ki = next(i for i, t in enumerate(tokens)
                  if t.startswith("k") and t[1:].isdigit())
        lead = _dec_simple(tokens[:ki])
        count = int(tokens[ki][1:])
        rest = tokens[ki + 1:]
        ops = []
        for _ in range(count):
            n_ent = int(rest[0][1:])
            (m,) = _dec_simple(rest[:1 + 2 * n_ent])
            ops.append(m)
            rest = rest[1 + 2 * n_ent:]
        return lead + (ops,)

    return enc, dec


_enc_k1, _dec_k1 = _kraus_codec(1)
GATE_SPECS["mixKrausMap"] = dataclasses.replace(
    GATE_SPECS["mixKrausMap"], encode=_enc_k1, decode=_dec_k1)


def _kraus_4(seed: int) -> list[np.ndarray]:
    xx = np.kron(mats_pauli_x(), mats_pauli_x())
    p = 0.1 + 0.02 * (seed % 3)
    return [np.sqrt(1 - p) * np.eye(4, dtype=np.complex128),
            np.sqrt(p) * xx.astype(np.complex128)]


def _kraus_8() -> list[np.ndarray]:
    x = mats_pauli_x()
    xxx = np.kron(x, np.kron(x, x))
    return [np.sqrt(0.8) * np.eye(8, dtype=np.complex128),
            np.sqrt(0.2) * xxx.astype(np.complex128)]


def mats_pauli_x() -> np.ndarray:
    return np.array([[0.0, 1.0], [1.0, 0.0]], dtype=np.complex128)


_enc_k2, _dec_k2 = _kraus_codec(2)
_enc_kN, _dec_kN = _kraus_codec(1)

GATE_SPECS.update({
    "mixTwoQubitKrausMap": Spec(
        cases=lambda n: [(a, b, _kraus_4(a + n * b)) for a, b in _pairs(n)],
        encode=_enc_k2, decode=_dec_k2, density_only=True),
    "mixMultiQubitKrausMap": Spec(
        cases=lambda n: [((0, 1, 2), _kraus_8())],
        encode=_enc_kN, decode=_dec_kN, density_only=True),
    # two-register functions: the trailing register is rebuilt from Spec.aux
    "calcFidelity": _spec(lambda n: [()], returns=True, aux="pure_plus"),
    "calcInnerProduct": _spec(lambda n: [()], returns=True,
                              statevec_only=True, aux="pure_debug"),
    "calcDensityInnerProduct": _spec(lambda n: [()], returns=True,
                                     density_only=True, aux="density_plus"),
    "calcHilbertSchmidtDistance": _spec(lambda n: [()], returns=True,
                                        density_only=True, aux="density_plus"),
    "mixDensityMatrix": _spec(lambda n: [(0.3,)], density_only=True,
                              aux="density_plus"),
    "initPureState": _spec(lambda n: [()], aux="pure_plus"),
    # getter tier (reference goldens: tests/unit/state_vector/maths/getAmp*
    # and friends)
    "getAmp": _spec(_amp_indices, returns=True, statevec_only=True),
    "getRealAmp": _spec(_amp_indices, returns=True, statevec_only=True),
    "getImagAmp": _spec(_amp_indices, returns=True, statevec_only=True),
    "getProbAmp": _spec(_amp_indices, returns=True, statevec_only=True),
    "getDensityAmp": _spec(
        lambda n: [(r, c) for r in range(1 << n) for c in (0, (1 << n) - 1)],
        returns=True, density_only=True),
    "getNumAmps": _spec(lambda n: [()], returns=True, statevec_only=True),
    "getNumQubits": _spec(lambda n: [()], returns=True),
    # seeded-sampling tier (reference goldens: measure.test,
    # measureWithStats.test — deterministic via the broadcast seed)
    "measure": _spec(lambda n: [(t,) for t in range(n)],
                     returns=True, reseed=True),
    "measureWithStats": _spec(lambda n: [(t,) for t in range(n)],
                              returns=True, reseed=True),
})


# ---------------------------------------------------------------------------
# register preparation
# ---------------------------------------------------------------------------

_BITSTRING = 0b101


def _prepare(qtype: str, n: int, env) -> "qt.Qureg":
    is_density = qtype.isupper()
    t = qtype.lower()
    q = qt.createDensityQureg(n, env) if is_density else qt.createQureg(n, env)
    if t == "z":
        qt.initZeroState(q)
    elif t == "p":
        qt.initPlusState(q)
    elif t == "d":
        qt.initDebugState(q)
    elif t == "b":
        qt.initClassicalState(q, _BITSTRING & ((1 << n) - 1))
    elif t == "r":
        rng = np.random.default_rng(42 + n)
        amps = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
        amps /= np.linalg.norm(amps)
        if is_density:
            pure = qt.createQureg(n, env)
            qt.initStateFromAmps(pure, amps.real, amps.imag)
            qt.initPureState(q, pure)
        else:
            qt.initStateFromAmps(q, amps.real, amps.imag)
    else:
        raise ValueError(f"unknown qureg type {qtype!r}")
    return q


def _apply(fn_name: str, q, args: tuple, spec: "Spec", qtype: str,
           n: int, env):
    """Call the API function (building the aux register if the spec has
    one); returns its value (or None)."""
    if spec.aux is not None:
        args = args + (_build_aux(spec.aux, qtype, n, env),)
    return getattr(qt, fn_name)(q, *args)


def _ret_values(ret) -> np.ndarray:
    """Flatten a scalar/complex/sequence return into comparable floats."""
    arr = np.atleast_1d(np.asarray(ret))
    if np.iscomplexobj(arr):
        arr = np.stack([arr.real, arr.imag], -1).reshape(-1)
    return arr.astype(np.float64)


def _measurements(q, n: int) -> list[float]:
    return [qt.calcProbOfOutcome(q, t, 0) for t in range(n)]


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GoldenFailure:
    function: str
    test_index: int
    check: str
    detail: str


def _check_lines(use_checks: str, qtype: str, n: int) -> int:
    """How many lines an entry's checks take after its head line."""
    dim = 1 << (2 * n if qtype.isupper() else n)
    return sum(1 + dim if c == "S" else 1 for c in use_checks if c != "E")


def run_file(path: str, env, tol: float = 1e-10):
    """Replay a golden file on ``env``. Returns ``(failures, skipped)``:
    the failures (empty = pass) and how many entries were skipped (those
    of a ``reseed=True`` spec)."""
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f]
    assert lines[0].startswith("# golden ")
    name = lines[0].split()[-1]
    spec = GATE_SPECS[name]
    num_tests = int(lines[1])
    i = 2
    failures: list[GoldenFailure] = []
    skipped = 0
    for test_idx in range(num_tests):
        head = lines[i].split()
        i += 1
        qt_variant, use_checks = head[0].split("-")
        n = int(head[1])
        if spec.reseed:
            skipped += 1
            i += _check_lines(use_checks, qt_variant, n)
            continue
        args = spec.decode(head[2:])
        q = _prepare(qt_variant, n, env)

        def fail(check, detail):
            failures.append(GoldenFailure(name, test_idx, check, detail))

        if use_checks == "E":
            try:
                _apply(name, q, args, spec, qt_variant, n, env)
                fail("E", "expected QuESTError, none raised")
            except qt.QuESTError:
                pass
            continue
        ret = _apply(name, q, args, spec, qt_variant, n, env)

        for check in use_checks:
            if check == "P":
                want = float(lines[i].split()[1]); i += 1
                got = qt.calcTotalProb(q)
                if abs(got - want) > tol:
                    fail("P", f"totalProb {got} != {want}")
            elif check == "M":
                want = [float(x) for x in lines[i].split()[1:]]; i += 1
                got = _measurements(q, n)
                if np.max(np.abs(np.array(got) - np.array(want))) > tol:
                    fail("M", f"outcome probs {got} != {want}")
            elif check == "S":
                i += 1  # "S" line
                dim = q.num_amps_total
                want = np.empty(dim, dtype=np.complex128)
                for j in range(dim):
                    re, im = lines[i + j].split()
                    want[j] = complex(float(re), float(im))
                i += dim
                got = q.to_numpy()
                err = np.max(np.abs(got - want))
                if err > tol:
                    fail("S", f"state max|Δ|={err:.3e}")
            elif check == "R":
                want = [float(x) for x in lines[i].split()[1:]]; i += 1
                got = _ret_values(ret)
                if np.max(np.abs(got - np.array(want))) > tol:
                    fail("R", f"return {got} != {want}")
    return failures, skipped
