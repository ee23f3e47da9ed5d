"""OpenQASM 2.0 importer: parse QASM text back into a :class:`Circuit`.

Counterpart of the JAX package's ``qasm_import.py``, producing the port's
``Circuit``. The reference can only WRITE QASM (``QuEST_qasm.c``); it has
no reader, so a recorded circuit cannot be replayed. This module closes
that loop: it parses the dialect the recorder emits
(``quest_tpu_torch/qasm.py`` — the reference logger's own conventions:
``c``-prefix control stacking, ``U(a,b,c)`` = ``Rz(a) Ry(b) Rz(c)`` from
the ZYZ decomposition, phase-restoration lines as plain ``Rz``) and
``Circuit.to_qasm`` writes, plus the common hand-written forms
(``cx``/``cz``/``ccx`` spellings, ``pi``-expression parameters), producing
a circuit that compiles like any other.

Round-tripping is exact for everything the recorder emits except the
global phase its uncontrolled-unitary ZYZ split drops (the reference drops
it too — restored only under controls, ``QuEST_qasm.c:277-297``).
"""

from __future__ import annotations

import ast
import dataclasses
import math
import re

import numpy as np

from .circuits import Circuit
from .core import matrices as mats

__all__ = ["ParsedQASM", "parse_qasm", "load_qasm_file"]


def _rz(theta: float) -> np.ndarray:
    return mats.rotation(theta, (0.0, 0.0, 1.0))


def _ry(theta: float) -> np.ndarray:
    return mats.rotation(theta, (0.0, 1.0, 0.0))


# base gate name -> (num_targets, num_params, builder). Builders return
# either a method name on Circuit (str) or a matrix factory.
_BASES: dict = {
    "x": (1, 0, "x"), "y": (1, 0, "y"), "z": (1, 0, "z"),
    "h": (1, 0, "h"), "s": (1, 0, "s"), "t": (1, 0, "t"),
    "rx": (1, 1, "rx"), "ry": (1, 1, "ry"), "rz": (1, 1, "rz"),
    "swap": (2, 0, mats.swap),
    "sqrtswap": (2, 0, mats.sqrt_swap),
    # "u" is dialect-dependent — see parse_qasm(dialect=...): the recorder
    # (and the reference logger it mirrors) writes U(rz2,ry,rz1) =
    # Rz Ry Rz in PRINTED order, while the OpenQASM 2.0 builtin is
    # U(theta,phi,lambda) = Rz(phi) Ry(theta) Rz(lambda). Same label,
    # different parameter order; nothing in the text disambiguates.
    "u": (1, 3, None),
    # qelib1's u3 always has the spec order (up to global phase)
    "u3": (1, 3, lambda th, ph, la: _rz(ph) @ _ry(th) @ _rz(la)),
    # common qelib1 aliases: u1 = phase, u2 = u3(pi/2, phi, lambda),
    # rzz = exp(-i theta/2 Z(x)Z) (the multiRotateZ two-qubit form)
    "u1": (1, 1, lambda la: np.diag([1.0, np.exp(1j * la)])),
    "p": (1, 1, lambda la: np.diag([1.0, np.exp(1j * la)])),  # qiskit name
    "u2": (1, 2, lambda ph, la: _rz(ph) @ _ry(np.pi / 2.0) @ _rz(la)),
    "rzz": (2, 1, lambda th: np.diag([np.exp(-0.5j * th),
                                      np.exp(0.5j * th),
                                      np.exp(0.5j * th),
                                      np.exp(-0.5j * th)])),
    "sdg": (1, 0, lambda: np.diag([1.0, -1j])),
    "tdg": (1, 0, lambda: np.diag([1.0, np.exp(-1j * np.pi / 4.0)])),
    "id": (1, 0, None),
}

# qelib1's u3/u2 (and the spec's U) carry e^{i(phi+lambda)/2} relative to
# the phase-dropped Rz.Ry.Rz built above — physical under controls
_PHASED_BASES = {"u3": lambda ps: (ps[1] + ps[2]) / 2.0,
                 "u2": lambda ps: (ps[0] + ps[1]) / 2.0}

_U_BUILDERS = {
    "quest": lambda a, b, c: _rz(a) @ _ry(b) @ _rz(c),
    "openqasm": lambda th, ph, la: _rz(ph) @ _ry(th) @ _rz(la),
}

_ROT_METHODS = {"rx", "ry", "rz"}

_LINE_RE = re.compile(
    r"^(?P<label>[A-Za-z_][A-Za-z0-9_]*)"
    r"(?:\s*\(\s*(?P<params>.*)\s*\))?"        # greedy: parens may nest
    r"\s+(?P<args>[^;()]+);$")                 # args never contain parens
_QUBIT_RE = re.compile(r"^(?P<reg>[A-Za-z_][A-Za-z0-9_]*)"
                       r"\[(?P<idx>\d+)\]$")

_ALLOWED_NODES = (ast.Expression, ast.BinOp, ast.UnaryOp, ast.Constant,
                  ast.Name, ast.Load, ast.Add, ast.Sub, ast.Mult, ast.Div,
                  ast.Pow, ast.USub, ast.UAdd)


def _eval_param(text: str) -> float:
    """Numeric parameter, allowing ``pi`` arithmetic (``pi/2``, ``3*pi/4``)
    — evaluated over a closed AST, no builtins reachable."""
    try:
        return float(text)
    except ValueError:
        pass
    tree = ast.parse(text.strip(), mode="eval")
    for node in ast.walk(tree):
        if not isinstance(node, _ALLOWED_NODES):
            raise ValueError(f"unsupported expression in parameter: {text!r}")
        if isinstance(node, ast.Name) and node.id != "pi":
            raise ValueError(f"unknown symbol {node.id!r} in parameter")

    def ev(n):
        if isinstance(n, ast.Expression):
            return ev(n.body)
        if isinstance(n, ast.Constant):
            return float(n.value)
        if isinstance(n, ast.Name):
            return math.pi
        if isinstance(n, ast.UnaryOp):
            v = ev(n.operand)
            return -v if isinstance(n.op, ast.USub) else v
        left, right = ev(n.left), ev(n.right)
        return {ast.Add: lambda: left + right,
                ast.Sub: lambda: left - right,
                ast.Mult: lambda: left * right,
                ast.Div: lambda: left / right,
                ast.Pow: lambda: left ** right}[type(n.op)]()

    try:
        return ev(tree)
    except TypeError as e:                     # e.g. float(1j)
        raise ValueError(f"non-real parameter {text!r}") from e


def _split_label(label: str):
    """Strip stacked ``c`` control prefixes down to a known base gate.

    Case-insensitive throughout (the recorder emits ``Rz``/``cRz``, the
    standard dialect ``rz``/``crz``, and the spec builtin is ``CX``).
    Returns (controls, base)."""
    for n_ctrl in range(len(label)):
        base = label[n_ctrl:].lower()
        if base in _BASES:
            if label[:n_ctrl].lower() != "c" * n_ctrl:
                break
            return n_ctrl, base
    raise ValueError(f"unknown gate label {label!r}")


@dataclasses.dataclass
class ParsedQASM:
    """Result of :func:`parse_qasm`.

    ``circuit`` holds every unitary operation; ``measurements`` lists
    ``(qubit, classical_bit)`` in program order (a :class:`Circuit` is a
    pure gate program — apply them with ``measure`` after running);
    ``resets`` counts ``reset`` statements seen at the head of the
    program (the recorder's init records; start from ``initZeroState``)."""
    circuit: Circuit
    measurements: list[tuple[int, int]]
    resets: int


def parse_qasm(text: str, dialect: str = "quest") -> ParsedQASM:
    """Parse OpenQASM 2.0 text into a pure gate :class:`Circuit`.

    Supports the subset the recorder emits plus common hand-written
    spellings; ``barrier``/``include`` are ignored, mid-circuit ``reset``
    is rejected (no mixed-state representation in a gate program).

    ``dialect`` resolves the ``U(a,b,c)`` parameter-order ambiguity:
    ``"quest"`` (default) reads recorder/reference-logger files, where
    ``U(rz2,ry,rz1)`` multiplies in printed order; ``"openqasm"`` reads
    the spec builtin ``U(theta,phi,lambda)`` = ``Rz(phi)Ry(theta)
    Rz(lambda)``. ``u3`` always has the spec order; every other gate is
    dialect-independent."""
    if dialect not in _U_BUILDERS:
        raise ValueError(f"unknown dialect {dialect!r}; "
                         f"expected one of {sorted(_U_BUILDERS)}")
    num_qubits = None
    qreg_name = None
    circuit = None
    measurements: list[tuple[int, int]] = []
    resets = 0
    seen_gate = False
    measured_qubits: set[int] = set()

    for raw in text.splitlines():
        line = raw.split("//", 1)[0].strip()
        if not line:
            continue
        for stmt in filter(None, (s.strip() for s in line.split(";"))):
            stmt += ";"
            low = stmt.lower()
            if low.startswith(("openqasm", "include", "barrier", "creg")):
                continue
            if low.startswith("qreg"):
                m = re.match(r"qreg\s+([A-Za-z_][A-Za-z0-9_]*)"
                             r"\[(\d+)\]\s*;", stmt)
                if not m:
                    raise ValueError(f"malformed qreg statement: {stmt!r}")
                if circuit is not None:
                    raise ValueError("multiple qreg declarations")
                qreg_name, num_qubits = m.group(1), int(m.group(2))
                circuit = Circuit(num_qubits)
                continue
            if circuit is None:
                raise ValueError(f"statement before qreg: {stmt!r}")
            if low.startswith("reset"):
                if seen_gate:
                    raise ValueError(
                        "mid-circuit reset is not representable in a pure "
                        "gate program")
                resets += 1
                continue
            if low.startswith("measure"):
                m = re.match(r"measure\s+(\S+)\s*->\s*(\S+)\s*;", stmt)
                if not m:
                    raise ValueError(f"malformed measure: {stmt!r}")
                q = _parse_qubit(m.group(1), qreg_name, num_qubits)
                cm = re.match(r"[A-Za-z_][A-Za-z0-9_]*\[(\d+)\]", m.group(2))
                measurements.append((q, int(cm.group(1)) if cm else q))
                measured_qubits.add(q)
                continue
            _parse_gate(stmt, circuit, qreg_name, num_qubits, dialect,
                        measured_qubits)
            seen_gate = True

    if circuit is None:
        raise ValueError("no qreg declaration found")
    return ParsedQASM(circuit, measurements, resets)


def _parse_qubit(tok: str, qreg_name: str, num_qubits: int) -> int:
    m = _QUBIT_RE.match(tok.strip())
    if not m or m.group("reg") != qreg_name:
        raise ValueError(f"bad qubit reference {tok!r}")
    idx = int(m.group("idx"))
    if idx >= num_qubits:
        raise ValueError(f"qubit index {idx} outside qreg[{num_qubits}]")
    return idx


def _parse_gate(stmt: str, circuit: Circuit, qreg_name: str,
                num_qubits: int, dialect: str,
                measured_qubits: set = frozenset()) -> None:
    m = _LINE_RE.match(stmt)
    if not m:
        raise ValueError(f"malformed gate statement: {stmt!r}")
    n_ctrl, base = _split_label(m.group("label"))
    n_targ, n_par, builder = _BASES[base]
    if base == "u":
        builder = _U_BUILDERS[dialect]
    params = [
        _eval_param(p) for p in m.group("params").split(",")
    ] if m.group("params") else []
    if len(params) != n_par:
        raise ValueError(
            f"{m.group('label')} takes {n_par} parameter(s), "
            f"got {len(params)}: {stmt!r}")
    qubits = [_parse_qubit(t, qreg_name, num_qubits)
              for t in m.group("args").split(",")]
    touched = measured_qubits.intersection(qubits)
    if touched:
        # silently hoisting the gate above the deferred measure would
        # change the program's distribution: reject, like mid-circuit
        # reset. Gates on DISJOINT qubits commute with the
        # projector and stay importable.
        raise ValueError(
            f"mid-circuit measurement: gate on already-measured "
            f"qubit(s) {sorted(touched)} cannot be deferred (use "
            f"Circuit.mid_measure or the imperative API instead)")
    if (base in ("swap", "sqrtswap") and n_ctrl >= 1
            and len(qubits) == n_ctrl + 1):
        # the reference logger styles the swap family's FIRST qubit as a
        # control ("cswap q[a],q[b]" = plain SWAP — QuEST_qasm's label
        # convention); a true Fredkin has n_ctrl + 2 qubits instead
        n_ctrl -= 1
    if len(qubits) != n_ctrl + n_targ:
        raise ValueError(
            f"{m.group('label')} needs {n_ctrl + n_targ} qubits, "
            f"got {len(qubits)}: {stmt!r}")
    controls, targets = tuple(qubits[:n_ctrl]), tuple(qubits[n_ctrl:])
    if builder is None:                       # id gate
        return
    if isinstance(builder, str):
        if not controls and builder not in _ROT_METHODS:
            getattr(circuit, builder)(*targets)
            return
        if not controls:
            getattr(circuit, builder)(targets[0], params[0])
            return
        mat = {"x": mats.pauli_x, "y": mats.pauli_y, "z": mats.pauli_z,
               "h": mats.hadamard, "s": mats.s_gate, "t": mats.t_gate}
        if builder in mat:
            circuit.gate(mat[builder](), targets, controls)
        else:
            axis = {"rx": (1.0, 0, 0), "ry": (0, 1.0, 0),
                    "rz": (0, 0, 1.0)}[builder]
            circuit.gate(mats.rotation(params[0], axis), targets, controls)
        return
    circuit.gate(np.asarray(builder(*params), dtype=np.complex128),
                 targets, controls)
    if controls:
        # restore the determinant phase the SU(2) form drops — it is
        # physical under controls: c^{n-1}u1((phi+lambda)/2)
        # on the controls, mirroring to_qasm's phase restoration
        gamma = 0.0
        if base in _PHASED_BASES:
            gamma = _PHASED_BASES[base](params)
        elif base == "u" and dialect == "openqasm":
            gamma = (params[1] + params[2]) / 2.0
        if abs(gamma) > 1e-15:
            t = np.ones((2,) * len(controls), dtype=np.complex128)
            t[(1,) * len(controls)] = np.exp(1j * gamma)
            circuit.diagonal(t, controls)


def load_qasm_file(path: str, dialect: str = "quest") -> ParsedQASM:
    with open(path) as f:
        return parse_qasm(f.read(), dialect=dialect)
