"""OpenQASM 2.0 recorder.

Python-native port of the reference QASM logger semantics
(``QuEST_qasm.c``): a per-register text log, off by default, with the same
gate-label table (``QuEST_qasm.c:38-53``), the same ``c``-prefix convention
for controlled gates, ZYZ decomposition for compact/general unitaries
(``getZYZRotAnglesFromComplexPair`` ``QuEST_common.c:123-133``), and comment
records for ops with no QASM form. The growable char buffer becomes a plain
Python list of lines.
"""

from __future__ import annotations

import numpy as np

__all__ = ["QASMLogger"]

QUREG_LABEL = "q"
MESREG_LABEL = "c"
CTRL_PREFIX = "c"
COMMENT_PREF = "//"

GATE_LABELS = {
    "sigma_x": "x",
    "sigma_y": "y",
    "sigma_z": "z",
    "t": "t",
    "s": "s",
    "hadamard": "h",
    "rotate_x": "Rx",
    "rotate_y": "Ry",
    "rotate_z": "Rz",
    "unitary": "U",
    "phase_shift": "Rz",
    "swap": "swap",
    "sqrt_swap": "sqrtswap",
}


def _zyz_from_complex_pair(alpha: complex, beta: complex):
    """U(alpha,beta) = exp(i phase) Rz(rz2) Ry(ry) Rz(rz1)
    (``QuEST_common.c:123-133``)."""
    alpha_mag = abs(alpha)
    ry = 2.0 * np.arccos(min(alpha_mag, 1.0))
    alpha_phase = np.arctan2(alpha.imag, alpha.real)
    beta_phase = np.arctan2(beta.imag, beta.real)
    rz2 = -alpha_phase + beta_phase
    rz1 = -alpha_phase - beta_phase
    return rz2, ry, rz1


# the reference prints gate parameters with REAL_QASM_FORMAT = "%.14g" in
# its double build (QuEST_precision.h:47); parameters are host f64 here
def _fmt(x: float) -> str:
    return f"{float(x):.14g}"


def _pair_and_phase_from_unitary(u):
    """Split u into exp(i phase) * compact(alpha, beta)
    (``getComplexPairAndPhaseFromUnitary`` ``QuEST_common.c:135-147``)."""
    u = np.asarray(u, dtype=np.complex128)
    g = (np.angle(u[0, 0]) + np.angle(u[1, 1])) / 2.0
    fac = np.exp(-1j * g)
    return complex(u[0, 0] * fac), complex(u[1, 0] * fac), float(g)


class QASMLogger:
    """Per-register QASM log (``QASMLogger`` struct, ``QuEST.h:63-70``)."""

    def __init__(self, num_qubits: int):
        self.num_qubits = num_qubits
        self.is_logging = False
        self._lines: list[str] = []
        self._header = [
            "OPENQASM 2.0;",
            f"qreg {QUREG_LABEL}[{num_qubits}];",
            f"creg {MESREG_LABEL}[{num_qubits}];",
        ]

    # -- plumbing ----------------------------------------------------------

    def _add(self, line: str) -> None:
        if self.is_logging:
            self._lines.append(line)

    def clear(self) -> None:
        self._lines = []

    def text(self) -> str:
        return "\n".join(self._header + self._lines) + "\n"

    def write_to_file(self, filename: str) -> None:
        with open(filename, "w") as f:
            f.write(self.text())

    # -- records (qasm_record* surface, QuEST_qasm.h:43-84) ---------------

    def _ctrl_label(self, gate: str, num_controls: int) -> str:
        return CTRL_PREFIX * num_controls + GATE_LABELS[gate]

    def _qubits(self, *qs: int) -> str:
        return ",".join(f"{QUREG_LABEL}[{q}]" for q in qs)

    def record_gate(self, gate: str, target: int, controls: tuple = ()) -> None:
        self._add(f"{self._ctrl_label(gate, len(controls))} "
                  f"{self._qubits(*controls, target)};")

    def _restore_phase(self, noun: str, angle: float, target: int,
                       controls: tuple, kind: str) -> None:
        """QASM's cRz / controlled-U drop a global phase that becomes
        physical under control; the reference restores it with an explicit
        uncontrolled Rz on the target plus a comment
        (``qasm_recordControlledParamGate`` ``QuEST_qasm.c:256-261``,
        ``qasm_record(Multi)ControlledUnitary`` ``:277-297,341-360``)."""
        kind = kind or ("controlled" if len(controls) == 1
                        else "multicontrolled")
        self.record_comment(
            "Restoring the discarded global phase of the previous "
            f"{kind} {noun}")
        self._add(f"{GATE_LABELS['rotate_z']}({_fmt(angle)}) "
                  f"{self._qubits(target)};")

    def record_param_gate(self, gate: str, target: int, param: float,
                          controls: tuple = (), kind: str = None) -> None:
        """``kind`` names the API entry point ("controlled" /
        "multicontrolled") for the phase-restoration comment — the
        reference words it per function, not per control count."""
        self._add(f"{self._ctrl_label(gate, len(controls))}({_fmt(param)}) "
                  f"{self._qubits(*controls, target)};")
        # the reference's multicontrolled form restores the phase even with
        # zero controls (qasm_recordMultiControlledParamGate fires on the
        # gate type alone, QuEST_qasm.c:331-338)
        if gate == "phase_shift" and (controls or kind == "multicontrolled"):
            self._restore_phase("phase gate", param / 2.0, target,
                                controls, kind)

    def record_compact_unitary(self, alpha, beta, target: int,
                               controls: tuple = ()) -> None:
        rz2, ry, rz1 = _zyz_from_complex_pair(complex(alpha), complex(beta))
        label = CTRL_PREFIX * len(controls) + GATE_LABELS["unitary"]
        self._add(f"{label}({_fmt(rz2)},{_fmt(ry)},{_fmt(rz1)}) "
                  f"{self._qubits(*controls, target)};")

    def record_unitary(self, u, target: int, controls: tuple = (),
                       kind: str = None) -> None:
        alpha, beta, phase = _pair_and_phase_from_unitary(u)
        self.record_compact_unitary(alpha, beta, target, controls)
        if controls:
            self._restore_phase("unitary", phase, target, controls, kind)

    def record_axis_rotation(self, angle: float, axis, target: int,
                             controls: tuple = ()) -> None:
        from .core.matrices import rotation_pair
        alpha, beta = rotation_pair(angle, axis)
        self.record_compact_unitary(alpha, beta, target, controls)

    def record_multi_state_controlled_unitary(self, u, controls, control_state,
                                              target: int) -> None:
        flips = [c for c, s in zip(controls, control_state) if s == 0]
        self.record_comment("NOTing some gates so that the subsequent "
                            "unitary is controlled-on-0")
        for c in flips:
            self.record_gate("sigma_x", c)
        self.record_unitary(u, target, tuple(controls),
                            kind="multicontrolled")
        self.record_comment("Undoing the NOTing of the controlled-on-0 "
                            "qubits of the previous unitary")
        for c in flips:
            self.record_gate("sigma_x", c)

    def record_u1(self, angle: float, target: int,
                  controls: tuple = ()) -> None:
        """qelib ``u1`` (= diag(1, e^{i angle})) with stacked ``c``
        prefixes — EXACT under controls, unlike the phase-shift Rz form.
        Emitted by ``Circuit.to_qasm`` (the importer reads it); not part
        of the reference logger's own output set."""
        label = CTRL_PREFIX * len(controls) + "u1"
        self._add(f"{label}({_fmt(angle)}) "
                  f"{self._qubits(*controls, target)};")

    def record_rzz(self, angle: float, q1: int, q2: int) -> None:
        """qelib ``rzz`` (= exp(-i angle/2 Z⊗Z)) — the two-qubit
        multiRotateZ parity phase, exact. Emitted by ``Circuit.to_qasm``."""
        self._add(f"rzz({_fmt(angle)}) {self._qubits(q1, q2)};")

    def record_measurement(self, qubit: int) -> None:
        self._add(f"measure {QUREG_LABEL}[{qubit}] -> {MESREG_LABEL}[{qubit}];")

    def record_init_zero(self) -> None:
        self._add(f"reset {QUREG_LABEL};")

    def record_init_plus(self) -> None:
        self.record_init_zero()
        for q in range(self.num_qubits):
            self.record_gate("hadamard", q)

    def record_init_classical(self, state_ind: int) -> None:
        self.record_init_zero()
        for q in range(self.num_qubits):
            if (state_ind >> q) & 1:
                self.record_gate("sigma_x", q)

    def record_comment(self, comment: str) -> None:
        self._add(f"{COMMENT_PREF} {comment}")
