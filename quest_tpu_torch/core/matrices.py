"""Standard gate matrices and diagonal factors (host-side, numpy).

Conventions match the reference exactly:

- ``compact_unitary(alpha, beta)`` = ``[[a, -conj(b)], [b, conj(a)]]``
  (``QuEST_cpu.c:1662-1719`` pair update).
- ``rotation(angle, axis)`` = ``exp(-i angle/2 n.sigma)`` via the
  (alpha, beta) map of ``getComplexPairFromRotation``
  (``QuEST_common.c:113-120``).
- ``sqrt_swap`` entries per ``statevec_sqrtSwapGate``
  (``QuEST_common.c:383-394``).
- Two-/multi-qubit matrices index bit ``j`` of the row by ``targets[j]``
  (ComplexMatrixN convention, gather order of ``QuEST_cpu.c:1820-1901``).

Everything here is tiny and host-side; matrices are built in float64/complex128
numpy and cast to the register dtype at application time. The ``*_traceable``
builders are the parametrised gates' one definition: torch float64 in,
complex128 torch out, so ``torch.func`` binds them over a batch of parameter
rows and differentiates them (``ops/adjoint.py``).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "PAULI_MATS",
    "hadamard",
    "pauli_x",
    "pauli_y",
    "pauli_z",
    "s_gate",
    "t_gate",
    "compact_unitary",
    "rotation_pair",
    "rotation",
    "rotation_traceable",
    "phase_factors_traceable",
    "swap",
    "sqrt_swap",
    "matrix2",
    "matrix4",
    "unit_vector",
    "embed_in_support",
    "diag_in_support",
]

_I = np.eye(2, dtype=np.complex128)
_X = np.array([[0, 1], [1, 0]], dtype=np.complex128)
_Y = np.array([[0, -1j], [1j, 0]], dtype=np.complex128)
_Z = np.array([[1, 0], [0, -1]], dtype=np.complex128)

# indexed by PauliOpType value (I=0, X=1, Y=2, Z=3)
PAULI_MATS = (_I, _X, _Y, _Z)


def hadamard() -> np.ndarray:
    return np.array([[1, 1], [1, -1]], dtype=np.complex128) / np.sqrt(2.0)


def pauli_x() -> np.ndarray:
    return _X.copy()


def pauli_y(conj: bool = False) -> np.ndarray:
    return _Y.conj().copy() if conj else _Y.copy()


def pauli_z() -> np.ndarray:
    return _Z.copy()


def s_gate(conj: bool = False) -> np.ndarray:
    return np.diag([1.0, -1j if conj else 1j]).astype(np.complex128)


def t_gate(conj: bool = False) -> np.ndarray:
    ph = np.exp(-1j * np.pi / 4) if conj else np.exp(1j * np.pi / 4)
    return np.diag([1.0, ph]).astype(np.complex128)


def compact_unitary(alpha: complex, beta: complex) -> np.ndarray:
    """U = [[alpha, -conj(beta)], [beta, conj(alpha)]]."""
    a = complex(alpha)
    b = complex(beta)
    return np.array([[a, -np.conj(b)], [b, np.conj(a)]], dtype=np.complex128)


def unit_vector(axis) -> np.ndarray:
    v = np.asarray(axis, dtype=np.float64)
    return v / np.linalg.norm(v)


def rotation_pair(angle: float, axis) -> tuple[complex, complex]:
    """(alpha, beta) of exp(-i angle/2 n.sigma), per getComplexPairFromRotation."""
    n = unit_vector(axis)
    c, s = np.cos(angle / 2.0), np.sin(angle / 2.0)
    alpha = complex(c, -s * n[2])
    beta = complex(s * n[1], -s * n[0])
    return alpha, beta


def rotation(angle: float, axis, conj: bool = False) -> np.ndarray:
    alpha, beta = rotation_pair(angle, axis)
    if conj:
        alpha, beta = np.conj(alpha), np.conj(beta)
    return compact_unitary(alpha, beta)


def rotation_traceable(angle, axis) -> torch.Tensor:
    """:func:`rotation` of an angle given as a float or a (batched) 0-dim
    float64 tensor: the same (alpha, beta) map, as a complex128 tensor."""
    n = unit_vector(axis)
    half = torch.as_tensor(angle, dtype=torch.float64) / 2.0
    c, s = torch.cos(half), torch.sin(half)
    alpha = torch.complex(c, -s * n[2])
    beta = torch.complex(s * n[1], -s * n[0])
    return torch.stack([torch.stack([alpha, -beta.conj()]),
                        torch.stack([beta, alpha.conj()])])


def phase_factors_traceable(angles) -> torch.Tensor:
    """``exp(i angles)`` of a float64 tensor (or a float), complex128."""
    return torch.exp(1j * torch.as_tensor(angles, dtype=torch.float64))


def swap() -> np.ndarray:
    m = np.zeros((4, 4), dtype=np.complex128)
    m[0, 0] = m[3, 3] = 1
    m[1, 2] = m[2, 1] = 1
    return m


def sqrt_swap(conj: bool = False) -> np.ndarray:
    m = np.zeros((4, 4), dtype=np.complex128)
    m[0, 0] = m[3, 3] = 1
    m[1, 1] = m[2, 2] = 0.5 + 0.5j
    m[1, 2] = m[2, 1] = 0.5 - 0.5j
    return m.conj() if conj else m


def embed_in_support(u: np.ndarray, targets, support,
                     ctrl_mask: int = 0, flip_mask: int = 0) -> np.ndarray:
    """Embed a (controlled) gate into the full operator over ``support``.

    ``support`` lists qubits; bit ``j`` of the output matrix index addresses
    ``support[j]`` (same ComplexMatrixN convention as gate targets). All of
    ``targets`` and the control qubits must be members of ``support``.
    Controls condition on 1 unless their bit is set in ``flip_mask``.
    """
    support = list(support)
    pos = {q: j for j, q in enumerate(support)}
    k = len(support)
    dim = 1 << k
    t_local = [pos[t] for t in targets]
    c_local = 0
    f_local = 0
    m, q = ctrl_mask, 0
    while m:
        if m & 1:
            c_local |= 1 << pos[q]
            if (flip_mask >> q) & 1:
                f_local |= 1 << pos[q]
        m >>= 1
        q += 1
    t_mask = 0
    for t in t_local:
        t_mask |= 1 << t
    want = c_local & ~f_local
    full = np.zeros((dim, dim), dtype=np.complex128)
    for col in range(dim):
        if (col & c_local) != want:
            full[col, col] = 1.0
            continue
        m_in = 0
        for j, t in enumerate(t_local):
            if (col >> t) & 1:
                m_in |= 1 << j
        base = col & ~t_mask
        for m_out in range(1 << len(t_local)):
            row = base
            for j, t in enumerate(t_local):
                if (m_out >> j) & 1:
                    row |= 1 << t
            full[row, col] += u[m_out, m_in]
    return full


def diag_in_support(tensor: np.ndarray, qubits_desc, support) -> np.ndarray:
    """Embed a diagonal factor ((2,)*k tensor, axes = qubits sorted desc)
    as a diagonal operator over ``support`` (bit j <-> support[j])."""
    support = list(support)
    dim = 1 << len(support)
    pos = {q: j for j, q in enumerate(support)}
    d = np.ones(dim, dtype=np.complex128)
    for idx in range(dim):
        key = tuple((idx >> pos[q]) & 1 for q in qubits_desc)
        d[idx] = tensor[key]
    return np.diag(d)


def matrix2(u) -> np.ndarray:
    """Coerce a 2x2 matrix-like (nested list / ndarray) to complex128."""
    m = np.asarray(u, dtype=np.complex128)
    if m.shape != (2, 2):
        raise ValueError(f"expected 2x2 matrix, got shape {m.shape}")
    return m


def matrix4(u) -> np.ndarray:
    m = np.asarray(u, dtype=np.complex128)
    if m.shape != (4, 4):
        raise ValueError(f"expected 4x4 matrix, got shape {m.shape}")
    return m
