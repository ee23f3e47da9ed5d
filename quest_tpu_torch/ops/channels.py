"""Kraus-operator sets for the built-in decoherence channels.

Counterpart of the JAX package's ``ops/channels.py``. Every channel of the
reference is (or is equivalent to) a Kraus map (``QuEST_common.c:540-604``,
``densmatr_mixPauli`` ``QuEST_common.c:675-695``). The static builders
return numpy ``complex128`` sets; the ``*_traceable`` builders take a
strength bound at run time (a float or a 0-dim tensor, the value of a
``Param``) and return ``complex128`` torch tensors with the same math —
keep each pair in sync.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ..core.matrices import PAULI_MATS

__all__ = [
    "damping_kraus",
    "pauli_kraus_traceable",
    "damping_kraus_traceable",
    "dephasing_kraus_traceable",
    "depolarising_kraus",
    "depolarising_kraus_traceable",
    "pauli_kraus",
    "two_qubit_dephasing_kraus",
    "two_qubit_depolarising_kraus",
]


def damping_kraus(prob: float) -> list[np.ndarray]:
    """Amplitude damping: K0 = diag(1, sqrt(1-p)), K1 = sqrt(p)|0><1|."""
    k0 = np.array([[1.0, 0.0], [0.0, np.sqrt(1.0 - prob)]], dtype=np.complex128)
    k1 = np.array([[0.0, np.sqrt(prob)], [0.0, 0.0]], dtype=np.complex128)
    return [k0, k1]


def pauli_kraus(prob_x: float, prob_y: float, prob_z: float) -> list[np.ndarray]:
    """rho -> (1-px-py-pz) rho + px X rho X + py Y rho Y + pz Z rho Z."""
    probs = (1.0 - prob_x - prob_y - prob_z, prob_x, prob_y, prob_z)
    return [np.sqrt(p) * m for p, m in zip(probs, PAULI_MATS)]


def depolarising_kraus(prob: float) -> list[np.ndarray]:
    """Homogeneous single-qubit depolarising: px=py=pz=p/3."""
    return pauli_kraus(prob / 3.0, prob / 3.0, prob / 3.0)


def two_qubit_dephasing_kraus(prob: float) -> list[np.ndarray]:
    """rho -> (1-p) rho + p/3 (Z1 rho Z1 + Z2 rho Z2 + Z1Z2 rho Z1Z2)
    (``mixTwoQubitDephasing`` semantics). Kraus index bit 0 addresses the
    first target, so Z on the first target is kron(I, Z)."""
    z = PAULI_MATS[3]
    i2 = PAULI_MATS[0]
    w = np.sqrt(prob / 3.0)
    return [np.sqrt(1.0 - prob) * np.eye(4, dtype=np.complex128),
            w * np.kron(i2, z),
            w * np.kron(z, i2),
            w * np.kron(z, z)]


def two_qubit_depolarising_kraus(prob: float) -> list[np.ndarray]:
    """rho -> (1-p) rho + p/15 sum over the 15 non-identity two-qubit Paulis.

    Kraus index bit 0 addresses the first target (matrix convention of
    ``densmatr_applyTwoQubitKrausSuperoperator``), so the kron order is
    (second (x) first).
    """
    ops = []
    for i, j in itertools.product(range(4), range(4)):
        w = (1.0 - prob) if (i == 0 and j == 0) else prob / 15.0
        ops.append(np.sqrt(w) * np.kron(PAULI_MATS[j], PAULI_MATS[i]))
    return ops


# -- run-time-strength variants (Circuit.dephase/damp/depolarise/
# pauli_channel with a Param): the same math as the static builders above


def _c(m) -> torch.Tensor:
    return torch.as_tensor(np.asarray(m, dtype=np.complex128))


def _sqrt(p) -> torch.Tensor:
    return torch.sqrt(torch.as_tensor(p, dtype=torch.float64)).to(
        torch.complex128)


def damping_kraus_traceable(prob) -> list:
    k0 = _c([[1.0, 0.0], [0.0, 0.0]]) \
        + _sqrt(1.0 - torch.as_tensor(prob, dtype=torch.float64)) \
        * _c([[0.0, 0.0], [0.0, 1.0]])
    k1 = _sqrt(prob) * _c([[0.0, 1.0], [0.0, 0.0]])
    return [k0, k1]


def dephasing_kraus_traceable(prob) -> list:
    p = torch.as_tensor(prob, dtype=torch.float64)
    return [_sqrt(1.0 - p) * _c(np.eye(2)), _sqrt(p) * _c(PAULI_MATS[3])]


def depolarising_kraus_traceable(prob) -> list:
    p = torch.as_tensor(prob, dtype=torch.float64)
    return [_sqrt(1.0 - p) * _c(np.eye(2))] + [
        _sqrt(p / 3.0) * _c(PAULI_MATS[c]) for c in (1, 2, 3)]


def pauli_kraus_traceable(prob_x, prob_y, prob_z) -> list:
    px, py, pz = (torch.as_tensor(p, dtype=torch.float64)
                  for p in (prob_x, prob_y, prob_z))
    probs = (1.0 - px - py - pz, px, py, pz)
    return [_sqrt(p) * _c(m) for p, m in zip(probs, PAULI_MATS)]
