"""Density-matrix operations on the flat 2n-qubit vector, on split planes.

Counterpart of the JAX package's ``ops/densmatr.py``. The reference
flattens an n-qubit density matrix into a 2n-qubit vector with
``flat[r + c*2^n] = rho[r, c]`` and reuses the state-vector kernels on it
(``QuEST.c:8-10``). The register keeps that layout as ``(2, 2^(2n))``
re/im planes: unitaries act as ``U`` on the row qubits and ``conj(U)`` on
the column qubits ``q+n`` (:func:`gate_passes` and :func:`diagonal_lift`
give the lift that the API layer and ``Circuit._lifted_density`` both
apply), while the other functions here are the genuinely density-specific
ones (``QuEST_internal.h:57-101``). As the JAX package leaves them to XLA,
they are plain torch ops. Updates happen IN PLACE on the planes;
reductions return 0-dim tensors on the planes' device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.apply import apply_unitary, split_shape

__all__ = [
    "gate_passes",
    "diagonal_lift",
    "conj_op",
    "init_pure_state",
    "calc_total_prob",
    "calc_prob_of_outcome",
    "collapse_to_known_prob_outcome",
    "calc_purity",
    "calc_fidelity",
    "calc_inner_product",
    "calc_hilbert_schmidt_distance",
    "mix_density_matrix",
    "mix_dephasing",
    "mix_two_qubit_dephasing",
    "dephasing_factors",
    "two_qubit_dephasing_factors",
    "apply_kraus_superoperator",
    "kraus_superoperator",
    "kraus_superoperator_traceable",
    "diagonal",
]


def _as_matrix(plane: torch.Tensor, num_qubits: int) -> torch.Tensor:
    """View one flat plane as ``mat[c, r] = rho[r, c]`` (the column axis
    leads because columns occupy the high index bits)."""
    dim = 1 << num_qubits
    return plane.view(dim, dim)


def diagonal(planes: torch.Tensor, num_qubits: int) -> torch.Tensor:
    """The real parts of rho's diagonal, ``(2^n,)`` (a strided view)."""
    return _as_matrix(planes[0], num_qubits).diagonal()


def conj_op(m):
    """The complex conjugate of an operator, numpy or a torch tensor (a
    torch conjugation is resolved: a lazy conj view would reach the
    packing unconjugated)."""
    if isinstance(m, torch.Tensor):
        return torch.conj(m).resolve_conj()
    return np.conj(np.asarray(m, dtype=np.complex128))


def _same(u):
    return u


def _conj_kron(u):
    if isinstance(u, torch.Tensor):
        return torch.kron(conj_op(u), u)
    u = np.asarray(u, dtype=np.complex128)
    return np.kron(np.conj(u), u)


def _outer_conj(d):
    if isinstance(d, torch.Tensor):
        return torch.tensordot(conj_op(d), d, dims=0)
    d = np.asarray(d, dtype=np.complex128)
    return np.multiply.outer(np.conj(d), d)


def gate_passes(targets, ctrl_mask: int, flip_mask: int, num_qubits: int,
                fused: bool = True) -> list:
    """How a gate ``u`` on an n-qubit density register acts on its flat
    2n-qubit vector: ``[(lift, targets, ctrl_mask, flip_mask), ...]``, one
    entry per pass, where ``lift(u)`` is that pass's operator (numpy or
    torch). Uncontrolled (and ``fused``): ``conj(u) (x) u`` on (targets,
    targets+n) in ONE pass (the reference needs two backend calls per gate,
    ``QuEST.c:175-658``). Controlled: row and column controls condition
    independently, so two passes (``QuEST.c:352-357``): ``u`` on targets
    under the controls, then ``conj(u)`` on the shifted copies."""
    targets = tuple(targets)
    shifted = tuple(t + num_qubits for t in targets)
    if fused and not ctrl_mask:
        return [(_conj_kron, targets + shifted, 0, 0)]
    return [(_same, targets, ctrl_mask, flip_mask),
            (conj_op, shifted, ctrl_mask << num_qubits,
             flip_mask << num_qubits)]


def diagonal_lift(targets, num_qubits: int):
    """``(lift, targets)`` of a diagonal factor tensor on an n-qubit
    density register (axis i = i-th of ``targets``, sorted descending):
    ``lift(d)`` is the outer product ``conj(d) (x) d`` on (targets+n,
    targets), still sorted descending."""
    targets = tuple(targets)
    return _outer_conj, tuple(t + num_qubits for t in targets) + targets


def init_pure_state(pure: torch.Tensor) -> torch.Tensor:
    """rho = |psi><psi| from a state's ``(2, 2^n)`` planes: fresh
    ``(2, 4^n)`` planes with ``flat[r + c*2^n] = psi_r * conj(psi_c)``
    (``QuEST_cpu.c:1189``), built by rank-one updates into the output, so
    no temporary of the register's size exists."""
    pr, pi = pure[0], pure[1]
    dim = pr.shape[0]
    out = torch.empty((2, dim, dim), dtype=pure.dtype, device=pure.device)
    # mat[c, r] = conj(psi_c) psi_r
    torch.outer(pr, pr, out=out[0])
    out[0].addr_(pi, pi)
    torch.outer(pr, pi, out=out[1])
    out[1].addr_(pi, pr, alpha=-1.0)
    return out.view(2, dim * dim)


def calc_total_prob(planes: torch.Tensor, num_qubits: int) -> torch.Tensor:
    """Trace: the sum of the real diagonal (``densmatr_calcTotalProb``)."""
    return diagonal(planes, num_qubits).sum()


def calc_prob_of_outcome(planes: torch.Tensor, num_qubits: int, qubit: int,
                         outcome: int) -> torch.Tensor:
    """Sum of the diagonal entries whose basis state has ``qubit`` == 0,
    complemented for outcome 1 (``densmatr_findProbabilityOfZeroLocal``
    ``QuEST_cpu.c:3117``)."""
    diag = diagonal(planes, num_qubits)
    pre, _, post = split_shape(num_qubits, (qubit,))
    zero_prob = diag.reshape(pre, 2, post)[:, 0, :].sum()
    return zero_prob if outcome == 0 else 1.0 - zero_prob


def collapse_to_known_prob_outcome(planes: torch.Tensor, num_qubits: int,
                                   qubit: int, outcome: int,
                                   prob: float) -> torch.Tensor:
    """Keep only the elements whose row AND column bit of ``qubit`` equal
    ``outcome``, scaled by 1/prob, in place (``QuEST_cpu.c:790``): the
    row bit is ``qubit``, the column bit ``qubit + n``."""
    x = planes.view((2,) + split_shape(2 * num_qubits,
                                       (qubit + num_qubits, qubit)))
    for c in range(2):
        for r in range(2):
            if (c, r) != (outcome, outcome):
                x[:, :, c, :, r, :].zero_()
    x[:, :, outcome, :, outcome, :].mul_(1.0 / prob)
    return planes


def calc_purity(planes: torch.Tensor) -> torch.Tensor:
    """Tr(rho^2) = sum |rho_ij|^2 (``densmatr_calcPurityLocal``)."""
    x = planes.reshape(-1)
    return torch.dot(x, x)


def calc_fidelity(planes: torch.Tensor, num_qubits: int,
                  pure: torch.Tensor) -> torch.Tensor:
    """<psi|rho|psi> (``densmatr_calcFidelityLocal`` ``QuEST_cpu.c:995``):
    ``w = mat conj(psi)`` (one matrix-vector product per plane pair), then
    ``Re sum_c w_c psi_c``."""
    a = _as_matrix(planes[0], num_qubits)
    b = _as_matrix(planes[1], num_qubits)
    p, q = pure[0], pure[1]
    # (A + iB)(p - iq) = (Ap + Bq) + i(Bp - Aq)
    w_re = torch.mv(a, p) + torch.mv(b, q)
    w_im = torch.mv(b, p) - torch.mv(a, q)
    return torch.dot(w_re, p) - torch.dot(w_im, q)


def calc_inner_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """real(Tr(a^dag b)) (``densmatr_calcInnerProductLocal``
    ``QuEST_cpu.c:963``): the dot product of the stacked planes."""
    return torch.dot(a.reshape(-1), b.reshape(-1))


def calc_hilbert_schmidt_distance(a: torch.Tensor,
                                  b: torch.Tensor) -> torch.Tensor:
    """sqrt(sum |a-b|^2) (``QuEST_cpu.c:928``)."""
    d = (a - b).reshape(-1)
    return torch.sqrt(torch.dot(d, d))


def mix_density_matrix(combine: torch.Tensor, other_prob: float,
                       other: torch.Tensor) -> torch.Tensor:
    """combine = (1-p)*combine + p*other, in place (``QuEST_cpu.c:895``)."""
    p = float(other_prob)
    return combine.mul_(1.0 - p).add_(other, alpha=p)


# ---------------------------------------------------------------------------
# decoherence channels
# ---------------------------------------------------------------------------
#
# Every channel is a Kraus map. The reference builds a superoperator
# S[(i,k),(j,l)] = sum_n conj(K_n[i,j]) K_n[k,l] and applies it as a
# 2k-qubit "unitary" on targets (t, t+n) of the flat vector
# (``QuEST_common.c:540-604``). The dephasing channels are diagonal and run
# as in-place scalings of the off-diagonal blocks (the reference's
# ``densmatr_oneQubitDegradeOffDiagonal`` fast path, ``QuEST_cpu.c:48``).


def kraus_superoperator(ops) -> np.ndarray:
    """S = sum_n conj(K_n) (x) K_n with row (i,k), col (j,l); i, j the
    column- (bra-)side indices (``macro_populateKrausOperator``
    ``QuEST_common.c:543-563``)."""
    ops = [np.asarray(op, dtype=np.complex128) for op in ops]
    d = ops[0].shape[0]
    s = np.zeros((d * d, d * d), dtype=np.complex128)
    for op in ops:
        s += np.kron(np.conj(op), op)
    return s


def kraus_superoperator_traceable(ops) -> torch.Tensor:
    """:func:`kraus_superoperator` of operators given as torch tensors (a
    PARAMETERIZED channel's, built from the strengths bound at run time):
    a complex128 tensor with its conjugation resolved."""
    s = None
    for op in ops:
        term = _conj_kron(torch.as_tensor(op, dtype=torch.complex128))
        s = term if s is None else s + term
    return s


def apply_kraus_superoperator(planes: torch.Tensor, num_qubits: int,
                              targets, superop) -> torch.Tensor:
    """Apply a superoperator to ``targets`` of the flat density vector, in
    place. Matrix bit order: targets (row side, low bits) then targets+n
    (column side, high bits) —
    ``densmatr_applyMultiQubitKrausSuperoperator``
    (``QuEST_common.c:598-604``)."""
    all_targets = tuple(int(t) for t in targets) \
        + tuple(int(t) + num_qubits for t in targets)
    return apply_unitary(planes, 2 * num_qubits, superop, all_targets)


def dephasing_factors(prob: float) -> np.ndarray:
    """(2, 2) off-diagonal retain tensor of 1q dephasing, axes (column
    bit, row bit)."""
    retain = 1.0 - 2.0 * prob
    return np.array([[1.0, retain], [retain, 1.0]], dtype=np.complex128)


def two_qubit_dephasing_factors(prob: float) -> np.ndarray:
    """(2, 2, 2, 2) retain tensor of 2q dephasing, axes (c_hi, c_lo, r_hi,
    r_lo): any row/column mismatch scales by 1-4p/3."""
    retain = 1.0 - (4.0 * prob) / 3.0
    fac = np.ones((2, 2, 2, 2), dtype=np.complex128)
    for chi in range(2):
        for clo in range(2):
            for rhi in range(2):
                for rlo in range(2):
                    if chi != rhi or clo != rlo:
                        fac[chi, clo, rhi, rlo] = retain
    return fac


def _scale_blocks(planes: torch.Tensor, num_qubits_vec: int,
                  positions_desc, factors: np.ndarray) -> torch.Tensor:
    """Multiply each block of the planes by the REAL factor its bits at
    ``positions_desc`` pick (``factors`` axis i = the i-th position), in
    place, leaving the blocks whose factor is 1 untouched."""
    x = planes.view((2,) + split_shape(num_qubits_vec, positions_desc))
    k = len(positions_desc)
    for bits in np.ndindex(*factors.shape):
        f = float(np.real(factors[bits]))
        if f == 1.0:
            continue
        idx = [slice(None), slice(None)]
        for i in range(k):
            idx += [bits[i], slice(None)]
        x[tuple(idx)].mul_(f)
    return planes


def mix_dephasing(planes: torch.Tensor, num_qubits: int, target: int,
                  prob: float) -> torch.Tensor:
    """rho -> (1-p) rho + p Z rho Z: the off-diagonals in ``target``
    scaled by 1-2p, in place (``densmatr_mixDephasing`` with dephase=2p,
    ``QuEST.c:907``)."""
    return _scale_blocks(planes, 2 * num_qubits,
                         (target + num_qubits, target),
                         dephasing_factors(prob))


def mix_two_qubit_dephasing(planes: torch.Tensor, num_qubits: int, q1: int,
                            q2: int, prob: float) -> torch.Tensor:
    """Z error on either or both qubits, total prob p: any row/column
    mismatch in q1 or q2 scales by 1-4p/3, in place
    (``densmatr_mixTwoQubitDephasing``)."""
    qs = tuple(sorted((q1 + num_qubits, q2 + num_qubits, q2, q1),
                      reverse=True))
    return _scale_blocks(planes, 2 * num_qubits, qs,
                         two_qubit_dephasing_factors(prob))
