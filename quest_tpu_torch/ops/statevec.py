"""State-vector reductions, data movement and collapse on split planes.

Counterpart of the JAX package's ``ops/statevec.py`` (the reference's
``statevec_*`` backend contract, ``QuEST_internal.h:108-246``). Every
function takes the ``(2, 2^N)`` planes plus static qubit metadata. Updates
(:func:`swap_amps`, :func:`collapse_to_known_prob_outcome`) happen IN PLACE;
reductions return 0-dim tensors on the planes' device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.apply import split_shape

__all__ = [
    "multi_rotate_z_diag",
    "swap_amps",
    "calc_total_prob",
    "calc_inner_product",
    "calc_prob_of_outcome",
    "collapse_to_known_prob_outcome",
    "set_weighted",
]

# amplitudes per chunk of set_weighted: each chunk's inputs are read before
# its output is written, so out may alias an input, and the chunk's
# temporaries (a few 16 MiB float32 planes) stay small beside the state
WEIGHTED_CHUNK = 1 << 22


def multi_rotate_z_diag(k: int, angle: float) -> np.ndarray:
    """(2,)*k parity-phase tensor: even-parity bit patterns get
    exp(-i angle/2), odd get exp(+i angle/2) (``QuEST_cpu.c:3075-3114``)."""
    idx = np.arange(1 << k)
    parity = np.zeros(1 << k, dtype=np.int64)
    for b in range(k):
        parity ^= (idx >> b) & 1
    fac = np.where(parity == 0, np.exp(-0.5j * angle), np.exp(0.5j * angle))
    return fac.reshape((2,) * k)


def swap_amps(planes: torch.Tensor, num_qubits: int, q1: int,
              q2: int) -> torch.Tensor:
    """SWAP as pure data movement, in place: exchange the amplitudes whose
    two bits differ (``statevec_swapQubitAmps`` ``QuEST_cpu.c:3502``)."""
    hi, lo = max(q1, q2), min(q1, q2)
    x = planes.view((2,) + split_shape(num_qubits, (hi, lo)))
    tmp = x[:, :, 0, :, 1, :].clone()
    x[:, :, 0, :, 1, :] = x[:, :, 1, :, 0, :]
    x[:, :, 1, :, 0, :] = tmp
    return planes


def _sum_sq(x: torch.Tensor) -> torch.Tensor:
    x = x.reshape(-1)
    return torch.dot(x, x)


def calc_total_prob(planes: torch.Tensor) -> torch.Tensor:
    """Sum of |amp|^2 (the compensated route lives in ``ops.reductions``,
    selected by the API layer via ``env.compensated``)."""
    return _sum_sq(planes)


def calc_inner_product(bra: torch.Tensor, ket: torch.Tensor):
    """<bra|ket> as (re, im) 0-dim tensors (conjugates bra, as
    ``calcInnerProductLocal`` ``QuEST_cpu.c:1076``)."""
    br, bi = bra[0].reshape(-1), bra[1].reshape(-1)
    kr, ki = ket[0].reshape(-1), ket[1].reshape(-1)
    return (torch.dot(br, kr) + torch.dot(bi, ki),
            torch.dot(br, ki) - torch.dot(bi, kr))


def zero_half(planes: torch.Tensor, num_qubits: int,
              qubit: int) -> torch.Tensor:
    """The outcome-0 half of the planes for ``qubit`` (a strided view)."""
    pre, _, post = split_shape(num_qubits, (qubit,))
    return planes.view(2, pre, 2, post)[:, :, 0, :]


def calc_prob_of_outcome(planes: torch.Tensor, num_qubits: int, qubit: int,
                         outcome: int) -> torch.Tensor:
    """P(outcome 0) summed directly; P(outcome 1) as its complement 1-P0 —
    the reference's semantics (``statevec_calcProbOfOutcome``
    ``QuEST_cpu_local.c:279-285``), observable on unnormalised registers."""
    zero_prob = _sum_sq(zero_half(planes, num_qubits, qubit))
    return zero_prob if outcome == 0 else 1.0 - zero_prob


def collapse_to_known_prob_outcome(planes: torch.Tensor, num_qubits: int,
                                   qubit: int, outcome: int,
                                   prob: float) -> torch.Tensor:
    """Zero the non-outcome half and renormalise the outcome half by
    1/sqrt(prob), in place (``QuEST_cpu.c:3346-3494``)."""
    pre, _, post = split_shape(num_qubits, (qubit,))
    x = planes.view(2, pre, 2, post)
    x[:, :, 1 - outcome, :].zero_()
    x[:, :, outcome, :].mul_(1.0 / math.sqrt(prob))
    return planes


def set_weighted(fac1, state1: torch.Tensor, fac2, state2: torch.Tensor,
                 fac_out, out: torch.Tensor) -> torch.Tensor:
    """out = fac1*state1 + fac2*state2 + fac_out*out on ``(2, N)`` planes,
    IN PLACE in ``out`` (returned), which may be ``state1`` or ``state2``
    (``QuEST_cpu.c:3585``). The complex factors split into real
    coefficients of the six input planes; each chunk of columns is read
    whole before its result is written back, so the state is read once and
    written once."""
    coefs = [complex(f) for f in (fac1, fac2, fac_out)]
    srcs = (state1, state2, out)
    num_amps = out.shape[1]
    for lo in range(0, num_amps, WEIGHTED_CHUNK):
        hi = min(lo + WEIGHTED_CHUNK, num_amps)
        new_re = torch.zeros_like(out[0, lo:hi])
        new_im = torch.zeros_like(new_re)
        for f, s in zip(coefs, srcs):
            re, im = s[0, lo:hi], s[1, lo:hi]
            new_re.add_(re, alpha=f.real).add_(im, alpha=-f.imag)
            new_im.add_(im, alpha=f.real).add_(re, alpha=f.imag)
        out[0, lo:hi] = new_re
        out[1, lo:hi] = new_im
    return out
